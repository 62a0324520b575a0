"""Parallelism on ``torch.distributed`` (port of ``gofr_tpu/parallel/``):
a named mesh of ranks (dp/fsdp/pp/sp/ep/tp axes), per-weight sharding
rules that keep each rank's slices, the collectives the model code calls
where the reference's compiler inserts them, sequence/context parallelism
(ring and Ulysses attention), the GPipe pipeline, and the world of
spawned ranks that runs them (``parallel/world.py``).
"""

from gofr_tpu_torch.parallel.context_parallel import (
    cp_context,
    ring_attention,
    ulysses_attention,
)
from gofr_tpu_torch.parallel.mesh import MeshSpec, build_mesh, local_mesh
from gofr_tpu_torch.parallel.sharding import (
    ShardingRules,
    llama_sharding_rules,
    named_sharding,
    shard_params,
    with_constraint,
)

__all__ = [
    "cp_context",
    "ring_attention",
    "ulysses_attention",
    "MeshSpec",
    "build_mesh",
    "local_mesh",
    "ShardingRules",
    "llama_sharding_rules",
    "named_sharding",
    "shard_params",
    "with_constraint",
]
