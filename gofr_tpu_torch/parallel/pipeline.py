"""Pipeline parallelism over the ``pp`` mesh axis, GPipe-style (port of
``gofr_tpu/parallel/pipeline.py``).

Transformer layers are stage-sharded over ``pp`` (stage s owns layers
[s·L/n, (s+1)·L/n)), microbatches stream through the stages, and
activations hop stage to stage with ``ppermute`` (point-to-point sends).
Inside a stage the other axes keep working: a ``tp``-sharded stage runs
its layers' collectives over ``tp`` as ``llama.forward`` does.

Schedule: single-direction fill-drain (GPipe). T = M + n - 1 ticks; stage
0 feeds microbatch t at tick t, the last stage emits microbatch t-(n-1).
Bubble fraction (n-1)/(M+n-1); callers pick M ≥ n to amortize. A stage
computes only on its M busy ticks (the reference computes every tick and
discards the rest); a bubble tick forwards a zero-weighted copy of its
input, so every rank builds the same graph and the backward's transfers
pair up.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from gofr_tpu_torch.parallel.collectives import copy_to, ppermute, psum
from gofr_tpu_torch.parallel.mesh import Mesh, require_axis


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x_mb: torch.Tensor,  # [M, b, ...] microbatched activations, the same on every pp rank
    mesh: Mesh,
    *,
    axis: str = "pp",
) -> torch.Tensor:
    """Run ``stage_fn(stage_params, x) -> x`` through the pp ring.

    ``stage_params`` is this rank's stage (what ``shard_params`` keeps of
    leaves stacked [L, ...] under a ``P("pp", ...)`` spec: [L/n, ...]).
    Output has the shape of ``x_mb``, the same on every pp rank (the last
    stage's outputs, broadcast over pp)."""
    n = require_axis(mesh, axis)
    if n == 1:
        return torch.stack([stage_fn(stage_params, x) for x in x_mb])

    M = x_mb.shape[0]
    T = M + n - 1
    stage = mesh.index(axis)
    perm = [(i, (i + 1) % n) for i in range(n)]
    first = 1.0 if stage == 0 else 0.0
    # x_mb is replicated over pp and only stage 0 reads it: backward sums
    # the stages' cotangents (stage 0's, the others' zeros)
    x_mb = copy_to(x_mb, mesh, axis)
    recv = torch.zeros_like(x_mb[0])
    outs: list[torch.Tensor] = []
    for t in range(T):
        inp = x_mb[min(t, M - 1)] * first + recv * (1.0 - first)
        out = stage_fn(stage_params, inp) if 0 <= t - stage < M else inp * 0.0
        if t >= n - 1:
            outs.append(out)
        if t < T - 1:
            recv = ppermute(out, mesh, axis, perm)
    # only the last stage's outputs are real; broadcast them over pp
    last = 1.0 if stage == n - 1 else 0.0
    return psum(torch.stack(outs) * last, mesh, axis)


# ----------------------------------------------------------------- llama glue


def pp_forward(
    cfg: Any,
    params: dict,
    tokens: torch.Tensor,  # [B, S] the global batch, the same on every rank
    mesh: Mesh,
    *,
    microbatches: int | None = None,
    axis: str = "pp",
) -> torch.Tensor:
    """Llama forward with the layer stack pipelined over ``axis``:
    [B, S] -> logits [B, S, V] f32 on every rank. ``params`` is this
    rank's slice of the tree (``shard_params(params, mesh,
    llama_sharding_rules(pp=True))``). The global batch is cut into ``M``
    microbatches (``n`` by default) and the microbatches are split over
    the data axes (``dp``, then ``fsdp``): each data rank pipelines its
    M/n_data of them. Embedding and LM head run outside the pipeline,
    their vocabulary over ``tp`` as in ``llama.forward``."""
    from gofr_tpu_torch.models import llama

    if cfg.attn_impl == "cp":
        raise ValueError("attn_impl='cp' cannot nest inside pp_forward")
    n = require_axis(mesh, axis)
    if cfg.n_layers % n != 0:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={n}")
    M = microbatches or max(n, 1)
    B, S = tokens.shape
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    if params["layers"]["wq"].shape[0] != cfg.n_layers // n:
        raise ValueError(
            f"pp_forward takes this rank's stage ({cfg.n_layers // n} layers): shard the params "
            "with shard_params(params, mesh, llama_sharding_rules(pp=True))"
        )
    n_data = llama.data_ranks(mesh)
    if M % n_data != 0:
        raise ValueError(f"microbatches={M} do not split over the {n_data} data-parallel ranks")
    rows = llama.data_rows(tokens, mesh)
    x = llama._embed_sharded(cfg, params, rows, mesh)  # [B_loc, S, D]
    dev = tokens.device
    sin, cos = llama.rope_table(cfg.max_seq_len, cfg.head_dim, cfg.rope_theta, dev)
    m_loc = M // n_data
    positions = torch.arange(S, device=dev)[None, :].expand(rows.shape[0] // m_loc, S)

    def stage_fn(stage_layers: dict, h: torch.Tensor) -> torch.Tensor:
        for layer in range(stage_layers["wq"].shape[0]):
            lp = {name: w[layer] for name, w in stage_layers.items()}
            h = llama._layer_sharded(cfg, h, lp, sin, cos, positions, mesh, llama._causal)
        return h

    x_mb = x.reshape(m_loc, rows.shape[0] // m_loc, S, -1)
    out = pipeline_apply(stage_fn, params["layers"], x_mb, mesh, axis=axis)
    logits = llama._logits_sharded(cfg, params, out.reshape(rows.shape[0], S, -1), mesh)
    return llama.gather_rows(logits, mesh)
