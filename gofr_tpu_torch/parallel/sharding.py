"""Sharding rules: map parameter paths to mesh axes (port of
``gofr_tpu/parallel/sharding.py``).

Rules are (regex over a parameter's path) -> spec, first match wins,
default replicated. A spec is the reference's ``PartitionSpec`` as a
tuple: one entry a dimension, each an axis name, ``None`` (not split) or a
tuple of names (split over their product, the first outermost); dimensions
past the spec are not split. Megatron-style TP for transformer blocks:
column-parallel in-projections shard the output/head axis on ``tp``,
row-parallel out-projections the input axis, embeddings the vocabulary.

Where the reference places a global array on the mesh and lets the
compiler insert the collectives, the port keeps on each rank the slice of
each leaf that its mesh coordinates select (:func:`shard_params`,
:func:`local_index`), and the model code calls the collectives.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import numpy as np
import torch

from gofr_tpu_torch.parallel.mesh import KNOWN_AXES, Mesh


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: ``P("tp", None)`` is
    ``("tp", None)``; ``P()`` is replicated."""

    def __new__(cls, *axes: Any) -> "PartitionSpec":
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's ``jax.sharding.NamedSharding``."""

    mesh: Mesh
    spec: PartitionSpec

    def shards(self) -> bool:
        """Whether the spec splits any dimension on this mesh (an axis of
        size 1 splits nothing)."""
        return any(self.mesh.shape[a] > 1 for a in spec_axes(self.spec))


def named_sharding(mesh: Mesh, *axes: Any) -> NamedSharding:
    return NamedSharding(mesh, P(*axes))


def spec_axes(spec: tuple) -> list[str]:
    """The axis names a spec splits on, in order."""
    out = []
    for entry in spec:
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if axis is not None:
                out.append(axis)
    return out


def _validate_spec(pat: str, spec: tuple) -> None:
    """Every axis name in a rule's spec must be framework vocabulary,
    raising at table construction instead of mid-forward."""
    for entry in spec:
        axes = entry if isinstance(entry, tuple) else (entry,)
        for axis in axes:
            if axis is not None and axis not in KNOWN_AXES:
                raise ValueError(
                    f"sharding rule {pat!r} names unknown mesh axis "
                    f"{axis!r} (vocabulary: {', '.join(sorted(KNOWN_AXES))})"
                )


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict/list/tuple tree, keeping its
    nesting; a path is the keys joined by ``/`` (``layers/wq``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, list) or type(tree) is tuple:
        out = [map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn("/".join(path), tree)


#: a weight-only int8 weight's two leaves: ``<weight>/q`` and ``<weight>/s``
_INT8_LEAF = re.compile(r"^(?P<weight>.+)/(?P<part>[qs])$")


class ShardingRules:
    """Ordered (pattern -> spec) rules applied to a params tree by path;
    first match wins, default replicated. Axis names are validated
    against the mesh vocabulary up front."""

    def __init__(self, rules: list[tuple[str, tuple]]) -> None:
        for pat, spec in rules:
            _validate_spec(pat, spec)
        self.rules = [(re.compile(pat), P(*spec)) for pat, spec in rules]

    def spec_for(self, path: str) -> PartitionSpec:
        """The first matching rule's spec, else replicated. The two leaves
        of a weight-only int8 weight (``models.llama.quantize_weight``) go
        by their weight's rule, as the reference's
        ``quantize_params(shard_params(...))`` places them: ``path/q`` takes
        it whole, and the scale ``path/s``, which has no contraction
        (second to last) axis, takes it without that entry. A rule that
        places such a weight names each of its dimensions."""
        int8 = _INT8_LEAF.match(path)
        if int8 is not None:
            spec = self._match(int8["weight"])
            if spec is not None:
                return spec if int8["part"] == "q" else P(*spec[:-2], *spec[-1:])
        spec = self._match(path)
        return P() if spec is None else spec

    def _match(self, path: str) -> PartitionSpec | None:
        for pat, spec in self.rules:
            if pat.search(path):
                return spec
        return None

    def tree_specs(self, params: Any) -> Any:
        """Spec tree matching ``params`` by key path."""
        return map_with_path(lambda path, _leaf: self.spec_for(path), params)

    def tree_shardings(self, mesh: Mesh, params: Any) -> Any:
        return map_with_path(lambda path, _leaf: NamedSharding(mesh, self.spec_for(path)), params)


def llama_sharding_rules(pp: bool = False) -> ShardingRules:
    """TP/FSDP rules for the Llama-family params of ``models.llama``
    (stacked-layer tree). Axis conventions:

    - wq/wk/wv: [L, d_model, heads*dh] — column-parallel: shard heads on tp,
      d_model on fsdp
    - wo:       [L, heads*dh, d_model] — row-parallel: shard input on tp
      (an all-reduce over tp follows the matmul)
    - w_gate/w_up: [L, d_model, d_ff] — column-parallel
    - w_down:      [L, d_ff, d_model] — row-parallel
    - embedding [vocab, d_model] + lm_head [d_model, vocab]: shard vocab on
      tp (logits all-gather), d_model on fsdp
    - norms: replicated

    With ``pp=True`` the stacked layer axis [L, ...] is sharded on the
    ``pp`` mesh axis (stage s owns layers [s*L/n, (s+1)*L/n)), matching the
    pipeline stage split in parallel/pipeline.py.
    """
    lead = "pp" if pp else None
    rules = [
        (r"embedding", P("tp", "fsdp")),
        (r"lm_head", P("fsdp", "tp")),
        (r"w[qkv]$", P(lead, "fsdp", "tp")),
        (r"wo$", P(lead, "tp", "fsdp")),
        (r"w_gate|w_up", P(lead, "fsdp", "tp")),
        (r"w_down", P(lead, "tp", "fsdp")),
    ]
    if pp:
        rules.append((r"layers/.*(norm)", P("pp")))
    rules.append((r"norm|scale|bias", P()))
    return ShardingRules(rules)


def bert_sharding_rules() -> ShardingRules:
    return ShardingRules(
        [
            (r"embedding", P("tp", None)),
            (r"w[qkv]$|w_inter", P(None, "fsdp", "tp")),
            (r"wo$|w_out", P(None, "tp", "fsdp")),
            (r"norm|scale|bias|pooler", P()),
        ]
    )


def kv_head_slice(n_heads: int, n_kv_heads: int, mesh: Mesh) -> tuple[int, int]:
    """(first, count) of the global KV heads this rank's serving cache
    keeps. The serving KV storage (the dense cache [L, slots, S_max, Hkv,
    Dh], the paged pools [L, N+1, Hkv, page, Dh], int8 scales [..., 1]
    alike) splits on its KV-head axis over ``tp`` and is replicated on
    every other axis, as the reference's GSPMD leaves a tp-sharded
    engine's cache: a rank keeps its ``n_kv_heads / tp`` heads when ``tp``
    divides them; with fewer KV heads than ``tp`` ranks (``tp`` a multiple
    of them) the one KV head its local query heads read, as the
    tensor-parallel layer selects it (``models.llama._layer_sharded``).
    Any other layout raises."""
    return kv_head_slices(n_heads, n_kv_heads, mesh.shape["tp"])[mesh.index("tp")]


def kv_head_slices(n_heads: int, n_kv_heads: int, tp: int) -> list[tuple[int, int]]:
    """:func:`kv_head_slice` of each ``tp`` index in order: what a rank that
    moves a whole cache entry to or from the ranks sends each of them, or
    takes from each (each head once where several ranks keep a copy)."""
    if n_heads % tp:
        raise ValueError(f"{n_heads} query heads do not split over tp={tp}")
    if n_kv_heads % tp == 0:
        count = n_kv_heads // tp
        return [(i * count, count) for i in range(tp)]
    if tp % n_kv_heads == 0:
        group = n_heads // n_kv_heads
        return [(i * (n_heads // tp) // group, 1) for i in range(tp)]
    raise ValueError(
        f"{n_kv_heads} KV heads neither split over tp={tp} nor divide it: no rank-local KV cache "
        "placement"
    )


def activation_spec(kind: str = "tokens") -> PartitionSpec:
    """Standard activation constraint points: batch on dp(+fsdp), sequence
    on sp, features replicated (tp acts inside layers)."""
    if kind == "tokens":  # [batch, seq]
        return P(("dp", "fsdp"), "sp")
    if kind == "hidden":  # [batch, seq, d_model]
        return P(("dp", "fsdp"), "sp", None)
    if kind == "logits":  # [batch, seq, vocab]
        return P(("dp", "fsdp"), "sp", "tp")
    raise ValueError(f"unknown activation kind {kind}")


def with_constraint(x: Any, mesh: Mesh, kind_or_spec: Any) -> Any:
    """The identity. The reference asks its compiler to lay an activation
    out by the spec; here every activation is already this rank's local
    slice, placed by the code that made it. The spec is still validated."""
    spec = activation_spec(kind_or_spec) if isinstance(kind_or_spec, str) else kind_or_spec
    _validate_spec(str(kind_or_spec), spec)
    return x


def local_index(shape: tuple[int, ...], spec: tuple, mesh: Mesh) -> tuple[slice, ...]:
    """The slice of a global ``shape`` that ``spec`` gives this rank of
    ``mesh``. A split dimension must divide evenly."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the {len(shape)} dims of {shape}")
    index = []
    for dim, entry in enumerate(spec):
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,)) if a is not None]
        n = math.prod(mesh.shape[a] for a in axes)
        if n == 1:
            index.append(slice(None))
            continue
        if shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(shape)} ({shape[dim]}) does not split {n} ways over {axes}"
            )
        i = 0
        for a in axes:  # the first axis outermost
            i = i * mesh.shape[a] + mesh.coordinate[a]
        size = shape[dim] // n
        index.append(slice(i * size, (i + 1) * size))
    return tuple(index)


def shard_leaf(leaf: Any, sharding: NamedSharding) -> Any:
    """This rank's slice of one full leaf (a tensor or an array), as a
    fresh contiguous copy: the full leaf can be freed after."""
    idx = local_index(tuple(leaf.shape), sharding.spec, sharding.mesh)
    if isinstance(leaf, torch.Tensor):
        return leaf[idx].clone(memory_format=torch.contiguous_format)
    return np.array(leaf[idx], copy=True)


def placement_at(sharding: Any, path: str) -> NamedSharding:
    """The placement a ``sharding=`` argument gives the leaf at ``path``:
    one :class:`NamedSharding` for every leaf, or a tree of them matching
    the params (``rules.tree_shardings(mesh, params)``). Anything else
    raises."""
    if isinstance(sharding, NamedSharding):
        return sharding
    if not isinstance(sharding, dict):
        raise TypeError(
            f"sharding= takes a parallel.sharding.NamedSharding or a tree of them "
            f"(rules.tree_shardings(mesh, params)), not {type(sharding).__name__}"
        )
    node: Any = sharding
    for key in path.split("/"):
        if isinstance(node, dict) and key in node:
            node = node[key]
        elif isinstance(node, (list, tuple)) and key.isdigit() and int(key) < len(node):
            node = node[int(key)]
        else:
            raise ValueError(f"sharding= tree has no placement for {path!r}")
    if not isinstance(node, NamedSharding):
        raise TypeError(f"sharding= tree holds {type(node).__name__} at {path!r}, "
                        "not a NamedSharding")
    return node


def placements(sharding: Any, tree: Any) -> Any:
    """:func:`placement_at` for every leaf of ``tree``, as a tree."""
    return map_with_path(lambda path, _leaf: placement_at(sharding, path), tree)


def shards_any(sharding: Any) -> bool:
    """Whether a ``sharding=`` argument (one placement, or a tree of them)
    splits any leaf. Anything but placements raises."""
    if isinstance(sharding, NamedSharding):
        return sharding.shards()
    found: list[bool] = []

    def one(path: str, s: Any) -> None:
        found.append(placement_at(s, path).shards())

    if not isinstance(sharding, dict):
        placement_at(sharding, "")  # raises the TypeError
    map_with_path(one, sharding)
    return any(found)


def shard_params(params: Any, mesh: Mesh, rules: ShardingRules) -> Any:
    """This rank's slices of a full params tree (tensors or arrays) by the
    rules: the weight-loading path (each rank keeps its slice)."""
    return map_with_path(lambda path, leaf: shard_leaf(leaf, NamedSharding(mesh, rules.spec_for(path))),
                         params)
