"""The committed kernel contract table of the port — ONE source of truth
for every device function in ``serving/batch.py`` and
``serving/kv_cache.py`` and for the kernel wrappers in ``ops/``:
positional parameter order, the set updated in place, the static (Python
value) arguments, the packed-output column layout, and symbolic return
signatures.

The port's copy of ``gofr_tpu/analysis/kernel_contracts.py``. What the
reference states in JAX terms is restated for PyTorch:

- "donated" becomes ``updated``: the arguments a function writes in
  place (the caches, the pools, the decode carry) and returns again;
- "static" becomes the Python values a function takes — the config, the
  ints (``steps``, ``slot``, ``start``), floats and bools — which the
  kernel-contract coverage rule reads from the annotations;
- the packed layouts stay: ``decode_block*`` returns ONE packed
  ``int32 [B, steps+2]`` array (tokens | done | n_valid —
  :func:`batch._pack_block`), ``ragged_step*`` appends a ``first`` column
  (``[B, steps+3]`` — ``_pack_ragged``), and ``verify_and_sample*`` pack
  (out | n_accept) into ``[B, T+1]`` (``_pack_spec``). The host unpack
  sites (``engine._consume``, ``engine._spec_step``) slice these columns
  by offset — a kernel-side pack edit without a matching unpack edit
  silently mis-binds ``done``/``n_valid``/``first``.

Where the port's signatures differ from the reference's, the table gives
the port's and the reason: the ragged entries take ``chunk_rows``
indices and per-row ``seeds`` in place of the reference's
``chunk_active`` mask and ``rids`` with ``rng_root``, and return
``last_logits`` of the K chunk rows only; the spec entries take a
``generator`` that advances in place, so they return no key; the
attention wrappers take no ``interpret`` flag and no block sizes.

This module is PURE DATA (stdlib only, no torch import): the static
analyzer (:mod:`gofr_tpu_torch.analysis.kernelcheck`) loads it on the
lint path, and the runtime twin (:mod:`gofr_tpu_torch.analysis
.kerneltrace`) runs every entry on the CPU, or observes a live engine,
against it.

Symbolic shape grammar: a return shape is a comma-separated list of
integer expressions over dimension symbols (``"B,steps+2"``); symbols
bind from declared ``arg_shapes`` (single symbols or ``_`` per dim) and
from recorded static int arguments, and an unbound bare symbol binds
greedily to the observed dimension on first use (then must stay
consistent). ``Ret(like=<param>)`` declares a passthrough: the output's
full signature must equal that input's — which is what makes carry
drift observable at runtime.
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class Ret:
    """One positional output of a kernel entry.

    Exactly one of ``shape`` / ``like`` is set: ``shape`` is a symbolic
    dim list (optionally with ``dtype``) for a single tensor; ``like``
    names an input parameter whose full signature the output must
    reproduce (the in-place carry / cache passthrough contract)."""

    name: str
    shape: str | None = None
    dtype: str | None = None
    like: str | None = None


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Column layout of a packed host-sync array: one leading token span
    (symbolic width) then scalar tail columns, all ``dtype``."""

    name: str
    span: str  # symbol naming the token-span width ("steps", "T")
    span_col: str  # what the span columns hold
    scalars: tuple[str, ...]  # tail column names, at span+0, span+1, ...
    dtype: str = "int32"

    def column_at(self, delta: int) -> str | None:
        """Name of the scalar column at offset ``span + delta``."""
        if 0 <= delta < len(self.scalars):
            return self.scalars[delta]
        return None


PACK_LAYOUTS: dict[str, PackedLayout] = {
    l.name: l
    for l in (
        # decode_block*: _pack_block — [B, steps+2]
        PackedLayout("block", "steps", "tokens", ("done", "n_valid")),
        # ragged_step*: _pack_ragged — [B, steps+3]
        PackedLayout(
            "ragged", "steps", "tokens", ("done", "n_valid", "first")
        ),
        # verify_and_sample*: _pack_spec — [B, T+1]
        PackedLayout("spec", "T", "out", ("n_accept",)),
    )
}

# the helper that builds each layout (its torch.cat order IS the layout)
PACK_HELPERS: dict[str, str] = {
    "_pack_block": "block",
    "_pack_ragged": "ragged",
    "_pack_spec": "spec",
}

# Host binding-name vocabularies per scalar column: when an unpack site
# assigns `name = <cast>(packed[row, col])`, the target name must belong
# to the column the offset resolves to — `n_valid = packed[s, steps]`
# (the done column) is exactly the silent mis-bind this rule exists for.
COLUMN_BINDINGS: dict[str, tuple[str, ...]] = {
    "done": ("done", "device_done", "dev_done", "done_flag"),
    "n_valid": ("n_valid", "nvalid", "valid", "n_emitted"),
    "first": ("first", "first_id", "first_tok", "first_token"),
    "n_accept": ("n_accept", "na", "na_np", "accepted", "n_acc"),
}


@dataclasses.dataclass(frozen=True)
class UnpackSite:
    """A host function that slices a packed kernel output after the
    block sync. ``span_names`` are the attribute/variable names that
    denote the token-span width inside that function (``rec.steps``)."""

    file: str
    function: str
    layout: str
    span_names: tuple[str, ...] = ("steps",)


_ENGINE = "gofr_tpu_torch/serving/engine.py"

UNPACK_SITES: tuple[UnpackSite, ...] = (
    # _consume serves BOTH plain decode blocks and ragged dispatches (the
    # reference's _consume_block); it reads the ragged superset's `first`
    # column and the shared tokens|done|n_valid prefix.
    UnpackSite(_ENGINE, "_consume", "ragged"),
    UnpackSite(_ENGINE, "_spec_step", "spec"),
)


@dataclasses.dataclass(frozen=True)
class KernelContract:
    name: str
    file: str
    params: tuple[str, ...]
    updated: tuple[str, ...] = ()  # written in place (the reference donates)
    static: tuple[str, ...] = ()  # Python values: config, ints, floats, bools
    packed: str | None = None  # PACK_LAYOUTS key; packed is returns[0]
    pack_helper: str | None = None  # required packing callee in the body
    returns: tuple[Ret, ...] = ()
    # dim-symbol bindings: param -> comma list of symbols / "_" per dim
    arg_shapes: tuple[tuple[str, str], ...] = ()


_BATCH = "gofr_tpu_torch/serving/batch.py"
_KVC = "gofr_tpu_torch/serving/kv_cache.py"
_PAGED_ATTN = "gofr_tpu_torch/ops/paged_attention.py"
_FLASH = "gofr_tpu_torch/ops/flash_attention.py"

# The per-row tail shared by the ragged entries (the reference's
# finish ... rids, rng_root, decode_active, steps, adapters, lora: here
# chunk_rows rides before it and seeds replace rids with rng_root).
_RAGGED_TAIL = (
    "finish", "new_len", "budgets", "stops", "temps", "topks", "topps",
    "seeds", "decode_active", "steps", "adapters", "lora",
)

KERNELS: tuple[KernelContract, ...] = (
    KernelContract(
        "prefill_compute", _BATCH,
        params=("cfg", "params", "tokens", "seq_len"),
        static=("cfg",),
        returns=(
            Ret("last_logits", shape="1,V", dtype="float32"),
            Ret("k_slab", shape="L,S,Hkv,Dh"),
            Ret("v_slab", shape="L,S,Hkv,Dh"),
        ),
        arg_shapes=(("tokens", "_,S"),),
    ),
    KernelContract(
        "insert_slot", _BATCH,
        params=("k_cache", "v_cache", "k_slab", "v_slab", "slot"),
        updated=("k_cache", "v_cache"),
        static=("slot",),
        returns=(Ret("k_cache", like="k_cache"), Ret("v_cache", like="v_cache")),
    ),
    KernelContract(
        "insert_slot_quantized", _BATCH,
        params=("cache", "k_slab", "v_slab", "slot"),
        updated=("cache",),
        static=("slot",),
        returns=(Ret("cache", like="cache"),),
    ),
    KernelContract(
        "admit_decode_state", _BATCH,
        params=(
            "state", "slots", "tokens", "lens", "budgets", "stops",
            "temps", "topks", "topps", "adapters",
        ),
        updated=("state",),
        returns=(Ret("state", like="state"),),
    ),
    KernelContract(
        "decode_block", _BATCH,
        params=("cfg", "params", "cache", "state", "active", "steps", "lora"),
        updated=("cache", "state"),
        static=("cfg", "steps"),
        packed="block",
        pack_helper="_pack_block",
        returns=(
            Ret("packed", shape="B,steps+2", dtype="int32"),
            Ret("cache", like="cache"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("active", "B"),),
    ),
    KernelContract(
        "decode_block_paged", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "state", "block_tables",
            "active", "steps", "lora",
        ),
        updated=("k_pool", "v_pool", "state"),
        static=("cfg", "steps"),
        packed="block",
        pack_helper="_pack_block",
        returns=(
            Ret("packed", shape="B,steps+2", dtype="int32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("active", "B"),),
    ),
    KernelContract(
        "decode_block_paged_q", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "ks_pool", "vs_pool",
            "state", "block_tables", "active", "steps", "lora",
        ),
        updated=("k_pool", "v_pool", "ks_pool", "vs_pool", "state"),
        static=("cfg", "steps"),
        packed="block",
        pack_helper="_pack_block",
        returns=(
            Ret("packed", shape="B,steps+2", dtype="int32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("ks_pool", like="ks_pool"),
            Ret("vs_pool", like="vs_pool"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("active", "B"),),
    ),
    KernelContract(
        "ragged_step", _BATCH,
        params=(
            "cfg", "params", "cache", "state", "chunk", "chunk_start",
            "chunk_rows",
        ) + _RAGGED_TAIL,
        updated=("cache", "state"),
        static=("cfg", "steps"),
        packed="ragged",
        pack_helper="_pack_ragged",
        returns=(
            Ret("packed", shape="B,steps+3", dtype="int32"),
            Ret("last_logits", shape="K,V", dtype="float32"),
            Ret("cache", like="cache"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("chunk", "B,C"), ("chunk_rows", "K")),
    ),
    KernelContract(
        "ragged_step_paged", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "state", "block_tables",
            "chunk", "chunk_start", "chunk_rows", "kv_capacity",
        ) + _RAGGED_TAIL,
        updated=("k_pool", "v_pool", "state"),
        static=("cfg", "steps"),
        packed="ragged",
        pack_helper="_pack_ragged",
        returns=(
            Ret("packed", shape="B,steps+3", dtype="int32"),
            Ret("last_logits", shape="K,V", dtype="float32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("chunk", "B,C"), ("chunk_rows", "K")),
    ),
    KernelContract(
        "ragged_step_paged_q", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "ks_pool", "vs_pool",
            "state", "block_tables", "chunk", "chunk_start", "chunk_rows",
            "kv_capacity",
        ) + _RAGGED_TAIL,
        updated=("k_pool", "v_pool", "ks_pool", "vs_pool", "state"),
        static=("cfg", "steps"),
        packed="ragged",
        pack_helper="_pack_ragged",
        returns=(
            Ret("packed", shape="B,steps+3", dtype="int32"),
            Ret("last_logits", shape="K,V", dtype="float32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("ks_pool", like="ks_pool"),
            Ret("vs_pool", like="vs_pool"),
            Ret("state", like="state"),
        ),
        arg_shapes=(("chunk", "B,C"), ("chunk_rows", "K")),
    ),
    KernelContract(
        "insert_chunk", _BATCH,
        params=("k_cache", "v_cache", "k_slab", "v_slab", "slot", "start"),
        updated=("k_cache", "v_cache"),
        static=("slot", "start"),
        returns=(Ret("k_cache", like="k_cache"), Ret("v_cache", like="v_cache")),
    ),
    KernelContract(
        "verify_and_sample", _BATCH,
        params=(
            "cfg", "params", "cache", "chunk", "start_len", "temperature",
            "top_k", "top_p", "generator",
        ),
        updated=("cache", "generator"),
        static=("cfg",),
        packed="spec",
        pack_helper="_pack_spec",
        returns=(
            Ret("packed", shape="B,T+1", dtype="int32"),
            Ret("cache", like="cache"),
        ),
        arg_shapes=(("chunk", "B,T"),),
    ),
    KernelContract(
        "verify_and_sample_paged", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "block_tables", "chunk",
            "start_len", "active", "kv_capacity", "temperature", "top_k",
            "top_p", "generator",
        ),
        updated=("k_pool", "v_pool", "generator"),
        static=("cfg",),
        packed="spec",
        pack_helper="_pack_spec",
        returns=(
            Ret("packed", shape="B,T+1", dtype="int32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
        ),
        arg_shapes=(("chunk", "B,T"),),
    ),
    KernelContract(
        "verify_and_sample_paged_q", _BATCH,
        params=(
            "cfg", "params", "k_pool", "v_pool", "ks_pool", "vs_pool",
            "block_tables", "chunk", "start_len", "active", "kv_capacity",
            "temperature", "top_k", "top_p", "generator",
        ),
        updated=("k_pool", "v_pool", "ks_pool", "vs_pool", "generator"),
        static=("cfg",),
        packed="spec",
        pack_helper="_pack_spec",
        returns=(
            Ret("packed", shape="B,T+1", dtype="int32"),
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("ks_pool", like="ks_pool"),
            Ret("vs_pool", like="vs_pool"),
        ),
        arg_shapes=(("chunk", "B,T"),),
    ),
    KernelContract(
        "lora_adjust_logits", _BATCH,
        params=("embedding", "a_row", "b_row", "token", "logits"),
        returns=(Ret("logits", like="logits"),),
    ),
    KernelContract(
        "_write_pages", _KVC,
        params=("k_pool", "v_pool", "k_slab", "v_slab", "page_ids"),
        updated=("k_pool", "v_pool"),
        returns=(Ret("k_pool", like="k_pool"), Ret("v_pool", like="v_pool")),
    ),
    KernelContract(
        "_write_pages_q", _KVC,
        params=(
            "k_pool", "v_pool", "ks_pool", "vs_pool", "k_slab", "v_slab",
            "page_ids",
        ),
        updated=("k_pool", "v_pool", "ks_pool", "vs_pool"),
        returns=(
            Ret("k_pool", like="k_pool"),
            Ret("v_pool", like="v_pool"),
            Ret("ks_pool", like="ks_pool"),
            Ret("vs_pool", like="vs_pool"),
        ),
    ),
    KernelContract(
        "paged_decode_attention", _PAGED_ATTN,
        params=("q", "k_pool", "v_pool", "block_tables", "seq_lens", "scale"),
        static=("scale",),
        returns=(Ret("out", like="q"),),
    ),
    KernelContract(
        "paged_decode_attention_q", _PAGED_ATTN,
        params=("q", "k_pool", "v_pool", "k_scale", "v_scale",
                "block_tables", "seq_lens", "scale"),
        static=("scale",),
        returns=(Ret("out", like="q"),),
    ),
    KernelContract(
        "flash_attention", _FLASH,
        params=("q", "k", "v", "kv_len", "causal", "scale"),
        static=("causal", "scale"),
        returns=(Ret("out", like="q"),),
    ),
)

CONTRACTS: dict[str, KernelContract] = {k.name: k for k in KERNELS}

# Files whose public module-level functions MUST each carry a contract
# above or stand in HOST_HELPERS (the coverage audit: a new device entry
# without a declared contract fails the lint).
KERNEL_FILES: tuple[str, ...] = (_BATCH, _KVC, _PAGED_ATTN, _FLASH)

# Public module-level functions of the kernel files that are not device
# entries, each with the reason it carries no contract.
HOST_HELPERS: dict[str, tuple[str, str]] = {
    "make_decode_state": (
        _BATCH, "the carry's cold-path constructor: carry-field-drift "
        "holds its field set and dtypes to DECODE_STATE_FIELDS"),
    "pad_bucket": (_BATCH, "host integer arithmetic (prompt bucket)"),
    "split_layout": (_PAGED_ATTN, "host launch-geometry arithmetic"),
    "scratch_numel": (_PAGED_ATTN, "host launch-geometry arithmetic"),
    "paged_decode_attention_ref": (
        _PAGED_ATTN, "the plain version the wrappers take on CPU tensors "
        "and the kernels are held against"),
    "flash_attention_ref": (
        _FLASH, "the plain version the wrapper takes on CPU tensors and "
        "the kernel is held against"),
}


def contracts_for_file(rel_path: str) -> dict[str, KernelContract]:
    return {k.name: k for k in KERNELS if k.file == rel_path}


# ---------------------------------------------------------------- carry
# The DecodeState carry (serving/batch.py): field set, ORDER, and dtypes.
# Every construction site (the dataclass itself, make_decode_state,
# admit_decode_state, the in-block constructor and the fold) must agree.
# Against the reference's table (int32 token fields, a key array, an
# int32 adapter column that is always present):
# - last_token, stop_tok and top_k are int64: torch's gathers, samplers
#   and comparisons take int64 indices and tokens (ROADMAP Queue C 3);
# - rng is a torch.Generator, advanced in place, not a key array;
# - adapter may be None on a state built by hand (make_decode_state
#   fills zeros when the caller gives none).
CARRY_CLASS = "DecodeState"
CARRY_FILE = _BATCH
DECODE_STATE_FIELDS: tuple[tuple[str, str], ...] = (
    ("last_token", "int64"),
    ("seq_len", "int32"),
    ("done", "bool"),
    ("budget", "int32"),
    ("stop_tok", "int64"),
    ("temperature", "float32"),
    ("top_k", "int64"),
    ("top_p", "float32"),
    ("rng", "generator"),
    ("adapter", "int32"),
)

# engine._pending_admit host-side tuple (built at engine._prefill_into's
# commit): (first_token, resident_len, budget, stop_id, adapter_slot) —
# arity must match everywhere it is built, annotated, and unpacked into
# admit_decode_state.
ADMIT_TUPLE_FIELDS: tuple[str, ...] = (
    "first_token", "resident_len", "budget", "stop_id", "adapter_slot",
)
ADMIT_TUPLE_ATTR = "_pending_admit"
ADMIT_TUPLE_FILE = _ENGINE


# ------------------------------------------------------------------ export
def render_table_json() -> str:
    """The static contract table as JSON (``--kernel-table``)."""
    return json.dumps(
        {
            "kernels": [dataclasses.asdict(k) for k in KERNELS],
            "layouts": {
                n: dataclasses.asdict(l) for n, l in PACK_LAYOUTS.items()
            },
            "pack_helpers": dict(PACK_HELPERS),
            "carry": {
                "class": CARRY_CLASS,
                "file": CARRY_FILE,
                "fields": [list(f) for f in DECODE_STATE_FIELDS],
            },
            "admit_tuple": {
                "attr": ADMIT_TUPLE_ATTR,
                "file": ADMIT_TUPLE_FILE,
                "fields": list(ADMIT_TUPLE_FIELDS),
            },
            "unpack_sites": [dataclasses.asdict(u) for u in UNPACK_SITES],
            "kernel_files": list(KERNEL_FILES),
            "host_helpers": {
                n: {"file": f, "reason": r}
                for n, (f, r) in sorted(HOST_HELPERS.items())
            },
        },
        indent=2,
        sort_keys=True,
    )
