"""kerneltrace — the runtime twin of the port's kernel contract table.

The port's copy of ``gofr_tpu/analysis/kerneltrace.py``. Two producers,
one consumer:

- :func:`run_matrix` runs EVERY contract-table entry on the CPU at the
  ``tiny`` config across the reference's matrix (dense / paged /
  int8-quantized caches x base / LoRA x plain / ragged / speculative x
  B,N variants) and exports the observed (tree, shape, dtype)
  signatures. The reference abstract-evaluates with ``jax.eval_shape``;
  PyTorch has no abstract evaluation of these Python functions, so the
  entries run for real on small CPU tensors, where every kernel wrapper
  takes its plain version and no kernel launches (the wrappers'
  ``launches`` counters stay where they were).
- :class:`KernelObserver` wraps the dispatch entries of a LIVE engine —
  ``serving.batch`` and ``serving.kv_cache`` at module level, where the
  engine and the cache look them up, and the three attention wrappers at
  ``models.llama``, where the model looks them up — and records the same
  signatures per unique call shape. It reads tensor metadata only
  (shape, dtype, device): no host sync, and :meth:`uninstall` restores
  exactly the functions it replaced.

Both exports feed ``python -m gofr_tpu_torch.analysis
--check-kernel-table`` / :func:`gofr_tpu_torch.analysis.kernelcheck
.check_kernel_table`, which replays them against the static table:
packed widths, symbolic return shapes, dtypes, and the ``like=``
passthroughs (carry drift).

A signature is ``{"tree": ..., "leaves": [[shape, dtype], ...]}``: a
tensor is one leaf with its dtype's torch name (``int32``,
``bfloat16``); a dataclass (``DecodeState``, ``KVCache``) a tree of its
fields in order; a ``torch.Generator`` a leaf recording only its device
(``generator:cpu``); a Python scalar a leaf of its type name; None no
leaf.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Any

from gofr_tpu_torch.analysis import kernel_contracts as kc


def _flatten(x: Any, leaves: list) -> str:
    """Tree description of ``x``; its leaves appended in order."""
    import torch

    if x is None:
        return "None"
    if isinstance(x, torch.Tensor):
        leaves.append([[int(d) for d in x.shape], str(x.dtype).removeprefix("torch.")])
        return "*"
    if isinstance(x, torch.Generator):
        leaves.append([[], f"generator:{x.device.type}"])
        return "*"
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        parts = [
            f"{f.name}={_flatten(getattr(x, f.name), leaves)}"
            for f in dataclasses.fields(x)
        ]
        return f"{type(x).__name__}({', '.join(parts)})"
    if isinstance(x, (tuple, list)):
        inner = ", ".join(_flatten(v, leaves) for v in x)
        return f"{type(x).__name__}({inner})"
    if isinstance(x, dict):
        inner = ", ".join(f"{k}={_flatten(x[k], leaves)}" for k in sorted(x))
        return f"dict({inner})"
    leaves.append([[], type(x).__name__])
    return "*"


def signature(x: Any) -> dict:
    """Portable (tree, shape, dtype) signature of a value: metadata
    only, never a read of a device value."""
    leaves: list = []
    tree = _flatten(x, leaves)
    return {"tree": tree, "leaves": leaves}


def _referenced(c: kc.KernelContract) -> set[str]:
    return {r.like for r in c.returns if r.like} | {
        p for p, _ in c.arg_shapes
    }


def _case(c: kc.KernelContract, variant: str, bound: dict,
          outs: Any) -> dict:
    if outs is None:  # observer records inputs first, outputs post-call
        out_list: list[Any] = []
    else:
        out_list = [outs] if len(c.returns) == 1 else list(outs)
    return {
        "kernel": c.name,
        "variant": variant,
        "inputs": {
            p: signature(bound[p]) for p in _referenced(c) if p in bound
        },
        "statics": {
            p: bound[p]
            for p in c.static
            if isinstance(bound.get(p), int)
            and not isinstance(bound.get(p), bool)
        },
        "outputs": [signature(o) for o in out_list],
    }


# ------------------------------------------------------------ CPU matrix


def _run_case(fn, c: kc.KernelContract, variant: str, bound: dict) -> dict:
    """Run one kernel entry on CPU tensors. ``bound`` maps every contract
    param to its value; the input signatures are taken BEFORE the call
    (the entries update caches and carries in place)."""
    case = _case(c, variant, bound, None)
    outs = fn(**{p: bound[p] for p in c.params if p in bound})
    out_list = [outs] if len(c.returns) == 1 else list(outs)
    case["outputs"] = [signature(o) for o in out_list]
    return case


def run_matrix() -> dict:
    """The full CPU matrix at the ``tiny`` config, at the reference
    matrix's sizes (S_max 32, bucket 8, page 4, 6 pages, 4 table columns,
    LoRA rank 4 over 2 adapter slots). Imports the serving layer lazily:
    this module stays importable from the lint path."""
    import torch

    from gofr_tpu_torch.models import llama
    from gofr_tpu_torch.ops import flash_attention as flash_mod
    from gofr_tpu_torch.ops import paged_attention as pa_mod
    from gofr_tpu_torch.serving import batch
    from gofr_tpu_torch.serving import kv_cache as kvc_mod

    dev = torch.device("cpu")
    cfg = llama.LlamaConfig.tiny()
    L, Hkv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    V, D = cfg.vocab_size, cfg.d_model
    S_MAX, S_BUCKET, PAGE, N_PAGES, M = 32, 8, 4, 6, 4
    RANK, ADAPTERS = 4, 2
    g = torch.Generator(device=dev).manual_seed(0)
    params = llama.init_params(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    lora_tabs = (
        torch.zeros(ADAPTERS, D, RANK, dtype=torch.float32),
        torch.zeros(ADAPTERS, RANK, V, dtype=torch.float32),
    )

    def i32(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int32)

    def i64(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.int64)

    def f32(*shape, fill=0.0):
        return torch.full(shape, fill, dtype=torch.float32)

    def flags(*shape, fill=True):
        return torch.full(shape, fill, dtype=torch.bool)

    def tokens(*shape):
        return torch.randint(3, V, shape, generator=g, dtype=torch.int64)

    def slab(S, dtype=None):
        return torch.randn(L, S, Hkv, Dh, generator=g).to(dtype or cfg.dtype)

    def dense_cache(B, quant=False):
        return llama.KVCache.create(
            cfg, B, max_len=S_MAX, kv_dtype="int8" if quant else None, device=dev
        )

    def pools(quant=False):
        shape = (L, N_PAGES + 1, Hkv, PAGE, Dh)
        if not quant:
            return torch.zeros(shape, dtype=cfg.dtype), torch.zeros(shape, dtype=cfg.dtype), \
                None, None
        sshape = shape[:-1] + (1,)
        return (torch.zeros(shape, dtype=torch.int8), torch.zeros(shape, dtype=torch.int8),
                torch.ones(sshape, dtype=torch.float32), torch.ones(sshape, dtype=torch.float32))

    def tables(B):
        # each row owns distinct pages 0..N_PAGES-1 (page N_PAGES is the trash)
        t = torch.zeros(B, M, dtype=torch.int32)
        for b in range(B):
            for m in range(M):
                t[b, m] = (b * 2 + m) % N_PAGES
        return t

    def state(B, seq_len=4):
        return batch.make_decode_state(
            [5] * B, [seq_len] * B, [False] * B, [8] * B, [-1] * B, [0.0] * B,
            [0] * B, [1.0] * B, torch.Generator(device=dev).manual_seed(1),
            [0] * B, device=dev,
        )

    def ragged_tail(B, steps, lora):
        return {
            "finish": flags(B), "new_len": i32(B, fill=6), "budgets": i32(B, fill=4),
            "stops": i64(B, fill=-1), "temps": f32(B), "topks": i64(B),
            "topps": f32(B, fill=1.0), "seeds": list(range(B)),
            "decode_active": flags(B), "steps": steps,
            "adapters": i32(B) if lora is not None else None, "lora": lora,
        }

    def spec_tail(B):
        return {
            "temperature": f32(B), "top_k": i64(B), "top_p": f32(B, fill=1.0),
            "generator": torch.Generator(device=dev).manual_seed(2),
        }

    C = kc.CONTRACTS
    cases: list[dict] = []

    def add(name, variant, **bound):
        mod = batch if C[name].file == kc.CARRY_FILE else kvc_mod
        cases.append(_run_case(getattr(mod, name), C[name], variant, bound))

    add("prefill_compute", "dense", cfg=cfg, params=params,
        tokens=tokens(1, S_BUCKET), seq_len=i32(1, fill=5))
    cache = dense_cache(1)
    add("insert_slot", "dense", k_cache=cache.k, v_cache=cache.v,
        k_slab=slab(S_BUCKET), v_slab=slab(S_BUCKET), slot=0)
    add("insert_slot_quantized", "quantized", cache=dense_cache(1, quant=True),
        k_slab=slab(S_BUCKET), v_slab=slab(S_BUCKET), slot=0)
    add("insert_chunk", "dense", k_cache=cache.k, v_cache=cache.v,
        k_slab=slab(4), v_slab=slab(4), slot=0, start=4)
    add("admit_decode_state", "dense", state=state(3),
        slots=torch.tensor([0, 2], dtype=torch.int64), tokens=i64(2, fill=7),
        lens=i32(2, fill=5), budgets=i32(2, fill=4), stops=i64(2, fill=-1),
        temps=f32(2), topks=i64(2), topps=f32(2, fill=1.0), adapters=i32(2))

    for variant, B, steps, quant, lora in (
        ("dense.b3n4", 3, 4, False, None),
        ("dense.b2n2", 2, 2, False, None),
        ("dense.lora", 3, 4, False, lora_tabs),
        ("dense.q", 3, 4, True, None),
    ):
        add("decode_block", variant, cfg=cfg, params=params,
            cache=dense_cache(B, quant), state=state(B), active=flags(B),
            steps=steps, lora=lora)
    for variant, lora in (("paged", None), ("paged.lora", lora_tabs)):
        kp, vp, _, _ = pools()
        add("decode_block_paged", variant, cfg=cfg, params=params, k_pool=kp,
            v_pool=vp, state=state(3), block_tables=tables(3), active=flags(3),
            steps=4, lora=lora)
    kp, vp, ksp, vsp = pools(quant=True)
    add("decode_block_paged_q", "paged.q", cfg=cfg, params=params, k_pool=kp,
        v_pool=vp, ks_pool=ksp, vs_pool=vsp, state=state(3),
        block_tables=tables(3), active=flags(3), steps=4, lora=None)

    # every row chunks (K = B), so last_logits [K, V] has the reference's
    # [B, V] shape
    for variant, B, chunk_c, steps, lora in (
        ("dense.b3n4", 3, 4, 4, None),
        ("dense.b2n2", 2, 2, 2, None),
        ("dense.lora", 3, 4, 4, lora_tabs),
    ):
        add("ragged_step", variant, cfg=cfg, params=params, cache=dense_cache(B),
            state=state(B), chunk=tokens(B, chunk_c), chunk_start=i32(B, fill=2),
            chunk_rows=torch.arange(B, dtype=torch.int64),
            **ragged_tail(B, steps, lora))
    kp, vp, _, _ = pools()
    add("ragged_step_paged", "paged", cfg=cfg, params=params, k_pool=kp, v_pool=vp,
        state=state(3), block_tables=tables(3), chunk=tokens(3, 4),
        chunk_start=i32(3, fill=2), chunk_rows=torch.arange(3, dtype=torch.int64),
        kv_capacity=i32(3, fill=M * PAGE), **ragged_tail(3, 4, None))
    kp, vp, ksp, vsp = pools(quant=True)
    add("ragged_step_paged_q", "paged.q", cfg=cfg, params=params, k_pool=kp,
        v_pool=vp, ks_pool=ksp, vs_pool=vsp, state=state(3), block_tables=tables(3),
        chunk=tokens(3, 4), chunk_start=i32(3, fill=2),
        chunk_rows=torch.arange(3, dtype=torch.int64),
        kv_capacity=i32(3, fill=M * PAGE), **ragged_tail(3, 4, None))

    add("verify_and_sample", "spec.dense", cfg=cfg, params=params,
        cache=dense_cache(3), chunk=tokens(3, 3), start_len=i32(3, fill=4),
        **spec_tail(3))
    kp, vp, _, _ = pools()
    add("verify_and_sample_paged", "spec.paged", cfg=cfg, params=params, k_pool=kp,
        v_pool=vp, block_tables=tables(3), chunk=tokens(3, 3),
        start_len=i32(3, fill=4), active=flags(3), kv_capacity=i32(3, fill=M * PAGE),
        **spec_tail(3))
    kp, vp, ksp, vsp = pools(quant=True)
    add("verify_and_sample_paged_q", "spec.paged.q", cfg=cfg, params=params,
        k_pool=kp, v_pool=vp, ks_pool=ksp, vs_pool=vsp, block_tables=tables(3),
        chunk=tokens(3, 3), start_len=i32(3, fill=4), active=flags(3),
        kv_capacity=i32(3, fill=M * PAGE), **spec_tail(3))

    add("lora_adjust_logits", "lora", embedding=params["embedding"],
        a_row=f32(D, RANK), b_row=f32(RANK, V), token=i32(fill=5),
        logits=f32(1, V))

    kp, vp, _, _ = pools()
    add("_write_pages", "paged", k_pool=kp, v_pool=vp, k_slab=slab(2 * PAGE),
        v_slab=slab(2 * PAGE), page_ids=torch.tensor([1, 3], dtype=torch.int64))
    kp, vp, ksp, vsp = pools(quant=True)
    add("_write_pages_q", "paged.q", k_pool=kp, v_pool=vp, ks_pool=ksp, vs_pool=vsp,
        k_slab=slab(2 * PAGE), v_slab=slab(2 * PAGE),
        page_ids=torch.tensor([1, 3], dtype=torch.int64))

    # ops-level attention sees ONE layer's pool: [N+1, Hkv, page, Dh]
    lp = torch.randn(N_PAGES + 1, Hkv, PAGE, Dh, generator=g).to(cfg.dtype)
    lp8 = torch.randint(-127, 128, (N_PAGES + 1, Hkv, PAGE, Dh), generator=g,
                        dtype=torch.int8)
    lps = torch.full((N_PAGES + 1, Hkv, PAGE, 1), 0.01, dtype=torch.float32)
    q = torch.randn(3, cfg.n_heads, Dh, generator=g).to(cfg.dtype)
    cases.append(_run_case(pa_mod.paged_decode_attention,
                           C["paged_decode_attention"], "paged", {
                               "q": q, "k_pool": lp, "v_pool": lp,
                               "block_tables": tables(3), "seq_lens": i32(3, fill=9),
                               "scale": None}))
    cases.append(_run_case(pa_mod.paged_decode_attention_q,
                           C["paged_decode_attention_q"], "paged.q", {
                               "q": q, "k_pool": lp8, "v_pool": lp8,
                               "k_scale": lps, "v_scale": lps,
                               "block_tables": tables(3), "seq_lens": i32(3, fill=9),
                               "scale": None}))
    qkv = torch.randn(2, 8, cfg.n_heads, Dh, generator=g).to(cfg.dtype)
    cases.append(_run_case(flash_mod.flash_attention, C["flash_attention"], "flash", {
        "q": qkv, "k": qkv, "v": qkv, "kv_len": None, "causal": True, "scale": None,
    }))

    return {"mode": "matrix", "cases": cases, "violations": []}


def export_matrix(path: str) -> dict:
    payload = run_matrix()
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
    return payload


# --------------------------------------------------------- live observer


class KernelObserver:
    """Record device-contract signatures from a LIVE engine: wraps the
    dispatch entries (``serving.batch``, ``serving.kv_cache``) and the
    attention wrappers where ``models.llama`` looks them up, so every
    unique call shape becomes an ``observed``-mode case for
    ``--check-kernel-table``. Input signatures are captured before the
    call (metadata only); results pass through untouched, so an installed
    observer changes nothing about the run. ``counts`` holds the calls
    per entry."""

    def __init__(self) -> None:
        self.cases: list[dict] = []
        self.violations: list[str] = []
        self.counts: dict[str, int] = {}
        self._seen: set[str] = set()
        self._orig: list[tuple[Any, str, Any]] = []

    def _recorder(self, c: kc.KernelContract, fn):
        # updated=(): the wrapper must not copy the kernel wrappers'
        # `launches` counters, which stay on the original functions
        @functools.wraps(fn, updated=())
        def recorded(*args, **kwargs):
            self.counts[c.name] = self.counts.get(c.name, 0) + 1
            bound = dict(zip(c.params, args))
            for k, v in kwargs.items():
                if k not in c.params:
                    self.violations.append(
                        f"{c.name}: dispatched with undeclared keyword '{k}'"
                    )
                bound[k] = v
            if len(args) > len(c.params):
                self.violations.append(
                    f"{c.name}: dispatched with {len(args)} positional "
                    f"args; the contract declares {len(c.params)}"
                )
            case = None
            try:
                case = _case(c, "", bound, None)
            except Exception as exc:  # never perturb the engine
                self.violations.append(f"{c.name}: could not record inputs ({exc})")
            out = fn(*args, **kwargs)
            if case is not None:
                try:
                    out_list = [out] if len(c.returns) == 1 else list(out)
                    case["outputs"] = [signature(o) for o in out_list]
                except Exception as exc:
                    self.violations.append(f"{c.name}: could not record outputs ({exc})")
                    return out
                dedup = json.dumps(
                    {k: v for k, v in case.items() if k != "variant"},
                    sort_keys=True,
                )
                if dedup not in self._seen:
                    self._seen.add(dedup)
                    case["variant"] = f"obs{len(self.cases)}"
                    self.cases.append(case)
            return out

        recorded.__kerneltrace_wrapped__ = fn
        return recorded

    def install(self) -> "KernelObserver":
        from gofr_tpu_torch.models import llama
        from gofr_tpu_torch.serving import batch
        from gofr_tpu_torch.serving import kv_cache as kvc_mod

        # where each entry is looked up at call time: the engine calls
        # batch.<entry>, the cache calls its module's _write_pages*, and
        # the model calls the attention wrappers it imported by name
        homes = {
            kc.CARRY_FILE: batch,
            "gofr_tpu_torch/serving/kv_cache.py": kvc_mod,
            "gofr_tpu_torch/ops/paged_attention.py": llama,
            "gofr_tpu_torch/ops/flash_attention.py": llama,
        }
        for c in kc.KERNELS:
            mod = homes[c.file]
            fn = getattr(mod, c.name)
            self._orig.append((mod, c.name, fn))
            setattr(mod, c.name, self._recorder(c, fn))
        return self

    def uninstall(self) -> None:
        for mod, name, fn in reversed(self._orig):
            setattr(mod, name, fn)
        self._orig.clear()

    def export(self, path: str | None = None) -> dict:
        payload = {
            "mode": "observed",
            "cases": self.cases,
            "violations": self.violations,
        }
        if path is not None:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(payload, fh, indent=2, sort_keys=True)
        return payload


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="export the CPU kernel-contract matrix")
    ap.add_argument("--out", required=True)
    ns = ap.parse_args(argv)
    payload = export_matrix(ns.out)
    print(f"kerneltrace: {len(payload['cases'])} matrix case(s) -> {ns.out}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
