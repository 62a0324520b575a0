"""The port's kernel contract table and kernelcheck
(gofr_tpu_torch/analysis/kernel_contracts.py, kernelcheck.py) against the
JAX package's.

- Each fixture case of ``tests/test_kernelcheck.py`` runs as the
  reference's own test (its assertions included); its torch translation
  here runs through the port's rule and gives the same rule ids. The
  translation writes JAX's idiom in torch's: ``torch.cat`` for
  ``jnp.concatenate``, the ``_pack_spec`` helper where the reference packs
  the spec layout inline, an upload ``up(x, np.<dtype>)`` for
  ``jnp.asarray(x, jnp.<dtype>)``, annotations for ``static_argnums``.
  The dtype family is restated for torch (float64, dtype-less literal
  tensors, int64 in an int32 pack), so its cases pair by shape: a hot-zone
  finding, a cold function, a clean zone.
- The contract table differs from the reference's only where the list
  below says, each with its ROADMAP Queue C item.
- ``check_kernel_table`` replays exports against the port's table.
- ``spec-rank-mismatch``'s reference fixtures are written over the mesh
  client's ``compile(name, fn, *examples, in_shardings=, out_shardings=)``
  (the port's ``shard_map(fn, in_specs=, out_specs=)(*args)``), with
  ``NamedSharding(mesh, P(...))`` placements; the port's own checks (a
  global-view wrapper against its bodies, the placement calls, the
  sharding-rule tables against ``init_params``) are held below.
"""

from __future__ import annotations

import dataclasses
import json
import os

import pytest
from torch_reference_fixtures import (
    materialize,
    record_fixtures,
    reference_module,
    run_reference_test,
)

pytest.importorskip("jax")

from gofr_tpu.analysis import kernel_contracts as jkc  # noqa: E402
from gofr_tpu_torch.analysis import baseline_io  # noqa: E402
from gofr_tpu_torch.analysis import kernel_contracts as kc  # noqa: E402
from gofr_tpu_torch.analysis.core import run_rules, run_unified  # noqa: E402
from gofr_tpu_torch.analysis.kernelcheck import (  # noqa: E402
    CarryFieldDriftRule,
    DtypeDisciplineRule,
    KernelContractCoverageRule,
    PackLayoutRule,
    SpecRankRule,
    check_kernel_table,
    kernelcheck_rules,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = [os.path.join(REPO_ROOT, p) for p in
             ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")]
ENGINE = "gofr_tpu_torch/serving/engine.py"
BATCH = "gofr_tpu_torch/serving/batch.py"
KVC = "gofr_tpu_torch/serving/kv_cache.py"
FLASH = "gofr_tpu_torch/ops/flash_attention.py"
PX = "gofr_tpu_torch/parallel/x.py"
_SHARDING_IMPORT = "from gofr_tpu_torch.parallel.sharding import NamedSharding, P\n"

_GOOD_CONSUME = (
    "def _block_sync(x):\n"
    "    return x\n"
    "\n"
    "def _consume(self, rec, slot):\n"
    "    packed = _block_sync(rec.packed)\n"
    "    device_done = bool(packed[slot, rec.steps])\n"
    "    n_valid = int(packed[slot, rec.steps + 1])\n"
    "    first_id = int(packed[slot, rec.steps + 2])\n"
    "    toks = [int(packed[slot, i]) for i in range(n_valid)]\n"
    "    return toks, device_done, first_id\n"
)
_FIELD_LINES = "".join(f"    {n}: int\n" for n, _ in kc.DECODE_STATE_FIELDS)
_FLASH_OK = (
    "import torch\n"
    "def flash_attention_ref(q, k, v, kv_len=None, causal: bool = True,\n"
    "                        scale: float | None = None):\n"
    "    return q\n"
    "def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,\n"
    "                    kv_len: torch.Tensor | None = None, causal: bool = True,\n"
    "                    scale: float | None = None) -> torch.Tensor:\n"
    "    return q\n"
)
_WRITE_PAGES_Q = (
    "def _write_pages_q(k_pool, v_pool, ks_pool, vs_pool, k_slab, v_slab,\n"
    "                   page_ids):\n"
    "    return k_pool, v_pool, ks_pool, vs_pool\n"
)


def _coverage():
    return KernelContractCoverageRule(anchor=None)


# reference test name -> (the torch translation's files, its rule)
CASES = {
    "test_unpack_offset_past_layout_flagged": (
        {ENGINE: _GOOD_CONSUME.replace("rec.steps + 2", "rec.steps + 7")}, PackLayoutRule),
    "test_unpack_binding_misbind_flagged": (
        {ENGINE: _GOOD_CONSUME.replace(
            "    device_done = bool(packed[slot, rec.steps])\n"
            "    n_valid = int(packed[slot, rec.steps + 1])\n",
            "    device_done = bool(packed[slot, rec.steps + 1])\n"
            "    n_valid = int(packed[slot, rec.steps])\n")}, PackLayoutRule),
    "test_unpack_clean_consume_block": ({ENGINE: _GOOD_CONSUME}, PackLayoutRule),
    "test_unpack_clean_spec_negative_slices": ({ENGINE: (
        "def _block_sync(x):\n"
        "    return x\n"
        "\n"
        "def _spec_step(self):\n"
        "    packed_np = _block_sync(self.packed)\n"
        "    out_np = packed_np[:, :-1]\n"
        "    na_np = packed_np[:, -1]\n"
        "    return out_np, na_np\n")}, PackLayoutRule),
    "test_pack_helper_column_swap_flagged": ({BATCH: (
        "import torch\n"
        "\n"
        "def _pack_block(toks, done, active):\n"
        "    n_valid = (toks >= 0).sum(dim=1, dtype=torch.int32)\n"
        "    return torch.cat(\n"
        "        [toks.to(torch.int32), n_valid[:, None],\n"
        "         (done & active)[:, None].to(torch.int32)],\n"
        "        dim=1)\n")}, PackLayoutRule),
    "test_spec_kernel_missing_scalar_column_flagged": ({BATCH: (
        "import torch\n"
        "\n"
        "def _pack_spec(out, n_accept):\n"
        "    return torch.cat([out.to(torch.int32)], dim=1)\n"
        "\n"
        "def verify_and_sample(cfg, params, cache, chunk, start_len,\n"
        "                      temperature, top_k, top_p, generator):\n"
        "    return _pack_spec(chunk, None), cache\n")}, PackLayoutRule),
    "test_decode_block_wrong_helper_flagged": ({BATCH: (
        "def decode_block(cfg, params, cache, state, active, steps,\n"
        "                 lora=None):\n"
        "    return _pack_ragged(None, None, active, None), cache, state\n")}, PackLayoutRule),
    "test_decode_block_declared_helper_clean": ({BATCH: (
        "def decode_block(cfg, params, cache, state, active, steps,\n"
        "                 lora=None):\n"
        "    return _pack_block(None, None, active), cache, state\n")}, PackLayoutRule),
    # dtype-discipline: a literal tensor with no dtype in a hot zone
    "test_dtypeless_asarray_of_literal_in_hot_zone_flagged": ({
        "gofr_tpu_torch/ops/sampling.py": (
            "import torch\n"
            "def sample(logits):\n"
            "    t = torch.tensor(1.0)\n"
            "    return logits / t\n")}, DtypeDisciplineRule),
    # a 64-bit float in an engine hot function
    "test_64bit_dtype_in_engine_hot_func_flagged": ({ENGINE: (
        "import torch\n"
        "def _dispatch(self):\n"
        "    temps = torch.as_tensor(self.temps, dtype=torch.float64)\n"
        "    return temps\n")}, DtypeDisciplineRule),
    # int64 where the table declares int32: a pack helper widening
    "test_float_index_arange_flagged": ({BATCH: (
        "import torch\n"
        "def _pack_block(toks, done, active):\n"
        "    return toks.long()\n")}, DtypeDisciplineRule),
    "test_engine_cold_function_not_in_dtype_zone": ({ENGINE: (
        "import torch\n"
        "def warmup(self):\n"
        "    t = torch.tensor(1.0)\n"
        "    return t\n")}, DtypeDisciplineRule),
    "test_explicit_dtype_asarray_clean": ({"gofr_tpu_torch/ops/sampling.py": (
        "import torch\n"
        "def sample(logits):\n"
        "    t = torch.tensor(1.0, dtype=torch.float32, device=logits.device)\n"
        "    idx = torch.arange(8, device=logits.device)\n"
        "    return logits / t + idx\n")}, DtypeDisciplineRule),
    "test_decode_state_missing_field_flagged": ({BATCH: (
        "class DecodeState:\n"
        + "".join(f"    {n}: int\n" for n, _ in kc.DECODE_STATE_FIELDS[:-1]))},
        CarryFieldDriftRule),
    "test_decode_state_ctor_arity_drift_flagged": ({BATCH: (
        "class DecodeState:\n" + _FIELD_LINES + "\n"
        "def _block_step(st):\n"
        "    return DecodeState(1, 2, 3, 4, 5, 6, 7, 8, 9)\n")}, CarryFieldDriftRule),
    "test_make_decode_state_wrong_dtype_flagged": ({BATCH: (
        "import numpy as np\n"
        "class DecodeState:\n" + _FIELD_LINES + "\n"
        "def make_decode_state(last_token, seq_len, done, budget, stop_tok,\n"
        "                      temperature, top_k, top_p, rng, adapter, *, device):\n"
        "    def up(x, dtype):\n"
        "        return x\n"
        "    return DecodeState(\n"
        "        up(last_token, np.int64), up(seq_len, np.int32), up(done, np.bool_),\n"
        "        up(budget, np.int32), up(stop_tok, np.int64),\n"
        "        up(temperature, np.int32),\n"  # drifted
        "        up(top_k, np.int64), up(top_p, np.float32), rng,\n"
        "        up(adapter, np.int32),\n"
        "    )\n")}, CarryFieldDriftRule),
    "test_admit_dropping_field_flagged": ({BATCH: (
        "class DecodeState:\n" + _FIELD_LINES + "\n"
        "def admit_decode_state(state, slots, *vals):\n"
        + "".join(f"    state.{n}[slots] = vals[0]\n" for n, _ in kc.DECODE_STATE_FIELDS
                  if n not in ("rng", "adapter"))
        + "    return state\n")}, CarryFieldDriftRule),
    "test_tree_unflatten_starred_ctor_clean": ({BATCH: (
        "class DecodeState:\n" + _FIELD_LINES
        + "    @classmethod\n"
        "    def tree_unflatten(cls, _aux, children):\n"
        "        return cls(*children)\n")}, CarryFieldDriftRule),
    "test_pending_admit_tuple_arity_flagged": ({ENGINE: (
        "class Engine:\n"
        "    def admit(self, slot, first_id, resident, budget):\n"
        "        self._pending_admit[slot] = (first_id, resident,\n"
        "                                     budget)\n")}, CarryFieldDriftRule),
    "test_pending_admit_annotation_arity_flagged": ({ENGINE: (
        "class Engine:\n"
        "    def __init__(self):\n"
        "        self._pending_admit: dict[int, tuple[int, int, int, int]] = {}\n")},
        CarryFieldDriftRule),
    "test_pending_admit_correct_arity_clean": ({ENGINE: (
        "class Engine:\n"
        "    def __init__(self):\n"
        "        self._pending_admit: dict[int, tuple[int, int, int, int, int]] = {}\n"
        "    def admit(self, slot, a, b, c, d, e):\n"
        "        self._pending_admit[slot] = (a, b, c, d, e)\n")}, CarryFieldDriftRule),
    # spec-rank-mismatch: shard_map(body, in_specs=, out_specs=)(args) is
    # the mesh client's compile(name, body, *args, in_shardings=,
    # out_shardings=); a spec places with NamedSharding(mesh, P(...))
    "test_shard_map_in_specs_arity_mismatch_flagged": ({PX: (
        _SHARDING_IMPORT +
        "def body(a, b):\n"
        "    return a, b\n"
        "def wrap(client, x, y, z):\n"
        "    spec = NamedSharding(client.mesh(), P('dp', None))\n"
        "    return client.compile('body', body, x, y, z,\n"
        "                          in_shardings=(spec, spec, NamedSharding(client.mesh(), P())),\n"
        "                          out_shardings=(spec, spec))\n")}, SpecRankRule),
    "test_partition_spec_arity_exceeds_declared_rank_flagged": ({PX: (
        _SHARDING_IMPORT +
        "def body(a,  # [B, S, D]\n"
        "         b):  # [B, D]\n"
        "    return a, b\n"
        "def wrap(client, x, y):\n"
        "    mesh = client.mesh()\n"
        "    return client.compile('body', body, x, y,\n"
        "                          in_shardings=(NamedSharding(mesh, P('dp')),\n"
        "                                        NamedSharding(mesh, P('dp', None, None))),\n"
        "                          out_shardings=(NamedSharding(mesh, P()), NamedSharding(mesh, P())))\n"
    )}, SpecRankRule),
    "test_out_specs_vs_returned_tuple_flagged": ({PX: (
        _SHARDING_IMPORT +
        "def body(a, b):\n"
        "    return a, b\n"
        "def wrap(client, x, y):\n"
        "    rep = NamedSharding(client.mesh(), P())\n"
        "    return client.compile('body', body, x, y, in_shardings=(rep, rep),\n"
        "                          out_shardings=rep)\n")}, SpecRankRule),
    "test_call_arity_vs_in_specs_flagged": ({PX: (
        _SHARDING_IMPORT +
        "def wrap(client, fn, x, y, z):\n"
        "    rep = NamedSharding(client.mesh(), P())\n"
        "    return client.compile('fn', fn, x, y, z, in_shardings=(rep, rep),\n"
        "                          out_shardings=rep)\n")}, SpecRankRule),
    # a keyword-only partial and a spec shorter than the rank (legal:
    # trailing dims replicate)
    "test_partial_bound_inner_and_trailing_spec_clean": ({PX: (
        "import functools\n" + _SHARDING_IMPORT +
        "def inner(q,  # [B, S, H, D]\n"
        "          k,  # [B, S, H, D]\n"
        "          v,  # [B, S, H, D]\n"
        "          *, axis, n):\n"
        "    return q\n"
        "def wrap(client, q, k, v, n):\n"
        "    spec = NamedSharding(client.mesh(), P(None, 'sp', None, None))\n"
        "    fn = functools.partial(inner, axis='sp', n=n)\n"
        "    return client.compile('inner', fn, q, k, v, in_shardings=(spec, spec, spec),\n"
        "                          out_shardings=spec)\n")}, SpecRankRule),
    # a spec tree the AST cannot resolve must not false-positive
    "test_unresolvable_spec_pytree_skipped": ({PX: (
        _SHARDING_IMPORT +
        "from gofr_tpu_torch.tree import tree_map\n"
        "def wrap(client, stage_params, x_mb, axis):\n"
        "    def body(stage_local, x):\n"
        "        return x\n"
        "    mesh = client.mesh()\n"
        "    param_specs = tree_map(lambda _: NamedSharding(mesh, P(axis)), stage_params)\n"
        "    return client.compile('stage', body, stage_params, x_mb,\n"
        "                          in_shardings=(param_specs, NamedSharding(mesh, P())),\n"
        "                          out_shardings=NamedSharding(mesh, P()))\n")}, SpecRankRule),
    # coverage counts public module-level functions, not jitted defs
    "test_new_jitted_kernel_without_contract_flagged": ({FLASH: (
        _FLASH_OK + "def brand_new_kernel(x):\n    return x\n")}, _coverage),
    # the reference's donation set becomes the static (Python value) set
    "test_donation_drift_flagged": ({KVC: (
        "def _write_pages(k_pool, v_pool, k_slab, v_slab, page_ids: int):\n"
        "    return k_pool, v_pool\n" + _WRITE_PAGES_Q)}, _coverage),
    "test_signature_drift_flagged": ({KVC: (
        "def _write_pages(k_pool, v_pool, slab, page_ids):\n"
        "    return k_pool, v_pool\n" + _WRITE_PAGES_Q)}, _coverage),
    "test_stale_contract_flagged": ({FLASH: (
        "def flash_attention_ref(q, k, v, kv_len=None, causal: bool = True,\n"
        "                        scale: float | None = None):\n"
        "    return q\n")}, _coverage),
    "test_vanished_unpack_site_flagged": ({ENGINE: (
        "def _consume(self):\n"
        "    pass\n")}, _coverage),
    "test_matching_kernel_file_clean": ({FLASH: _FLASH_OK}, _coverage),
    "test_coverage_rule_inert_without_real_tree_anchor": ({
        FLASH: "X = 1\n",
        ENGINE: "def _consume(self):\n    pass\n"}, KernelContractCoverageRule),
    "test_findings_roundtrip_json_and_sarif": ({"gofr_tpu_torch/ops/sampling.py": (
        "import torch\n"
        "def sample(logits):\n"
        "    t = torch.tensor(1.0)\n"
        "    return logits / t\n")}, DtypeDisciplineRule),
    "test_baseline_covers_kernelcheck_findings": ({"gofr_tpu_torch/ops/sampling.py": (
        "import torch\n"
        "def sample(logits):\n"
        "    return logits.double()\n")}, DtypeDisciplineRule),
    "test_non_kernel_file_ignored": ({"gofr_tpu_torch/other/tool.py": (
        "def helper(x):\n"
        "    return x\n")}, _coverage),
}


def test_every_reference_lint_case_is_translated():
    """Every fixture case of the reference's kernelcheck suite has a torch
    translation here, spec-rank-mismatch's among them."""
    mod = reference_module("test_kernelcheck")
    src = open(mod.__file__, encoding="utf-8").read()
    cases = {name for name in vars(mod) if name.startswith("test_")
             and f"def {name}(tmp_path)" in src and "lint_tree(" in
             src.split(f"def {name}(tmp_path)")[1].split("\ndef ")[0]}
    spec_rank = {n for n in cases if "SpecRankRule" in
                 src.split(f"def {n}(tmp_path)")[1].split("\ndef ")[0]}
    assert len(spec_rank) == 6 and set(CASES) == cases


@pytest.mark.parametrize("name", sorted(CASES))
def test_translated_fixture_gives_the_reference_rule_ids(name, tmp_path, monkeypatch):
    mod = reference_module("test_kernelcheck")
    calls = record_fixtures(mod, "lint_tree", monkeypatch)
    run_reference_test(mod, name, tmp_path)  # the reference's test, as it is
    assert len(calls) == 1
    ref_rules = sorted(f.rule for f in calls[0][1])
    files, rule = CASES[name]
    port = run_rules([materialize(tmp_path / "port", files)], [rule()])
    assert sorted(f.rule for f in port) == ref_rules, [f.render() for f in port]


# ------------------------------------------- spec-rank-mismatch, the port's own
def _spec_rank(tmp_path, files):
    return sorted((f.rule, f.line) for f in run_rules([materialize(tmp_path, files)],
                                                      [SpecRankRule()]))


def test_global_view_plumbing_against_the_bodies_it_maps(tmp_path):
    """``_global_view(fn, ...)`` calls ``fn(q, k, v, mesh, axis=, scale=)``:
    a body that takes another positional count has drifted (the port's
    ``context_parallel.py`` idiom)."""
    assert _spec_rank(tmp_path, {PX: (
        "def _global_view(fn, q, k, v, mesh, axis, scale):\n"
        "    return fn(q, k, v, mesh, axis=axis, scale=scale)\n"
        "def ring_sharded(q,  # [B, S, H, D]\n"
        "                 k, v, mesh, *, axis='sp', scale=None):\n"
        "    return q\n"
        "def ulysses_sharded(q, k, v, *, axis='sp', scale=None):\n"
        "    return q\n"
        "def ring(q, k, v, mesh):\n"
        "    return _global_view(ring_sharded, q, k, v, mesh, 'sp', None)\n"
        "def ulysses(q, k, v, mesh):\n"
        "    return _global_view(ulysses_sharded, q, k, v, mesh, 'sp', None)\n")}) == [
        ("spec-rank-mismatch", 11)]


def test_placement_calls_against_the_declared_rank(tmp_path):
    assert _spec_rank(tmp_path, {PX: (
        _SHARDING_IMPORT +
        "from gofr_tpu_torch.parallel.sharding import local_index, shard_leaf, with_constraint\n"
        "def place(mesh, x,  # [B, D]\n"
        "          w):  # [L, D, F]\n"
        "    a = local_index((4, 8), P('dp', 'tp', None), mesh)\n"
        "    b = local_index(x.shape, P('dp'), mesh)\n"
        "    c = shard_leaf(w, NamedSharding(mesh, P(None, 'fsdp', 'tp', 'ep')))\n"
        "    d = with_constraint(x, mesh, 'hidden')\n"
        "    e = with_constraint(x, mesh, 'tokens')\n"
        "    return a, b, c, d, e\n")}) == [
        ("spec-rank-mismatch", 5), ("spec-rank-mismatch", 7), ("spec-rank-mismatch", 8)]


def test_sharding_rules_against_init_params(tmp_path):
    """Each ``<model>_sharding_rules`` entry against the rank of every
    leaf of ``models/<model>.py``'s ``init_params`` it is the first match
    for; the real tables are clean (``test_port_tree_clean``)."""
    files = {
        "gofr_tpu_torch/parallel/sharding.py": (
            "from gofr_tpu_torch.parallel.mesh import P\n"
            "def toy_sharding_rules():\n"
            "    rules = [(r'w_in', P('fsdp', 'tp')), (r'w_out', P(None, 'tp', 'fsdp'))]\n"
            "    rules.append((r'norm', P('tp', None)))\n"
            "    return rules\n"),
        "gofr_tpu_torch/models/toy.py": (
            "def init_params(cfg):\n"
            "    def w(shape):\n"
            "        return shape\n"
            "    return {'layers': {'w_in': w((2, 3)), 'w_out': w((3, 2)),\n"
            "                       'norm': w((3,))}}\n")}
    assert _spec_rank(tmp_path, files) == [("spec-rank-mismatch", 3), ("spec-rank-mismatch", 4)]


# ------------------------------------------------------------ the table
def test_carry_differs_from_the_reference_only_where_listed():
    """Deliberate, ROADMAP Queue C 3: token fields are int64 (torch's
    index and sampler dtype) and the sampling state is a torch.Generator."""
    deliberate = {"last_token": ("int32", "int64"), "stop_tok": ("int32", "int64"),
                  "top_k": ("int32", "int64"), "rng": ("key", "generator")}
    ref, port = dict(jkc.DECODE_STATE_FIELDS), dict(kc.DECODE_STATE_FIELDS)
    assert list(ref) == list(port)
    assert {f: (ref[f], port[f]) for f in ref if ref[f] != port[f]} == deliberate
    assert kc.ADMIT_TUPLE_FIELDS == jkc.ADMIT_TUPLE_FIELDS
    assert {n: (lay.span, lay.scalars) for n, lay in kc.PACK_LAYOUTS.items()} == {
        n: (lay.span, lay.scalars) for n, lay in jkc.PACK_LAYOUTS.items()}


def test_contracts_differ_from_the_reference_only_where_listed():
    """The same 20 entries. Deliberate, Queue C 3: the ragged entries take
    chunk_rows and seeds (the reference's chunk_active mask, rids and
    rng_root) and return the K chunk rows' logits; the spec entries take a
    generator that advances in place and return no key. The attention
    wrappers take no interpret flag and no block sizes (the kernels size
    their own tiles); what the reference donates is updated in place. The
    entries the tensor-parallel engine dispatches (prefill_compute, the
    decode blocks, the ragged steps, the spec verifies) take its ``mesh``
    last, where the reference's arrays carry their shardings."""
    assert set(kc.CONTRACTS) == set(jkc.CONTRACTS)
    for name, c in kc.CONTRACTS.items():
        ref = jkc.CONTRACTS[name]
        assert c.file == ref.file.replace("gofr_tpu/", "gofr_tpu_torch/")
        assert c.packed == ref.packed
        on_mesh = name == "prefill_compute" or name.startswith(
            ("decode_block", "ragged_step", "verify_and_sample"))
        assert (c.params[-1] == "mesh") == on_mesh, name
        params = c.params[:-1] if on_mesh else c.params
        if name.startswith("ragged_step"):
            assert [p for p in ref.params if p not in ("chunk_active", "rids", "rng_root")] \
                == [p for p in params if p not in ("chunk_rows", "seeds")]
            assert c.returns[1].shape == "K,V" and ref.returns[1].shape == "B,V"
        elif name.startswith("verify_and_sample"):
            assert params == tuple("generator" if p == "rng" else p for p in ref.params)
            assert [r.name for r in c.returns] == [r.name for r in ref.returns if r.name != "rng"]
        elif name in ("paged_decode_attention", "paged_decode_attention_q", "flash_attention"):
            assert c.params == tuple(p for p in ref.params
                                     if p not in ("interpret", "block_q", "block_k"))
        else:
            assert params == ref.params, name
            assert [dataclasses.astuple(r) for r in c.returns] == \
                [dataclasses.astuple(r) for r in ref.returns], name
        assert set(ref.donated) <= set(c.updated), name


def test_contract_table_json_stable():
    blob = json.loads(kc.render_table_json())
    assert {k["name"] for k in blob["kernels"]} == set(kc.CONTRACTS)
    assert blob["carry"]["fields"][0] == ["last_token", "int64"]
    assert blob["layouts"]["ragged"]["scalars"] == ["done", "n_valid", "first"]
    assert set(blob["host_helpers"]) == set(kc.HOST_HELPERS)


# ------------------------------------------------------------ the port's tree
def test_port_tree_clean():
    findings = run_rules(PORT_TREE, kernelcheck_rules())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_tree_drift_is_caught(tmp_path, monkeypatch):
    """A contract whose params drift from the port's batch.py, and a
    layout whose columns drift from its pack helper, fail on the real
    tree."""
    import dataclasses

    drifted = dataclasses.replace(kc.CONTRACTS["insert_chunk"], params=("k_cache", "v_cache"))
    monkeypatch.setattr(kc, "KERNELS", tuple(
        drifted if k.name == "insert_chunk" else k for k in kc.KERNELS))
    monkeypatch.setattr(kc, "PACK_LAYOUTS", {
        **kc.PACK_LAYOUTS, "block": kc.PackedLayout("block", "steps", "tokens",
                                                    ("n_valid", "done"))})
    findings = run_rules([os.path.join(REPO_ROOT, "gofr_tpu_torch")], kernelcheck_rules())
    msgs = [f.message for f in findings]
    assert any("kernel 'insert_chunk' signature" in m for m in msgs), msgs
    assert any("_pack_block() column" in m and "should carry 'n_valid'" in m for m in msgs), msgs


def test_unified_keeps_kernelcheck_suppressions_live(tmp_path):
    top = materialize(tmp_path, {"gofr_tpu_torch/ops/sampling.py": (
        "import torch\n"
        "def sample(logits):\n"
        "    # gofrlint: disable=dtype-discipline -- a host scalar, read once\n"
        "    t = torch.tensor(1.0)\n"
        "    return logits / t\n")})
    live, stale = run_unified([top], kernelcheck_rules())
    assert live == [] and stale == []


def test_findings_json_sarif_and_baseline(tmp_path):
    from gofr_tpu_torch.analysis.sarif import render_sarif

    top = materialize(tmp_path, {"gofr_tpu_torch/ops/sampling.py": (
        "import torch\n"
        "def sample(logits):\n"
        "    return logits.double()\n")})
    findings = run_rules([top], kernelcheck_rules())
    assert [f.rule for f in findings] == ["dtype-discipline"]
    assert json.loads(baseline_io.render_json(findings))["findings"][0]["rule"] \
        == "dtype-discipline"
    assert json.loads(render_sarif(findings))["runs"][0]["results"][0]["ruleId"] \
        == "dtype-discipline"
    path = str(tmp_path / "baseline.json")
    baseline_io.write_baseline(path, findings)
    assert baseline_io.apply_baseline(findings, baseline_io.load_baseline(path)) == ([], 1)


# ----------------------------------------------- static <-> runtime twin
def _sig(shape, dtype, tree="*"):
    return {"tree": tree, "leaves": [[list(shape), dtype]]}


def _decode_block_case(**over):
    state = {"tree": "DecodeState(...)", "leaves": [
        [[3], "int64"], [[3], "int32"], [[3], "bool"], [[3], "int32"], [[3], "int64"],
        [[3], "float32"], [[3], "int64"], [[3], "float32"], [[], "generator:cuda"],
        [[3], "int32"]]}
    cache = {"tree": "KVCache(...)", "leaves": [[[2, 3, 32, 2, 16], "bfloat16"]] * 2}
    case = {"kernel": "decode_block", "variant": "t",
            "inputs": {"active": _sig((3,), "bool"), "cache": cache, "state": state},
            "statics": {"steps": 4},
            "outputs": [_sig((3, 6), "int32"), cache, state]}
    case.update(over)
    return case


def test_check_kernel_table_clean_case():
    assert check_kernel_table({"mode": "observed", "cases": [_decode_block_case()]}) == []


@pytest.mark.parametrize("drift,expect", [
    ("width", "dim 'steps+2' = 6 by the contract, observed 7"),
    ("dtype", "dtype int64; the contract declares int32"),
    ("carry", "in-place carry drift"),
    ("arity", "returned 2 output(s); the contract declares 3"),
])
def test_check_kernel_table_drift(drift, expect):
    bad = _decode_block_case()
    if drift == "width":
        bad["outputs"][0] = _sig((3, 7), "int32")
    elif drift == "dtype":
        bad["outputs"][0] = _sig((3, 6), "int64")
    elif drift == "carry":
        bad["outputs"][2] = dict(bad["outputs"][2], leaves=bad["outputs"][2]["leaves"][:-1])
    else:
        bad["outputs"] = bad["outputs"][:2]
    div = check_kernel_table({"mode": "observed", "cases": [bad]})
    assert any(expect in d for d in div), div


def test_check_kernel_table_unknown_kernel_violations_and_matrix_coverage():
    div = check_kernel_table({
        "mode": "observed",
        "cases": [{"kernel": "mystery_kernel", "variant": "x", "inputs": {},
                   "statics": {}, "outputs": []}],
        "violations": ["decode_block: dispatched with undeclared keyword 'x'"]})
    assert any("no declared contract" in d for d in div)
    assert any(d.startswith("runtime violation:") for d in div)
    div = check_kernel_table({"mode": "matrix", "cases": [_decode_block_case()]})
    assert any("'ragged_step' was never exercised" in d for d in div)
    assert any("'flash_attention' was never exercised" in d for d in div)
