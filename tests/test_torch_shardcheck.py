"""The port's shardcheck (gofr_tpu_torch/analysis/shardcheck.py) against the
JAX package's (gofr_tpu/analysis/shardcheck.py).

- Each fixture case of ``tests/test_shardcheck.py`` runs as the reference's
  own test (its assertions included); its torch translation here runs
  through the port's ``default_rules()``, as the reference's runs through
  its own, and gives the same rule ids. The translation writes JAX's idiom
  in the port's:
  - ``from jax.sharding import PartitionSpec`` is the port's
    ``parallel.sharding.PartitionSpec``; ``Mesh(devices,
    axis_names=...)`` is ``DeviceMesh(..., mesh_dim_names=...)``;
  - ``jax.lax.psum(x, "tp")`` is ``psum(x, mesh, "tp")``; a body handed to
    ``shard_map`` is a rank function handed to ``run_spmd``, or a function
    that receives the mesh it runs over;
  - a jitted function that donates its first argument is a contract
    kernel that updates it in place (``insert_slot_quantized``, whose
    ``cache`` is ``updated``); a jitted function with statics is a
    contract kernel with statics (``insert_slot_quantized``'s ``slot``,
    ``insert_chunk``'s ``slot`` and ``start``); ``jax.jit(fn)`` in a hot
    body is ``torch.compile(fn)``.
  No case gives other rule ids than the reference's: the port's in-place
  semantics make none of them legal. A bare call statement, whose result
  is dropped, is torch's in-place idiom (the argument IS the result); no
  reference case has one, and it is held clean below.
- The JSON output, the ratchet baseline, the committed empty baseline and
  the port's tree clean under the family are the reference's cases over
  the port's CLI.
- The port's additions: a mesh's own lookups and spec strings,
  ``.item()``, a CUDA graph built per call, the zone tables joining
  zone-drift.
"""

from __future__ import annotations

import io
import json
import os
from contextlib import redirect_stdout

import pytest
from torch_reference_fixtures import (
    materialize,
    record_fixtures,
    reference_module,
    run_reference_test,
)

pytest.importorskip("jax")

from gofr_tpu_torch.analysis import baseline_io  # noqa: E402
from gofr_tpu_torch.analysis import shardcheck as sc  # noqa: E402
from gofr_tpu_torch.analysis.core import Finding, run_rules  # noqa: E402
from gofr_tpu_torch.analysis.deadlinecheck import ZoneDriftRule  # noqa: E402
from gofr_tpu_torch.analysis.rules import default_rules  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = [os.path.join(REPO_ROOT, p) for p in
             ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")]
SHARD_RULES = ("mesh-axis-unknown", "collective-unmapped", "use-after-donation",
               "retrace-hazard", "spec-rank-mismatch")

MESH = "gofr_tpu_torch/parallel/mesh.py"
RULES = "gofr_tpu_torch/parallel/rules.py"
BATCH = "gofr_tpu_torch/serving/batch.py"
ENGINE = "gofr_tpu_torch/serving/engine.py"
MESH_DECL = 'AXIS_ORDER = ("dp", "tp", "sp")\n'
PSPEC = "from gofr_tpu_torch.parallel.sharding import PartitionSpec as P\n"
COLL = ("from gofr_tpu_torch.parallel.collectives import axis_index, pmean, psum\n"
        "from gofr_tpu_torch.parallel.mesh import build_mesh\n"
        "from gofr_tpu_torch.parallel.world import run_spmd\n")
# the reference's donating ``step(cache, tok)``: the contract kernel whose
# ``cache`` is updated in place (kernel_contracts.py)
UPDATING = ("def insert_slot_quantized(cache, k_slab, v_slab, slot: int):\n"
            "    return cache\n")
IMPORT = "from gofr_tpu_torch.serving.batch import insert_slot_quantized\n"
CALL = "insert_slot_quantized(cache, slab, slab, 0)"


def _donation(body: str, extra: dict | None = None) -> dict:
    return {BATCH: UPDATING, ENGINE: IMPORT + body, **(extra or {})}


# reference test name -> the torch translation's trees (one a lint_tree call)
CASES: dict[str, list[dict[str, str]]] = {
    # ------------------------------------------------------------ mesh axes
    "test_mesh_axis_typo_in_partition_spec": [{
        MESH: MESH_DECL, RULES: PSPEC + 'SPEC = P("tpu", None)\n'}],
    "test_mesh_axis_unknown_collective_axis_name": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/cp.py": (
            COLL +
            "def body(device, x):\n"
            '    return psum(x, build_mesh(), "fsdp")\n'
            "def wrap(x):\n"
            "    return run_spmd(body, 2, args=(x,))\n")}],
    "test_mesh_axis_nested_tuple_and_defaults_clean": [{
        MESH: MESH_DECL, RULES: (
            PSPEC + 'SPEC = P(("dp", "tp"), "sp", None)\n'
            'def ring(x, mesh, *, axis="sp"):\n'
            "    return x\n")}],
    "test_mesh_axis_names_keyword_declaration_form": [{
        MESH: ("from torch.distributed.device_mesh import DeviceMesh\n"
               "def build(grid):\n"
               '    return DeviceMesh("cpu", grid, mesh_dim_names=("dp", "tp"))\n'),
        RULES: PSPEC + 'GOOD = P("dp", "tp")\nBAD = P("model", None)\n'}],
    "test_mesh_axis_skipped_without_mesh_declaration": [{
        RULES: PSPEC + 'SPEC = P("anything", None)\n'}],
    "test_mesh_axis_suppression_honored": [{
        MESH: MESH_DECL, RULES: (
            PSPEC + 'SPEC = P("expert", None)'
            "  # gofrlint: disable=mesh-axis-unknown -- bound by a caller mesh\n")}],
    # -------------------------------------------------- collective mapping
    "test_collective_with_literal_axis_outside_shard_map": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/bad.py": (
            COLL +
            "def grad_sync(g):\n"
            '    return psum(g, build_mesh("dp=2"), "dp")\n')}],
    "test_collective_at_module_scope_flagged": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/bad.py": (
            COLL + 'MESH = build_mesh("tp=2")\nIDX = axis_index(MESH, "tp")\n')}],
    "test_collective_inside_shard_map_body_clean": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/good.py": (
            COLL +
            "def wrap(x):\n"
            "    def body(device, v):\n"
            '        return psum(v, build_mesh("tp=2"), "tp")\n'
            "    return run_spmd(body, 2, args=(x,))\n")}],
    "test_collective_in_lambda_passed_to_shard_map_clean": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/good.py": (
            COLL +
            "def wrap(xs, mesh):\n"
            '    return list(map(lambda v: psum(v, mesh, "tp"), xs))\n')}],
    "test_collective_axis_parameter_convention_clean": [{
        MESH: MESH_DECL, "gofr_tpu_torch/parallel/good.py": (
            "import functools\n" + COLL +
            "def ring_sharded(x, mesh, *, axis):\n"
            "    return pmean(x, mesh, axis)\n"
            "def ring(x, mesh, axis):\n"
            "    fn = functools.partial(ring_sharded, axis=axis)\n"
            "    return fn(x, mesh)\n")}],
    # --------------------------------------- in-place update (donation)
    "test_use_after_donation_positive": [_donation(
        "def drive(cache, slab):\n"
        f"    new_cache = {CALL}\n"
        "    return cache + 1\n")],
    "test_use_after_donation_attribute_chain": [_donation(
        "class Engine:\n"
        "    def drive(self, slab):\n"
        "        out = insert_slot_quantized(self.cache.k, slab, slab, 0)\n"
        "        return self.cache.k.sum()\n")],
    "test_donation_rebind_idiom_clean": [_donation(
        "def drive(cache, slab):\n"
        f"    cache = {CALL}\n"
        "    return cache + 1\n")],
    "test_donation_metadata_reads_and_rebind_kill_clean": [_donation(
        "def drive(cache, slab):\n"
        f"    out = {CALL}\n"
        "    shape = cache.shape\n"
        "    cache = out\n"
        "    return cache, shape\n")],
    "test_donation_read_in_later_method_not_flagged": [_donation(
        "class Engine:\n"
        "    def drive(self, slab):\n"
        "        out = insert_slot_quantized(self.cache, slab, slab, 0)\n"
        "        self.cache = out\n"
        "    def probe(self):\n"
        "        return self.cache\n")],
    "test_donation_conditional_rebind_clean": [_donation(
        "def drive(cache, slab, full):\n"
        "    if full:\n"
        f"        cache = {CALL}\n"
        "    return cache.sum()\n")],
    "test_donation_in_loop_without_rebind_flagged": [_donation(
        "def drive(cache, slabs):\n"
        "    outs = []\n"
        "    for slab in slabs:\n"
        f"        out = {CALL}\n"
        "        outs.append(out)\n"
        "    return outs\n")],
    "test_donation_self_referencing_rebind_flagged": [
        _donation("def drive(cache, slab):\n"
                  f"    out = {CALL}\n"
                  "    cache = cache + 1\n"
                  "    return cache\n"),
        _donation("def drive(cache, slab):\n"
                  f"    out = {CALL}\n"
                  "    cache += 1\n"
                  "    return cache\n")],
    "test_donation_local_same_name_function_shadows_registry": [{
        BATCH: UPDATING, "gofr_tpu_torch/models/other.py": (
            "def insert_slot_quantized(cache, k_slab, v_slab, slot):\n"
            "    return cache + k_slab\n"
            "def drive(cache, slab):\n"
            f"    out = {CALL}\n"
            "    return cache + 1\n")}],
    "test_donation_in_compound_header_flagged": [_donation(
        "def drive(cache, slab):\n"
        f"    if {CALL} is None:\n"
        "        return None\n"
        "    return cache + 1\n")],
    "test_donation_of_loop_iteration_variable_clean": [_donation(
        "def drive(caches, slab):\n"
        "    outs = []\n"
        "    for cache in caches:\n"
        f"        out = {CALL}\n"
        "        outs.append(out)\n"
        "    return outs\n")],
    "test_donation_in_loop_with_rebind_clean": [_donation(
        "def drive(cache, slabs):\n"
        "    for slab in slabs:\n"
        f"        cache = {CALL}\n"
        "    return cache\n")],
    "test_donation_alias_captured_before_call_flagged": [_donation(
        "class Inflight:\n"
        "    def __init__(self, tok):\n"
        "        self.next_token = tok\n"
        "def drive(cache, slab):\n"
        "    rec = Inflight(cache)\n"
        f"    cache = {CALL}\n"
        "    return rec.next_token.sum()\n")],
    "test_donation_direct_alias_copy_flagged": [_donation(
        "def drive(cache, slab):\n"
        "    keep = cache\n"
        f"    cache = {CALL}\n"
        "    return keep + 1\n")],
    "test_donation_alias_rebound_before_read_clean": [_donation(
        "def drive(cache, slab):\n"
        "    keep = cache\n"
        f"    cache = {CALL}\n"
        "    keep = cache\n"
        "    return keep + 1\n")],
    "test_donation_alias_attribute_store_is_not_a_read": [_donation(
        "class Holder:\n"
        "    def __init__(self, tok):\n"
        "        self.next_token = tok\n"
        "def drive(cache, slab):\n"
        "    rec = Holder(cache)\n"
        f"    cache = {CALL}\n"
        "    rec.steps = 2\n"
        "    return slab\n")],
    "test_donation_alias_shed_before_call_clean": [_donation(
        "def drive(cache, slab, other):\n"
        "    keep = cache\n"
        "    keep = other\n"
        f"    cache = {CALL}\n"
        "    return keep + 1\n")],
    # ------------------------------------------------- capture hazards
    "test_retrace_branch_on_traced_param": [{BATCH: (
        "def insert_slot_quantized(cache, k_slab, v_slab, slot: int):\n"
        "    if k_slab:\n"
        "        return cache + 1\n"
        "    return cache\n")}],
    "test_retrace_unhashable_static_at_call_site": [{BATCH: (
        UPDATING +
        "def drive(cache, slab):\n"
        "    return insert_slot_quantized(cache, slab, slab, [128, 256])\n")}],
    "test_retrace_jit_inside_hot_function": [{ENGINE: (
        "import torch\n"
        "def dispatch(fn, x):\n"
        "    return torch.compile(fn)(x)\n")}],
    "test_retrace_static_branch_and_shape_inspection_clean": [{BATCH: (
        "def insert_chunk(k_cache, v_cache, k_slab, v_slab, slot: int, start: int):\n"
        "    if start > 1:\n"  # static: one capture per bucket
        "        k_slab = k_slab * 2\n"
        "    if slot is None:\n"  # identity test: static
        "        slot = 0\n"
        "    if k_slab.shape[0] > 4:\n"  # shape: static under a capture
        "        return k_slab[:4], v_cache\n"
        "    return k_cache, v_cache\n")}],
    "test_retrace_outside_zone_clean": [{"gofr_tpu_torch/models/extra.py": (
        "def insert_slot_quantized(cache, k_slab, v_slab, slot: int):\n"
        "    if k_slab:\n"
        "        return cache + 1\n"
        "    return cache\n")}],
}

# the reference's cases that lint through its CLI or need no fixture tree:
# each has a port test of its own name below
CLI_CASES = {
    "test_json_format_and_stable_ids", "test_json_clean_exit_zero", "test_baseline_round_trip",
    "test_partial_update_preserves_uncovered_baseline_entries",
    "test_file_only_update_preserves_cross_file_rule_entries", "test_baseline_counts_per_key",
    "test_committed_baseline_is_empty", "test_real_tree_clean_under_shardcheck",
}


def test_every_reference_case_is_translated():
    mod = reference_module("test_shardcheck")
    names = {n for n in vars(mod) if n.startswith("test_")}
    assert len(names) == 41
    assert set(CASES) | CLI_CASES == names and not set(CASES) & CLI_CASES
    assert all(n in globals() for n in CLI_CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_translated_fixture_gives_the_reference_rule_ids(name, tmp_path, monkeypatch):
    mod = reference_module("test_shardcheck")
    calls = record_fixtures(mod, "lint_tree", monkeypatch)
    run_reference_test(mod, name, tmp_path)  # the reference's test, as it is
    trees = CASES[name]
    assert len(calls) == len(trees)
    for i, ((_, ref, _, _), files) in enumerate(zip(calls, trees)):
        port = run_rules([materialize(tmp_path / f"port{i}", files)], default_rules())
        assert sorted(f.rule for f in port) == sorted(f.rule for f in ref), \
            [f.render() for f in port]


# ------------------------------------------------------------ the port's CLI
HAZARD = ("def insert_slot_quantized(cache, k_slab, v_slab, slot: int):\n"
          "    if k_slab:\n"
          "        return cache + 1\n"
          "    return cache\n")


def _main(*args: str) -> tuple[int, str]:
    from gofr_tpu_torch.analysis.__main__ import main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(list(args))
    return rc, buf.getvalue()


def test_json_format_and_stable_ids(tmp_path):
    top = materialize(tmp_path, {BATCH: HAZARD})
    runs = [_main(top, "--no-ffi", "--format", "json", "--no-baseline") for _ in range(2)]
    assert runs[0][0] == runs[1][0] == 1
    out1, out2 = (json.loads(out) for _, out in runs)
    assert out1 == out2
    (finding,) = out1["findings"]
    assert set(finding) == {"id", "rule", "file", "line", "message"}
    assert finding["rule"] == "retrace-hazard" and finding["id"].startswith("retrace-hazard-")


def test_json_clean_exit_zero(tmp_path):
    top = materialize(tmp_path, {"gofr_tpu_torch/ok.py": "def f():\n    return 1\n"})
    rc, out = _main(top, "--no-ffi", "--format", "json", "--no-baseline")
    assert rc == 0 and json.loads(out)["findings"] == []


def test_baseline_round_trip(tmp_path):
    top = materialize(tmp_path, {BATCH: HAZARD})
    baseline = tmp_path / "baseline.json"
    args = [top, "--no-ffi", "--baseline", str(baseline)]
    assert _main(*args)[0] == 1  # blocks before the baseline exists
    assert _main(*args, "--update-baseline")[0] == 0
    assert _main(*args)[0] == 0
    data = json.loads(baseline.read_text())
    assert data["version"] == baseline_io.BASELINE_VERSION and len(data["findings"]) == 1
    assert _main(*args, "--no-baseline")[0] == 1
    batch = tmp_path / BATCH
    batch.write_text(HAZARD + "import torch\ndef dispatch(fn, x):\n    return torch.compile(fn)(x)\n")
    assert _main(*args)[0] == 1  # a new finding is not covered
    batch.write_text("def f():\n    return 1\n")
    assert _main(*args)[0] == 0  # a stale baseline is harmless


def test_partial_update_preserves_uncovered_baseline_entries(tmp_path):
    top = materialize(tmp_path, {
        BATCH: HAZARD,
        ENGINE: "import torch\ndef dispatch(fn, x):\n    return torch.compile(fn)(x)\n"})
    baseline = tmp_path / "baseline.json"
    assert _main(top, "--no-ffi", "--baseline", str(baseline), "--update-baseline")[0] == 0
    assert len(json.loads(baseline.read_text())["findings"]) == 2
    assert _main(str(tmp_path / BATCH), "--no-ffi", "--baseline", str(baseline),
                 "--update-baseline")[0] == 0
    keys = json.loads(baseline.read_text())["findings"]
    assert any("engine.py" in k for k in keys), keys
    assert _main(top, "--no-ffi", "--baseline", str(baseline))[0] == 0


def test_file_only_update_preserves_cross_file_rule_entries(tmp_path):
    top = materialize(tmp_path, {MESH: MESH_DECL, RULES: PSPEC + 'SPEC = P("model", None)\n'})
    baseline = tmp_path / "baseline.json"
    assert _main(top, "--no-ffi", "--baseline", str(baseline), "--update-baseline")[0] == 0
    before = json.loads(baseline.read_text())["findings"]
    assert any(k.startswith("mesh-axis-unknown|") for k in before)
    assert _main(str(tmp_path / RULES), "--no-ffi", "--baseline", str(baseline),
                 "--update-baseline")[0] == 0
    assert json.loads(baseline.read_text())["findings"] == before
    assert _main(top, "--no-ffi", "--baseline", str(baseline))[0] == 0


def test_baseline_counts_per_key():
    f = Finding("r", "a.py", 3, "m")
    g = Finding("r", "a.py", 9, "m")
    blocking, baselined = baseline_io.apply_baseline([f, g], {"r|a.py|m": 1})
    assert baselined == 1 and len(blocking) == 1


def test_committed_baseline_is_empty():
    assert baseline_io.load_baseline(baseline_io.default_baseline_path()) == {}


def test_real_tree_clean_under_shardcheck():
    """The reference lints its tree with every rule and keeps the family's
    ids; the family alone gives the same ids, in a third of the time."""
    from gofr_tpu_torch.analysis.kernelcheck import SpecRankRule

    findings = run_rules(PORT_TREE, sc.shardcheck_rules() + [SpecRankRule()])
    assert {r.name for r in sc.shardcheck_rules() + [SpecRankRule()]} == set(SHARD_RULES)
    assert findings == [], "\n".join(f.render() for f in findings)


# ------------------------------------------------------ the port's additions
def _rules(tmp_path, files: dict[str, str], rules=None) -> list[tuple[str, int]]:
    found = run_rules([materialize(tmp_path, files)], rules or sc.shardcheck_rules())
    return sorted((f.rule, f.line) for f in found)


def test_mesh_lookups_and_spec_strings_are_axis_usages(tmp_path):
    assert _rules(tmp_path, {MESH: MESH_DECL, "gofr_tpu_torch/parallel/x.py": (
        "from gofr_tpu_torch.parallel.mesh import build_mesh, require_axis\n"
        "def f(mesh):\n"
        '    a = mesh.group("tpu")\n'
        '    b = mesh.shape["sp"] + mesh.index("dp") + require_axis(mesh, "ep")\n'
        '    c = build_mesh("dp=2,model=2")\n'
        '    d = "a.b".index("b")\n'  # not a mesh: no usage
        "    return a, b, c, d\n")}) == [
        ("mesh-axis-unknown", 3), ("mesh-axis-unknown", 4), ("mesh-axis-unknown", 5)]


def test_collective_over_a_mesh_the_function_builds_is_flagged(tmp_path):
    files = {MESH: MESH_DECL, "gofr_tpu_torch/parallel/x.py": (
        COLL +
        "def rank_fn(device, x):\n"
        '    return psum(x, build_mesh("tp=2"), "tp")\n'
        "def helper(x):\n"
        '    return psum(x, build_mesh("tp=2"), "tp")\n'
        "def method_like(self, x):\n"
        '    return psum(x, self.mesh, "tp")\n'
        "def run(x):\n"
        "    return run_spmd(rank_fn, 2, args=(x,))\n")}
    assert _rules(tmp_path, files) == [("collective-unmapped", 7)]


def test_bare_in_place_call_is_the_idiom(tmp_path):
    """``f(x)`` alone updates ``x`` and drops the result: reading ``x``
    after it reads the result, not a value from before the call. An alias
    taken before it still shares the storage."""
    assert _rules(tmp_path, _donation(
        "def drive(cache, slab, slabs):\n"
        f"    {CALL}\n"
        "    for slab in slabs:\n"
        f"        {CALL}\n"
        "    return cache + 1\n")) == []
    assert _rules(tmp_path / "alias", _donation(
        "def drive(cache, slab):\n"
        "    keep = cache\n"
        f"    {CALL}\n"
        "    return keep + 1\n")) == [("use-after-donation", 5)]


def test_host_reads_and_captures_in_the_hot_path(tmp_path):
    assert _rules(tmp_path, {
        BATCH: ("def insert_slot_quantized(cache, k_slab, v_slab, slot: int = [0]):\n"
                "    n = k_slab.item() + int(v_slab[0]) + k_slab.numel()\n"
                "    if v_slab.device.type == 'cpu' or k_slab.dim() > 2:\n"
                "        return cache\n"
                "    return cache + n\n"),
        "gofr_tpu_torch/ops/x.py": (
            "import torch\n"
            "def replay(fn, x):\n"
            "    g = torch.cuda.CUDAGraph()\n"
            "    with torch.cuda.graph(g):\n"
            "        fn(x)\n"
            "    return g\n"),
        "gofr_tpu_torch/models/x.py": (
            "import torch\n"
            "def warm(fn):\n"
            "    return torch.compile(fn)\n")}) == [
        ("retrace-hazard", 1), ("retrace-hazard", 2), ("retrace-hazard", 2),
        ("retrace-hazard", 3), ("retrace-hazard", 4)]


def test_retrace_zones_join_zone_drift(monkeypatch):
    """A retrace zone naming a file that moved is a zone-drift finding on
    the real tree, as each of the other analyzers' zones is."""
    monkeypatch.setattr(sc, "RETRACE_ZONE_FILES",
                        sc.RETRACE_ZONE_FILES + ("gofr_tpu_torch/serving/gone.py",))
    found = run_rules([os.path.join(REPO_ROOT, "gofr_tpu_torch")], [ZoneDriftRule()])
    assert [(f.rule, f.path) for f in found] == [
        ("zone-drift", "gofr_tpu_torch/analysis/shardcheck.py")]
    assert "RETRACE_ZONE_FILES" in found[0].message and "gone.py" in found[0].message
