"""The port's deadlinecheck (gofr_tpu_torch/analysis/deadlinecheck.py)
against the JAX package's.

- Every fixture of ``tests/test_deadlinecheck.py`` that goes through its
  ``lint_tree`` or ``_zone_lint`` runs through both packages' rules (the
  reference's own test runs as it is; the recorded fixture, its zone
  tables and its anchor then run through the port's rules under
  ``gofr_tpu_torch/``), and the (rule, line) findings are equal.
- The port's tree is clean, its zone tables (the rules', leakcheck's and
  the kernel contract table's) name live files and functions, and its
  boundary table names the port's entry points.
"""

from __future__ import annotations

import json
import os

import pytest
from torch_reference_fixtures import (
    fixture_tests,
    materialize,
    pairs,
    port_path,
    record_fixtures,
    reference_module,
    run_reference_test,
)

pytest.importorskip("jax")

from gofr_tpu_torch.analysis import baseline_io  # noqa: E402
from gofr_tpu_torch.analysis.core import run_rules, run_unified  # noqa: E402
from gofr_tpu_torch.analysis.deadlinecheck import (  # noqa: E402
    BOUNDARY_CLASSES,
    BOUNDARY_FUNCS,
    ZoneDriftRule,
    build_boundary_table,
    check_deadline_coverage,
    deadlinecheck_rules,
    render_table_json,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = [os.path.join(REPO_ROOT, p) for p in
             ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")]

DEADLINE_FIXTURES = fixture_tests("test_deadlinecheck", ("lint_tree", "_zone_lint"))


def _port_zones(zones):
    return [(label, port_path(home), {port_path(k): v for k, v in table.items()})
            for label, home, table in zones]


def test_reference_fixture_set_is_harvested():
    assert len(DEADLINE_FIXTURES) >= 25, DEADLINE_FIXTURES


@pytest.mark.parametrize("name", DEADLINE_FIXTURES)
def test_fixture_findings_match_reference(name, tmp_path, monkeypatch):
    mod = reference_module("test_deadlinecheck")
    lint_calls = record_fixtures(mod, "lint_tree", monkeypatch)
    zone_calls = record_fixtures(mod, "_zone_lint", monkeypatch)
    run_reference_test(mod, name, tmp_path)  # the reference's test, as it is
    assert lint_calls or zone_calls, f"{name} linted no fixture"
    for i, (files, ref_findings, args, kwargs) in enumerate(lint_calls + zone_calls):
        top = materialize(tmp_path / f"port{i}",
                          {port_path(rel): src for rel, src in files.items()})
        if i < len(lint_calls):
            rules = deadlinecheck_rules()
        else:
            zones = kwargs.get("zones", args[0] if args else None)
            anchor = kwargs.get("anchor", args[1] if len(args) > 1 else "gofr_tpu/svc/anchor.py")
            rules = [ZoneDriftRule(zones=_port_zones(zones), anchor=port_path(anchor))]
        port = run_rules([top], rules)
        assert pairs(port) == pairs(ref_findings), (
            name, [f.render() for f in port], [f.render() for f in ref_findings])


# ------------------------------------------------------------- the port's tree
def test_port_tree_clean():
    findings = run_rules(PORT_TREE, deadlinecheck_rules())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_zone_tables_match_the_port_tree():
    """Every zone the port's analyzers key on (the rules' four tables,
    leakcheck's retire-gate zone, the kernel files and unpack sites)
    names a live file and live functions."""
    findings = run_rules([os.path.join(REPO_ROOT, "gofr_tpu_torch")], [ZoneDriftRule()])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_zone_drift_finds_a_moved_unpack_site(tmp_path, monkeypatch):
    from gofr_tpu_torch.analysis import kernel_contracts as kc

    moved = kc.UnpackSite("gofr_tpu_torch/serving/engine.py", "_consume_moved", "ragged")
    monkeypatch.setattr(kc, "UNPACK_SITES", kc.UNPACK_SITES + (moved,))
    findings = run_rules([os.path.join(REPO_ROOT, "gofr_tpu_torch")], [ZoneDriftRule()])
    assert [(f.rule, f.path) for f in findings] == [
        ("zone-drift", "gofr_tpu_torch/analysis/kernel_contracts.py")]
    assert "'_consume_moved'" in findings[0].message


def test_default_zones_inert_on_a_fixture_engine(tmp_path):
    top = materialize(tmp_path, {
        "gofr_tpu_torch/serving/engine.py": "def drive(cache):\n    return cache\n"})
    assert run_rules([top], [ZoneDriftRule()]) == []


def test_unified_pass_includes_deadline_rules():
    from gofr_tpu_torch.analysis.rules import default_rules

    names = {r.name for r in default_rules()}
    assert {"deadline-dropped", "unbounded-wire-call", "retry-unbudgeted",
            "cancel-unreachable", "zone-drift"} <= names


def test_unified_run_keeps_deadline_suppressions_live(tmp_path):
    top = materialize(tmp_path, {"gofr_tpu_torch/svc/a.py": (
        "class W:\n"
        "    def run(self, payload, deadline):\n"
        "        fut = self.pool_start(payload)\n"
        "        # gofrlint: disable=deadline-dropped -- grace\n"
        "        return fut.result(timeout=5.0)\n")})
    live, stale = run_unified([top], deadlinecheck_rules())
    assert [f for f in live if f.rule == "deadline-dropped"] == []
    assert stale == [], "\n".join(f.render() for f in stale)


def test_findings_roundtrip_json_sarif_and_baseline(tmp_path):
    from gofr_tpu_torch.analysis.sarif import render_sarif

    top = materialize(tmp_path, {"gofr_tpu_torch/svc/a.py": (
        "class W:\n"
        "    def run(self, payload, deadline):\n"
        "        fut = self.pool_start(payload)\n"
        "        return fut.result(timeout=5.0)\n")})
    findings = run_rules([top], deadlinecheck_rules())
    assert [f.rule for f in findings] == ["deadline-dropped"]
    blob = json.loads(baseline_io.render_json(findings))
    assert blob["findings"][0]["rule"] == "deadline-dropped"
    sarif = json.loads(render_sarif(findings))
    assert sarif["runs"][0]["results"][0]["ruleId"] == "deadline-dropped"
    path = str(tmp_path / "baseline.json")
    baseline_io.write_baseline(path, findings)
    left, covered = baseline_io.apply_baseline(findings, baseline_io.load_baseline(path))
    assert left == [] and covered == 1


# ------------------------------------------- boundary table & cross-check
def test_boundary_table_names_the_port_entry_points():
    from gofr_tpu.analysis import deadlinecheck as jdc

    assert BOUNDARY_CLASSES == jdc.BOUNDARY_CLASSES and BOUNDARY_FUNCS == jdc.BOUNDARY_FUNCS
    sites = build_boundary_table(PORT_TREE)["sites"]
    for site, prefix in {
        "Router.submit": "gofr_tpu_torch/serving/router.py:",
        "Router.resume": "gofr_tpu_torch/serving/router.py:",
        "LocalReplica.submit": "gofr_tpu_torch/serving/router.py:",
        "LocalReplica.resume": "gofr_tpu_torch/serving/router.py:",
        "HTTPReplica.submit": "gofr_tpu_torch/serving/router.py:",
        "HTTPReplica.resume": "gofr_tpu_torch/serving/router.py:",
        "HTTPReplica.fetch_kv": "gofr_tpu_torch/serving/router.py:",
        "ServingEngine.submit": "gofr_tpu_torch/serving/engine.py:",
        "KVMigrator.fetch_chain": "gofr_tpu_torch/serving/prefix_index.py:",
        "KVMigrator.fetch_handoff": "gofr_tpu_torch/serving/prefix_index.py:",
        "KVMigrator.evacuate_chain": "gofr_tpu_torch/serving/prefix_index.py:",
        "AdapterRegistry.acquire": "gofr_tpu_torch/serving/lora.py:",
        "remote.run_stream": "gofr_tpu_torch/serving/remote.py:",
        "remote.open_resume": "gofr_tpu_torch/serving/remote.py:",
    }.items():
        assert sites[site].startswith(prefix), (site, sites.get(site))
    json.loads(render_table_json(build_boundary_table(PORT_TREE)))


def test_coverage_flags_unknown_site_and_violations():
    table = {"version": 1, "sites": {"Router.submit": "x.py:1"}}
    runtime = {"events": [{"site": "Router.submit", "op": "crossing"},
                          {"site": "Mystery.hop", "op": "crossing"}],
               "violations": ["budget widened at Mystery.hop: ..."]}
    div = check_deadline_coverage(runtime, table)
    assert any("Mystery.hop" in d and "unknown boundary" in d for d in div)
    assert any(d.startswith("runtime budget violation:") for d in div)
    clean = {"events": [{"site": "Router.submit", "op": "crossing"}], "violations": []}
    assert check_deadline_coverage(clean, table) == []
