"""The port's leakcheck and leaktrace (gofr_tpu_torch/analysis/) against
the JAX package's.

- Every fixture of ``tests/test_leakcheck.py`` that goes through its
  ``lint_tree`` runs through both packages' leakcheck families (the
  reference's own test runs as it is, its assertions included; the
  recorded fixture then runs through the port's rules, placed under
  ``gofr_tpu_torch/`` where the reference placed it under ``gofr_tpu/``),
  and the (rule, line) findings are equal.
- The port's tree is clean, its resource table names the port's sites,
  and the runtime tracer balances on a live port engine with its pairs
  covered by the static table.
- The same submits, one cancel, one deadline expiry and stop run on both
  packages' tiny paged engines under their tracers: both balance, with
  equal acquire counts for ``kv-slot`` and ``timeline`` (the reference on
  its Python scheduler, ROADMAP Queue C 14).
"""

from __future__ import annotations

import json
import os
import time

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

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.analysis import leakcheck as jleakcheck  # noqa: E402
from gofr_tpu.analysis.core import run_rules as jrun_rules  # noqa: E402
from gofr_tpu_torch.analysis import leaktrace  # noqa: E402
from gofr_tpu_torch.analysis.core import run_rules  # noqa: E402
from gofr_tpu_torch.analysis.leakcheck import (  # noqa: E402
    RESOURCES,
    build_resource_table,
    check_coverage,
    leakcheck_rules,
    parse_transfer_annotations,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TREE = [os.path.join(REPO_ROOT, p) for p in
             ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------- the reference's fixtures
LEAK_FIXTURES = fixture_tests("test_leakcheck", ("lint_tree",))


def test_reference_fixture_set_is_harvested():
    assert len(LEAK_FIXTURES) >= 25, LEAK_FIXTURES


@pytest.mark.parametrize("name", LEAK_FIXTURES)
def test_fixture_findings_match_reference(name, tmp_path, monkeypatch):
    mod = reference_module("test_leakcheck")
    calls = record_fixtures(mod, "lint_tree", monkeypatch)
    run_reference_test(mod, name, tmp_path)  # the reference's test, as it is
    assert calls, f"{name} linted no fixture"
    for i, (files, ref_findings, _args, _kw) in enumerate(calls):
        root = tmp_path / f"port{i}"
        top = materialize(root, {port_path(rel): src for rel, src in files.items()})
        port = run_rules([top], leakcheck_rules())
        assert pairs(port) == pairs(ref_findings), (
            name, [f.render() for f in port], [f.render() for f in ref_findings])


def test_native_handle_kind_has_no_counterpart(tmp_path):
    """The reference's native-handle kind (gofr_*_create/destroy) has no
    port counterpart (no native/ runtime: Queue C 33, 37); its wrapper kind
    names the port's Scheduler and TPUClient, and the port's BlockAllocator
    (a Python ledger) is no wrapper."""
    kinds = {s.kind: s for s in RESOURCES}
    assert "native-handle" not in kinds and "native-wrapper" not in kinds
    assert kinds["wrapper"].acquire == frozenset({"Scheduler", "TPUClient"})
    src = ("def make():\n"
           "    h = gofr_ba_create(4, 4)\n"
           "    return 1\n")
    ref = jrun_rules([materialize(tmp_path / "ref", {"gofr_tpu/svc/a.py": src})],
                     jleakcheck.leakcheck_rules())
    port = run_rules([materialize(tmp_path / "port", {"gofr_tpu_torch/svc/a.py": src})],
                     leakcheck_rules())
    assert pairs(ref) == [("leak-unreleased", 2)] and port == []


# ------------------------------------------------------------- the port's tree
def test_port_tree_clean():
    findings = run_rules(PORT_TREE, leakcheck_rules())
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_quarantine_leaks_are_declared_transfers():
    for rel in ("gofr_tpu_torch/serving/scheduler.py", "gofr_tpu_torch/serving/kv_cache.py"):
        with open(os.path.join(REPO_ROOT, rel), encoding="utf-8") as fp:
            marks, bad = parse_transfer_annotations(fp.read(), rel)
        assert bad == [] and "quarantine" in marks.values(), rel


def test_resource_table_names_the_port_sites():
    table = build_resource_table(PORT_TREE)
    assert {"leak": "quarantine"}.items() <= table["transfer_methods"].items()
    kv = table["kinds"]["kv-slot"]
    assert any(s.startswith("gofr_tpu_torch/serving/engine.py:") for s in kv["acquire_sites"])
    assert any(s.startswith("gofr_tpu_torch/serving/engine.py:") for s in kv["release_sites"])
    assert table["kinds"]["wrapper"]["acquire_methods"] == ["Scheduler", "TPUClient"]
    assert table["kinds"]["wrapper"]["acquire_sites"]  # the engine builds its Scheduler


def test_check_coverage_divergences():
    table = build_resource_table(PORT_TREE)
    runtime = {"events": [
        {"kind": "kv-slot", "op": "acquire", "name": "alloc_slot"},
        {"kind": "wrapper", "op": "release", "name": "leak"},  # a declared transfer
        {"kind": "mystery", "op": "acquire", "name": "x"},
        {"kind": "kv-slot", "op": "release", "name": "drop_slot"},
    ]}
    div = check_coverage(runtime, table)
    assert len(div) == 2
    assert any("unknown resource kind 'mystery'" in d for d in div)
    assert any("'drop_slot'" in d for d in div)


# ------------------------------------------------------------------ leaktrace
def test_install_guard_and_exact_uninstall():
    from gofr_tpu_torch.serving.block_alloc import BlockAllocator
    from gofr_tpu_torch.serving.scheduler import Scheduler

    originals = (BlockAllocator.alloc, Scheduler.close, Scheduler.__init__)
    mon = leaktrace.install()
    try:
        with pytest.raises(leaktrace.LeakTraceError):
            leaktrace.install()
        assert BlockAllocator.alloc is not originals[0]
    finally:
        assert leaktrace.uninstall() is mon
    assert (BlockAllocator.alloc, Scheduler.close, Scheduler.__init__) == originals


def test_balance_counts_and_leak_detection():
    from gofr_tpu_torch.serving.block_alloc import BlockAllocator
    from gofr_tpu_torch.serving.scheduler import Scheduler

    mon = leaktrace.install()
    try:
        ba = BlockAllocator(8, 4)
        ba.alloc(7, 4)
        sched = Scheduler(2, 4, 64)
        assert len(mon.unreclaimed()) == 2  # the kv-seq and the wrapper
        with pytest.raises(leaktrace.LeakTraceError):
            mon.check()
        ba.free(7)
        sched.leak()  # the quarantine transfer releases the wrapper
    finally:
        leaktrace.uninstall()
    mon.check()
    assert mon.counts() == {"kv-seq": {"acquire": 1, "release": 1},
                            "wrapper": {"acquire": 1, "release": 1}}
    events = {(e["kind"], e["op"], e["name"]) for e in mon.events()}
    assert ("wrapper", "release", "leak") in events
    assert check_coverage(mon.export(), build_resource_table(PORT_TREE)) == []


def test_export_merges(tmp_path):
    path = str(tmp_path / "leaks.json")
    mon = leaktrace.LeakTraceMonitor()
    mon.on_acquire("kv-slot", "alloc_slot", 1)
    mon.on_release("kv-slot", "free_slot", 1)
    leaktrace.export_to(mon, path)
    mon2 = leaktrace.LeakTraceMonitor()
    mon2.on_acquire("timeline", "begin", 2)
    leaktrace.export_to(mon2, path)
    with open(path, encoding="utf-8") as fp:
        merged = json.load(fp)
    assert {e["kind"] for e in merged["events"]} == {"kv-slot", "timeline"}
    assert len(merged["unreclaimed"]) == 1


# ------------------------------------------------- both packages' engines
def _wait_idle(engine, timeout=20.0):
    t_end = time.monotonic() + timeout
    while (any(s is not None for s in engine.slots) or engine._by_id) \
            and time.monotonic() < t_end:
        time.sleep(0.005)


def _scenario(engine, errors_mod) -> dict:
    """Three submits, one cancel of a queued request, one deadline expiry
    while queued, then stop. Returns each request's outcome."""
    long_prompt = list(range(3, 60))
    futs = [engine.submit(list(range(3, 3 + n)), max_new_tokens=6) for n in (5, 20, 40)]
    doomed = engine.submit(long_prompt, max_new_tokens=6)
    expired = engine.submit(long_prompt, max_new_tokens=6, deadline=0.001)
    engine.cancel(doomed.request_id)
    time.sleep(0.05)  # the deadline passes while the loop is not started
    engine.start()
    out = {}
    for i, f in enumerate(futs):
        out[i] = f.result(timeout=120).finish_reason
    for name, f in (("cancel", doomed), ("deadline", expired)):
        try:
            out[name] = f.result(timeout=120).finish_reason
        except errors_mod.HTTPError as exc:
            out[name] = exc.status_code
    _wait_idle(engine)
    engine.stop()
    return out


def _count_acquires(mon) -> dict:
    counts: dict = {}
    real = mon.on_acquire

    def counting(kind, name, key):
        counts[kind] = counts.get(kind, 0) + 1
        return real(kind, name, key)

    mon.on_acquire = counting
    return counts


def test_engines_balance_with_equal_counts(monkeypatch):
    from gofr_tpu.analysis import leaktrace as jleaktrace
    from gofr_tpu.http import errors as jerrors
    from gofr_tpu.models import llama as jllama
    from gofr_tpu.native import runtime as jruntime
    from gofr_tpu.serving import ByteTokenizer as JByteTokenizer
    from gofr_tpu.serving import EngineConfig as JEngineConfig
    from gofr_tpu.serving import ServingEngine as JServingEngine
    from gofr_tpu_torch import errors as terrors
    from gofr_tpu_torch.models import llama as tllama
    from gofr_tpu_torch.models.convert import params_from_jax
    from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    monkeypatch.setattr(jruntime, "load_runtime", lambda: None)  # Queue C 14
    conf = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32, 64),
                prefill_chunk_tokens=16, kv_page_size=8, max_queue=16,
                kv_layout="paged", kv_dtype="bf16")
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")

    results, counts, monitors = {}, {}, {}
    for label, tracer, build, errs in (
        ("ref", jleaktrace, lambda: JServingEngine(jcfg, jparams, JEngineConfig(**conf),
                                                   JByteTokenizer()), jerrors),
        ("port", leaktrace, lambda: ServingEngine(tcfg, tparams, EngineConfig(**conf),
                                                  ByteTokenizer(), device="cpu"), terrors),
    ):
        mon = tracer.install()
        counts[label] = _count_acquires(mon)
        try:
            results[label] = _scenario(build(), errs)
        finally:
            tracer.uninstall()
        monitors[label] = mon
    assert results["ref"] == results["port"], results
    assert results["port"]["deadline"] == 504 and results["port"]["cancel"] == "cancel"
    for label, mon in monitors.items():
        mon.check()  # nothing live after stop
    for kind in ("kv-slot", "timeline"):
        assert counts["ref"].get(kind) == counts["port"].get(kind), counts
        assert counts["port"].get(kind), counts
    assert check_coverage(monitors["port"].export(), build_resource_table(PORT_TREE)) == []
