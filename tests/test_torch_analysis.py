"""The port's gofrlint core (``gofr_tpu_torch/analysis``) against the JAX
package's (``gofr_tpu/analysis``):

- every fixture tree of the reference's own rule tests
  (``tests/test_analysis.py``, ``tests/test_lockcheck.py``) for the
  backend-neutral families (blocking calls, metrics, daemon loops, manual
  settles, router retries, suppressions, lock order, hold-and-block,
  guarded-by) is linted by both analyzers — the port's over the same tree
  under ``gofr_tpu_torch/`` — with the same rule ids, lines and messages
  (paths read ``gofr_tpu/`` on both sides);
- the PyTorch host-sync forms are flagged in a zone and not outside it, and
  a kernel launch whose status never reaches ``_build.check`` is flagged;
- the FFI cross-check is clean on the tree, and a copy of a ``.cu`` with an
  argument dropped, retyped or renamed away (under ``tmp_path``) is caught;
- ``python -m gofr_tpu_torch.analysis --all`` exits 0 on the tree; the
  baseline, JSON and SARIF behave, and the leak, deadline and kernel table
  flags and ``--chaos-coverage`` each round-trip; the stale-suppression
  audit covers every rule id, and the ``cancel-unreachable`` suppressions
  are each hit;
- a forced AB/BA in two threads is a cycle in both packages' lock-order
  monitors; a tiny CPU engine run under the port's shim gives a runtime
  graph that ``check_subgraph`` accepts against the static graph.

With ``GOFR_LOCK_ORDER=1`` (the reference's switch) this file's tests run
under the port's lock-order shim too (a module fixture), and any cycle the
shim saw fails the module."""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import pytest

from gofr_tpu.analysis import lockorder as r_lockorder
from gofr_tpu.analysis.core import run_rules as r_run_rules
from gofr_tpu.analysis.rules import default_rules as r_default_rules
from gofr_tpu_torch.analysis import baseline_io, lockorder
from gofr_tpu_torch.analysis.core import run_rules, run_unified
from gofr_tpu_torch.analysis.ffi import check_ffi
from gofr_tpu_torch.analysis.lockcheck import build_static_graph, check_subgraph
from gofr_tpu_torch.analysis.rules import default_rules

ROOT = Path(__file__).resolve().parents[1]
TARGETS = [str(ROOT / t) for t in ("gofr_tpu_torch", "chip_smoke.py", "tools_torch",
                                   "examples_torch")]


@pytest.fixture(autouse=True, scope="module")
def _port_lock_order_tier():
    """The reference's ``GOFR_LOCK_ORDER=1`` switch, for the port: this
    module's tests run under the port's shim and fail on a cycle."""
    if os.environ.get("GOFR_LOCK_ORDER") != "1":
        yield
        return
    mon = lockorder.install()
    try:
        yield
    finally:
        lockorder.uninstall()
    mon.check()


# ------------------------------------------------------- reference fixtures
# the reference's rule tests whose trees exercise a backend-specific rule
# (JAX host syncs, libtpu's ctypes layer, native/'s FFI) or no tree at all
_SPECIFIC = ("host_sync", "ctypes", "ffi", "real_tree", "cli", "chaos", "engine_locks",
             "lockorder_monitor", "runtime_graph", "check_lock_graph", "check_subgraph",
             "stale_suppression_real", "rlock_reentrancy_no_self", "stdlib_primitives")


def _load_reference_tests(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TESTS = {name: _load_reference_tests(name) for name in ("test_analysis", "test_lockcheck")}
FIXTURE_CASES = sorted(
    (mod_name, fn_name)
    for mod_name, mod in REF_TESTS.items()
    for fn_name, fn in vars(mod).items()
    if fn_name.startswith("test_") and callable(fn) and "lint_tree(" in inspect.getsource(fn)
    and not any(tag in fn_name for tag in _SPECIFIC)
)


def _normalize(findings) -> list[tuple]:
    def norm(text: str) -> str:
        return text.replace("gofr_tpu_torch/", "gofr_tpu/")

    return [(f.rule, norm(f.path), f.line, norm(f.message)) for f in findings]


@pytest.mark.parametrize("case", FIXTURE_CASES, ids=[f"{m}::{f}" for m, f in FIXTURE_CASES])
def test_reference_fixture_trees_lint_alike(case, tmp_path, monkeypatch):
    """Run the reference test as written (its own assertions hold on the
    reference's findings); every tree it lints is also linted by the port
    under ``gofr_tpu_torch/``, and the two finding lists must be equal."""
    mod_name, fn_name = case
    mod = REF_TESTS[mod_name]
    compared: list = []

    def lint_both(path, files):
        for rel, source in files.items():
            for root, prefix in ((Path(path), "gofr_tpu/"), (tmp_path / "_port", "gofr_tpu_torch/")):
                target = root / (prefix + rel[len("gofr_tpu/"):] if rel.startswith("gofr_tpu/")
                                 else rel)
                target.parent.mkdir(parents=True, exist_ok=True)
                target.write_text(source)
        top = sorted(files)[0].split("/")[0]
        ref = r_run_rules([str(Path(path) / top)], r_default_rules())
        port_top = "gofr_tpu_torch" if top == "gofr_tpu" else top
        port = run_rules([str(tmp_path / "_port" / port_top)], default_rules())
        compared.append((_normalize(ref), _normalize(port)))
        shutil.rmtree(tmp_path / "_port")
        return ref

    monkeypatch.setattr(mod, "lint_tree", lint_both)
    fn = getattr(mod, fn_name)
    params = inspect.signature(fn).parameters
    kwargs = {"tmp_path": tmp_path / "ref"} if "tmp_path" in params else {}
    (tmp_path / "ref").mkdir()
    fn(**kwargs)
    assert compared, f"{fn_name} linted no tree"
    for ref, port in compared:
        assert port == ref


def test_fixture_cases_cover_every_neutral_family():
    names = " ".join(f for _, f in FIXTURE_CASES)
    for family in ("blocking_call", "metric", "daemon", "settle", "router_retry",
                   "lock_order", "hold_and_block", "guarded_by", "suppression"):
        assert family in names, family
    assert len(FIXTURE_CASES) >= 50


# ------------------------------------------------------- PyTorch host syncs
def _lint(tmp_path, files: dict[str, str]):
    """Every rule but kernelcheck's: its unpack-site rule reads a fixture
    ``_consume`` of ``serving/engine.py`` as the engine's packed-column
    unpack site (tests/test_torch_kernelcheck.py holds that family)."""
    from gofr_tpu_torch.analysis.kernelcheck import kernelcheck_rules

    for rel, source in files.items():
        full = tmp_path / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(source)
    kernel_rules = {r.name for r in kernelcheck_rules()}
    return run_rules([str(tmp_path / "gofr_tpu_torch")],
                     [r for r in default_rules() if r.name not in kernel_rules])


HOST_SYNC_FORMS = {
    "item": "    return x.item()\n",
    "cpu": "    return x.cpu()\n",
    "tolist": "    return x.tolist()\n",
    "numpy": "    return x.numpy()\n",
    "synchronize": "    torch.cuda.synchronize()\n",
    "stream_sync": "    torch.cuda.current_stream().synchronize()\n",
    "int_of_device": "    y = torch.argmax(x)\n    return int(y)\n",
    "float_of_method": "    y = torch.zeros(2)\n    z = y.sum()\n    return float(z)\n",
    "bool_truth": "    ok = torch.isfinite(x).all()\n    if ok:\n        return 1\n",
    "compare_truth": "    packed = batch_ops.decode_block(x)\n    while packed[0, 0] == 3:\n        break\n",
    "not_truth": "    done = torch.zeros(1)\n    return not done\n",
    "suffix_attr": "    return 1 if self.seq_dev else 0\n",
    "assert_truth": "    m = llama.forward(x)\n    assert m.any()\n",
}


@pytest.mark.parametrize("form", sorted(HOST_SYNC_FORMS))
def test_pytorch_host_sync_forms_flagged_in_zone_not_outside(form, tmp_path):
    body = HOST_SYNC_FORMS[form]
    src = ("import torch\nfrom gofr_tpu_torch.models import llama\n"
           "from gofr_tpu_torch.serving import batch as batch_ops\n\n"
           f"def _dispatch(self, x):\n{body}")
    inside = _lint(tmp_path / "in", {"gofr_tpu_torch/serving/engine.py": src})
    assert [f.rule for f in inside] == ["host-sync"], inside
    assert inside[0].line >= 6
    # a function of engine.py off the engine thread, and a file outside the zone
    off = _lint(tmp_path / "off", {"gofr_tpu_torch/serving/engine.py":
                                   src.replace("def _dispatch(", "def submit(")})
    outside = _lint(tmp_path / "out", {"gofr_tpu_torch/serving/other.py": src})
    assert off == [] and outside == []
    # batch.py is a zone whole
    whole = _lint(tmp_path / "batch", {"gofr_tpu_torch/serving/batch.py": src})
    assert [f.rule for f in whole] == ["host-sync"]


def test_host_sync_clean_forms(tmp_path):
    """Metadata reads, identity tests, host values after the sanctioned
    read, closures and an annotated sync point are clean."""
    src = (
        "import torch\nimport numpy as np\n\n"
        "def _block_sync(packed):\n"
        "    # gofrlint: disable=host-sync -- the one sanctioned read\n"
        "    return packed.cpu().numpy()\n\n"
        "def _consume(self, rec):\n"
        "    host = _block_sync(rec.packed)\n"
        "    n = int(host[0, 0])\n"
        "    y = torch.zeros(4)\n"
        "    if y.shape[0] == 4 and y is not None and y.dtype == torch.int32:\n"
        "        n += int(y.shape[0]) + len(y)\n"
        "    if self.cache_len[0] > 0:\n"
        "        n += 1\n"
        "    def later():\n"
        "        return y.item()\n"
        "    return n, later\n"
    )
    assert _lint(tmp_path, {"gofr_tpu_torch/serving/engine.py": src}) == []


def test_kernel_launch_status_must_reach_check(tmp_path):
    src = (
        "from gofr_tpu_torch import _build\n\n"
        "def checked(q):\n"
        "    status = _build.library('flash_attention').gofr_flash_attention_bf16(q)\n"
        "    _build.check(status, 'flash_attention')\n\n"
        "def wrapped(q):\n"
        "    lib = _build.library('paged_attention')\n"
        "    _build.check(lib.gofr_paged_decode_bf16(q), 'paged')\n\n"
        "def returned(q):\n"
        "    return _build.library('paged_attention').gofr_paged_decode_int8(q)\n\n"
        "def discarded(q):\n"
        "    _build.library('flash_attention').gofr_flash_attention_bf16(q)\n\n"
        "def never_checked(q):\n"
        "    lib = _build.library('paged_attention')\n"
        "    status = lib.gofr_paged_decode_int8(q)\n"
        "    return q\n"
    )
    findings = _lint(tmp_path, {"gofr_tpu_torch/ops/k.py": src})
    assert [(f.rule, f.line) for f in findings] == [("ctypes-unchecked", 15),
                                                   ("ctypes-unchecked", 19)]
    assert "gofr_flash_attention_bf16(): kernel launch status discarded" in findings[0].message


# ------------------------------------------------------- FFI
def _copy_ffi_tree(tmp_path) -> Path:
    root = tmp_path / "repo"
    (root / "gofr_tpu_torch").mkdir(parents=True)
    shutil.copy(ROOT / "gofr_tpu_torch" / "_build.py", root / "gofr_tpu_torch" / "_build.py")
    shutil.copytree(ROOT / "gofr_tpu_torch" / "csrc", root / "gofr_tpu_torch" / "csrc")
    return root


def test_ffi_clean_on_the_tree():
    assert check_ffi(str(ROOT)) == []


def test_ffi_clean_on_a_pristine_copy(tmp_path):
    assert check_ffi(str(_copy_ffi_tree(tmp_path))) == []


DRIFTS = {
    # the scale dropped from the flash entry's C signature
    "dropped": ("flash_attention.cu", "int Hkv, int D, float scale,", "int Hkv, int D,",
                "ffi-mismatch", "gofr_flash_attention_bf16: 14 argtypes"),
    # page retyped to float in the bf16 paged entry
    "retyped": ("paged_attention.cu", "int Hkv, int Dh, int page, int n_pool_pages,\n"
                "                                      int max_pages, int pps, float scale, "
                "void* stream) {\n  return launch<uint16_t>",
                "int Hkv, int Dh, float page, int n_pool_pages,\n"
                "                                      int max_pages, int pps, float scale, "
                "void* stream) {\n  return launch<uint16_t>", "ffi-mismatch",
                "gofr_paged_decode_bf16: 18 argtypes"),
    # the int8 entry renamed: a binding with no C symbol, a symbol with no binding
    "renamed": ("paged_attention.cu", "extern \"C\" int gofr_paged_decode_int8(",
                "extern \"C\" int gofr_paged_decode_i8(", "ffi-stale", "gofr_paged_decode_int8"),
    # the return type changed from the cudaError_t int
    "restype": ("flash_attention.cu", "extern \"C\" int gofr_flash_attention_bf16(",
                "extern \"C\" void* gofr_flash_attention_bf16(", "ffi-mismatch",
                "returns ptr, but ctypes reads i32"),
}


@pytest.mark.parametrize("drift", sorted(DRIFTS))
def test_ffi_catches_a_drifted_copy(drift, tmp_path):
    root = _copy_ffi_tree(tmp_path)
    fname, old, new, rule, text = DRIFTS[drift]
    path = root / "gofr_tpu_torch" / "csrc" / fname
    source = path.read_text()
    assert old in source
    path.write_text(source.replace(old, new, 1))
    findings = check_ffi(str(root))
    assert any(f.rule == rule and text in f.message for f in findings), findings
    if drift == "renamed":
        assert {f.rule for f in findings} == {"ffi-stale", "ffi-unbound"}


def test_ffi_catches_a_binding_edit(tmp_path):
    root = _copy_ffi_tree(tmp_path)
    build = root / "gofr_tpu_torch" / "_build.py"
    src = build.read_text()
    old = "[_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]"
    assert old in src
    build.write_text(src.replace(old, "[_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]"))
    findings = check_ffi(str(root))
    assert [f.rule for f in findings] == ["ffi-mismatch"]
    assert findings[0].path == "gofr_tpu_torch/_build.py"


# ------------------------------------------------------- the CLI and the tree
def test_cli_all_is_clean_on_the_tree():
    proc = subprocess.run([sys.executable, "-m", "gofr_tpu_torch.analysis", "--all"], cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "gofrlint: clean" in proc.stdout


def test_tree_has_no_finding_without_the_baseline():
    """The port's tree is clean with no baseline at all: every finding is
    fixed or suppressed with a reason (the baseline records none)."""
    live, stale = run_unified(TARGETS, default_rules())
    assert live == [] and stale == []
    assert check_ffi(str(ROOT)) == []
    assert baseline_io.load_baseline(baseline_io.default_baseline_path()) == {}


def test_cli_formats_baseline_and_refusals(tmp_path, capsys):
    """The CLI in process: JSON ids, SARIF, the ratchet baseline, the
    stale-suppression audit, ``--ffi``, ``--lock-graph``, and the flags
    once refused (the leak, deadline and kernel tables, chaos coverage),
    each with its table and its check of an export."""
    from gofr_tpu_torch.analysis.__main__ import main

    def run(*args):
        capsys.readouterr()
        rc = main(list(args))
        out = capsys.readouterr()
        return rc, out.out, out.err

    pkg = tmp_path / "gofr_tpu_torch" / "http"
    pkg.mkdir(parents=True)
    (pkg / "dispatch.py").write_text("import time\n\ndef handle():\n    time.sleep(1)\n")
    target = str(tmp_path / "gofr_tpu_torch")
    rc, out, _ = run("--no-ffi", "--no-baseline", "--format", "json", target)
    data = json.loads(out)
    assert rc == 1 and [f["rule"] for f in data["findings"]] == ["blocking-call"]
    assert data["findings"][0]["id"].startswith("blocking-call-")
    rc, out, _ = run("--no-ffi", "--no-baseline", "--format", "sarif", target)
    sarif = json.loads(out)
    assert rc == 1 and sarif["version"] == "2.1.0"
    assert sarif["runs"][0]["results"][0]["ruleId"] == "blocking-call"
    baseline = tmp_path / "baseline.json"
    assert run("--no-ffi", "--baseline", str(baseline), "--update-baseline", target)[0] == 0
    assert baseline_io.load_baseline(str(baseline)) == {
        "blocking-call|gofr_tpu_torch/http/dispatch.py|time.sleep(): blocking call in a "
        "handler-dispatch/decode-loop zone": 1}
    assert run("--no-ffi", "--baseline", str(baseline), target)[0] == 0
    (pkg / "dispatch.py").write_text("import time\n\ndef handle():\n    time.sleep(1)\n"
                                     "    time.sleep(2)\n")
    assert run("--no-ffi", "--baseline", str(baseline), target)[0] == 1
    (pkg / "dispatch.py").write_text(
        "def handle():\n    return 1  # gofrlint: disable=blocking-call -- nothing here\n")
    rc, out, _ = run("--all", "--no-ffi", "--no-baseline", target)
    assert rc == 1 and "stale-suppression" in out
    rc, out, _ = run("--check-suppressions", target)
    assert rc == 1 and "stale-suppression" in out
    assert run("--ffi", "--repo-root", str(ROOT))[0] == 0
    rc, out, _ = run("--lock-graph", str(ROOT / "gofr_tpu_torch"))
    graph = json.loads(out)
    assert rc == 0 and graph["nodes"] and graph["version"] == 1
    exported = tmp_path / "runtime.json"
    exported.write_text(json.dumps({"version": 1, "nodes": [], "edges": []}))
    assert run("--check-lock-graph", str(exported), str(ROOT / "gofr_tpu_torch"))[0] == 0
    # the flags once refused (leakcheck, deadlinecheck, the kernel table,
    # chaoscov) each round-trip: a table out, an export checked against it
    tree = str(ROOT / "gofr_tpu_torch")
    rc, out, _ = run("--leak-table", tree)
    assert rc == 0 and "wrapper" in json.loads(out)["kinds"]
    leaks = tmp_path / "leaks.json"
    leaks.write_text(json.dumps({"events": [
        {"kind": "kv-slot", "op": "acquire", "name": "alloc_slot"},
        {"kind": "wrapper", "op": "release", "name": "leak"}], "unreclaimed": []}))
    assert run("--check-leak-table", str(leaks), tree)[0] == 0
    leaks.write_text(json.dumps({"events": [], "unreclaimed": ["kv-slot ... never released"]}))
    assert run("--check-leak-table", str(leaks), tree)[0] == 1
    rc, out, _ = run("--deadline-table", tree)
    assert rc == 0 and "Router.submit" in json.loads(out)["sites"]
    crossings = tmp_path / "deadline.json"
    crossings.write_text(json.dumps({"events": [{"site": "Router.submit", "op": "crossing"}],
                                     "violations": []}))
    assert run("--check-deadline-table", str(crossings), tree)[0] == 0
    crossings.write_text(json.dumps({"events": [{"site": "Mystery.hop", "op": "crossing"}],
                                     "violations": []}))
    assert run("--check-deadline-table", str(crossings), tree)[0] == 1
    rc, out, _ = run("--kernel-table")
    assert rc == 0 and len(json.loads(out)["kernels"]) == 20
    kernels = tmp_path / "kernels.json"
    kernels.write_text(json.dumps({"mode": "observed", "cases": [], "violations": []}))
    assert run("--check-kernel-table", str(kernels))[0] == 0
    kernels.write_text(json.dumps({"mode": "observed", "cases": [], "violations": ["x"]}))
    assert run("--check-kernel-table", str(kernels))[0] == 1
    assert run("--check-kernel-table", str(tmp_path / "missing.json"))[0] == 2
    rc, out, _ = run("--chaos-coverage", "--repo-root", str(ROOT))
    assert rc == 0 and json.loads(out)["missing"] == []


def test_pending_rules_are_the_five_that_wait_for_the_mesh():
    """None waits any more: shardcheck's four rules and kernelcheck's
    spec-rank-mismatch run in the port (ROADMAP Queue A item 16), the
    stale-suppression audit covers every id, and the port's rules are the
    reference's rule ids less the ones no AST rule raises (the metric
    catalog's, the FFI check's, the audit's and the parser's)."""
    from gofr_tpu.analysis.sarif import RULE_DESCRIPTIONS as R_RULES
    from gofr_tpu_torch.analysis import core
    from gofr_tpu_torch.analysis.sarif import RULE_DESCRIPTIONS

    assert not hasattr(core, "PENDING_RULES")
    assert set(R_RULES) <= set(RULE_DESCRIPTIONS)
    assert {r.name for r in default_rules()} == set(R_RULES) - {
        "metric-register-site", "metric-never-emitted", "metric-dynamic-name",
        "metric-label-cardinality", "ffi-mismatch", "ffi-unbound", "ffi-stale",
        "stale-suppression", "bad-suppression", "syntax-error", "bad-transfer-annotation"}


def test_cancel_unreachable_suppressions_count_as_used():
    """The port's cancel-unreachable suppressions (the SQL pool's three
    checkouts, the sqlite connection lock) are each hit by the rule on the
    raw view: the audit would call an unused one stale."""
    from gofr_tpu_torch.analysis.core import SourceFile
    from gofr_tpu_torch.analysis.deadlinecheck import CancelUnreachableRule

    sites = set()
    for rel in ("gofr_tpu_torch/datasource/sql/base.py", "gofr_tpu_torch/datasource/sql/sqlite.py"):
        sf = SourceFile(str(ROOT / rel), rel, (ROOT / rel).read_text())
        for rec in sf.suppression_records:
            if "cancel-unreachable" in rec.rules:
                sites.add((rel, rec.line, rec.covered))
    assert len(sites) == 4
    raw = [f for f in run_rules(TARGETS, [CancelUnreachableRule()], honor_suppressions=False)]
    for rel, line, covered in sites:
        assert any(f.path == rel and f.line in covered for f in raw), (rel, line)
    live, stale = run_unified(TARGETS, default_rules())
    assert not [f for f in stale if f.path.startswith("gofr_tpu_torch/datasource/sql/")]


def test_zone_tables_name_the_ports_files_and_functions():
    import ast

    from gofr_tpu_torch.analysis import rules

    for table in (rules.DISPATCH_ZONES, rules.BACKOFF_ZONES, rules.HOT_SYNC_ZONES,
                  rules.ROUTER_RETRY_ZONES):
        for rel, funcs in table.items():
            path = ROOT / rel
            assert path.is_file(), rel
            if funcs == "*":
                continue
            tree = ast.parse(path.read_text())
            have = {n.name for n in ast.walk(tree)
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            assert funcs <= have, (rel, sorted(funcs - have))


# ------------------------------------------------------- lock order
@pytest.mark.parametrize("side", ["ref", "port"])
def test_forced_ab_ba_is_a_cycle_in_both_monitors(side):
    mod = {"ref": r_lockorder, "port": lockorder}[side]
    mon = mod.LockOrderMonitor()
    a = mon.make_lock()
    b = mon.make_lock()  # a site of its own: the export keys locks by creation line

    def ab():
        with a, b:
            pass

    def ba():
        with b, a:
            pass

    for fn in (ab, ba):  # one after the other: the order is recorded, nothing deadlocks
        t = threading.Thread(target=fn)
        t.start()
        t.join(10)
    cycles = mon.cycles()
    assert len(cycles) == 1 and len(cycles[0]) == 3
    with pytest.raises(mod.LockOrderError):
        mon.check()
    exported = mon.export_graph()
    assert len(exported["edges"]) == 2


def test_port_monitor_agrees_with_the_reference_on_nesting():
    """The same acquisition orders through both monitors give the same
    cycle count and the same site graph (sites anchored per package)."""
    def drive(mod):
        mon = mod.LockOrderMonitor()
        locks = [mon.make_lock(), mon.make_lock(), mon.make_lock(), mon.make_lock()]
        r = mon.make_rlock()
        orders = [(0, 1), (1, 2), (2, 3), (0, 3), (3, 0)]
        for i, j in orders:
            with locks[i], locks[j]:
                with r, r:
                    pass
        return len(mon.cycles()), len(mon.export_graph()["edges"])

    assert drive(lockorder) == drive(r_lockorder)


def test_tiny_cpu_engine_runtime_graph_is_a_subgraph_of_the_static_graph():
    import torch

    from gofr_tpu_torch import EngineConfig, ServingEngine
    from gofr_tpu_torch.models.llama import LlamaConfig, init_params
    from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

    torch.set_num_threads(1)
    cfg = LlamaConfig.tiny(max_seq_len=256)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    owns = lockorder._active is None
    mon = lockorder.install() if owns else lockorder._active
    try:
        for layout in ("paged", "dense"):
            eng = ServingEngine(cfg, params, EngineConfig(max_slots=2, max_seq_len=256,
                                                          kv_layout=layout, multi_step=2),
                                ByteTokenizer(cfg.vocab_size), device="cpu")
            eng.start()
            try:
                futs = [eng.submit([5, 6, 7, k], max_new_tokens=4) for k in range(3)]
                for f in futs:
                    f.result(timeout=120)
                long = eng.submit([9] * 8, max_new_tokens=64)
                eng.cancel(long.request_id)  # the cancel path takes its locks too
                long.result(timeout=120)
            finally:
                eng.stop()
    finally:
        if owns:
            lockorder.uninstall()
    runtime = mon.export_graph()
    assert runtime["edges"], "the engine run observed no lock nesting"
    assert mon.cycles() == []
    static = build_static_graph([str(ROOT / "gofr_tpu_torch")])
    assert check_subgraph(runtime, static) == []
