"""``python -m gofr_tpu_torch.analysis`` — run the port's gofrlint.

Exit status 0 when clean, 1 on any unsuppressed (and un-baselined)
finding, 2 on a usage error. With no paths it lints the port's tree:
``gofr_tpu_torch/``, ``chip_smoke.py``, ``tools_torch/`` and
``examples_torch/`` under the repository root.

Modes (the port's copy of ``gofr_tpu/analysis/__main__.py``, for the
families ported so far):

- default: the AST rules (shardcheck's among them) and the FFI
  cross-check, through the ratchet
  baseline (``gofr_tpu_torch/analysis/baseline.json``);
- ``--all``: the same in one shared walk, plus the stale-suppression audit;
- ``--ffi``: only ``csrc/*.cu`` against ``_build.SIGNATURES``;
- ``--check-suppressions``: only the stale-suppression audit;
- ``--lock-graph`` / ``--check-lock-graph PATH``: lockcheck's static graph,
  and a runtime export (``LockOrderMonitor.export_graph``) checked as a
  subgraph of it;
- ``--leak-table`` / ``--check-leak-table PATH``: leakcheck's static
  resource table, and a runtime reclaim export (``leaktrace``) checked
  against it (every observed acquire/release statically known, nothing
  unreclaimed);
- ``--deadline-table`` / ``--check-deadline-table PATH``: deadlinecheck's
  static boundary table, and a runtime export (``deadlinetrace``) checked
  against it (every crossing statically known, no budget violation);
- ``--kernel-table`` / ``--check-kernel-table PATH``: the committed kernel
  contract table, and a runtime export (``kerneltrace``: the CPU matrix
  or a live-engine observer) checked against it;
- ``--chaos-coverage``: every registered chaos point scheduled by a test
  of the port's chaos tier (JSON; exit 1 when one is missing);
- ``--update-baseline``, ``--no-baseline``, ``--format text|json|sarif``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gofr_tpu_torch.analysis import baseline_io
from gofr_tpu_torch.analysis.core import iter_python_files, run_rules, run_unified
from gofr_tpu_torch.analysis.ffi import check_ffi
from gofr_tpu_torch.analysis.rules import default_rules
from gofr_tpu_torch.analysis.sarif import RULE_DESCRIPTIONS, render_sarif

# the tree the analyzer covers, relative to the repository root
DEFAULT_TARGETS = ("gofr_tpu_torch", "chip_smoke.py", "tools_torch", "examples_torch")

FFI_RULES = {"ffi-mismatch", "ffi-unbound", "ffi-stale", "ffi-layout"}


def _default_repo_root() -> str:
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def default_paths(repo_root: str) -> list[str]:
    return [os.path.join(repo_root, t) for t in DEFAULT_TARGETS
            if os.path.exists(os.path.join(repo_root, t))]


def _emit(findings: list, fmt: str) -> None:
    if fmt == "sarif":
        print(render_sarif(findings))
    elif fmt == "json":
        print(baseline_io.render_json(findings))
    else:
        for f in findings:
            print(f.render())


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m gofr_tpu_torch.analysis",
        description="gofrlint over the PyTorch port: AST rules, shardcheck, lockcheck, "
        "leakcheck, deadlinecheck, kernelcheck, the stale-suppression audit, "
        "the csrc/ctypes FFI cross-check and chaos coverage",
    )
    parser.add_argument("paths", nargs="*",
                        help="files/directories to lint (default: the port's tree)")
    parser.add_argument("--repo-root", default=None,
                        help="repository root holding gofr_tpu_torch/ (default: inferred)")
    parser.add_argument("--all", action="store_true",
                        help="rules + lockcheck + FFI + the stale-suppression audit "
                        "in one shared walk")
    parser.add_argument("--ffi", "--ffi-only", dest="ffi_only", action="store_true",
                        help="run only the csrc/*.cu vs _build.SIGNATURES check")
    parser.add_argument("--no-ffi", action="store_true", help="skip the FFI check")
    parser.add_argument("--format", choices=("text", "json", "sarif"), default="text")
    parser.add_argument("--baseline", default=None, metavar="PATH",
                        help="ratchet baseline (default: gofr_tpu_torch/analysis/baseline.json)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the ratchet baseline: report every finding")
    parser.add_argument("--update-baseline", action="store_true",
                        help="re-record the current findings as the ratchet floor and exit 0")
    parser.add_argument("--check-suppressions", action="store_true",
                        help="stale-suppression audit only")
    parser.add_argument("--lock-graph", action="store_true",
                        help="emit lockcheck's static lock graph as JSON")
    parser.add_argument("--check-lock-graph", metavar="PATH", default=None,
                        help="check a runtime lock graph export is a subgraph of the static one")
    parser.add_argument("--leak-table", action="store_true",
                        help="emit leakcheck's static resource table as JSON")
    parser.add_argument("--check-leak-table", metavar="PATH", default=None,
                        help="check a runtime reclaim export (leaktrace) against "
                        "the static resource table")
    parser.add_argument("--deadline-table", action="store_true",
                        help="emit deadlinecheck's static boundary table as JSON")
    parser.add_argument("--check-deadline-table", metavar="PATH", default=None,
                        help="check a runtime deadline export (deadlinetrace) "
                        "against the static boundary table")
    parser.add_argument("--kernel-table", action="store_true",
                        help="emit the committed kernel contract table as JSON")
    parser.add_argument("--check-kernel-table", metavar="PATH", default=None,
                        help="check a runtime kernel export (kerneltrace: the CPU "
                        "matrix or a live-engine observer) against the contract table")
    parser.add_argument("--chaos-coverage", action="store_true",
                        help="every registered chaos point must be scheduled by a "
                        "test of the port's chaos tier (JSON output)")
    parser.add_argument("--list-rules", action="store_true", help="list rules and exit")
    return parser


def _read_json(path: str, what: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as fp:
            return json.load(fp)
    except (OSError, ValueError) as exc:
        print(f"error: cannot read {what} {path}: {exc}", file=sys.stderr)
        return None


def _tables(args: argparse.Namespace, paths: list[str]) -> int | None:
    """The table modes: emit a static table, or check a runtime export
    against it. None when no table flag was given."""
    if args.leak_table or args.check_leak_table:
        from gofr_tpu_torch.analysis.leakcheck import (
            build_resource_table,
            check_coverage,
            render_table_json,
        )

        table = build_resource_table(paths)
        if args.leak_table:
            print(render_table_json(table))
            return 0
        runtime = _read_json(args.check_leak_table, "runtime reclaim export")
        if runtime is None:
            return 2
        divergences = check_coverage(runtime, table)
        for d in divergences:
            print(d)
        unreclaimed = runtime.get("unreclaimed", [])
        for u in unreclaimed:
            print(f"unreclaimed at runtime: {u}")
        if divergences or unreclaimed:
            print(f"leakcheck: {len(divergences)} coverage divergence(s), "
                  f"{len(unreclaimed)} unreclaimed resource(s) — analyzer blind "
                  "spot or a real runtime leak", file=sys.stderr)
            return 1
        print(f"leakcheck: runtime pairs covered by the static table "
              f"({len(runtime.get('events', []))} observed event(s) checked)")
        return 0
    if args.deadline_table or args.check_deadline_table:
        from gofr_tpu_torch.analysis.deadlinecheck import (
            build_boundary_table,
            check_deadline_coverage,
            render_table_json,
        )

        table = build_boundary_table(paths)
        if args.deadline_table:
            print(render_table_json(table))
            return 0
        runtime = _read_json(args.check_deadline_table, "runtime deadline export")
        if runtime is None:
            return 2
        divergences = check_deadline_coverage(runtime, table)
        for d in divergences:
            print(d)
        if divergences:
            print(f"deadlinecheck: {len(divergences)} divergence(s) — analyzer "
                  "blind spot or a runtime budget violation", file=sys.stderr)
            return 1
        print(f"deadlinecheck: runtime crossings covered by the static boundary "
              f"table ({len(runtime.get('events', []))} observed crossing(s) checked)")
        return 0
    if args.kernel_table:
        from gofr_tpu_torch.analysis.kernel_contracts import render_table_json

        print(render_table_json())
        return 0
    if args.check_kernel_table:
        from gofr_tpu_torch.analysis.kernelcheck import check_kernel_table

        runtime = _read_json(args.check_kernel_table, "runtime kernel export")
        if runtime is None:
            return 2
        divergences = check_kernel_table(runtime)
        for d in divergences:
            print(d)
        if divergences:
            print(f"kernelcheck: {len(divergences)} static<->runtime divergence(s) — "
                  "the contract table and the observed kernels disagree",
                  file=sys.stderr)
            return 1
        print(f"kernelcheck: runtime signatures match the contract table "
              f"({len(runtime.get('cases', []))} case(s) checked, mode "
              f"{runtime.get('mode', '?')})")
        return 0
    return None


def _list_rules() -> None:
    from gofr_tpu_torch.analysis import deadlinecheck as dc
    from gofr_tpu_torch.analysis import kernel_contracts as kctab
    from gofr_tpu_torch.analysis import kernelcheck as kch
    from gofr_tpu_torch.analysis import leakcheck as lk
    from gofr_tpu_torch.analysis import rules as rules_mod
    from gofr_tpu_torch.analysis import shardcheck as sc

    for rule in sorted(RULE_DESCRIPTIONS):
        print(f"{rule:<25} {RULE_DESCRIPTIONS[rule]}")
    print()
    print("dispatch zones:", ", ".join(sorted(rules_mod.DISPATCH_ZONES)))
    print("backoff zones: ", ", ".join(sorted(rules_mod.BACKOFF_ZONES)))
    print("host-sync zones:", ", ".join(sorted(rules_mod.HOT_SYNC_ZONES)))
    print("retrace zones: ", ", ".join(sorted(sc.RETRACE_ZONE_FILES + sc.RETRACE_ZONE_DIRS)))
    print("retire-gate zones:", ", ".join(sorted(lk.RETIRE_GATE_ZONES)))
    print("deadline entry roots:", ", ".join(sorted(
        dc.ENTRY_FUNC_NAMES | {f"{c}.*" for c in dc.ENTRY_CLASSES} | set(dc.ENTRY_FILES)
    )))
    print("deadline boundaries:", ", ".join(sorted(
        {f"{c}.{m}" for c, ms in dc.BOUNDARY_CLASSES.items() for m in ms}
        | dc.BOUNDARY_FUNCS
    )))
    print("kernel contract files:", ", ".join(kctab.KERNEL_FILES))
    print("kernel contracts:", ", ".join(k.name for k in kctab.KERNELS))
    print("kernel unpack sites:", ", ".join(
        f"{u.function} (layout {u.layout})" for u in kctab.UNPACK_SITES))
    print("dtype hot zones:   engine." + ", engine.".join(sorted(kch.ENGINE_HOT_FUNCS)))


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0

    repo_root = args.repo_root or _default_repo_root()
    if args.chaos_coverage:
        from gofr_tpu_torch.analysis.chaoscov import check_chaos_coverage

        report = check_chaos_coverage(repo_root)
        print(json.dumps(report, indent=2))
        if report["missing"]:
            print(f"chaoscov: {len(report['missing'])} chaos point(s) scheduled by "
                  f"no chaos-tier test: {report['missing']} — add a fault schedule "
                  "or remove the dead injection point", file=sys.stderr)
            return 1
        return 0
    paths = args.paths or default_paths(repo_root)
    if not args.ffi_only:
        for p in paths:
            if not os.path.exists(p):
                print(f"error: no such path: {p}", file=sys.stderr)
                return 2

    if args.lock_graph or args.check_lock_graph:
        from gofr_tpu_torch.analysis.lockcheck import (
            build_static_graph,
            check_subgraph,
            render_graph_json,
        )

        static = build_static_graph(paths)
        if args.lock_graph:
            print(render_graph_json(static))
            return 0
        try:
            with open(args.check_lock_graph, encoding="utf-8") as fp:
                runtime = json.load(fp)
        except (OSError, ValueError) as exc:
            print(f"error: cannot read runtime lock graph {args.check_lock_graph}: {exc}",
                  file=sys.stderr)
            return 2
        divergences = check_subgraph(runtime, static)
        for d in divergences:
            print(d)
        if divergences:
            print(f"lockcheck: {len(divergences)} runtime edge(s) missing from the "
                  "static graph — analyzer blind spot", file=sys.stderr)
            return 1
        print(f"lockcheck: runtime graph is a subgraph of the static graph "
              f"({len(runtime.get('edges', []))} observed edge(s) checked)")
        return 0

    rc = _tables(args, paths)
    if rc is not None:
        return rc

    if args.check_suppressions:
        from gofr_tpu_torch.analysis.audit import stale_suppressions

        stale = stale_suppressions(paths)
        _emit(stale, args.format)
        if stale and args.format == "text":
            print(f"\ngofrlint: {len(stale)} stale suppression(s) — delete them.",
                  file=sys.stderr)
        if not stale and args.format == "text":
            print("gofrlint: suppressions all live")
        return 1 if stale else 0

    if args.all and args.update_baseline:
        print("error: --update-baseline uses the classic mode (without --all)",
              file=sys.stderr)
        return 2

    findings: list = []
    stale: list = []
    if args.all:
        findings, stale = run_unified(paths, default_rules())
    elif not args.ffi_only:
        findings = run_rules(paths, default_rules())
    ffi_ran = not args.no_ffi
    if ffi_ran:
        findings.extend(check_ffi(repo_root))

    baseline_path = args.baseline or baseline_io.default_baseline_path()
    if args.update_baseline:
        # a partial run must not erase entries for files and rules it
        # never looked at
        preserved: dict[str, int] = {}
        old = baseline_io.load_baseline(baseline_path)
        if old:
            linted = {rel for _, rel in iter_python_files(paths)} if not args.ffi_only else set()
            full_tree = any(os.path.isdir(p) for p in paths) and not args.ffi_only
            cross_file_rules = {r.name for r in default_rules() if r.cross_file}
            for key, count in old.items():
                parts = key.split("|", 2)
                if len(parts) != 3:
                    continue  # malformed entry: drop (the ratchet tightens)
                rule, file, _ = parts
                covered = (
                    file in linted and (full_tree or rule not in cross_file_rules)
                ) or (ffi_ran and rule in FFI_RULES)
                if not covered:
                    preserved[key] = count
        n = baseline_io.write_baseline(baseline_path, findings, preserved)
        print(f"gofrlint: baseline updated ({n} finding(s) recorded in {baseline_path})",
              file=sys.stderr)
        return 0

    baselined = 0
    if not args.no_baseline:
        findings, baselined = baseline_io.apply_baseline(
            findings, baseline_io.load_baseline(baseline_path))
    blocking = sorted(findings + stale, key=lambda f: (f.path, f.line, f.rule))
    _emit(blocking, args.format)
    if args.format != "text":
        return 1 if blocking else 0
    if baselined:
        print(f"gofrlint: {baselined} pre-existing finding(s) covered by the baseline "
              f"({baseline_path})", file=sys.stderr)
    if blocking:
        print(f"\ngofrlint: {len(blocking)} finding(s). Fix, or justify with "
              "'# gofrlint: disable=<rule> -- <reason>'.", file=sys.stderr)
        return 1
    print("gofrlint: clean" + (" (unified pass incl. suppression audit)" if args.all else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
