"""gofrlint for the port — framework-invariant static analysis over
``gofr_tpu_torch/``, ``chip_smoke.py``, ``tools_torch/`` and
``examples_torch/`` (the port's copy of ``gofr_tpu/analysis``'s core
families, written against a PyTorch tree):

- :mod:`gofr_tpu_torch.analysis.rules` — AST lints: no blocking calls in
  HTTP dispatch or the engine decode loop, no host-device syncs
  (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``torch.cuda.synchronize()``, a device tensor's truth value) on the
  engine thread outside the annotated sync points, registered and
  bounded-cardinality metrics, status-checked kernel launches.
- :mod:`gofr_tpu_torch.analysis.baseline_io` — ``--format json`` stable
  finding ids and the ratchet baseline (``baseline.json`` of the port's
  own; ``--update-baseline``).
- :mod:`gofr_tpu_torch.analysis.sarif` — SARIF 2.1.0 output.
- :mod:`gofr_tpu_torch.analysis.audit` — the stale-suppression audit.
- :mod:`gofr_tpu_torch.analysis.ffi` — every ``extern "C"`` entry of
  ``csrc/*.cu`` against ``_build.SIGNATURES`` (name, argument count,
  canonical types, ``int`` return).
- :mod:`gofr_tpu_torch.analysis.lockcheck` — the static lock graph
  (``lock-order-static``), ``hold-and-block`` and ``guarded-by``; exports
  the graph that the runtime tier's observed graph is checked against.
- :mod:`gofr_tpu_torch.analysis.lockorder` — the runtime lock-order shim.

Not ported yet (ROADMAP Queue A item 12): leakcheck/leaktrace,
deadlinecheck/deadlinetrace, chaoscov, kernel contracts, bench_ratchet,
shardcheck.

Run ``python -m gofr_tpu_torch.analysis --all``; it exits non-zero on any
unsuppressed finding. Suppress with
``# gofrlint: disable=<rule> -- <reason>`` — the reason is mandatory.
"""

from __future__ import annotations

from gofr_tpu_torch.analysis.core import (
    Finding,
    SourceFile,
    parse_suppressions,
    run_rules,
)

__all__ = ["Finding", "SourceFile", "parse_suppressions", "run_rules"]
