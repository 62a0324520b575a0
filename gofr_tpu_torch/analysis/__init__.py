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
- :mod:`gofr_tpu_torch.analysis.shardcheck` — mesh-axis vocabulary,
  collectives outside a rank function or a received mesh, reads of an
  in-place-updated argument as its pre-call value, and CUDA-graph capture
  hazards in the decode hot path.
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
- :mod:`gofr_tpu_torch.analysis.leakcheck` — resource pairing, exception
  paths, settlement on raise, retire gates; its runtime twin
  :mod:`gofr_tpu_torch.analysis.leaktrace` (balance and coverage).
- :mod:`gofr_tpu_torch.analysis.deadlinecheck` — deadline propagation,
  bounded waits, retry budgets, cancellable waits, zone drift; its runtime
  twin :mod:`gofr_tpu_torch.analysis.deadlinetrace` (budgets only narrow).
- :mod:`gofr_tpu_torch.analysis.kernel_contracts` — the committed device
  contract table; :mod:`gofr_tpu_torch.analysis.kernelcheck` holds the
  code to it, and :mod:`gofr_tpu_torch.analysis.kerneltrace` (a CPU matrix,
  a live-engine observer) holds the runtime to it.
- :mod:`gofr_tpu_torch.analysis.chaoscov` — every chaos point scheduled by
  a test of the port's chaos tier.

Not ported: bench_ratchet (with the port's bench).

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
