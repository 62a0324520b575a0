"""Chaos-coverage checker of the port (``--chaos-coverage``).

Every chaos point registered in ``gofr_tpu_torch/chaos/injector.py``
exists because some seam can fail there — and an injection point no test
ever schedules a fault at is exactly as good as no injection point. This
pass cross-checks the registered ``POINTS`` tuple against the port's
chaos tier at grep level: a point name that appears, quoted, in no
chaos-tier test file has shipped untested and fails the check.

The port's chaos tier is found, not listed: it is every
``tests/test_torch_*.py`` file that schedules faults through the port's
own injector, i.e. whose source both imports ``gofr_tpu_torch.chaos``
(``from gofr_tpu_torch import chaos``, ``import gofr_tpu_torch.chaos``,
``from gofr_tpu_torch.chaos import ...``) and constructs a
``ChaosInjector(``. The reference's checker parses the Makefile's
``chaos:`` recipe instead; that recipe belongs to the JAX package and
names none of the port's files, so it is neither read nor edited here.

JSON output: ``{"points": {point: [files]}, "missing": [...],
"test_files": [...]}``.
"""

from __future__ import annotations

import glob
import os
import re

_IMPORTS_PORT_CHAOS = re.compile(
    r"^\s*(?:from\s+gofr_tpu_torch\s+import\s+[^\n]*\bchaos\b"
    r"|from\s+gofr_tpu_torch\.chaos\b|import\s+gofr_tpu_torch\.chaos\b)",
    re.MULTILINE,
)


def chaos_test_files(repo_root: str) -> list[str]:
    """The port's chaos tier: ``tests/test_torch_*.py`` files that import
    the port's chaos module and construct an injector (repo-relative)."""
    out: list[str] = []
    for full in sorted(glob.glob(os.path.join(repo_root, "tests", "test_torch_*.py"))):
        try:
            with open(full, encoding="utf-8") as fp:
                source = fp.read()
        except OSError:
            continue
        if _IMPORTS_PORT_CHAOS.search(source) and "ChaosInjector(" in source:
            out.append(os.path.relpath(full, repo_root).replace(os.sep, "/"))
    return out


def check_chaos_coverage(repo_root: str) -> dict:
    """Cross-check every registered chaos point against the chaos-tier
    test files. ``missing`` non-empty = a point ships untested."""
    from gofr_tpu_torch.chaos.injector import POINTS

    test_files = chaos_test_files(repo_root)
    coverage: dict[str, list[str]] = {p: [] for p in POINTS}
    for rel in test_files:
        with open(os.path.join(repo_root, rel), encoding="utf-8") as fp:
            source = fp.read()
        for point in POINTS:
            if f'"{point}"' in source or f"'{point}'" in source:
                coverage[point].append(rel)
    return {
        "version": 1,
        "test_files": test_files,
        "points": coverage,
        "missing": sorted(p for p, files in coverage.items() if not files),
    }
