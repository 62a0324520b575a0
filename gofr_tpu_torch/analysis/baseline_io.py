"""Ratchet baseline + stable finding ids for the gofrlint CLI.

The ratchet model: pre-existing, already-justified findings recorded in
``gofr_tpu_torch/analysis/baseline.json`` do not block the build; any finding
NOT covered by the baseline does. ``--update-baseline`` re-records the
current findings, so the count can only be ratcheted down deliberately,
never drift up silently.

Baseline entries are keyed by ``rule | file | message`` (line numbers
excluded, so unrelated code motion does not churn the baseline) with a
per-key count: two identical findings in one file need two baseline
slots, and fixing one of them un-baselines the other.

Finding ids (``--format json``) are a stable digest over
``rule | file | line | message`` — the same finding produces the same id
across runs, so CI and editors can track, dedupe, and link findings.

The port's copy of ``gofr_tpu/analysis/baseline_io.py``.
"""

from __future__ import annotations

import hashlib
import json
import os

from gofr_tpu_torch.analysis.core import Finding

BASELINE_VERSION = 1


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def finding_id(f: Finding) -> str:
    digest = hashlib.sha1(
        f"{f.rule}|{f.path}|{f.line}|{f.message}".encode()
    ).hexdigest()
    return f"{f.rule}-{digest[:12]}"


def finding_json(f: Finding) -> dict:
    return {
        "id": finding_id(f),
        "rule": f.rule,
        "file": f.path,
        "line": f.line,
        "message": f.message,
    }


def render_json(findings: list[Finding]) -> str:
    return json.dumps(
        {
            "version": BASELINE_VERSION,
            "findings": [finding_json(f) for f in findings],
        },
        indent=2,
    )


def _baseline_key(f: Finding) -> str:
    return f"{f.rule}|{f.path}|{f.message}"


def load_baseline(path: str) -> dict[str, int]:
    """{key: count} from a baseline file; {} when absent or unreadable
    (a corrupt baseline must fail toward MORE findings, not fewer)."""
    try:
        with open(path, encoding="utf-8") as fp:
            data = json.load(fp)
    except (OSError, ValueError):
        return {}
    counts = data.get("findings", {})
    if not isinstance(counts, dict):
        return {}
    return {k: int(v) for k, v in counts.items() if isinstance(v, int) and v > 0}


def write_baseline(
    path: str, findings: list[Finding], preserve: dict[str, int] | None = None
) -> int:
    """Record the current findings as the ratchet floor; returns the
    number of recorded entries. ``preserve`` carries prior entries for
    files/rules the current run did NOT cover (a partial lint must not
    erase the rest of the baseline); keys re-observed now replace their
    preserved counts."""
    fresh: dict[str, int] = {}
    for f in findings:
        key = _baseline_key(f)
        fresh[key] = fresh.get(key, 0) + 1
    counts = dict(preserve or {})
    counts.update(fresh)
    payload = {
        "version": BASELINE_VERSION,
        "comment": (
            "gofrlint ratchet baseline: findings recorded here do not "
            "block; any NEW finding does. Regenerate with "
            "python -m gofr_tpu_torch.analysis --update-baseline (only after "
            "justifying every entry; prefer fixing or inline "
            "suppressions with reasons)."
        ),
        "findings": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(payload, fp, indent=2)
        fp.write("\n")
    return sum(counts.values())


def apply_baseline(
    findings: list[Finding], baseline: dict[str, int]
) -> tuple[list[Finding], int]:
    """Split findings into (blocking, n_baselined). Findings are consumed
    against the baseline counts in order; overflow beyond a key's count
    blocks."""
    remaining = dict(baseline)
    blocking: list[Finding] = []
    baselined = 0
    for f in findings:
        key = _baseline_key(f)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            baselined += 1
        else:
            blocking.append(f)
    return blocking, baselined
