"""Prometheus text-exposition well-formedness checks (port of
``gofr_tpu/metrics/promlint.py``, the same checks).

The CI gate behind the ``/metrics`` scrape test (docs/observability.md):
a malformed exposition doesn't fail loudly in production — Prometheus
drops the whole scrape, and the first anyone hears of it is a gap in
every dashboard at once. :func:`lint_exposition` validates the
text-format invariants that actually break scrapes or queries:

- every sample belongs to a family with exactly one ``# HELP`` and one
  ``# TYPE`` line, emitted before the samples;
- histogram families expose ``_bucket``/``_sum``/``_count`` series with
  cumulative (non-decreasing) bucket counts ending in a ``+Inf`` bucket
  equal to ``_count``;
- no duplicate series (same name + same label set twice);
- sample lines parse (name, optional ``{labels}``, numeric value).
"""

from __future__ import annotations

import re

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+[0-9]+)?$"  # optional timestamp
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _family_of(name: str, typed: dict[str, str]) -> str:
    """Collapse histogram sample names onto their family name."""
    for suffix in _HIST_SUFFIXES:
        if name.endswith(suffix) and name[: -len(suffix)] in typed:
            return name[: -len(suffix)]
    return name


def lint_exposition(text: str) -> list[str]:
    """Return a list of problems; empty means well-formed."""
    problems: list[str] = []
    helped: dict[str, int] = {}   # family -> HELP line no
    typed: dict[str, str] = {}    # family -> type
    seen_series: set[tuple[str, tuple]] = set()
    # family -> {labelkey(les stripped) -> [(le, count)]}
    buckets: dict[str, dict[tuple, list[tuple[float, float]]]] = {}
    counts: dict[str, dict[tuple, float]] = {}
    samples_started: set[str] = set()

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3:
                problems.append(f"line {lineno}: malformed HELP line")
                continue
            family = parts[2]
            if family in helped:
                problems.append(
                    f"line {lineno}: duplicate HELP for '{family}'"
                )
            if family in samples_started:
                problems.append(
                    f"line {lineno}: HELP for '{family}' after its samples"
                )
            helped[family] = lineno
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                problems.append(f"line {lineno}: malformed TYPE line")
                continue
            family, kind = parts[2], parts[3]
            if family in typed:
                problems.append(
                    f"line {lineno}: duplicate TYPE for '{family}'"
                )
            if family in samples_started:
                problems.append(
                    f"line {lineno}: TYPE for '{family}' after its samples"
                )
            if kind not in ("counter", "gauge", "histogram", "summary", "untyped"):
                problems.append(
                    f"line {lineno}: unknown TYPE '{kind}' for '{family}'"
                )
            typed[family] = kind
            continue
        if line.startswith("#"):
            continue  # free comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            problems.append(f"line {lineno}: unparseable sample: {line!r}")
            continue
        name = m.group("name")
        labels_raw = m.group("labels") or ""
        labels = tuple(sorted(_LABEL_RE.findall(labels_raw)))
        try:
            value = float(m.group("value"))
        except ValueError:
            problems.append(
                f"line {lineno}: non-numeric value for '{name}'"
            )
            continue
        family = _family_of(name, typed)
        samples_started.add(family)
        if family not in typed:
            problems.append(
                f"line {lineno}: sample '{name}' has no TYPE line"
            )
        if family not in helped:
            problems.append(
                f"line {lineno}: sample '{name}' has no HELP line"
            )
        series_key = (name, labels)
        if series_key in seen_series:
            problems.append(
                f"line {lineno}: duplicate series {name}{{{labels_raw}}}"
            )
        seen_series.add(series_key)
        if typed.get(family) == "histogram":
            if name == family + "_bucket":
                le = dict(labels).get("le")
                if le is None:
                    problems.append(
                        f"line {lineno}: histogram bucket without 'le'"
                    )
                    continue
                base = tuple(kv for kv in labels if kv[0] != "le")
                buckets.setdefault(family, {}).setdefault(base, []).append(
                    (float("inf") if le == "+Inf" else float(le), value)
                )
            elif name == family + "_count":
                counts.setdefault(family, {})[labels] = value

    for family, by_series in buckets.items():
        for base, entries in by_series.items():
            ordered = sorted(entries)
            values = [v for _, v in ordered]
            if any(b > a for a, b in zip(values[1:], values)):
                problems.append(
                    f"histogram '{family}'{dict(base)}: bucket counts are "
                    f"not cumulative: {values}"
                )
            if not ordered or ordered[-1][0] != float("inf"):
                problems.append(
                    f"histogram '{family}'{dict(base)}: no +Inf bucket"
                )
            else:
                total = counts.get(family, {}).get(base)
                if total is not None and total != ordered[-1][1]:
                    problems.append(
                        f"histogram '{family}'{dict(base)}: +Inf bucket "
                        f"{ordered[-1][1]} != _count {total}"
                    )
    return problems
