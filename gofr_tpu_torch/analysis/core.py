"""gofrlint core: findings, suppression comments, the rule runner.

Suppression grammar (fix-or-justify — a reason is mandatory):

    x = risky()  # gofrlint: disable=blocking-call -- probe thread, bounded

A standalone suppression comment (nothing but the comment on its line)
applies to the next source line instead, so multi-line statements can be
annotated above their first line. ``disable=a,b`` suppresses several
rules at once. A suppression with no ``-- reason`` (or an empty reason)
is itself reported as a ``bad-suppression`` finding and suppresses
nothing.

The port's copy of ``gofr_tpu/analysis/core.py``: paths anchor at the
``gofr_tpu_torch`` package instead of ``gofr_tpu``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize

_SUPPRESS_RE = re.compile(
    r"#\s*gofrlint:\s*disable=(?P<rules>[\w\-,]+)(?:\s*--\s*(?P<reason>.*))?\s*$"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class SuppressionRecord:
    """One well-formed inline suppression comment: the comment's own line,
    the rule names it disables, its (mandatory) reason, and every source
    line it covers. The stale-suppression audit
    (:mod:`gofr_tpu_torch.analysis.audit`) checks each record against the raw
    finding set."""

    line: int
    rules: frozenset[str]
    reason: str
    covered: frozenset[int]


def iter_suppression_records(
    source: str, path: str
) -> tuple[list[SuppressionRecord], list[Finding]]:
    """Parse every gofrlint suppression comment in ``source`` into
    records, plus findings for malformed ones."""
    records: list[SuppressionRecord] = []
    bad: list[Finding] = []
    src_lines = source.splitlines()
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        comments = [
            (t.start[0], t.start[1], t.string)
            for t in tokens
            if t.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return [], []
    for line, col, text in comments:
        m = _SUPPRESS_RE.search(text)
        if m is None:
            if "gofrlint:" in text and "disable" in text:
                bad.append(
                    Finding(
                        "bad-suppression", path, line,
                        "unparseable gofrlint suppression comment",
                    )
                )
            continue
        reason = (m.group("reason") or "").strip()
        if not reason:
            bad.append(
                Finding(
                    "bad-suppression", path, line,
                    "suppression without a reason: use "
                    "'# gofrlint: disable=<rule> -- <why this is safe>'",
                )
            )
            continue
        rules = frozenset(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        covered = {line}
        if not src_lines[line - 1][:col].strip():
            # comment alone on its line: cover the next CODE line (skip
            # continuation comment lines and blanks)
            target = line + 1
            while target <= len(src_lines) and (
                not src_lines[target - 1].strip()
                or src_lines[target - 1].lstrip().startswith("#")
            ):
                target += 1
            covered.add(target)
        records.append(
            SuppressionRecord(line, rules, reason, frozenset(covered))
        )
    return records, bad


def parse_suppressions(
    source: str, path: str
) -> tuple[dict[int, set[str]], list[Finding]]:
    """Return ``{line: {rules}}`` plus findings for malformed suppressions."""
    records, bad = iter_suppression_records(source, path)
    suppressed: dict[int, set[str]] = {}
    for rec in records:
        for line in rec.covered:
            suppressed.setdefault(line, set()).update(rec.rules)
    return suppressed, bad


class SourceFile:
    """A parsed Python file handed to every rule."""

    def __init__(self, path: str, rel_path: str, source: str) -> None:
        self.path = path
        self.rel_path = rel_path  # slash-normalized, relative to the walk root
        self.source = source
        self.tree = ast.parse(source, filename=path)
        # one tokenize pass serves both the live suppression table and
        # the stale-suppression audit (run_unified reads the records)
        self.suppression_records, self.bad_suppressions = (
            iter_suppression_records(source, rel_path)
        )
        self.suppressions: dict[int, set[str]] = {}
        for rec in self.suppression_records:
            for line in rec.covered:
                self.suppressions.setdefault(line, set()).update(rec.rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        return rule in self.suppressions.get(line, ())


PACKAGE = "gofr_tpu_torch"


def _package_rel(path: str, fallback: str) -> str:
    """rel_path anchored at the innermost ``gofr_tpu_torch`` package
    component, so zone tables keyed like ``gofr_tpu_torch/serving/engine.py``
    match no matter whether the CLI got the package root, a subdirectory, or
    a single file. Paths outside any ``gofr_tpu_torch`` tree (``chip_smoke.py``,
    ``tools_torch/``, ``examples_torch/``) keep ``fallback``."""
    parts = os.path.abspath(path).replace(os.sep, "/").split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i:])
    return fallback


def iter_python_files(paths: list[str]) -> list[tuple[str, str]]:
    """Expand files/directories into (abs_path, rel_path) pairs."""
    out: list[tuple[str, str]] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p):
            out.append((p, _package_rel(p, os.path.basename(p))))
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
            for f in sorted(files):
                if f.endswith(".py"):
                    full = os.path.join(root, f)
                    rel = os.path.relpath(full, os.path.dirname(p))
                    out.append((full, _package_rel(full, rel.replace(os.sep, "/"))))
    return out


class Rule:
    """A lint rule. ``visit_file`` yields per-file findings;
    ``finalize`` yields whole-project findings (cross-file state).
    ``cross_file`` marks rules whose findings (wholly or partly) come
    from ``finalize`` — consumers like the baseline updater use it to
    know which findings a partial run could NOT have re-observed."""

    name = ""
    cross_file = False

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        return []

    def finalize(self) -> list[Finding]:
        return []


def run_rules(
    paths: list[str], rules: list[Rule], honor_suppressions: bool = True
) -> list[Finding]:
    """Run rules over every Python file under ``paths``, honoring
    suppressions. Findings from ``finalize`` are matched against the
    suppression table of the file they landed in. Cross-file rules only
    finalize when at least one *directory* was walked — on a file subset
    they would see uses without their (elsewhere) registrations.
    ``honor_suppressions=False`` reports the RAW finding set (every
    inline suppression ignored) — the stale-suppression audit compares
    the suppression comments against exactly this set."""
    full_tree = any(os.path.isdir(p) for p in paths)
    findings: list[Finding] = []
    tables: dict[str, dict[int, set[str]]] = {}
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as f:
            source = f.read()
        try:
            sf = SourceFile(full, rel, source)
        except SyntaxError as exc:
            findings.append(Finding("syntax-error", rel, exc.lineno or 0, str(exc.msg)))
            continue
        if not honor_suppressions:
            # empty the live table: rules that consult sf.is_suppressed
            # internally (metrics, pubsub-settle) go raw through the same
            # object the finalize pass reads
            sf.suppressions.clear()
        tables[rel] = sf.suppressions
        findings.extend(sf.bad_suppressions)
        for rule in rules:
            for finding in rule.visit_file(sf):
                if not sf.is_suppressed(finding.rule, finding.line):
                    findings.append(finding)
    if full_tree:
        for rule in rules:
            for finding in rule.finalize():
                if finding.rule not in tables.get(finding.path, {}).get(
                    finding.line, ()
                ):
                    findings.append(finding)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


_STALE_MESSAGE = (
    "suppression for {rules} matches no current finding — the rule "
    "drifted or the code moved; delete the comment (a stale suppression "
    "would silently swallow the NEXT real finding)"
)


def run_unified(
    paths: list[str], rules: list[Rule]
) -> tuple[list[Finding], list[Finding]]:
    """The ``--all`` front door's single shared walk: every file is read,
    tokenized, and parsed ONCE; the rules run against the RAW (no
    inline-suppression) view; the live findings are recovered by
    post-filtering the raw set through the saved suppression tables —
    equivalent to :func:`run_rules`, which consults the same
    ``(rule, path, line)`` table — and the stale-suppression audit is
    computed from the identical raw set. Returns
    ``(live findings, stale-suppression findings)``."""
    full_tree = any(os.path.isdir(p) for p in paths)
    raw: list[Finding] = []
    unfiltered: list[Finding] = []  # bad-suppression: never suppressible
    tables: dict[str, dict[int, set[str]]] = {}
    file_records: list[tuple[str, list[SuppressionRecord]]] = []
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as f:
            source = f.read()
        try:
            sf = SourceFile(full, rel, source)
        except SyntaxError as exc:
            unfiltered.append(
                Finding("syntax-error", rel, exc.lineno or 0, str(exc.msg))
            )
            continue
        tables[rel] = {ln: set(rs) for ln, rs in sf.suppressions.items()}
        file_records.append((rel, sf.suppression_records))
        sf.suppressions.clear()  # rules see the raw view
        unfiltered.extend(sf.bad_suppressions)
        for rule in rules:
            raw.extend(rule.visit_file(sf))
    if full_tree:
        for rule in rules:
            raw.extend(rule.finalize())
    live = unfiltered + [
        f for f in raw
        if f.rule not in tables.get(f.path, {}).get(f.line, set())
    ]
    live.sort(key=lambda f: (f.path, f.line, f.rule))
    # stale audit over the SAME raw set (audit.stale_suppressions
    # semantics: a record none of whose covered lines carries a raw
    # finding for any of its named rules is stale)
    hits: dict[str, dict[int, set[str]]] = {}
    for f in raw:
        hits.setdefault(f.path, {}).setdefault(f.line, set()).add(f.rule)
    cross_file_rules = {r.name for r in rules if r.cross_file}
    stale: list[Finding] = []
    for rel, records in file_records:
        for rec in records:
            if not full_tree and rec.rules & cross_file_rules:
                continue
            file_hits = hits.get(rel, {})
            used = any(
                rule in file_hits.get(line, ())
                for line in rec.covered
                for rule in rec.rules
            )
            if not used:
                stale.append(
                    Finding(
                        "stale-suppression", rel, rec.line,
                        _STALE_MESSAGE.format(rules=sorted(rec.rules)),
                    )
                )
    stale.sort(key=lambda f: (f.path, f.line))
    return live, stale
