"""Stale-suppression audit (``--check-suppressions``).

A suppression is a claim: "this line triggers rule R, and here is why
that is safe." Rules drift, code moves, fixes land — and the claim goes
stale: the comment suppresses nothing but still reads like an active,
justified exemption. Worse, a stale suppression on a line that later
REGAINS the finding silently swallows the new, unreviewed instance.

The audit runs every AST rule with inline suppressions ignored (the raw
finding set) and then checks each well-formed suppression comment
against it: a suppression none of whose covered lines carries a raw
finding for any of its named rules is reported as ``stale-suppression``
and fails CI. Delete it (or fix the rule drift it exposes).

Scope: AST-rule suppressions only — the FFI cross-checker and the
ratchet baseline have their own lifecycles (`--update-baseline` ratchets
the baseline; FFI findings have no inline-suppression form).

The port's copy of ``gofr_tpu/analysis/audit.py``.
"""

from __future__ import annotations

from gofr_tpu_torch.analysis.core import Finding, run_unified


def stale_suppressions(paths: list[str]) -> list[Finding]:
    """Return a ``stale-suppression`` finding for every inline
    suppression under ``paths`` that matches no raw finding. One
    implementation: this delegates to :func:`core.run_unified` — the
    same shared-walk pass the ``--all`` front door runs — so the audit
    and the front door can never drift (on a file-only subset
    cross-file suppressions are preserved, same reasoning as the
    baseline updater's partial-run preservation)."""
    from gofr_tpu_torch.analysis.rules import default_rules

    return run_unified(paths, default_rules())[1]
