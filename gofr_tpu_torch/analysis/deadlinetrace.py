"""Runtime deadline-budget tracer of the port: the dynamic twin of
deadlinecheck (the port's copy of ``gofr_tpu/analysis/deadlinetrace.py``).

deadlinecheck proves statically that every blocking call on a request's
path carries a bound derived from its deadline. This shim checks the
same contract at runtime while installed: it instruments the
deadline-budget BOUNDARIES of the serving plane — the seams where a
remaining budget is handed from one component to the next —

- ``Router.submit`` / ``LocalReplica.submit`` / ``HTTPReplica.submit``
  / ``ServingEngine.submit`` (``deadline=`` budget, router→replica→
  engine admission);
- ``HTTPReplica.fetch_kv`` and ``KVMigrator.fetch_chain`` /
  ``fetch_handoff`` (cross-replica KV migration bounds);
- ``AdapterRegistry.acquire`` (the LoRA upload wait);
- ``remote.run_stream`` (the SSE stream open + per-frame budget);
- ``Router.resume`` / ``LocalReplica.resume`` / ``HTTPReplica.resume``
  / ``remote.open_resume`` (the HA plane's keyed re-attach walk),

and asserts two invariants on every crossing, per thread:

1. **Monotone narrowing** — the budget passed downward never exceeds
   the remaining budget of the enclosing crossing on the same thread
   (a widened budget means some frame re-derived the bound from a
   constant instead of the deadline).
2. **No dead crossings** — a crossing is never entered with a NEGATIVE
   budget: an expired request must be settled (504) at the frame that
   observed the expiry, not handed onward. (A zero budget is legal: it
   is the clamped "ask, don't wait" form — the callee fails fast.)

A crossing with ``budget=None`` under an enclosing deadline is NOT a
runtime violation — deadline-less submits are legal (no SLO attached)
and the static ``deadline-dropped`` rule owns the case where a deadline
was in scope but dropped.

Every observed crossing site is recorded, so a run can assert coverage
against the static boundary table
(:func:`gofr_tpu_torch.analysis.deadlinecheck.check_deadline_coverage`) —
a site the runtime crossed that the analyzer doesn't know is an
analyzer blind spot. Narrowing is checked per thread: the router walks
replicas on worker threads, and each thread keeps its own stack of
enclosing deadlines. Usage mirrors leaktrace (the export merge-writes
when several runs share one file):

    mon = deadlinetrace.install()
    try:
        ...  # real engine/router workload
    finally:
        deadlinetrace.uninstall()
    mon.check()                          # raises on any budget violation
    deadlinetrace.export_to(mon, path)   # merge-write observed crossings
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable

__all__ = [
    "DeadlineTraceError", "DeadlineTraceMonitor", "install", "uninstall",
    "export_to",
]

# slack for clock reads between the caller computing `remaining` and the
# wrapper re-reading monotonic(): a correctly-clamped budget can appear
# to exceed the enclosing deadline by scheduling jitter, never by more
_EPS = 0.005


class DeadlineTraceError(AssertionError):
    pass


class DeadlineTraceMonitor:
    """Observed boundary crossings + budget violations."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._crossings: list[str] = []        # ordered, with duplicates
        self._violations: list[str] = []
        self._local = threading.local()        # per-thread deadline stack

    # -- instrumentation callbacks -------------------------------------

    def _stack(self) -> list[float | None]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def enter(self, site: str, budget: float | None) -> None:
        now = time.monotonic()
        with self._mu:
            self._crossings.append(site)
            if budget is not None and budget < 0:
                self._violations.append(
                    f"expired request crossed boundary {site} "
                    f"(budget {budget:.6f}s < 0 — settle at the frame "
                    "that observed the expiry instead)"
                )
            enclosing = next(
                (d for d in reversed(self._stack()) if d is not None), None
            )
            if (
                budget is not None and enclosing is not None
                and now + budget > enclosing + _EPS
            ):
                self._violations.append(
                    f"budget widened at {site}: passed {budget:.4f}s but "
                    f"only {max(enclosing - now, 0.0):.4f}s remain of the "
                    "enclosing deadline — derive the bound from the "
                    "remaining deadline, not a constant"
                )
        abs_deadline = now + budget if budget is not None else None
        self._stack().append(abs_deadline)

    def exit(self, site: str) -> None:
        st = self._stack()
        if st:
            st.pop()

    # -- results -------------------------------------------------------

    def crossings(self) -> list[str]:
        with self._mu:
            return list(self._crossings)

    def observed_sites(self) -> set[str]:
        with self._mu:
            return set(self._crossings)

    def violations(self) -> list[str]:
        with self._mu:
            return list(self._violations)

    def events(self) -> list[dict[str, str]]:
        """Unique crossings in the shape check_deadline_coverage eats."""
        return [
            {"site": s, "op": "crossing"}
            for s in sorted(self.observed_sites())
        ]

    def export(self) -> dict:
        return {
            "version": 1,
            "events": self.events(),
            "violations": self.violations(),
        }

    def check(self) -> None:
        bad = self.violations()
        if bad:
            raise DeadlineTraceError(
                f"deadlinetrace: budget violations ({len(bad)}):\n  "
                + "\n  ".join(bad)
            )


_active: DeadlineTraceMonitor | None = None
_originals: list[tuple[Any, str, Any]] = []


def _wrap_boundary(
    owner: Any, method: str, site: str,
    budget_from: Callable[[tuple, dict], float | None],
) -> None:
    """Patch ``owner.method`` so the monitor sees enter/exit around the
    original call — enter must run BEFORE (an expired crossing is the
    violation even when the callee then raises)."""
    original = getattr(owner, method)

    def wrapper(*args: Any, **kwargs: Any) -> Any:
        mon = _active
        if mon is None:
            return original(*args, **kwargs)
        mon.enter(site, budget_from(args, kwargs))
        try:
            return original(*args, **kwargs)
        finally:
            mon.exit(site)

    wrapper.__name__ = method
    wrapper.__wrapped__ = original  # type: ignore[attr-defined]
    _originals.append((owner, method, original))
    setattr(owner, method, wrapper)


def _kw(name: str, pos: int | None = None) -> Callable[..., float | None]:
    def budget_from(args: tuple, kwargs: dict) -> float | None:
        if name in kwargs:
            return kwargs[name]
        if pos is not None and len(args) > pos:
            return args[pos]
        return None
    return budget_from


def install() -> DeadlineTraceMonitor:
    """Instrument the deadline boundaries; returns the monitor. Raises
    if already installed (a nested uninstall would strip the outer
    tier's instrumentation)."""
    global _active
    if _active is not None:
        raise DeadlineTraceError("deadlinetrace already installed")
    from gofr_tpu_torch.serving import remote
    from gofr_tpu_torch.serving.engine import ServingEngine
    from gofr_tpu_torch.serving.lora import AdapterRegistry
    from gofr_tpu_torch.serving.prefix_index import KVMigrator
    from gofr_tpu_torch.serving.router import HTTPReplica, LocalReplica, Router

    mon = DeadlineTraceMonitor()
    _active = mon
    try:
        _wrap_boundary(Router, "submit", "Router.submit", _kw("deadline"))
        _wrap_boundary(LocalReplica, "submit", "LocalReplica.submit",
                       _kw("deadline"))
        _wrap_boundary(HTTPReplica, "submit", "HTTPReplica.submit",
                       _kw("deadline"))
        _wrap_boundary(ServingEngine, "submit", "ServingEngine.submit",
                       _kw("deadline"))
        # self rides in args[0] for these, so positional budgets shift by 1
        _wrap_boundary(HTTPReplica, "fetch_kv", "HTTPReplica.fetch_kv",
                       _kw("timeout", pos=2))
        _wrap_boundary(KVMigrator, "fetch_chain", "KVMigrator.fetch_chain",
                       _kw("deadline"))
        _wrap_boundary(KVMigrator, "fetch_handoff",
                       "KVMigrator.fetch_handoff", _kw("deadline"))
        _wrap_boundary(AdapterRegistry, "acquire", "AdapterRegistry.acquire",
                       _kw("timeout", pos=2))
        _wrap_boundary(remote, "run_stream", "remote.run_stream",
                       _kw("timeout"))
        # HA plane: keyed re-attach rides the same budget discipline —
        # Router.resume's deadline flows to the replica handle, which
        # hands open_resume the remaining window as its head timeout
        _wrap_boundary(Router, "resume", "Router.resume", _kw("deadline"))
        _wrap_boundary(LocalReplica, "resume", "LocalReplica.resume",
                       _kw("deadline"))
        _wrap_boundary(HTTPReplica, "resume", "HTTPReplica.resume",
                       _kw("deadline"))
        _wrap_boundary(remote, "open_resume", "remote.open_resume",
                       _kw("timeout"))
    except Exception:
        uninstall()
        raise
    return mon


def uninstall() -> DeadlineTraceMonitor | None:
    """Restore the original methods; in-flight calls through the old
    wrappers still see the (now-detached) monitor safely."""
    global _active
    for owner, method, original in reversed(_originals):
        setattr(owner, method, original)
    _originals.clear()
    mon, _active = _active, None
    return mon


def export_to(mon: DeadlineTraceMonitor, path: str) -> None:
    """Merge-write the observed crossings into ``path`` (several runs
    append to one export; the union feeds
    ``--check-deadline-table``)."""
    data = mon.export()
    try:
        with open(path, encoding="utf-8") as fp:
            prior = json.load(fp)
    except (OSError, ValueError):
        prior = {}
    sites = {e.get("site") for e in prior.get("events", ())}
    events = list(prior.get("events", ()))
    for e in data["events"]:
        if e["site"] not in sites:
            events.append(e)
    payload = {
        "version": 1,
        "events": sorted(events, key=lambda e: e["site"]),
        "violations": sorted(
            set(prior.get("violations", ())) | set(data["violations"])
        ),
    }
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(payload, fp, indent=2)
        fp.write("\n")
