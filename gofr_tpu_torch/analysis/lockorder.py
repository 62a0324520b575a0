"""Lock-order race tier: Python-side deadlock detection (the port's copy of
``gofr_tpu/analysis/lockorder.py``; its export anchors paths at
``gofr_tpu_torch``).

The port's control plane is Python threads over Python locks (engine
``_count_lock``, allocator/scheduler ``_mu``, pool and websocket locks).
An inconsistent acquisition order between two of those deadlocks the
serving process — and only under production load.

This shim instruments ``threading.Lock``/``threading.RLock`` creation
while installed: every acquisition records *potential order* edges (each
lock currently held by the thread → the lock being acquired, recorded at
the attempt so a blocked acquire still contributes). A cycle in that
graph is an AB/BA ordering that CAN deadlock, even if this run got
lucky — the lock-order analogue of TSan's happens-before reasoning.

Usage (the port's concurrency tests opt in through a fixture of their own
file under ``GOFR_LOCK_ORDER=1``; ``chip_smoke.py``'s analytics phase runs
its engine and app under it on the card):

    mon = lockorder.install()
    try:
        ...  # exercise concurrent code
    finally:
        lockorder.uninstall()
    mon.check()  # raises LockOrderError on any cycle
"""

from __future__ import annotations

import _thread
import threading
import traceback
from typing import Any

__all__ = ["LockOrderError", "LockOrderMonitor", "install", "uninstall"]


class LockOrderError(AssertionError):
    pass


def _creation_site() -> str:
    # innermost frame outside this module and threading internals
    for frame in reversed(traceback.extract_stack()[:-2]):
        fn = frame.filename
        if "analysis/lockorder" in fn.replace("\\", "/") or fn.endswith(
            ("threading.py",)
        ):
            continue
        return f"{fn}:{frame.lineno}"
    return "<unknown>"


class LockOrderMonitor:
    """Edge graph of observed lock-acquisition order, across all threads."""

    def __init__(self) -> None:
        # bookkeeping must use raw locks: instrumented ones would recurse
        self._mu = _thread.allocate_lock()
        self._edges: dict[int, set[int]] = {}
        self._edge_sites: dict[tuple[int, int], str] = {}
        self._sites: dict[int, str] = {}
        self._held = threading.local()
        self._next_token = 0  # monotonic lock ids: id() reuse after GC
        # would merge edges of distinct lock generations into fake cycles
        self.locks_created = 0

    # -- instrumentation callbacks ------------------------------------------
    def _register(self, site: str) -> int:
        with self._mu:
            token = self._next_token
            self._next_token += 1
            self._sites[token] = site
            self.locks_created += 1
            return token

    def _held_stack(self) -> list[int]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = []
            self._held.stack = stack
        return stack

    def on_attempt(self, lock_id: int) -> None:
        """Record order edges at the acquisition ATTEMPT — a blocked
        acquire is exactly the one that matters for deadlock evidence."""
        stack = self._held_stack()
        if lock_id in stack:  # reentrant RLock acquire: no self-ordering
            return
        if not stack:
            return
        with self._mu:
            for held in stack:
                if held == lock_id:
                    continue
                self._edges.setdefault(held, set()).add(lock_id)
                if (held, lock_id) not in self._edge_sites:
                    # format the stack only for NEW edges — this runs under
                    # the one global mutex on the exact path the tier stresses
                    self._edge_sites[(held, lock_id)] = (
                        "acquired at "
                        + "".join(
                            traceback.format_stack(limit=6)[:-2][-2:]
                        ).strip()
                    )

    def on_acquired(self, lock_id: int) -> None:
        self._held_stack().append(lock_id)

    def on_released(self, lock_id: int) -> None:
        stack = self._held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == lock_id:
                del stack[i]
                return

    def on_released_all(self, lock_id: int) -> None:
        stack = self._held_stack()
        stack[:] = [x for x in stack if x != lock_id]

    # -- direct construction (no global patching) ---------------------------
    def make_lock(self) -> "_InstrumentedLock":
        """An instrumented Lock bound to THIS monitor only. Use in tests
        that build synthetic acquisition orders: it never touches the
        global ``threading.Lock`` factories, so it cannot poison (or
        disable) a session-wide monitor installed by the lock-order tier."""
        return _InstrumentedLock(_thread.allocate_lock(), self)

    def make_rlock(self) -> "_InstrumentedRLock":
        return _InstrumentedRLock(_thread.RLock(), self)

    # -- analysis ------------------------------------------------------------
    def cycles(self) -> list[list[str]]:
        """Cycles in the order graph, as lists of creation-site labels."""
        with self._mu:
            edges = {a: set(bs) for a, bs in self._edges.items()}
            sites = dict(self._sites)
        out: list[list[str]] = []
        seen_cycles: set[frozenset[int]] = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color: dict[int, int] = {}
        path: list[int] = []

        def dfs(node: int) -> None:
            color[node] = GRAY
            path.append(node)
            for nxt in sorted(edges.get(node, ())):
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    cyc = path[path.index(nxt):]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(
                            [sites.get(x, f"<lock {x}>") for x in cyc + [nxt]]
                        )
                elif c == WHITE:
                    dfs(nxt)
            path.pop()
            color[node] = BLACK

        for node in sorted(edges):
            if color.get(node, WHITE) == WHITE:
                dfs(node)
        return out

    def check(self) -> None:
        cycles = self.cycles()
        if cycles:
            raise LockOrderError(format_cycles(cycles))

    def export_graph(self) -> dict:
        """The observed acquisition graph, with lock instances collapsed
        to their creation sites (``rel_path:line``, package-anchored like
        the static analyzer's) so it can be checked as a subgraph of
        lockcheck's static graph (``--lock-graph``): every runtime edge
        between two statically-known locks must exist statically, or the
        analyzer has a blind spot. Site-level self-edges are kept (two
        instances of one class can nest the "same" creation site); the
        subgraph checker ignores them."""
        from gofr_tpu_torch.analysis.core import _package_rel

        with self._mu:
            edges = {a: set(bs) for a, bs in self._edges.items()}
            sites = dict(self._sites)

        def norm(token: int) -> str:
            site = sites.get(token, f"<lock {token}>")
            path, _, line = site.rpartition(":")
            return f"{_package_rel(path, path)}:{line}"

        edge_set = {
            (norm(a), norm(b)) for a, bs in edges.items() for b in bs
        }
        return {
            "version": 1,
            "nodes": sorted({s for e in edge_set for s in e}),
            "edges": [list(e) for e in sorted(edge_set)],
        }


def format_cycles(cycles: list[list[str]]) -> str:
    lines = [f"lock-order cycle(s) detected ({len(cycles)}):"]
    for i, cyc in enumerate(cycles, 1):
        lines.append(f"  cycle {i}: " + " -> ".join(cyc))
    lines.append(
        "  (locks identified by creation site; an A->B and B->A ordering "
        "can deadlock under the right interleaving)"
    )
    return "\n".join(lines)


class _InstrumentedLock:
    """Wraps a raw lock, reporting acquire/release to the monitor."""

    def __init__(self, real: Any, mon: LockOrderMonitor) -> None:
        self._real = real
        self._mon = mon
        self._token = mon._register(_creation_site())

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._mon.on_attempt(self._token)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._mon.on_acquired(self._token)
        return ok

    acquire_lock = acquire  # legacy alias some stdlib paths still use

    def release(self) -> None:
        self._real.release()
        self._mon.on_released(self._token)

    release_lock = release

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<gofrlint {type(self).__name__} of {self._real!r}>"

    def __getattr__(self, name: str) -> Any:
        return getattr(self._real, name)


class _InstrumentedRLock(_InstrumentedLock):
    """RLock wrapper implementing the Condition integration protocol
    (``_release_save``/``_acquire_restore``/``_is_owned``) so
    ``threading.Condition`` keeps working under instrumentation."""

    def _release_save(self) -> Any:
        state = self._real._release_save()
        self._mon.on_released_all(self._token)
        return state

    def _acquire_restore(self, state: Any) -> None:
        self._mon.on_attempt(self._token)
        self._real._acquire_restore(state)
        self._mon.on_acquired(self._token)

    def _is_owned(self) -> bool:
        return self._real._is_owned()


_active: LockOrderMonitor | None = None
_originals: tuple[Any, Any] | None = None


def install() -> LockOrderMonitor:
    """Patch ``threading.Lock``/``RLock`` so locks created from now on
    are instrumented. Returns the monitor; call :func:`uninstall` before
    inspecting, then ``monitor.check()``.

    Raises if a monitor is already installed: silently sharing the
    active one would let a nested install's ``uninstall()`` disable the
    outer (session) tier, and synthetic test cycles would poison it.
    Tests that only need instrumented locks (not global patching) should
    use :meth:`LockOrderMonitor.make_lock` on a private monitor."""
    global _active, _originals
    if _active is not None:
        raise LockOrderError(
            "lock-order monitor already installed (session tier active?); "
            "use LockOrderMonitor().make_lock() for a private monitor"
        )
    mon = LockOrderMonitor()
    real_lock, real_rlock = threading.Lock, threading.RLock

    def make_lock() -> _InstrumentedLock:
        return _InstrumentedLock(real_lock(), mon)

    def make_rlock() -> _InstrumentedRLock:
        return _InstrumentedRLock(real_rlock(), mon)

    threading.Lock = make_lock  # type: ignore[misc,assignment]
    threading.RLock = make_rlock  # type: ignore[misc,assignment]
    _active, _originals = mon, (real_lock, real_rlock)
    return mon


def uninstall() -> LockOrderMonitor | None:
    """Restore the real lock factories; instrumented locks already handed
    out keep working (they wrap real locks)."""
    global _active, _originals
    if _originals is not None:
        threading.Lock, threading.RLock = _originals  # type: ignore[misc]
    mon, _active, _originals = _active, None, None
    return mon
