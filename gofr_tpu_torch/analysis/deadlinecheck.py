"""deadlinecheck — whole-program deadline-propagation and bounded-wait
analysis of the port.

The port's copy of ``gofr_tpu/analysis/deadlinecheck.py``, written
against ``gofr_tpu_torch/``. Every request carries a deadline (the
``X-Request-Timeout`` header → ``engine.submit(deadline=)`` →
``_Request.deadline``), and every wait on the request's path must be
bounded by what remains of it. The distributed plane — router
failover/hedging, cross-replica KV migration, the disaggregated
prefill→decode handoff, SSE token streaming, LoRA adapter uploads — has
dozens of blocking cross-process call sites. This module machine-checks
the invariant the way lockcheck pins lock order and leakcheck pins
resource lifecycles — five rule families over a whole-program call graph
rooted at the request-serving entry points (``ServingEngine.submit``/
``resume``/``stream``, ``Router.submit``/``resume``, ``LocalReplica``,
``HTTPReplica`` with ``fetch_kv``, ``KVMigrator.fetch_chain``/
``fetch_handoff``, ``AdapterRegistry.acquire``, ``remote.run_stream``/
``open_resume`` and the serving/handlers.py surface):

``deadline-dropped``
    A function that HAS a request-scoped deadline in hand — a
    deadline/timeout-style parameter, or a request object whose
    ``.deadline``/``.remaining()``/``.expired()`` it consults — and
    makes a bound-accepting blocking or cross-process call
    (``.result()``/``.wait()``/``.join()``/``.acquire()``, the service
    client verbs, ``fetch_kv``/``fetch_chain``/``run_stream``…) without
    passing a bound DERIVED from that deadline. A constant bound while
    the deadline is in scope is still a drop: the wait outlives what
    the request has left.

``unbounded-wire-call``
    Transport-layer sites reachable from a serving entry point with NO
    finite bound at all: executor ``.result()`` / ``Event.wait()`` /
    ``Thread.join()`` without a timeout, service-client calls and
    ``urllib.request.urlopen`` without a ``timeout=``, and SSE
    frame-read loops (``for … in resp.lines()`` / ``iter_events(…)``)
    that enforce no deadline between frames.

``retry-unbudgeted``
    Retry/reconnect/requeue loops not governed by a ``RetryConfig``-
    style max-elapsed ladder: a ``while`` loop that retries on failure
    with no budget evidence — no max_elapsed/deadline/attempt-count
    mention, no monotonic-clock comparison, no stop-Event gate — plus
    the AdapterBusy requeue class: a ``front=True`` requeue in a
    function that never checks request expiry.

``cancel-unreachable``
    A blocking wait on a path reachable from ``cancel()``/``drain()``/
    ``stop()``/``shutdown()``/``close()`` that waits on no stop
    ``Event`` and has no bounded timeout — cancellation cannot
    interrupt it.

``zone-drift``
    Cross-analyzer hygiene: every zone entry the port's analyzers key on
    (``rules.DISPATCH_ZONES``, ``BACKOFF_ZONES``, ``ROUTER_RETRY_ZONES``,
    ``HOT_SYNC_ZONES``, ``leakcheck.RETIRE_GATE_ZONES``, and
    ``kernel_contracts.KERNEL_FILES`` with its ``UNPACK_SITES``) must name
    a file that is still scanned and functions that still exist in it —
    a stale zone silently disables its rules for code that moved;
    shardcheck's ``RETRACE_ZONE_FILES``/``RETRACE_ZONE_DIRS`` too.

Like lockcheck/leakcheck, the analysis over-approximates toward a
SUPERSET: the call graph is name-based (an edge to every program
function sharing the callee's bare name), branches are scanned linearly,
and any deadline-derived expression counts as a bound — so the runtime
deadline tracer's observed boundary crossings
(:mod:`gofr_tpu_torch.analysis.deadlinetrace`) can be asserted a subset
of the static boundary table (:func:`check_deadline_coverage`); a
divergence is an analyzer blind spot, not a test flake.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from typing import Any, Iterable

from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# -- vocabulary ---------------------------------------------------------------

# parameter names that carry a request-scoped deadline/budget into a
# function (exact names, or any name containing a *_TOKEN substring)
DEADLINE_PARAM_NAMES = {
    "deadline", "timeout", "remaining", "budget", "max_wait", "max_elapsed",
}
DEADLINE_PARAM_TOKENS = ("deadline", "timeout")

# attribute accesses that witness a request object's deadline in scope:
# req.deadline / req.expired(now) / req.remaining()
DEADLINE_ATTRS = {"deadline", "remaining", "expired", "deadline_abs"}

# bound-accepting blocking calls (rule 1): terminal method names that
# take a timeout and block the calling thread until it elapses
WAIT_METHODS = {"result", "wait", "join", "acquire"}
# cross-process fetch/stream verbs whose bound must be request-derived
FETCH_CALLS = {
    "fetch_kv", "fetch_chain", "fetch_one", "fetch_handoff",
    "fetch_one_handoff", "run_stream", "flush",
}
# service-client verbs: wire calls — only when the receiver looks like a
# service client or the call carries wire kwargs (json/headers/data),
# so dict.get()/cache.put() never match
SERVICE_VERBS = {"post", "get", "put", "patch", "delete", "request", "stream"}
SERVICE_RECEIVERS = {
    "svc", "_svc", "service", "client", "session", "http", "conn",
}
WIRE_KWARGS = {"json", "headers", "data"}

# kwarg names that carry the bound into a callee
BOUND_KWARGS = {
    "timeout", "deadline", "timeout_s", "deadline_s", "max_wait",
    "join_timeout", "max_elapsed", "budget",
}

# SSE / chunked-transfer frame-iteration calls: one blocking read per
# loop iteration — the open-time timeout does NOT bound the loop
FRAME_ITER_CALLS = {"lines", "iter_events", "iter_lines", "iter_content"}

# receivers that ARE the stop signal: waiting on one is interruptible
# by definition (stop() sets it), and pacing a maintenance loop with
# stop.wait(interval) is the idiom gofrlint's blocking-call rule asks for
_STOP_NAME_TOKENS = (
    "stop", "shutdown", "shut_down", "halt", "quit", "exit", "done",
    "closed", "closing", "cancel", "term", "finished", "wake", "release",
)

# retry vocabulary (rule 3)
RETRY_CALL_NAMES = {"requeue", "reconnect", "resubmit", "retry"}
BUDGET_EVIDENCE_TOKENS = (
    "max_elapsed", "deadline", "remaining", "expired", "budget",
    "max_retries", "retries", "attempt", "monotonic", "perf_counter",
    "elapsed",
)

# serving entry points: the call-graph roots. Bare
# function names, classes whose EVERY method is a root, and files whose
# every top-level function is a root (the HTTP handler surface).
ENTRY_FUNC_NAMES = {
    "submit", "stream", "generate", "generate_stream", "generate_cancel",
    "kv_fetch", "ws_generate", "embed",
    "fetch_chain", "fetch_one", "fetch_handoff", "fetch_one_handoff",
    "fetch_kv",
    # the HA plane's keyed re-attach walk: ServingEngine/Router/replica
    # resume and remote.open_resume, beside remote.run_stream
    "resume", "open_resume", "run_stream",
}
# single methods that are roots where their bare name is too generic to
# root every def that shares it (a lock's acquire)
ENTRY_METHODS = {"AdapterRegistry": {"acquire"}}
ENTRY_CLASSES = {"HTTPReplica", "LocalReplica"}
ENTRY_FILES = ("gofr_tpu_torch/serving/handlers.py",)

# cancellation/teardown roots (rule 4)
CANCEL_ROOT_NAMES = {
    "cancel", "drain", "stop", "shutdown", "close", "warm_restart",
}

# scaffolding is process-lifetime by design; the analyzers lint code,
# they are not on any request path themselves
_EXEMPT_PREFIXES = ("gofr_tpu_torch/testutil/", "gofr_tpu_torch/analysis/")


# -- helpers ------------------------------------------------------------------


def _dotted(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(dotted: str | None) -> str | None:
    return None if dotted is None else dotted.rsplit(".", 1)[-1]


def _receiver_terminal(call: ast.Call) -> str | None:
    if not isinstance(call.func, ast.Attribute):
        return None
    return _terminal(_dotted(call.func.value))


def _is_deadline_param(name: str) -> bool:
    low = name.lower()
    return low in DEADLINE_PARAM_NAMES or any(
        tok in low for tok in DEADLINE_PARAM_TOKENS
    )


def _is_stopish(name: str | None) -> bool:
    if name is None:
        return False
    low = name.lower()
    return any(tok in low for tok in _STOP_NAME_TOKENS)


def _mentions_derived(expr: ast.expr, derived: set[str]) -> bool:
    """True when ``expr`` references a deadline-derived local name or a
    request object's deadline surface (``req.remaining()``,
    ``req.deadline``) — the derived-bound grammar."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and node.id in derived:
            return True
        if isinstance(node, ast.Attribute) and node.attr in DEADLINE_ATTRS:
            return True
    return False


def _names_in(expr: ast.expr) -> Iterable[str]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            yield node.id


def _mentions_token(node: ast.AST, tokens: tuple[str, ...]) -> bool:
    for sub in ast.walk(node):
        name = None
        if isinstance(sub, ast.Name):
            name = sub.id
        elif isinstance(sub, ast.Attribute):
            name = sub.attr
        elif isinstance(sub, ast.keyword) and sub.arg:
            name = sub.arg
        if name is not None:
            low = name.lower()
            if any(tok in low for tok in tokens):
                return True
    return False


# -- per-function facts -------------------------------------------------------


@dataclasses.dataclass
class _CallSite:
    term: str
    recv: str | None
    line: int
    n_args: int
    kwarg_names: tuple[str, ...]
    bound_kw: str | None          # first BOUND_KWARGS kwarg present
    bound_derived: bool           # that kwarg's value mentions a derived name
    any_arg_derived: bool         # any arg/kwarg mentions a derived name
    wire_kwargs: bool             # carries json=/headers=/data=
    has_splat: bool               # forwards **kw — a bound may ride through
    settled_recv: bool            # same receiver had .done()/.exception()
    #                               consulted in this function: the future
    #                               is known settled, .result() cannot block


@dataclasses.dataclass
class _FrameLoop:
    line: int
    iter_term: str
    bounded: bool  # iter call or loop body mentions the deadline grammar


@dataclasses.dataclass
class _DeadlineFunc:
    name: str
    cls: str | None
    rel_path: str
    line: int
    has_deadline_scope: bool = False
    derived: set[str] = dataclasses.field(default_factory=set)
    calls: list[_CallSite] = dataclasses.field(default_factory=list)
    called_names: set[str] = dataclasses.field(default_factory=set)
    frame_loops: list[_FrameLoop] = dataclasses.field(default_factory=list)
    checks_expiry: bool = False    # mentions expired/deadline/remaining
    requeue_sites: list[int] = dataclasses.field(default_factory=list)

    @property
    def qual(self) -> str:
        return f"{self.cls}.{self.name}" if self.cls else self.name


@dataclasses.dataclass
class _DeadlineModule:
    rel_path: str
    funcs: list[_DeadlineFunc] = dataclasses.field(default_factory=list)
    all_def_names: set[str] = dataclasses.field(default_factory=set)


def _collect_func(
    fn: ast.FunctionDef | ast.AsyncFunctionDef, cls: str | None, rel_path: str
) -> _DeadlineFunc:
    info = _DeadlineFunc(fn.name, cls, rel_path, fn.lineno)
    params = [
        a.arg for a in (
            fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        )
    ]
    derived = {p for p in params if _is_deadline_param(p)}
    # derived-name fixpoint over assignments: anything computed from a
    # deadline name (or a request's .remaining()/.deadline) is derived
    assigns: list[tuple[list[str], ast.expr]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets: list[str] = []
            for t in node.targets:
                if isinstance(t, ast.Name):
                    targets.append(t.id)
                elif isinstance(t, ast.Subscript):
                    d = _dotted(t.value)
                    if d is not None and "." not in d:
                        targets.append(d)  # kw["deadline"] = … taints kw
            if targets:
                assigns.append((targets, node.value))
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                assigns.append(([node.target.id], node.value))
    for _ in range(8):
        grew = False
        for targets, value in assigns:
            if _mentions_derived(value, derived):
                for t in targets:
                    if t not in derived:
                        derived.add(t)
                        grew = True
        if not grew:
            break
    info.derived = derived
    info.has_deadline_scope = bool(derived) or any(
        isinstance(n, ast.Attribute) and n.attr in DEADLINE_ATTRS
        for n in ast.walk(fn)
    )
    info.checks_expiry = _mentions_token(fn, BUDGET_EVIDENCE_TOKENS)
    # receivers whose settled-ness this function consults (.done() /
    # .exception()): a .result() on one cannot block — the done-callback
    # idiom (Router._on_attempt_done and friends)
    settled: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in ("done", "exception"):
            recv = _receiver_terminal(node)
            if recv is not None:
                settled.add(recv)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            term = _terminal(_dotted(node.func))
            if term is None:
                continue
            info.called_names.add(term)
            kwargs = tuple(k.arg for k in node.keywords if k.arg)
            bound_kw = next((k for k in kwargs if k in BOUND_KWARGS), None)
            bound_derived = False
            if bound_kw is not None:
                for k in node.keywords:
                    if k.arg == bound_kw:
                        bound_derived = _mentions_derived(k.value, derived)
                        break
            any_arg = any(
                _mentions_derived(a, derived) for a in node.args
            ) or any(
                _mentions_derived(k.value, derived) for k in node.keywords
            )
            recv = _receiver_terminal(node)
            info.calls.append(_CallSite(
                term, recv, node.lineno,
                len(node.args), kwargs, bound_kw, bound_derived, any_arg,
                bool(set(kwargs) & WIRE_KWARGS),
                any(k.arg is None for k in node.keywords),
                recv is not None and recv in settled,
            ))
            if term in RETRY_CALL_NAMES or any(
                k.arg == "front"
                and isinstance(k.value, ast.Constant) and k.value.value is True
                for k in node.keywords
            ):
                info.requeue_sites.append(node.lineno)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            if isinstance(node.iter, ast.Call):
                it = _terminal(_dotted(node.iter.func))
                if it in FRAME_ITER_CALLS:
                    bounded = _mentions_derived(node.iter, derived) or any(
                        _mentions_token(s, BUDGET_EVIDENCE_TOKENS)
                        for s in node.body
                    )
                    info.frame_loops.append(
                        _FrameLoop(node.lineno, it, bounded)
                    )
    return info


def _module_of(sf: SourceFile) -> _DeadlineModule:
    mod = getattr(sf, "_deadlinecheck_module", None)
    if mod is None:
        mod = _DeadlineModule(sf.rel_path)
        for stmt in sf.tree.body:
            if isinstance(stmt, ast.ClassDef):
                for m in stmt.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        mod.funcs.append(
                            _collect_func(m, stmt.name, sf.rel_path)
                        )
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                mod.funcs.append(_collect_func(stmt, None, sf.rel_path))
        for node in ast.walk(sf.tree):
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
            ):
                mod.all_def_names.add(node.name)
        sf._deadlinecheck_module = mod  # type: ignore[attr-defined]
    return mod


# -- the whole-program call graph ---------------------------------------------


class DeadlineGraph:
    """Name-based over-approximated call graph: an edge from F to every
    program function sharing a called bare name. BFS from the serving
    entry roots (and, separately, the cancel/teardown roots) gives the
    reachable sets rules 2 and 4 gate on."""

    def __init__(self) -> None:
        self.modules: dict[str, _DeadlineModule] = {}

    def add(self, sf: SourceFile) -> _DeadlineModule:
        mod = _module_of(sf)
        self.modules[sf.rel_path] = mod
        return mod

    def _funcs(self) -> list[_DeadlineFunc]:
        return [f for m in self.modules.values() for f in m.funcs]

    def _index(self) -> dict[str, list[_DeadlineFunc]]:
        idx: dict[str, list[_DeadlineFunc]] = {}
        for f in self._funcs():
            idx.setdefault(f.name, []).append(f)
        return idx

    def _bfs(self, roots: list[_DeadlineFunc]) -> set[int]:
        idx = self._index()
        seen: set[int] = set()
        frontier = list(roots)
        while frontier:
            nxt: list[_DeadlineFunc] = []
            for f in frontier:
                if id(f) in seen:
                    continue
                seen.add(id(f))
                for name in f.called_names:
                    for g in idx.get(name, ()):
                        if id(g) not in seen:
                            nxt.append(g)
            frontier = nxt
        return seen

    def serving_reachable(self) -> set[int]:
        roots = [
            f for f in self._funcs()
            if not any(f.rel_path.startswith(p) for p in _EXEMPT_PREFIXES)
            and (
                f.name in ENTRY_FUNC_NAMES
                or f.name in ENTRY_METHODS.get(f.cls or "", ())
                or f.cls in ENTRY_CLASSES
                or any(f.rel_path.endswith(e) for e in ENTRY_FILES)
            )
        ]
        return self._bfs(roots)

    def cancel_reachable(self) -> set[int]:
        roots = [
            f for f in self._funcs()
            if f.name in CANCEL_ROOT_NAMES
            and not any(f.rel_path.startswith(p) for p in _EXEMPT_PREFIXES)
        ]
        return self._bfs(roots)


# -- rule 1: deadline-dropped -------------------------------------------------


def _bound_sink(site: _CallSite) -> str | None:
    """Classify a call site as a bound-accepting blocking call, or None.
    Returns a short label for the finding message."""
    term, recv = site.term, site.recv
    if site.has_splat:
        return None  # **kw forwarding: the caller's bound rides through
    if term == "result" and site.settled_recv:
        return None  # done-callback: the future is already settled
    if term in WAIT_METHODS and recv is not None:
        if term == "join" and (site.n_args > 0 or site.kwarg_names):
            # `sep.join(parts)` is str.join; `t.join(timeout=…)` is
            # handled through the bound kwarg below
            if site.bound_kw is None:
                return None
        if term == "wait" and _is_stopish(recv):
            return None  # stop-event pacing: interruptible by design
        return f"{recv}.{term}()"
    if term in FETCH_CALLS:
        return f"{term}()"
    if term in SERVICE_VERBS and (
        (recv is not None and recv.lstrip("_") in {
            r.lstrip("_") for r in SERVICE_RECEIVERS
        }) or site.wire_kwargs
    ):
        return f"{recv or ''}.{term}()".lstrip(".")
    if term == "urlopen":
        return "urlopen()"
    return None


class DeadlineDroppedRule(Rule):
    """``deadline-dropped``: a function holding a request-scoped
    deadline makes a bound-accepting blocking call whose bound is not
    derived from it — the deadline dies at that frame."""

    name = "deadline-dropped"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if any(sf.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        for f in mod.funcs:
            if not f.has_deadline_scope:
                continue
            for site in f.calls:
                label = _bound_sink(site)
                if label is None:
                    continue
                if site.bound_derived or site.any_arg_derived:
                    continue  # a derived bound (or the deadline itself)
                    # rides into the callee
                if site.bound_kw is not None:
                    how = (
                        f"passes a constant {site.bound_kw}= while "
                        "the request's deadline is in scope"
                    )
                else:
                    how = "passes no bound at all"
                out.append(Finding(
                    self.name, sf.rel_path, site.line,
                    f"'{f.qual}' holds a request-scoped deadline but "
                    f"{label} {how} — derive the bound from the "
                    "remaining deadline (min(cap, remaining)) so the "
                    "wait can never outlive the request",
                ))
        return out


# -- rule 2: unbounded-wire-call ----------------------------------------------


def _unbounded_wire(site: _CallSite) -> str | None:
    term, recv = site.term, site.recv
    if site.has_splat:
        return None  # **kw forwarding: the caller's bound rides through
    if term == "result" and recv is not None and site.n_args == 0 \
            and site.bound_kw is None and not site.settled_recv:
        return f"{recv}.result() without a timeout"
    if term == "wait" and recv is not None and site.n_args == 0 \
            and site.bound_kw is None and not _is_stopish(recv):
        return f"{recv}.wait() without a timeout"
    if term == "join" and recv is not None and site.n_args == 0 \
            and not site.kwarg_names:
        return f"{recv}.join() without a timeout"
    if term in SERVICE_VERBS and (
        (recv is not None and recv.lstrip("_") in {
            r.lstrip("_") for r in SERVICE_RECEIVERS
        }) or site.wire_kwargs
    ) and site.bound_kw is None:
        return f"service call {recv or ''}.{term}() without a timeout"
    if term == "urlopen" and site.bound_kw is None:
        return "urlopen() without a timeout"
    return None


class UnboundedWireCallRule(Rule):
    """``unbounded-wire-call``: a transport/wait site reachable from a
    serving entry point with no finite bound. Cross-file — reachability
    needs the whole-program graph, so findings come from finalize."""

    name = "unbounded-wire-call"
    cross_file = True

    def __init__(self) -> None:
        self.graph = DeadlineGraph()

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        self.graph.add(sf)
        return []

    def finalize(self) -> list[Finding]:
        reachable = self.graph.serving_reachable()
        out: list[Finding] = []
        for mod in self.graph.modules.values():
            if any(mod.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
                continue
            for f in mod.funcs:
                if id(f) not in reachable:
                    continue
                for site in f.calls:
                    label = _unbounded_wire(site)
                    if label is None:
                        continue
                    out.append(Finding(
                        self.name, f.rel_path, site.line,
                        f"'{f.qual}' is reachable from a serving entry "
                        f"point and {label} — an unbounded wait here "
                        "holds a request (and its slot/KV budget) past "
                        "any deadline; pass a finite bound",
                    ))
                for loop in f.frame_loops:
                    if loop.bounded:
                        continue
                    out.append(Finding(
                        self.name, f.rel_path, loop.line,
                        f"'{f.qual}' iterates stream frames via "
                        f"{loop.iter_term}() with no deadline enforced "
                        "between reads — an expired request keeps the "
                        "remote decode (and this worker) running to "
                        "completion; check the remaining deadline per frame",
                    ))
        out.sort(key=lambda f: (f.path, f.line))
        return out


# -- rule 3: retry-unbudgeted -------------------------------------------------


class RetryUnbudgetedRule(Rule):
    """``retry-unbudgeted``: retry loops with no max-elapsed ladder, and
    requeue sites in functions that never check request expiry."""

    name = "retry-unbudgeted"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if any(sf.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
            return []
        out: list[Finding] = []
        for node in ast.walk(sf.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for loop in ast.walk(node):
                if not isinstance(loop, ast.While):
                    continue
                if not self._retries(loop):
                    continue
                if self._budgeted(loop):
                    continue
                out.append(Finding(
                    self.name, sf.rel_path, loop.lineno,
                    f"retry loop in '{node.name}' has no budget: no "
                    "RetryConfig-style max_elapsed ladder, no "
                    "attempt/deadline bound, no monotonic-clock gate, "
                    "and no stop-Event pacing — a persistent failure "
                    "spins forever; govern it with a max-elapsed "
                    "budget (service/options.py Retry)",
                ))
        # the AdapterBusy requeue class: a front-of-queue requeue in a
        # function that never consults request expiry would cycle an
        # expired request through admission forever
        mod = _module_of(sf)
        for f in mod.funcs:
            if not f.requeue_sites or f.checks_expiry:
                continue
            for line in f.requeue_sites:
                out.append(Finding(
                    self.name, sf.rel_path, line,
                    f"'{f.qual}' requeues work but never checks request "
                    "expiry (no expired()/deadline/remaining consult on "
                    "any path) — an expired request would requeue "
                    "forever; gate the requeue on the remaining deadline",
                ))
        out.sort(key=lambda f: (f.path, f.line))
        return out

    @staticmethod
    def _retries(loop: ast.While) -> bool:
        for sub in ast.walk(loop):
            if isinstance(sub, ast.Try):
                for handler in sub.handlers:
                    for s in ast.walk(handler):
                        if isinstance(s, ast.Continue):
                            return True
            if isinstance(sub, ast.Call):
                term = _terminal(_dotted(sub.func))
                if term in RETRY_CALL_NAMES:
                    return True
        return False

    @staticmethod
    def _budgeted(loop: ast.While) -> bool:
        if _mentions_token(loop, BUDGET_EVIDENCE_TOKENS):
            return True
        # `while not self._stop.is_set():` / stop.wait(delay) pacing:
        # shutdown-interruptible maintenance loops are governed by their
        # owner's stop(), not a per-request budget
        if _mentions_token(loop.test, _STOP_NAME_TOKENS):
            return True
        for sub in ast.walk(loop):
            if isinstance(sub, ast.Call):
                term = _terminal(_dotted(sub.func))
                if term in ("wait", "is_set") and _is_stopish(
                    _receiver_terminal(sub)
                ):
                    return True
        return False


# -- rule 4: cancel-unreachable -----------------------------------------------


def _unbounded_wait(site: _CallSite) -> str | None:
    term, recv = site.term, site.recv
    if recv is None or site.has_splat:
        return None
    if term == "result" and site.settled_recv:
        return None  # done-callback: the future is already settled
    if term in ("wait", "result") and site.n_args == 0 \
            and site.bound_kw is None and not _is_stopish(recv):
        return f"{recv}.{term}()"
    if term == "join" and site.n_args == 0 and not site.kwarg_names:
        return f"{recv}.join()"
    if term == "acquire" and site.n_args == 0 and not site.kwarg_names \
            and not _is_stopish(recv):
        return f"{recv}.acquire()"
    return None


class CancelUnreachableRule(Rule):
    """``cancel-unreachable``: a blocking wait reachable from the
    cancel/drain/stop/shutdown surface that waits on no stop Event and
    has no bounded timeout — cancellation cannot interrupt it."""

    name = "cancel-unreachable"
    cross_file = True

    def __init__(self) -> None:
        self.graph = DeadlineGraph()

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        self.graph.add(sf)
        return []

    def finalize(self) -> list[Finding]:
        reachable = self.graph.cancel_reachable()
        out: list[Finding] = []
        for mod in self.graph.modules.values():
            if any(mod.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
                continue
            for f in mod.funcs:
                if id(f) not in reachable:
                    continue
                for site in f.calls:
                    label = _unbounded_wait(site)
                    if label is None:
                        continue
                    out.append(Finding(
                        self.name, f.rel_path, site.line,
                        f"'{f.qual}' is reachable from the cancel/drain/"
                        f"stop surface and parks on {label} with no stop "
                        "Event and no bounded timeout — cancellation "
                        "cannot interrupt it; bound the wait or gate it "
                        "on the stop Event",
                    ))
        out.sort(key=lambda f: (f.path, f.line))
        return out


# -- rule 5: zone-drift -------------------------------------------------------


def _default_zone_specs() -> list[tuple[str, str, dict[str, Any]]]:
    """(label, home-module-rel-path, {file-suffix: functions|'*'}) for
    every zone table the analyzer family keys on. Imported lazily so a
    fixture tree can inject fake tables without touching the real ones."""
    from gofr_tpu_torch.analysis import kernel_contracts as kc
    from gofr_tpu_torch.analysis import leakcheck as lk
    from gofr_tpu_torch.analysis import rules as rules_mod
    from gofr_tpu_torch.analysis import shardcheck as sc

    rules_home = "gofr_tpu_torch/analysis/rules.py"
    unpack: dict[str, set[str]] = {}
    for site in kc.UNPACK_SITES:
        unpack.setdefault(site.file, set()).add(site.function)
    kernels: dict[str, set[str]] = {}
    for k in kc.KERNELS:
        kernels.setdefault(k.file, set()).add(k.name)
    return [
        ("DISPATCH_ZONES", rules_home, dict(rules_mod.DISPATCH_ZONES)),
        ("BACKOFF_ZONES", rules_home, dict(rules_mod.BACKOFF_ZONES)),
        ("ROUTER_RETRY_ZONES", rules_home, dict(rules_mod.ROUTER_RETRY_ZONES)),
        ("HOT_SYNC_ZONES", rules_home, dict(rules_mod.HOT_SYNC_ZONES)),
        ("RETRACE_ZONE_FILES", "gofr_tpu_torch/analysis/shardcheck.py",
         {f: "*" for f in sc.RETRACE_ZONE_FILES}),
        ("RETRACE_ZONE_DIRS", "gofr_tpu_torch/analysis/shardcheck.py",
         {d: "*" for d in sc.RETRACE_ZONE_DIRS}),
        ("RETIRE_GATE_ZONES", "gofr_tpu_torch/analysis/leakcheck.py",
         dict(lk.RETIRE_GATE_ZONES)),
        ("KERNEL_FILES", "gofr_tpu_torch/analysis/kernel_contracts.py",
         kernels),
        ("UNPACK_SITES", "gofr_tpu_torch/analysis/kernel_contracts.py",
         unpack),
    ]


class ZoneDriftRule(Rule):
    """``zone-drift``: a zone entry naming a file that is no longer
    scanned, or a function that no longer exists in it, silently
    disables the rules keyed on that zone. Cross-file; gated on the
    anchor file so fixture trees don't trip the real tables."""

    name = "zone-drift"
    cross_file = True

    def __init__(
        self,
        zones: list[tuple[str, str, dict[str, Any]]] | None = None,
        anchor: str | None = "gofr_tpu_torch/serving/engine.py",
        anchor_symbol: str | None = "ServingEngine",
    ) -> None:
        self._zones = zones
        self._anchor = anchor
        # a fixture tree can materialize a file NAMED like the anchor
        # (shardcheck's engine.py fixtures do); requiring the anchor to
        # also DEFINE the marker symbol pins the gate to the real tree
        self._anchor_symbol = anchor_symbol if zones is None else None
        self._anchor_seen = anchor is None
        self._files: dict[str, set[str]] = {}  # rel_path -> def names

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        mod = _module_of(sf)
        self._files[sf.rel_path] = mod.all_def_names
        if self._anchor is not None and sf.rel_path.endswith(self._anchor):
            if (self._anchor_symbol is None
                    or self._anchor_symbol in mod.all_def_names):
                self._anchor_seen = True
        return []

    def finalize(self) -> list[Finding]:
        if not self._anchor_seen:
            return []
        zones = self._zones if self._zones is not None \
            else _default_zone_specs()
        out: list[Finding] = []
        for label, home, table in zones:
            for suffix, funcs in table.items():
                if suffix.endswith("/"):
                    if not any(
                        rel.startswith(suffix) or f"/{suffix}" in f"/{rel}"
                        for rel in self._files
                    ):
                        out.append(Finding(
                            self.name, home, 1,
                            f"{label} names directory '{suffix}' but no "
                            "scanned file lives under it — the zone is "
                            "dead and its rules silently disabled; fix "
                            "or delete the entry",
                        ))
                    continue
                matches = [
                    rel for rel in self._files if rel.endswith(suffix)
                ]
                if not matches:
                    out.append(Finding(
                        self.name, home, 1,
                        f"{label} names file '{suffix}' which no longer "
                        "exists in the scanned tree — the zone is dead "
                        "and its rules silently disabled; fix or delete "
                        "the entry",
                    ))
                    continue
                if funcs == "*":
                    continue
                defined: set[str] = set()
                for rel in matches:
                    defined |= self._files[rel]
                for fn in sorted(set(funcs) - defined):
                    out.append(Finding(
                        self.name, home, 1,
                        f"{label}['{suffix}'] names function '{fn}' "
                        "which no longer exists there — the zone entry "
                        "is stale and its rules silently skip the moved "
                        "code; fix or delete the name",
                    ))
        out.sort(key=lambda f: (f.path, f.line, f.message))
        return out


def deadlinecheck_rules() -> list[Rule]:
    return [
        DeadlineDroppedRule(), UnboundedWireCallRule(),
        RetryUnbudgetedRule(), CancelUnreachableRule(), ZoneDriftRule(),
    ]


# -- static boundary table & runtime cross-check ------------------------------

# the deadline-budget boundaries the runtime tracer instruments
# (analysis/deadlinetrace.py): Class → methods, plus module-level
# functions. Every runtime-observed crossing site must appear here.
BOUNDARY_CLASSES: dict[str, set[str]] = {
    # HA plane: the keyed re-attach walk carries the caller's deadline
    # through the same replica tiers submit does
    "Router": {"submit", "resume"},
    "LocalReplica": {"submit", "resume"},
    "HTTPReplica": {"submit", "fetch_kv", "resume"},
    "ServingEngine": {"submit"},
    "KVMigrator": {"fetch_chain", "fetch_handoff", "evacuate_chain"},
    "AdapterRegistry": {"acquire"},
}
BOUNDARY_FUNCS: set[str] = {"run_stream", "open_resume"}


def build_boundary_table(paths: list[str]) -> dict:
    """The static deadline-boundary table: every (class, method) and
    module function the runtime deadline tracer may observe a budget
    crossing at, with its defining site. ``--deadline-table`` emits it;
    ``--check-deadline-table`` asserts a runtime export is a subset."""
    from gofr_tpu_torch.analysis.core import iter_python_files

    sites: dict[str, str] = {}
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as fp:
            source = fp.read()
        try:
            tree = ast.parse(source, filename=full)
        except SyntaxError:
            continue
        for stmt in tree.body:
            if isinstance(stmt, ast.ClassDef):
                wanted = BOUNDARY_CLASSES.get(stmt.name)
                if not wanted:
                    continue
                for m in stmt.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and m.name in wanted:
                        sites[f"{stmt.name}.{m.name}"] = f"{rel}:{m.lineno}"
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if stmt.name in BOUNDARY_FUNCS:
                    mod = rel.rsplit("/", 1)[-1].removesuffix(".py")
                    sites[f"{mod}.{stmt.name}"] = f"{rel}:{stmt.lineno}"
    return {"version": 1, "sites": dict(sorted(sites.items()))}


def render_table_json(table: dict) -> str:
    return json.dumps(table, indent=2, sort_keys=True)


def check_deadline_coverage(runtime: dict, table: dict) -> list[str]:
    """Verify every runtime-observed boundary crossing
    (:mod:`gofr_tpu_torch.analysis.deadlinetrace` export: ``{"events":
    [{"site", "op"}]}``) is statically known, and surface any budget
    violations the tracer recorded. Returns human-readable divergences
    (empty = ok); an unknown site means the analyzer's boundary table
    has a blind spot for a crossing the runtime actually took."""
    known = set(table.get("sites", {}))
    divergences: list[str] = []
    for ev in runtime.get("events", ()):
        site = ev.get("site")
        if site not in known:
            divergences.append(
                f"runtime deadline crossing at unknown boundary '{site}' "
                "— add it to deadlinecheck.BOUNDARY_CLASSES/FUNCS"
            )
    for v in runtime.get("violations", ()):
        divergences.append(f"runtime budget violation: {v}")
    return sorted(set(divergences))
