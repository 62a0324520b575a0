"""leakcheck — whole-program resource-lifecycle analysis of the port.

The port's copy of ``gofr_tpu/analysis/leakcheck.py``, written against
``gofr_tpu_torch/``. The lifecycle tests prove the invariant ("exactly
one terminal state, slots + KV pages reclaimed, zero leaked spans,
thread exits clean") on the paths they drive; this module is its static
twin over every path, in four rule families over the serving control
plane:

``leak-unreleased``
    Acquire/release pairing over a whole-program table of paired
    resources (:data:`RESOURCES`): the ``Scheduler`` and ``TPUClient``
    wrappers → ``close()``, KV ``alloc_slot``/``try_reserve_slot``/
    ``try_reserve_chunk`` → ``free_slot`` (and ``allocator.alloc`` →
    ``allocator.free``), tracer ``start_span`` → ``end()``/
    ``close_spans`` (or the ``open_span`` ownership sink),
    ``TimelineRecorder.begin`` → ``finish``, ``ThreadPoolExecutor`` →
    ``shutdown``, non-daemon ``Thread`` → ``join``. Each acquisition
    must reach a *disposition*: released in-function (``with`` / a
    release call on the bound name), transferred (returned, yielded,
    stored into another object, passed to a sink or any non-trivial
    callee, or carrying an explicit ``# leakcheck: transfer(<recipient>)``
    annotation), or escalated to its class — in which case the class
    (any method, interprocedurally through same-class calls) must
    contain a paired release or a call to a transfer-annotated method.
    Factory returns resolve cross-file: a function whose return value is
    an acquisition makes its *call sites* the acquisitions.

    The reference's ``native-handle`` kind (``gofr_*_create`` →
    ``gofr_*_destroy``) has no counterpart here: the port carries no
    ``native/`` runtime (ROADMAP Queue C 33, 37), so no call of the port
    acquires a raw handle. Its ``native-wrapper`` kind is the port's
    ``wrapper`` kind, whose constructors are the port's ``Scheduler``
    and ``TPUClient``; the port's ``BlockAllocator`` is a Python ledger
    with nothing to close, and its sequences are the ``kv-seq`` kind.

``leak-exception-path``
    When an acquire and its paired release live in ONE function, every
    explicit ``raise``/``return`` edge between them must not strand the
    resource: the release must sit in a ``finally`` of a try enclosing
    the acquire, or the escaping path must release first (an ``except``
    handler of the try that *directly* contains the acquire is exempt —
    on that edge the acquisition itself failed).

``settle-on-raise``
    Settlement-reachability: a function that REGISTERS a future/timeline
    (``self._by_id[rid] = req``, ``timeline.begin``) must have every
    subsequent explicit ``raise`` post-dominated by a settle call
    (``_try_resolve`` / ``_settle_future`` / ``finish`` /
    ``set_exception`` …) — either a settle earlier on the same path or an
    enclosing ``try`` whose handler/finally settles.

``retire-gate-missing``
    Transfer-ownership discipline for resources crossing threads: in the
    engine-thread zone, between a blocking call (migration
    ``fetch_one``/``fetch_chain``, the monolithic ``prefill_compute``
    dispatch) and any commit into rebuilt state (cache ``put``,
    ``write_span``/``write_prefill``/``insert_chunk``, ...) there must be
    a ``_check_retired()`` gate — a thread retired by a warm restart
    mid-fetch must never insert dead slabs into the state the restart
    just reset.

Deliberate leaks are declared, not suppressed ad hoc: a
``# leakcheck: transfer(<recipient>)`` annotation on a ``def`` line makes
that method a declared ownership-transfer sink (the quarantine ``leak()``
methods carry ``transfer(quarantine)``), and on an acquire line it marks
that single acquisition transferred. A malformed annotation is itself a
``bad-transfer-annotation`` finding and declares nothing.

Like lockcheck, the analysis over-approximates toward a SUPERSET table:
branches are scanned linearly, unresolvable calls are ignored, and any
plausible transfer counts — so the runtime reclaim tracer's observed
acquire/release sites (:mod:`gofr_tpu_torch.analysis.leaktrace`) can be
asserted a subset of the static table (:func:`check_coverage`); a
divergence is an analyzer blind spot, not a test flake.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from typing import Any, Iterable

from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# -- resource vocabulary ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """One paired-resource family. ``acquire`` are VALUE-producing call
    terminal names (constructors, handle factories, ``start_span``) —
    the bound name carries the obligation; ``acquire_methods`` are
    receiver-STATE acquires (``alloc_slot``) — the obligation lands on
    the enclosing class. ``*_receivers`` restrict matching to receivers
    whose terminal attribute name is listed (guards generic names like
    ``begin``/``alloc`` against sql transactions etc.). ``sinks`` are
    callee names that take ownership of an argument (``open_span``:
    the timeline's terminal mark closes registered spans)."""

    kind: str
    acquire: frozenset = frozenset()
    acquire_methods: frozenset = frozenset()
    release: frozenset = frozenset()
    acquire_receivers: frozenset = frozenset()
    release_receivers: frozenset = frozenset()
    sinks: frozenset = frozenset()


RESOURCES: tuple[ResourceSpec, ...] = (
    # the reference's native-handle kind (gofr_*_create/destroy) has no
    # counterpart: the port carries no native/ runtime (ROADMAP Queue C
    # 33, 37), so nothing here acquires a raw handle
    ResourceSpec(
        "wrapper",
        # the port's Scheduler (serving/scheduler.py) and the device
        # datasource's TPUClient (datasource/tpu/client.py) in place of
        # the reference's native Scheduler/BlockAllocator/PjrtClient/
        # PjrtExecutable; the port's BlockAllocator is a plain Python
        # ledger with nothing to close (its sequences are kv-seq below)
        acquire=frozenset({"Scheduler", "TPUClient"}),
        release=frozenset({"close", "destroy"}),
    ),
    ResourceSpec(
        "kv-slot",
        acquire_methods=frozenset({
            "alloc_slot", "try_reserve_slot", "try_reserve_chunk",
        }),
        release=frozenset({"free_slot"}),
    ),
    ResourceSpec(
        "kv-seq",
        acquire_methods=frozenset({"alloc"}),
        release=frozenset({"free"}),
        acquire_receivers=frozenset({"allocator"}),
        release_receivers=frozenset({"allocator"}),
    ),
    ResourceSpec(
        "span",
        acquire=frozenset({"start_span"}),
        release=frozenset({"end", "end_span", "close_spans"}),
        sinks=frozenset({"open_span"}),
    ),
    ResourceSpec(
        "timeline",
        acquire=frozenset({"begin"}),
        release=frozenset({"finish", "mark_terminal"}),
        acquire_receivers=frozenset({"timeline", "recorder"}),
    ),
    ResourceSpec(
        "executor",
        acquire=frozenset({"ThreadPoolExecutor"}),
        release=frozenset({"shutdown"}),
    ),
    ResourceSpec(
        "thread",
        acquire=frozenset({"Thread"}),  # non-daemon only (see _thread_exempt)
        release=frozenset({"join"}),
    ),
)

_ACQUIRE_VALUE: dict[str, ResourceSpec] = {}
_ACQUIRE_METHOD: dict[str, ResourceSpec] = {}
_RELEASE: dict[str, list[ResourceSpec]] = {}
_SINKS: dict[str, ResourceSpec] = {}
for _spec in RESOURCES:
    for _n in _spec.acquire:
        _ACQUIRE_VALUE[_n] = _spec
    for _n in _spec.acquire_methods:
        _ACQUIRE_METHOD[_n] = _spec
    for _n in _spec.release:
        _RELEASE.setdefault(_n, []).append(_spec)
    for _n in _spec.sinks:
        _SINKS[_n] = _spec

# callables whose argument positions never take ownership — passing a
# handle to int()/_check() is a read, not a transfer
BENIGN_ARG_CALLS = {
    "int", "float", "bool", "str", "len", "repr", "id", "isinstance",
    "getattr", "hasattr", "print", "_check", "max", "min", "abs",
}

# -- settlement-reachability vocabulary ---------------------------------------

# subscript-assignment into these self attributes registers a future the
# engine owes a terminal state (serving/engine.py _by_id)
FUTURE_REGISTRY_ATTRS = {"_by_id"}
# timeline registration: <recv>.begin(...) where the receiver is
# recognizably the flight recorder (guards sql transaction .begin())
TIMELINE_RECEIVERS = {"timeline", "recorder"}
# terminal-settlement vocabulary: reaching any of these settles the
# registered future/timeline
SETTLE_CALLS = {
    "_try_resolve", "_settle_future", "_fail_all",
    "set_exception", "set_result", "finish", "mark_terminal",
}

# -- retirement-gate vocabulary -----------------------------------------------

# engine-thread functions where a blocking call can outlive the thread's
# ownership of the engine (warm restart replaces it mid-call)
RETIRE_GATE_ZONES: dict[str, set[str] | str] = {
    "gofr_tpu_torch/serving/engine.py": "*",
}
# blocking boundaries: the thread may return RETIRED from these
BLOCKING_FETCH_CALLS = {"fetch_one", "fetch_chain", "prefill_compute"}
# commits into rebuilt state that a retired thread must never perform
COMMIT_CALLS = {
    "put", "write_span", "write_prefill", "insert_chunk",
    "insert_slot", "insert_slot_quantized", "advance_slot",
    "_commit_prefilled", "_commit_first_token",
}
RETIRE_GATE_CALLS = {"_check_retired"}

# scaffolding threads/sockets live exactly as long as the process by
# design (same exemption as hold-and-block / daemon-loop-no-heartbeat)
_EXEMPT_PREFIXES = ("gofr_tpu_torch/testutil/",)

# -- transfer annotations -----------------------------------------------------

_TRANSFER_RE = re.compile(
    r"#\s*leakcheck:\s*transfer\((?P<target>[\w.\-]+)\)\s*$"
)


def parse_transfer_annotations(
    source: str, path: str
) -> tuple[dict[int, str], list[Finding]]:
    """``{line: recipient}`` for every well-formed
    ``# leakcheck: transfer(<recipient>)`` comment, plus
    ``bad-transfer-annotation`` findings for malformed ones. A
    standalone annotation comment covers the next code line (same
    convention as gofrlint suppressions)."""
    out: dict[int, str] = {}
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
        return {}, []
    for line, col, text in comments:
        if "leakcheck:" not in text:
            continue
        m = _TRANSFER_RE.search(text)
        if m is None:
            bad.append(
                Finding(
                    "bad-transfer-annotation", path, line,
                    "unparseable leakcheck annotation — use "
                    "'# leakcheck: transfer(<recipient>)'",
                )
            )
            continue
        target = m.group("target")
        covered = line
        if not src_lines[line - 1][:col].strip():
            covered = line + 1
            while covered <= len(src_lines) and (
                not src_lines[covered - 1].strip()
                or src_lines[covered - 1].lstrip().startswith("#")
            ):
                covered += 1
        out[covered] = target
        out.setdefault(line, target)
    return out, bad


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
    """Terminal attribute name of the call's receiver:
    ``self.timeline.begin(...)`` → ``timeline``."""
    if not isinstance(call.func, ast.Attribute):
        return None
    return _terminal(_dotted(call.func.value))


def _thread_exempt(call: ast.Call) -> bool:
    """daemon=True threads are process-lifetime by design; their
    supervision story is the ``daemon-loop-no-heartbeat`` rule, not
    join-pairing."""
    for kw in call.keywords:
        if kw.arg == "daemon":
            return isinstance(kw.value, ast.Constant) and kw.value.value is True
    return False


def _zone_functions(
    zones: dict[str, set[str] | str], rel_path: str
) -> set[str] | str | None:
    for suffix, funcs in zones.items():
        if rel_path.endswith(suffix):
            return funcs
    return None


def _match_acquire(call: ast.Call) -> ResourceSpec | None:
    """Resource spec for a direct acquisition call, or None."""
    term = _terminal(_dotted(call.func))
    if term is None:
        return None
    spec = _ACQUIRE_VALUE.get(term)
    if spec is not None:
        if spec.kind == "thread" and _thread_exempt(call):
            return None
        if spec.acquire_receivers:
            recv = _receiver_terminal(call)
            if recv not in spec.acquire_receivers:
                return None
        return spec
    spec = _ACQUIRE_METHOD.get(term)
    if spec is not None and spec.acquire_receivers:
        recv = _receiver_terminal(call)
        if recv not in spec.acquire_receivers:
            return None
    return spec


def _match_releases(call: ast.Call) -> list[ResourceSpec]:
    term = _terminal(_dotted(call.func))
    if term is None or not isinstance(call.func, ast.Attribute):
        return []
    out = []
    for spec in _RELEASE.get(term, ()):
        if spec.release_receivers:
            recv = _receiver_terminal(call)
            if recv not in spec.release_receivers:
                continue
        out.append(spec)
    return out


# -- per-function facts -------------------------------------------------------


@dataclasses.dataclass
class _Acquire:
    kind: str | None          # None = PENDING: a call that may resolve to
    line: int                 # a factory at finalize ('self.m()' / bare name)
    what: str                 # rendered name, e.g. "ThreadPoolExecutor"
    var: str | None = None    # local name bound to the value, if any
    method_style: bool = False  # receiver-state acquire (alloc_slot)
    disposed: str | None = None  # with|release|transfer|attr:<name>|annotation
    ctx: tuple = ()           # enclosing (try-id, segment) chain at the site


@dataclasses.dataclass
class _Event:
    op: str    # raise | return | settle | register | fetch | commit | gate | release
    line: int
    ctx: tuple[tuple[int, str], ...] = ()  # (try-id, body|handler|finally) chain
    kind: str | None = None
    recv: str | None = None  # release receiver (`span.end()` → "span")


@dataclasses.dataclass
class _LeakFunc:
    name: str
    rel_path: str
    cls: str | None
    acquires: list[_Acquire] = dataclasses.field(default_factory=list)
    events: list[_Event] = dataclasses.field(default_factory=list)
    # kinds released anywhere in this function (receiver-insensitive
    # beyond the spec's hints): feeds class-level pairing
    released_kinds: set = dataclasses.field(default_factory=set)
    # terminal names of every call, for transfer-method + factory
    # resolution at finalize
    called_names: set = dataclasses.field(default_factory=set)
    registers: bool = False
    # try-id -> (handlers settle, finally settles)
    try_settles: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _LeakClass:
    name: str
    rel_path: str
    funcs: dict = dataclasses.field(default_factory=dict)
    transfer_methods: dict = dataclasses.field(default_factory=dict)
    factory_kinds: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _LeakModule:
    rel_path: str
    classes: dict = dataclasses.field(default_factory=dict)
    funcs: dict = dataclasses.field(default_factory=dict)
    transfer_funcs: dict = dataclasses.field(default_factory=dict)
    factory_kinds: dict = dataclasses.field(default_factory=dict)
    annotations: dict = dataclasses.field(default_factory=dict)
    bad_annotations: list = dataclasses.field(default_factory=list)


class _FuncScanner:
    """Linear statement walk of one function body: records acquisitions
    with their local-name bindings, dispositions of those names, release
    calls, and the event stream (raise/return/settle/register/
    fetch/commit/gate) with try-context — branches share one linear
    scan (over-approximation toward a superset table, like lockcheck);
    nested ``def``/``lambda`` bodies are deferred work and skipped."""

    def __init__(self, info: _LeakFunc, annotations: dict[int, str]) -> None:
        self.info = info
        self.annotations = annotations
        self._ctx: list[tuple[int, str]] = []
        self._next_try = 0
        # local name -> open acquisition (strongest disposition wins)
        self._bound: dict[str, _Acquire] = {}

    # -- disposition ranking --------------------------------------------------
    _RANK = {
        None: 0, "transfer": 1, "attr": 2, "with": 3,
        "release": 3, "annotation": 3,
    }

    def _dispose(self, acq: _Acquire, how: str) -> None:
        base = how.split(":", 1)[0]
        if self._RANK[base] > self._RANK.get(
            (acq.disposed or "").split(":", 1)[0] or None, 0
        ):
            acq.disposed = how

    # -- expression scan ------------------------------------------------------
    def _record_acquire(
        self, call: ast.Call, var: str | None, returned: bool = False
    ) -> _Acquire | None:
        """A direct acquisition — or a PENDING one: a ``self.m()`` /
        bare-name call that finalize may resolve to a factory (its
        disposition is tracked now, while the binding is visible)."""
        spec = _match_acquire(call)
        dotted = _dotted(call.func)
        if spec is None:
            if dotted is None or dotted.count(".") > 1 or (
                "." in dotted and not dotted.startswith("self.")
            ):
                return None  # unresolvable receiver: out of reach
            acq = _Acquire(
                None, call.lineno, dotted, var=var, ctx=tuple(self._ctx)
            )
        else:
            term = _terminal(dotted) or "?"
            acq = _Acquire(
                spec.kind, call.lineno, term, var=var,
                method_style=term in spec.acquire_methods,
                ctx=tuple(self._ctx),
            )
        if call.lineno in self.annotations:
            acq.disposed = "annotation"
        elif returned:
            acq.disposed = "transfer"
        self.info.acquires.append(acq)
        if var is not None and acq.disposed is None and not acq.method_style:
            self._bound[var] = acq
        return acq

    def _scan_call(self, call: ast.Call) -> None:
        dotted = _dotted(call.func)
        term = _terminal(dotted)
        if term is not None:
            self.info.called_names.add(term)
        # releases: mark the kind released here + on the bound name
        for spec in _match_releases(call):
            self.info.released_kinds.add(spec.kind)
            recv = _dotted(call.func.value) if isinstance(
                call.func, ast.Attribute
            ) else None
            self.info.events.append(
                _Event("release", call.lineno, tuple(self._ctx), spec.kind,
                       recv=recv)
            )
            if recv in self._bound:
                self._dispose(self._bound[recv], "release")
        # settle vocabulary (family 2)
        if term in SETTLE_CALLS:
            self.info.events.append(
                _Event("settle", call.lineno, tuple(self._ctx))
            )
            for tid, seg in self._ctx:
                h, f = self.info.try_settles.get(tid, (False, False))
                if seg.startswith("handler"):
                    self.info.try_settles[tid] = (True, f)
                elif seg == "finally":
                    self.info.try_settles[tid] = (h, True)
        # timeline registration (family 2): <timeline>.begin(...)
        if term == "begin" and _receiver_terminal(call) in TIMELINE_RECEIVERS:
            self.info.events.append(
                _Event("register", call.lineno, tuple(self._ctx), "timeline")
            )
            self.info.registers = True
        # retirement-gate events (family 3)
        if term in BLOCKING_FETCH_CALLS:
            self.info.events.append(
                _Event("fetch", call.lineno, tuple(self._ctx))
            )
        if term in COMMIT_CALLS:
            self.info.events.append(
                _Event("commit", call.lineno, tuple(self._ctx), term)
            )
        if term in RETIRE_GATE_CALLS:
            self.info.events.append(
                _Event("gate", call.lineno, tuple(self._ctx))
            )
        # argument-passing dispositions for bound resources
        sink = term in _SINKS
        benign = (
            term in BENIGN_ARG_CALLS and dotted is not None and "." not in dotted
        )
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            for name in self._names_in(arg):
                if name in self._bound and not benign:
                    self._dispose(self._bound[name], "transfer")
                    if sink:
                        self._dispose(self._bound[name], "release")

    @staticmethod
    def _names_in(expr: ast.expr) -> Iterable[str]:
        for node in ast.walk(expr):
            if isinstance(node, ast.Name):
                yield node.id

    def _scan_expr(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue  # deferred work, off this thread of control
            self._scan_expr(child)
        if isinstance(node, ast.Call):
            # bare-expression acquires (value discarded) are recorded by
            # _scan_stmt; here we only see nested/used calls
            self._scan_call(node)

    # -- statement walk -------------------------------------------------------
    def scan_body(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt)

    def _push(self, seg_id: int, seg: str) -> None:
        self._ctx.append((seg_id, seg))

    def _pop(self) -> None:
        self._ctx.pop()

    def _scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are deferred work
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    acq = self._record_acquire(expr, None)
                    if acq is not None:
                        acq.disposed = "with"
                    self._scan_call(expr)
                    for child in ast.iter_child_nodes(expr):
                        self._scan_expr(child)
                else:
                    self._scan_expr(expr)
                    # `with span:` on an already-bound resource releases it
                    d = _dotted(expr)
                    if d in self._bound:
                        self._dispose(self._bound[d], "with")
            self.scan_body(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            tid = self._next_try
            self._next_try += 1
            self.info.try_settles.setdefault(tid, (False, False))
            self._push(tid, "body")
            self.scan_body(stmt.body)
            self._pop()
            # handlers are numbered: SIBLING handlers are distinct paths
            # (a settle in one must not mask a raise in another)
            for i, handler in enumerate(stmt.handlers):
                self._push(tid, f"handler{i}")
                self.scan_body(handler.body)
                self._pop()
            # orelse is its own segment: a raise there never routes
            # through this try's handlers, so handler settles must not
            # protect it (finally still does)
            self._push(tid, "orelse")
            self.scan_body(stmt.orelse)
            self._pop()
            self._push(tid, "finally")
            self.scan_body(stmt.finalbody)
            self._pop()
            return
        if isinstance(stmt, ast.If):
            self._scan_expr(stmt.test)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return
        if isinstance(stmt, ast.While):
            self._scan_expr(stmt.test)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            return
        if isinstance(stmt, ast.Raise):
            self._scan_expr(stmt)
            self.info.events.append(
                _Event("raise", stmt.lineno, tuple(self._ctx))
            )
            return
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                if isinstance(stmt.value, ast.Call):
                    self._record_acquire(stmt.value, None, returned=True)
                self._scan_expr(stmt.value)
                for name in self._names_in(stmt.value):
                    if name in self._bound:
                        self._dispose(self._bound[name], "transfer")
            self.info.events.append(
                _Event("return", stmt.lineno, tuple(self._ctx))
            )
            return
        if isinstance(stmt, ast.Assign):
            value = stmt.value
            targets = stmt.targets
            single = (
                targets[0] if len(targets) == 1 and isinstance(
                    targets[0], ast.Name
                ) else None
            )
            if isinstance(value, ast.Call):
                acq = self._record_acquire(
                    value, single.id if single is not None else None
                )
                self._scan_call(value)
                for child in ast.iter_child_nodes(value):
                    self._scan_expr(child)
                if acq is not None and single is None:
                    # bound to an attribute / tuple directly
                    for t in targets:
                        d = _dotted(t)
                        if d is not None and d.startswith("self."):
                            self._dispose(acq, f"attr:{d[5:]}")
                        elif isinstance(t, (ast.Subscript, ast.Tuple, ast.List)):
                            self._dispose(acq, "transfer")
            else:
                self._scan_expr(value)
            # registry registration: self._by_id[rid] = req (family 2)
            for t in targets:
                if isinstance(t, ast.Subscript):
                    d = _dotted(t.value)
                    if (
                        d is not None and d.startswith("self.")
                        and d.split(".")[-1] in FUTURE_REGISTRY_ATTRS
                    ):
                        self.info.events.append(
                            _Event("register", stmt.lineno,
                                   tuple(self._ctx), "future")
                        )
                        self.info.registers = True
                # aliasing a bound resource into an attribute or
                # container escalates/transfers it
                d = _dotted(t)
                names = list(self._names_in(value)) if not isinstance(
                    value, ast.Call
                ) else []
                if d is not None and d.startswith("self.") and d.count(".") == 1:
                    if isinstance(value, ast.Call):
                        for acq2 in self.info.acquires:
                            if acq2.line == value.lineno and not acq2.method_style:
                                self._dispose(acq2, f"attr:{d[5:]}")
                    for name in names:
                        if name in self._bound:
                            self._dispose(self._bound[name], f"attr:{d[5:]}")
                elif isinstance(t, ast.Subscript) or (
                    d is not None and "." in d
                ):
                    for name in names:
                        if name in self._bound:
                            self._dispose(self._bound[name], "transfer")
            return
        # leaf statements: expression statements, aug-assign, etc.
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            self._record_acquire(stmt.value, None)
            self._scan_call(stmt.value)
            for child in ast.iter_child_nodes(stmt.value):
                self._scan_expr(child)
            return
        self._scan_expr(stmt)


# -- per-file collection ------------------------------------------------------


def _module_of(sf: SourceFile) -> _LeakModule:
    mod = getattr(sf, "_leakcheck_module", None)
    if mod is None:
        mod = _collect_module(sf)
        sf._leakcheck_module = mod  # type: ignore[attr-defined]
    return mod


def _factory_kind(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> str | None:
    """Resource kind for a function whose RETURN value is a direct
    acquisition — its call sites become the acquisitions (the caller
    owns the obligation)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
            spec = _match_acquire(node.value)
            if spec is not None:
                return spec.kind
    return None


def _collect_module(sf: SourceFile) -> _LeakModule:
    annotations, bad = parse_transfer_annotations(sf.source, sf.rel_path)
    mod = _LeakModule(
        rel_path=sf.rel_path, annotations=annotations, bad_annotations=bad
    )
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.ClassDef):
            cls = _LeakClass(name=stmt.name, rel_path=sf.rel_path)
            for m in stmt.body:
                if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                info = _LeakFunc(m.name, sf.rel_path, stmt.name)
                _FuncScanner(info, annotations).scan_body(m.body)
                cls.funcs[m.name] = info
                if m.lineno in annotations:
                    cls.transfer_methods[m.name] = annotations[m.lineno]
                kind = _factory_kind(m)
                if kind is not None:
                    cls.factory_kinds[m.name] = kind
            mod.classes[stmt.name] = cls
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = _LeakFunc(stmt.name, sf.rel_path, None)
            _FuncScanner(info, annotations).scan_body(stmt.body)
            mod.funcs[stmt.name] = info
            if stmt.lineno in annotations:
                mod.transfer_funcs[stmt.name] = annotations[stmt.lineno]
            kind = _factory_kind(stmt)
            if kind is not None:
                mod.factory_kinds[stmt.name] = kind
    return mod


# -- whole-program registry ---------------------------------------------------


class LeakRegistry:
    """Accumulates per-file collection and computes the whole-program
    acquire/release pairing in :meth:`pairing_findings`."""

    def __init__(self) -> None:
        self.modules: dict[str, _LeakModule] = {}

    def add(self, sf: SourceFile) -> _LeakModule:
        mod = _module_of(sf)
        self.modules[sf.rel_path] = mod
        return mod

    # transfer-annotated method names, tree-wide: a call to one is a
    # declared ownership transfer (the quarantine-leak `leak()` family)
    def _transfer_names(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for mod in self.modules.values():
            out.update(mod.transfer_funcs)
            for cls in mod.classes.values():
                out.update(cls.transfer_methods)
        return out

    def _transfer_kinds(self) -> dict[str, set]:
        """Resource kinds a call to each transfer-annotated method
        counts as releasing: the kinds its OWN class acquires or
        releases, plus the wrapper kind naming the class itself
        (``Scheduler.leak()`` releases the caller's ``wrapper``
        obligation, not every kind the caller holds)."""
        out: dict[str, set] = {}
        for mod in self.modules.values():
            for name in mod.transfer_funcs:
                f = mod.funcs.get(name)
                kinds = set()
                if f is not None:
                    kinds |= f.released_kinds
                    kinds |= {a.kind for a in f.acquires if a.kind}
                out.setdefault(name, set()).update(kinds)
            for cls in mod.classes.values():
                kinds = set()
                for f in cls.funcs.values():
                    kinds |= f.released_kinds
                    kinds |= {a.kind for a in f.acquires if a.kind}
                for spec in RESOURCES:
                    if cls.name in spec.acquire:
                        kinds.add(spec.kind)
                for name in cls.transfer_methods:
                    out.setdefault(name, set()).update(kinds)
        return out

    # factory-function names, tree-wide: calling one acquires its kind
    def _factory_names(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for mod in self.modules.values():
            out.update(mod.factory_kinds)
            for cls in mod.classes.values():
                out.update(cls.factory_kinds)
        return out

    def _scopes(self) -> list[tuple[str, str, str | None, list[_LeakFunc]]]:
        """(rel_path, scope-label, class-name-or-None, functions) for
        every class plus each module's top-level functions."""
        out = []
        for mod in self.modules.values():
            if mod.funcs:
                out.append(
                    (mod.rel_path, f"module {mod.rel_path}", None,
                     list(mod.funcs.values()))
                )
            for cls in mod.classes.values():
                out.append(
                    (mod.rel_path, f"class {cls.name}", cls.name,
                     list(cls.funcs.values()))
                )
        return out

    def _resolve_factory(
        self, mod: _LeakModule, cls: _LeakClass | None, f: _LeakFunc,
        dotted: str,
    ) -> str | None:
        """Resolve a PENDING call-use to a factory's resource kind:
        ``self.m()`` through the enclosing class's factory methods, a
        bare name through the same module's (then, uniquely, any
        module's) module-level factory functions."""
        if dotted.startswith("self."):
            name = dotted[5:]
            if cls is None or name == f.name:
                return None
            return cls.factory_kinds.get(name)
        if dotted == f.name:
            return None
        if dotted in mod.factory_kinds:
            return mod.factory_kinds[dotted]
        if dotted in mod.funcs or dotted in mod.classes:
            return None  # defined locally, and not a factory
        hits = {
            m.factory_kinds[dotted]
            for m in self.modules.values()
            if dotted in m.factory_kinds
        }
        return hits.pop() if len(hits) == 1 else None

    def pairing_findings(self) -> list[Finding]:
        transfer_kinds = self._transfer_kinds()
        out: list[Finding] = []
        for rel_path, scope, cls_name, funcs in self._scopes():
            if any(rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
                continue
            mod = self.modules[rel_path]
            cls = mod.classes.get(cls_name) if cls_name else None
            released: set[str] = set()
            # defining a transfer-annotated method IS the declared
            # disposition path for its kinds (the quarantine-leak shape)
            own_transfers = (
                mod.transfer_funcs if cls is None else cls.transfer_methods
            )
            for name in own_transfers:
                released |= transfer_kinds.get(name, set())
            for f in funcs:
                released |= f.released_kinds
                for name in f.called_names & set(transfer_kinds):
                    released |= transfer_kinds[name]
                for acq in f.acquires:
                    if acq.kind is None:
                        acq.kind = self._resolve_factory(mod, cls, f, acq.what)
            # undisposed local acquires are function-level findings;
            # attr-escalated and receiver-state acquires are scope-level
            owned: list[tuple[str, int, str]] = []
            for f in funcs:
                for acq in f.acquires:
                    if acq.kind is None:
                        continue  # unresolvable call-use: out of reach
                    d = acq.disposed or ""
                    if d.startswith("attr:") or (
                        acq.method_style and acq.disposed is None
                    ):
                        owned.append((acq.kind, acq.line, acq.what))
                    elif acq.disposed is None and acq.var is None:
                        out.append(
                            Finding(
                                "leak-unreleased", f.rel_path, acq.line,
                                f"{acq.what}(): acquired {acq.kind} is "
                                "discarded — it can never be released; "
                                "bind it and pair it with "
                                "release/close/shutdown, or declare the "
                                "handoff with '# leakcheck: "
                                "transfer(<recipient>)'",
                            )
                        )
                    elif acq.disposed is None:
                        out.append(
                            Finding(
                                "leak-unreleased", f.rel_path, acq.line,
                                f"{acq.what}(): acquired {acq.kind} bound "
                                f"to '{acq.var}' is never released, "
                                "returned, or transferred on any path out "
                                f"of '{f.name}' — pair it with its "
                                "release (with/finally), or declare the "
                                "handoff with '# leakcheck: "
                                "transfer(<recipient>)'",
                            )
                        )
            for kind, line, what in owned:
                spec = next(s for s in RESOURCES if s.kind == kind)
                if kind in released:
                    continue
                out.append(
                    Finding(
                        "leak-unreleased", rel_path, line,
                        f"{what}(): {scope} acquires {kind} but contains "
                        f"no paired release "
                        f"({'/'.join(sorted(spec.release))}) and no "
                        "declared ownership transfer — every acquisition "
                        "must reach its release on some path, or carry "
                        "'# leakcheck: transfer(<recipient>)'",
                    )
                )
        out.sort(key=lambda f: (f.path, f.line))
        return out

    # -- static resource table (runtime cross-check) ---------------------------
    def resource_table(self) -> dict:
        """The static acquire/release site table the runtime reclaim
        tracer's observed pairs are asserted a subset of."""
        kinds: dict[str, dict[str, Any]] = {
            s.kind: {
                "acquire_methods": sorted(s.acquire | s.acquire_methods),
                "release_methods": sorted(s.release),
                "acquire_sites": set(),
                "release_sites": set(),
            }
            for s in RESOURCES
        }
        transfer_names = self._transfer_names()
        for mod in self.modules.values():
            for scope_funcs in [mod.funcs] + [
                c.funcs for c in mod.classes.values()
            ]:
                for f in scope_funcs.values():
                    for acq in f.acquires:
                        if acq.kind is None:
                            continue  # unresolved call-use
                        kinds[acq.kind]["acquire_sites"].add(
                            f"{f.rel_path}:{acq.line}"
                        )
                    for ev in f.events:
                        if ev.op == "release" and ev.kind in kinds:
                            kinds[ev.kind]["release_sites"].add(
                                f"{f.rel_path}:{ev.line}"
                            )
        transfer_sites = {
            f"{mod.rel_path}:{line}:{target}"
            for mod in self.modules.values()
            for line, target in mod.annotations.items()
        }
        return {
            "version": 1,
            "transfer_methods": dict(sorted(transfer_names.items())),
            "transfer_sites": sorted(transfer_sites),
            "kinds": {
                name: {
                    key: sorted(val) if isinstance(val, set) else val
                    for key, val in entry.items()
                }
                for name, entry in sorted(kinds.items())
            },
        }


# -- rules --------------------------------------------------------------------


class LeakPairingRule(Rule):
    """``leak-unreleased`` + ``bad-transfer-annotation``: whole-program
    acquire/release pairing. Cross-file — pairing findings only fire on
    directory runs (a file subset would see acquires without their
    elsewhere releases)."""

    name = "leak-unreleased"
    cross_file = True

    def __init__(self) -> None:
        self.registry = LeakRegistry()

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        mod = self.registry.add(sf)
        return [
            f for f in mod.bad_annotations
            if not sf.is_suppressed(f.rule, f.line)
        ]

    def finalize(self) -> list[Finding]:
        return self.registry.pairing_findings()


class LeakExceptionPathRule(Rule):
    """``leak-exception-path``: an explicit raise/return edge between an
    acquire and its same-function release strands the resource unless
    the release is in a ``finally`` (or the edge releases first)."""

    name = "leak-exception-path"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if any(sf.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        funcs: list[_LeakFunc] = list(mod.funcs.values())
        for cls in mod.classes.values():
            funcs.extend(cls.funcs.values())
        for f in funcs:
            out.extend(self._check_func(sf, f))
        return out

    def _check_func(self, sf: SourceFile, f: _LeakFunc) -> list[Finding]:
        out: list[Finding] = []
        # order the merged acquire/event stream by line (the scan is
        # lexical, so line order is event order for our purposes)
        releases = [e for e in f.events if e.op == "release"]
        escapes = [e for e in f.events if e.op in ("raise", "return")]
        for acq in f.acquires:
            if acq.disposed in ("with", "annotation"):
                continue
            # a VAR-bound acquire pairs with the release on ITS name: a
            # sibling resource of the same kind releasing first must not
            # shrink this acquisition's checked window (two spans in one
            # function — `a.end()` says nothing about `b`)
            same = [
                r for r in releases
                if r.kind == acq.kind and r.line > acq.line
                and (acq.var is None or r.recv == acq.var)
            ]
            if not same:
                continue  # pairing (or its absence) is family-1 business
            release = same[0]
            # release inside a finally: every edge is covered
            if any(seg == "finally" for _tid, seg in release.ctx):
                continue
            for esc in escapes:
                if not (acq.line < esc.line < release.line):
                    continue
                # an escape inside an except handler of the try whose
                # BODY contains the acquire is the acquisition's OWN
                # failure path (the acquire raised; nothing was held).
                # A handler of an UNRELATED try gives no such guarantee
                # — the release check below is its only out.
                ctx = esc.ctx
                if ctx and ctx[-1][1].startswith("handler") and (
                    (ctx[-1][0], "body") in acq.ctx
                ):
                    continue
                # an edge that released first is clean (same var-aware
                # set: a sibling's release does not excuse this one)
                if any(acq.line < r.line < esc.line for r in same):
                    continue
                out.append(
                    Finding(
                        self.name, sf.rel_path, esc.line,
                        f"this {esc.op} exits '{f.name}' between the "
                        f"{acq.kind} acquire (line {acq.line}) and its "
                        f"release (line {release.line}) — the resource "
                        "escapes on the exception edge; move the release "
                        "into a finally, or release before raising",
                    )
                )
                break  # one finding per acquisition is enough
        return out


class SettleOnRaiseRule(Rule):
    """``settle-on-raise``: in a function that registers a
    future/timeline, every subsequent explicit ``raise`` must be
    settlement-post-dominated — a settle on its own path, or an
    enclosing try whose handler/finally settles."""

    name = "settle-on-raise"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if any(sf.rel_path.startswith(p) for p in _EXEMPT_PREFIXES):
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        funcs: list[_LeakFunc] = list(mod.funcs.values())
        for cls in mod.classes.values():
            funcs.extend(cls.funcs.values())
        for f in funcs:
            if f.registers:
                out.extend(self._check_func(sf, f))
        return out

    def _check_func(self, sf: SourceFile, f: _LeakFunc) -> list[Finding]:
        regs = [e for e in f.events if e.op == "register"]
        settles = [e for e in f.events if e.op == "settle"]
        first_reg = min(e.line for e in regs)
        out: list[Finding] = []
        for esc in f.events:
            if esc.op != "raise" or esc.line <= first_reg:
                continue
            if self._protected(f, esc, settles):
                continue
            out.append(
                Finding(
                    self.name, sf.rel_path, esc.line,
                    f"'{f.name}' registers a future/timeline (line "
                    f"{first_reg}) but this raise is not "
                    "settlement-post-dominated — the registered request "
                    "strands forever; settle (_try_resolve/"
                    "_settle_future/finish) in an enclosing except/"
                    "finally, or before raising",
                )
            )
        return out

    @staticmethod
    def _protected(f: _LeakFunc, esc: _Event, settles: list[_Event]) -> bool:
        # enclosing try (raise in its BODY — an orelse raise never
        # routes through the handlers) whose handler or finally settles
        # — the canonical submit() shape
        for tid, seg in esc.ctx:
            h, fin = f.try_settles.get(tid, (False, False))
            if seg == "body" and (h or fin):
                return True
            if fin:
                return True
        # a settle earlier on the same path: its ctx is a prefix of the
        # raise's ctx (same suite or an enclosing one)
        for s in settles:
            if s.line < esc.line and esc.ctx[: len(s.ctx)] == s.ctx:
                return True
        return False


class RetireGateRule(Rule):
    """``retire-gate-missing``: in the engine-thread zone, a commit into
    rebuilt state after a blocking fetch/dispatch requires an
    intervening ``_check_retired()`` — a thread replaced by a warm
    restart mid-call must unwind, not poison the rebuilt state."""

    name = "retire-gate-missing"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        funcs = _zone_functions(RETIRE_GATE_ZONES, sf.rel_path)
        if funcs is None:
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        all_funcs: list[_LeakFunc] = list(mod.funcs.values())
        for cls in mod.classes.values():
            all_funcs.extend(cls.funcs.values())
        for f in all_funcs:
            if funcs != "*" and f.name not in funcs:
                continue
            pending: int | None = None
            for ev in sorted(
                (e for e in f.events if e.op in ("fetch", "commit", "gate")),
                key=lambda e: e.line,
            ):
                if ev.op == "fetch":
                    pending = ev.line
                elif ev.op == "gate":
                    pending = None
                elif ev.op == "commit" and pending is not None:
                    out.append(
                        Finding(
                            self.name, sf.rel_path, ev.line,
                            f"{ev.kind}() commits into engine state after "
                            f"the blocking call at line {pending} with no "
                            "_check_retired() between them — a thread "
                            "retired by a warm restart mid-call would "
                            "commit into the rebuilt engine's state "
                            "(dead slabs / stale slots); gate it",
                        )
                    )
                    pending = None  # one finding per blocking call
        return out


def leakcheck_rules() -> list[Rule]:
    return [
        LeakPairingRule(), LeakExceptionPathRule(),
        SettleOnRaiseRule(), RetireGateRule(),
    ]


# -- static table export & runtime cross-check --------------------------------


def build_resource_table(paths: list[str]) -> dict:
    """Collect the whole-program static resource table for ``paths`` —
    the JSON the runtime reclaim tracer's observed pairs are asserted a
    subset of (``--leak-table`` / ``--check-leak-table``)."""
    from gofr_tpu_torch.analysis.core import iter_python_files

    reg = LeakRegistry()
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as fp:
            source = fp.read()
        try:
            sf = SourceFile(full, rel, source)
        except SyntaxError:
            continue
        reg.add(sf)
    return reg.resource_table()


def render_table_json(table: dict) -> str:
    return json.dumps(table, indent=2, sort_keys=True)


def check_coverage(runtime: dict, table: dict) -> list[str]:
    """Verify every runtime-observed acquire/release event
    (:mod:`gofr_tpu_torch.analysis.leaktrace` export: ``{"events": [{"kind",
    "op", "name"}]}``) is statically known: the kind exists in the
    static table and the event's method name is in that kind's
    acquire/release vocabulary (transfer-annotated methods count as
    releases — a declared quarantine leak IS the documented
    disposition). Returns human-readable divergences (empty = ok); a
    divergence means the analyzer's table has a blind spot for a
    resource the runtime actually cycles."""
    kinds = table.get("kinds", {})
    transfers = set(table.get("transfer_methods", {}))
    divergences: list[str] = []
    for ev in runtime.get("events", ()):
        kind, op, name = ev.get("kind"), ev.get("op"), ev.get("name")
        entry = kinds.get(kind)
        if entry is None:
            divergences.append(
                f"runtime {op} of unknown resource kind '{kind}' "
                f"({name}) — add it to leakcheck.RESOURCES"
            )
            continue
        if op == "acquire":
            known = set(entry.get("acquire_methods", ()))
        else:
            known = set(entry.get("release_methods", ())) | transfers
        if name not in known:
            divergences.append(
                f"runtime {op} site '{name}' for kind '{kind}' is not in "
                "the static vocabulary — analyzer blind spot"
            )
    return sorted(set(divergences))
