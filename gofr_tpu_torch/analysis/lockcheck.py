"""lockcheck — whole-program static concurrency analysis.

The control plane fronting the TPU data plane (engine, supervisor,
router/membership, subscriber, the pubsub drivers) is the most lock-dense
code in the tree, and every shipped race (submit-vs-warm-restart
stranding, hedge-loser settling the winner, ``/routerz``
read-modify-write) was caught by manual review, not tooling. The runtime
``GOFR_LOCK_ORDER=1`` tier only sees acquisition orders the concurrency
tests happen to exercise. This module is the static twin — three rule
families over the whole tree:

``lock-order-static``
    Builds the cross-file lock-acquisition graph: ``self.<attr>`` lock
    identities per class (plus module-level locks), nesting observed
    through ``with`` blocks and ``acquire()``/``release()`` pairs, and
    cross-object edges propagated through resolvable call chains
    (``self.m()``, ``self.attr.m()`` where ``attr`` was bound to a known
    class, same-file functions and constructors). A cycle in that graph
    is an AB/BA ordering that CAN deadlock even if no test ever
    interleaves it. :func:`build_static_graph` exports the graph as JSON
    so the runtime tier's *observed* graph can be asserted a subgraph of
    it (:func:`check_subgraph` — divergence means an analyzer blind spot
    or a dead lock site).

``hold-and-block``
    Flags blocking operations executed while a registry lock is held:
    the gofrlint blocking-call set (``time.sleep``, subprocess, sync
    HTTP, ``open``), unbounded ``Future.result()`` / ``Thread.join()`` /
    ``Event.wait()`` (no timeout), socket I/O, and engine dispatch
    (``_block_sync`` / ``block_until_ready``). A blocked millisecond
    under a lock stalls every waiter — on the decode plane that is a
    latency bug even when it is not a deadlock. Bounded-timeout forms
    (``acquire(timeout=...)``, ``wait(t)``) are allowed by construction;
    deliberate I/O-serialization locks are suppressed with a reason,
    like every finding in this suite (fix-or-justify).

``guarded-by``
    Per class, infers which lock guards each mutable attribute from the
    dominant write pattern (≥2 guarded writes outside ``__init__`` and
    at least two thirds of all writes), then flags writes that skip the
    guard in methods reachable from a second thread root
    (``Thread(target=self.m)``, ``executor.submit(self.m)``) — the
    read-modify-write shape behind the ``/routerz`` counter race.

Static analysis over-approximates deliberately: branches do not fork the
held-set, loops are scanned once with persistent holds, and unresolvable
calls are ignored rather than guessed. The goal is a graph that is a
SUPERSET of anything the runtime tier can observe, so the
runtime-subgraph invariant stays assertable.

The port's copy of ``gofr_tpu/analysis/lockcheck.py``, over the port's
tree; ``gofr_tpu_torch/testutil/`` is the exempt scaffolding.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from typing import Iterable

from gofr_tpu_torch.analysis.core import Finding, Rule, SourceFile

# the gofrlint blocking-call set, shared so the two rules can never
# drift apart (rules.py only imports lockcheck lazily inside
# default_rules(), so this module-level import is cycle-free)
from gofr_tpu_torch.analysis.rules import BLOCKING_CALLS as HOLD_BLOCKING_CALLS

# -- vocabulary ---------------------------------------------------------------

_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "Lock", "RLock",
}

# method names that are unbounded waits when called with NO timeout:
# Future.result(), Thread.join(), Event/Condition.wait(). A timeout
# argument (the bounded forms) makes them legal under a lock.
HOLD_UNBOUNDED_METHODS = {"result", "join", "wait"}

# engine-dispatch / device-sync surface: blocking on the data plane
HOLD_DISPATCH_METHODS = {"block_until_ready", "_block_sync"}

# socket/driver I/O methods: a transport stall under a lock wedges every
# other caller of that driver
HOLD_IO_METHODS = {"sendall", "recv", "recv_into", "connect", "getresponse"}

# constructors that mark an attribute as concurrency infrastructure, not
# guarded mutable state
_INFRA_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Event",
    "threading.Condition", "threading.Semaphore", "threading.Thread",
    "Lock", "RLock", "Event", "Condition", "Semaphore", "Thread",
    "ThreadPoolExecutor",
}

# container-mutating method names counted as writes for guarded-by
_MUTATOR_METHODS = {
    "append", "appendleft", "add", "update", "setdefault", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "extend",
    "insert", "rotate",
}

_GUARD_MIN_SITES = 2       # guarded writes needed to infer a guard
_GUARD_DOMINANCE = 2 / 3   # guarded fraction of all non-init writes


def _dotted(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# -- lock identities ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LockKey:
    """Identity of a lock in the static graph. ``cls`` is None for
    module-level locks; ``attr`` is the attribute/name."""

    rel_path: str
    cls: str | None
    attr: str

    @property
    def label(self) -> str:
        owner = f"{self.cls}." if self.cls else ""
        return f"{self.rel_path}:{owner}{self.attr}"


@dataclasses.dataclass
class _FuncInfo:
    """Per-function facts: direct acquisitions, calls with the held-set
    at the call site, attribute writes, blocking ops under a lock."""

    name: str
    rel_path: str
    cls: str | None
    acquired: list[tuple[LockKey, int]] = dataclasses.field(default_factory=list)
    # (held lock, acquired lock, line) — lexical nesting edges
    edges: list[tuple[LockKey, LockKey, int]] = dataclasses.field(default_factory=list)
    # (dotted callee, held locks, line)
    calls: list[tuple[str, tuple[LockKey, ...], int]] = dataclasses.field(
        default_factory=list
    )
    # (attr, held locks, line)
    writes: list[tuple[str, tuple[LockKey, ...], int]] = dataclasses.field(
        default_factory=list
    )
    # (description, held lock label, line)
    blocking: list[tuple[str, str, int]] = dataclasses.field(default_factory=list)

    @property
    def key(self) -> tuple[str, str | None, str]:
        return (self.rel_path, self.cls, self.name)


@dataclasses.dataclass
class _ClassInfo:
    name: str
    rel_path: str
    locks: dict[str, LockKey] = dataclasses.field(default_factory=dict)
    lock_sites: dict[LockKey, list[int]] = dataclasses.field(default_factory=dict)
    # attr -> bound class name (self.x = ClassName(...) or annotated param)
    attr_types: dict[str, str] = dataclasses.field(default_factory=dict)
    infra_attrs: set[str] = dataclasses.field(default_factory=set)
    funcs: dict[str, _FuncInfo] = dataclasses.field(default_factory=dict)
    thread_roots: set[str] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _ModuleInfo:
    rel_path: str
    locks: dict[str, LockKey] = dataclasses.field(default_factory=dict)
    lock_sites: dict[LockKey, list[int]] = dataclasses.field(default_factory=dict)
    classes: dict[str, _ClassInfo] = dataclasses.field(default_factory=dict)
    funcs: dict[str, _FuncInfo] = dataclasses.field(default_factory=dict)


def _is_lock_factory(call: ast.expr) -> bool:
    if not isinstance(call, ast.Call):
        return False
    return (_dotted(call.func) or "") in _LOCK_FACTORIES


def _is_infra_factory(call: ast.expr) -> bool:
    if not isinstance(call, ast.Call):
        return False
    d = _dotted(call.func) or ""
    return d in _INFRA_FACTORIES or d.split(".")[-1] in _INFRA_FACTORIES


# -- per-function scanner -----------------------------------------------------


class _FuncScanner:
    """Linear abstract interpretation of one function body: tracks the
    held-lock stack through ``with`` nesting and ``acquire``/``release``
    pairs, records order edges, calls, writes, and blocking ops. Branches
    share one held-set (over-approximation toward a superset graph);
    nested ``def``/``lambda`` bodies are deferred work and skipped."""

    def __init__(
        self,
        info: _FuncInfo,
        cls_locks: dict[str, LockKey],
        mod_locks: dict[str, LockKey],
    ) -> None:
        self.info = info
        self.cls_locks = cls_locks
        self.mod_locks = mod_locks
        self.held: list[LockKey] = []

    # lock expression -> identity
    def _lock_of(self, expr: ast.expr) -> LockKey | None:
        d = _dotted(expr)
        if d is None:
            return None
        if d.startswith("self.") and d.count(".") == 1:
            return self.cls_locks.get(d[5:])
        if "." not in d:
            return self.mod_locks.get(d)
        return None

    def _acquire(self, lock: LockKey, line: int) -> None:
        if lock in self.held:  # reentrant: no self-ordering
            return
        for h in self.held:
            self.info.edges.append((h, lock, line))
        self.info.acquired.append((lock, line))
        self.held.append(lock)

    def _release(self, lock: LockKey) -> None:
        for i in range(len(self.held) - 1, -1, -1):
            if self.held[i] == lock:
                del self.held[i]
                return

    # -- blocking classification ---------------------------------------------
    @staticmethod
    def _has_timeout(call: ast.Call) -> bool:
        # result()/join()/wait() take the timeout first — a literal-None
        # positional (`fut.result(None)`) is as unbounded as no argument
        if call.args:
            first = call.args[0]
            return not (
                isinstance(first, ast.Constant) and first.value is None
            )
        for kw in call.keywords:
            if kw.arg == "timeout":
                return not (
                    isinstance(kw.value, ast.Constant) and kw.value.value is None
                )
        return False

    def _check_blocking(self, call: ast.Call, dotted: str | None) -> None:
        if not self.held:
            return
        lock_label = self.held[-1].label
        if dotted in HOLD_BLOCKING_CALLS:
            self.info.blocking.append((f"{dotted}()", lock_label, call.lineno))
            return
        if not isinstance(call.func, ast.Attribute):
            return
        method = call.func.attr
        if method in HOLD_DISPATCH_METHODS:
            self.info.blocking.append(
                (f".{method}() [device dispatch]", lock_label, call.lineno)
            )
        elif method in HOLD_IO_METHODS:
            self.info.blocking.append(
                (f".{method}() [transport I/O]", lock_label, call.lineno)
            )
        elif method in HOLD_UNBOUNDED_METHODS and not self._has_timeout(call):
            self.info.blocking.append(
                (f".{method}() without timeout", lock_label, call.lineno)
            )

    # -- expression scan ------------------------------------------------------
    def _scan_expr(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue  # deferred work
            self._scan_expr(child)
        if not isinstance(node, ast.Call):
            return
        dotted = _dotted(node.func)
        if dotted is not None and dotted.endswith(".acquire"):
            lock = self._lock_of(node.func.value)  # type: ignore[attr-defined]
            if lock is not None:
                self._acquire(lock, node.lineno)
                return
        if dotted is not None and dotted.endswith(".release"):
            lock = self._lock_of(node.func.value)  # type: ignore[attr-defined]
            if lock is not None:
                self._release(lock)
                return
        if dotted is not None:
            self.info.calls.append((dotted, tuple(self.held), node.lineno))
        self._check_blocking(node, dotted)
        # container mutations count as attribute writes (guarded-by)
        if isinstance(node.func, ast.Attribute) and node.func.attr in _MUTATOR_METHODS:
            recv = _dotted(node.func.value)
            if recv is not None and recv.startswith("self.") and recv.count(".") == 1:
                self.info.writes.append(
                    (recv[5:], tuple(self.held), node.lineno)
                )

    def _record_write_target(self, target: ast.expr, line: int) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_write_target(elt, line)
            return
        if isinstance(target, ast.Subscript):
            target = target.value
        if isinstance(target, ast.Starred):
            target = target.value
        d = _dotted(target)
        if d is not None and d.startswith("self.") and d.count(".") == 1:
            self.info.writes.append((d[5:], tuple(self.held), line))

    # -- statement walk -------------------------------------------------------
    def scan_body(self, stmts: Iterable[ast.stmt]) -> None:
        for stmt in stmts:
            self._scan_stmt(stmt)

    def _scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return  # nested defs are deferred work
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed: list[LockKey] = []
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    if lock not in self.held:
                        self._acquire(lock, item.context_expr.lineno)
                        pushed.append(lock)
                else:
                    self._scan_expr(item.context_expr)
            self.scan_body(stmt.body)
            for lock in reversed(pushed):
                self._release(lock)
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
        if isinstance(stmt, ast.Try):
            self.scan_body(stmt.body)
            for handler in stmt.handlers:
                self.scan_body(handler.body)
            self.scan_body(stmt.orelse)
            self.scan_body(stmt.finalbody)
            return
        # leaf statement: scan expressions, then record write targets
        self._scan_expr(stmt)
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                self._record_write_target(t, stmt.lineno)
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            self._record_write_target(stmt.target, stmt.lineno)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self._record_write_target(t, stmt.lineno)


# -- per-file collection ------------------------------------------------------


def _module_of(sf: SourceFile) -> _ModuleInfo:
    """Per-file collection, memoized on the SourceFile: the three rules
    (and the registry) share one statement walk instead of re-parsing."""
    mod = getattr(sf, "_lockcheck_module", None)
    if mod is None:
        mod = _collect_module(sf)
        sf._lockcheck_module = mod  # type: ignore[attr-defined]
    return mod


def _collect_module(sf: SourceFile) -> _ModuleInfo:
    mod = _ModuleInfo(rel_path=sf.rel_path)
    # module-level locks first (visible to every function in the file)
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.Assign) and _is_lock_factory(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    key = LockKey(sf.rel_path, None, t.id)
                    mod.locks[t.id] = key
                    mod.lock_sites.setdefault(key, []).append(stmt.lineno)
    for stmt in sf.tree.body:
        if isinstance(stmt, ast.ClassDef):
            mod.classes[stmt.name] = _collect_class(sf, stmt, mod)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = _FuncInfo(stmt.name, sf.rel_path, None)
            _FuncScanner(info, {}, mod.locks).scan_body(stmt.body)
            mod.funcs[stmt.name] = info
    return mod


def _collect_class(
    sf: SourceFile, cls: ast.ClassDef, mod: _ModuleInfo
) -> _ClassInfo:
    info = _ClassInfo(name=cls.name, rel_path=sf.rel_path)
    methods = [
        n for n in cls.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    # factory-method return types: `self.x = self._make_y()` binds x to
    # whatever class _make_y returns (annotation, or a `return Ctor(...)`)
    returns: dict[str, str] = {}
    for m in methods:
        if m.returns is not None:
            d = _dotted(m.returns)
            if d and d.split(".")[-1][:1].isupper():
                returns[m.name] = d.split(".")[-1]
                continue
        for node in ast.walk(m):
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Call):
                d = _dotted(node.value.func)
                if d and d.split(".")[-1][:1].isupper():
                    returns[m.name] = d.split(".")[-1]
                    break
    # pass 1: lock attrs, infra attrs, attr->class bindings, thread roots
    for m in methods:
        ann: dict[str, str] = {}
        for arg in list(m.args.args) + list(m.args.kwonlyargs):
            if arg.annotation is not None:
                d = _dotted(arg.annotation)
                if d:
                    ann[arg.arg] = d.split(".")[-1]
        for node in ast.walk(m):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    d = _dotted(t)
                    if not (d and d.startswith("self.") and d.count(".") == 1):
                        continue
                    attr = d[5:]
                    if _is_lock_factory(node.value):
                        key = LockKey(sf.rel_path, cls.name, attr)
                        info.locks[attr] = key
                        info.lock_sites.setdefault(key, []).append(node.lineno)
                    elif _is_infra_factory(node.value):
                        info.infra_attrs.add(attr)
                    elif isinstance(node.value, ast.Call):
                        cd = _dotted(node.value.func)
                        if cd:
                            last = cd.split(".")[-1]
                            if last[:1].isupper():
                                info.attr_types[attr] = last
                            elif (
                                cd.startswith("self.")
                                and cd.count(".") == 1
                                and last in returns
                            ):
                                info.attr_types[attr] = returns[last]
                    elif isinstance(node.value, ast.Name) and node.value.id in ann:
                        info.attr_types[attr] = ann[node.value.id]
            elif isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d.split(".")[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            td = _dotted(kw.value) or ""
                            if td.startswith("self.") and td.count(".") == 1:
                                info.thread_roots.add(td[5:])
                elif d.endswith(".submit") and node.args:
                    td = _dotted(node.args[0]) or ""
                    if td.startswith("self.") and td.count(".") == 1:
                        info.thread_roots.add(td[5:])
    # pass 2: scan bodies with the lock vocabulary in place
    for m in methods:
        finfo = _FuncInfo(m.name, sf.rel_path, cls.name)
        _FuncScanner(finfo, info.locks, mod.locks).scan_body(m.body)
        info.funcs[m.name] = finfo
    return info


# -- whole-program registry ---------------------------------------------------


class LockRegistry:
    """Accumulates per-file collection results and computes the
    whole-program acquisition graph in :meth:`graph`."""

    def __init__(self) -> None:
        self.modules: dict[str, _ModuleInfo] = {}

    def add(self, sf: SourceFile) -> _ModuleInfo:
        mod = _module_of(sf)
        self.modules[sf.rel_path] = mod
        return mod

    # -- call resolution ------------------------------------------------------
    def _classes_named(self, name: str, prefer_rel: str) -> list[_ClassInfo]:
        local = self.modules.get(prefer_rel)
        if local and name in local.classes:
            return [local.classes[name]]
        hits = [
            m.classes[name] for m in self.modules.values() if name in m.classes
        ]
        return hits if len(hits) == 1 else []

    def _resolve(
        self, func: _FuncInfo, dotted: str
    ) -> list[_FuncInfo]:
        parts = dotted.split(".")
        mod = self.modules.get(func.rel_path)
        if mod is None:
            return []
        cls = mod.classes.get(func.cls) if func.cls else None
        if parts[0] == "self" and cls is not None:
            if len(parts) == 2:
                target = cls.funcs.get(parts[1])
                return [target] if target else []
            if len(parts) == 3:
                bound = cls.attr_types.get(parts[1])
                if bound:
                    out = []
                    for ci in self._classes_named(bound, func.rel_path):
                        if parts[2] in ci.funcs:
                            out.append(ci.funcs[parts[2]])
                    return out
            return []
        if len(parts) == 1:
            name = parts[0]
            if name in mod.funcs:
                return [mod.funcs[name]]
            for ci in self._classes_named(name, func.rel_path):
                if "__init__" in ci.funcs:
                    return [ci.funcs["__init__"]]
        return []

    def _all_funcs(self) -> list[_FuncInfo]:
        out: list[_FuncInfo] = []
        for mod in self.modules.values():
            out.extend(mod.funcs.values())
            for ci in mod.classes.values():
                out.extend(ci.funcs.values())
        return out

    # -- transitive acquisition summaries -------------------------------------
    def _summaries(self) -> dict[tuple, set[LockKey]]:
        funcs = self._all_funcs()
        summaries: dict[tuple, set[LockKey]] = {
            f.key: {lock for lock, _ in f.acquired} for f in funcs
        }
        resolved: dict[tuple, list[tuple]] = {}
        for f in funcs:
            targets: list[tuple] = []
            for dotted, _held, _line in f.calls:
                for t in self._resolve(f, dotted):
                    targets.append(t.key)
            resolved[f.key] = targets
        changed = True
        while changed:
            changed = False
            for f in funcs:
                s = summaries[f.key]
                before = len(s)
                for t in resolved[f.key]:
                    s |= summaries.get(t, set())
                if len(s) != before:
                    changed = True
        return summaries

    # -- the graph -------------------------------------------------------------
    def graph(self) -> dict:
        """The static acquisition graph:

        ``nodes``: ``{label: {"sites": ["rel:line", ...]}}`` — one node per
        lock identity, with every ``threading.Lock()`` creation site that
        produces it (a re-created lock keeps its identity).
        ``edges``: ``{(a_label, b_label): ["rel:line", ...]}`` rendered as a
        sorted list — lock ``a`` held while ``b`` is acquired, with the
        acquisition sites.
        """
        summaries = self._summaries()
        edge_sites: dict[tuple[str, str], set[str]] = {}
        nodes: dict[str, set[str]] = {}
        for mod in self.modules.values():
            for key, lines in mod.lock_sites.items():
                nodes.setdefault(key.label, set()).update(
                    f"{mod.rel_path}:{ln}" for ln in lines
                )
            for ci in mod.classes.values():
                for key, lines in ci.lock_sites.items():
                    nodes.setdefault(key.label, set()).update(
                        f"{ci.rel_path}:{ln}" for ln in lines
                    )
        for f in self._all_funcs():
            for a, b, line in f.edges:
                if a != b:
                    edge_sites.setdefault((a.label, b.label), set()).add(
                        f"{f.rel_path}:{line}"
                    )
            for dotted, held, line in f.calls:
                if not held:
                    continue
                for t in self._resolve(f, dotted):
                    for lock in summaries.get(t.key, ()):
                        for h in held:
                            if h != lock:
                                edge_sites.setdefault(
                                    (h.label, lock.label), set()
                                ).add(f"{f.rel_path}:{line}")
        return {
            "version": 1,
            "nodes": {
                label: {"sites": sorted(sites)}
                for label, sites in sorted(nodes.items())
            },
            "edges": [
                {"from": a, "to": b, "sites": sorted(sites)}
                for (a, b), sites in sorted(edge_sites.items())
            ],
        }

    def cycles(self) -> list[tuple[list[str], str]]:
        """Cycles in the acquisition graph as (label-cycle, first-site)
        pairs, each normalized to start at its smallest label so the
        finding message is stable across runs."""
        g = self.graph()
        adj: dict[str, dict[str, list[str]]] = {}
        for e in g["edges"]:
            adj.setdefault(e["from"], {})[e["to"]] = e["sites"]
        out: list[tuple[list[str], str]] = []
        seen: set[frozenset[str]] = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color: dict[str, int] = {}
        path: list[str] = []

        def dfs(node: str) -> None:
            color[node] = GRAY
            path.append(node)
            for nxt in sorted(adj.get(node, ())):
                c = color.get(nxt, WHITE)
                if c == GRAY:
                    cyc = path[path.index(nxt):]
                    key = frozenset(cyc)
                    if key not in seen:
                        seen.add(key)
                        lo = cyc.index(min(cyc))
                        norm = cyc[lo:] + cyc[:lo]
                        site = adj[norm[0]][
                            norm[1] if len(norm) > 1 else norm[0]
                        ][0]
                        out.append((norm + [norm[0]], site))
                elif c == WHITE:
                    dfs(nxt)
            path.pop()
            color[node] = BLACK

        for node in sorted(adj):
            if color.get(node, WHITE) == WHITE:
                dfs(node)
        return out


# -- rules --------------------------------------------------------------------


class LockOrderStaticRule(Rule):
    """``lock-order-static``: cycle in the whole-program acquisition
    graph. Cross-file — only fires on directory runs."""

    name = "lock-order-static"
    cross_file = True

    def __init__(self) -> None:
        self.registry = LockRegistry()

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        self.registry.add(sf)
        return []

    def finalize(self) -> list[Finding]:
        out: list[Finding] = []
        for cycle, site in self.registry.cycles():
            rel, _, line = site.rpartition(":")
            out.append(
                Finding(
                    self.name, rel, int(line),
                    "lock-order cycle: " + " -> ".join(cycle)
                    + " — an AB/BA acquisition order that can deadlock "
                    "under the right interleaving",
                )
            )
        return out


class HoldAndBlockRule(Rule):
    """``hold-and-block``: blocking operation while a lock is held.
    ``gofr_tpu_torch/testutil/`` is exempt — scaffolding brokers serialize
    throwaway sockets by design (same rationale as
    ``daemon-loop-no-heartbeat``)."""

    name = "hold-and-block"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if "gofr_tpu_torch/testutil/" in sf.rel_path:
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        funcs: list[_FuncInfo] = list(mod.funcs.values())
        for ci in mod.classes.values():
            funcs.extend(ci.funcs.values())
        for f in funcs:
            for desc, lock_label, line in f.blocking:
                out.append(
                    Finding(
                        self.name, sf.rel_path, line,
                        f"{desc} while holding {lock_label} — a blocking "
                        "op under a lock stalls every waiter; move it off "
                        "the critical section or bound it with a timeout",
                    )
                )
        return out


class GuardedByRule(Rule):
    """``guarded-by``: write to an attribute that skips its inferred
    guard, in a method reachable from a second thread root."""

    name = "guarded-by"

    def visit_file(self, sf: SourceFile) -> list[Finding]:
        if "gofr_tpu_torch/testutil/" in sf.rel_path:
            return []
        mod = _module_of(sf)
        out: list[Finding] = []
        for ci in mod.classes.values():
            out.extend(self._check_class(sf, ci))
        return out

    @staticmethod
    def _reachable(ci: _ClassInfo) -> set[str]:
        """Methods reachable from the class's thread roots via self-calls."""
        reach = set(r for r in ci.thread_roots if r in ci.funcs)
        frontier = list(reach)
        while frontier:
            fn = ci.funcs.get(frontier.pop())
            if fn is None:
                continue
            for dotted, _held, _line in fn.calls:
                parts = dotted.split(".")
                if parts[0] == "self" and len(parts) == 2:
                    m = parts[1]
                    if m in ci.funcs and m not in reach:
                        reach.add(m)
                        frontier.append(m)
        return reach

    def _check_class(self, sf: SourceFile, ci: _ClassInfo) -> list[Finding]:
        if not ci.locks or not ci.thread_roots:
            return []
        # writes per attr, outside __init__
        writes: dict[str, list[tuple[str, tuple[LockKey, ...], int]]] = {}
        for fname, f in ci.funcs.items():
            if fname == "__init__":
                continue
            for attr, held, line in f.writes:
                if attr in ci.locks or attr in ci.infra_attrs:
                    continue
                writes.setdefault(attr, []).append((fname, held, line))
        reach = self._reachable(ci)
        out: list[Finding] = []
        for attr, sites in sorted(writes.items()):
            counts: dict[LockKey, int] = {}
            for _fname, held, _line in sites:
                for lock in held:
                    if lock.cls == ci.name or lock.cls is None:
                        counts[lock] = counts.get(lock, 0) + 1
            if not counts:
                continue
            guard = max(counts, key=lambda k: (counts[k], k.label))
            if counts[guard] < _GUARD_MIN_SITES:
                continue
            if counts[guard] < _GUARD_DOMINANCE * len(sites):
                continue
            for fname, held, line in sites:
                if guard in held or fname not in reach:
                    continue
                out.append(
                    Finding(
                        self.name, sf.rel_path, line,
                        f"{ci.name}.{attr} is written under "
                        f"{guard.label} at {counts[guard]} site(s) but "
                        f"this write in '{fname}' (reachable from a "
                        f"thread root of {ci.name}) skips the guard — "
                        "an unguarded cross-thread read-modify-write",
                    )
                )
        return out


def lockcheck_rules() -> list[Rule]:
    return [LockOrderStaticRule(), HoldAndBlockRule(), GuardedByRule()]


# -- graph export & runtime cross-check ---------------------------------------


def build_static_graph(paths: list[str]) -> dict:
    """Collect the whole-program static acquisition graph for ``paths``
    (files or directories) — the JSON the runtime lock-order tier's
    observed graph is asserted a subgraph of."""
    from gofr_tpu_torch.analysis.core import iter_python_files

    reg = LockRegistry()
    for full, rel in iter_python_files(paths):
        with open(full, encoding="utf-8") as fp:
            source = fp.read()
        try:
            sf = SourceFile(full, rel, source)
        except SyntaxError:
            continue
        reg.add(sf)
    return reg.graph()


def render_graph_json(graph: dict) -> str:
    return json.dumps(graph, indent=2, sort_keys=True)


def check_subgraph(
    runtime_graph: dict,
    static_graph: dict,
    exclude_prefixes: tuple[str, ...] = ("gofr_tpu_torch/testutil/",),
) -> list[str]:
    """Verify the runtime-observed acquisition graph is a subgraph of the
    static one. Returns human-readable divergence strings (empty = ok).

    Runtime nodes are creation sites (``path:line``); they are mapped to
    static lock identities through the static nodes' site lists. Sites
    the static graph does not know (locks created in tests, the stdlib,
    or via factories the analyzer cannot see) are ignored — the invariant
    is about edges BETWEEN statically-known locks. Site-level self-edges
    are ignored too: two instances of one class can legitimately nest
    the "same" lock. ``exclude_prefixes`` drops scaffolding
    (testutil) sites from the comparison."""
    site_to_label: dict[str, str] = {}
    for label, node in static_graph.get("nodes", {}).items():
        for site in node.get("sites", ()):
            site_to_label[site] = label
    static_edges = {
        (e["from"], e["to"]) for e in static_graph.get("edges", ())
    }
    divergences: list[str] = []
    for a_site, b_site in runtime_graph.get("edges", ()):
        if any(
            a_site.startswith(p) or b_site.startswith(p)
            for p in exclude_prefixes
        ):
            continue
        a = site_to_label.get(a_site)
        b = site_to_label.get(b_site)
        if a is None or b is None or a == b:
            continue
        if (a, b) not in static_edges:
            divergences.append(
                f"runtime edge {a} ({a_site}) -> {b} ({b_site}) is missing "
                "from the static graph — analyzer blind spot (or a lock "
                "acquisition path the analyzer cannot resolve)"
            )
    return sorted(divergences)
