"""Graph datasource — the Dgraph-shaped contract
(container/datasources.go:408-491) with an embedded property-graph
engine.

The reference interface is Query/Mutate/Alter/NewTxn over a Dgraph
cluster; here the same surface runs on an in-process **property graph**:
uid-addressed nodes with typed properties, directed labeled edges
(predicates), reverse-edge indexing, and a structured query language
covering the DQL patterns the reference's examples use:

- root functions: ``eq``/``gt``/``lt``/``ge``/``le`` on a property,
  ``has`` (predicate or property exists), ``uid``, ``anyofterms``
- ``@filter`` with ``and``/``or``/``not`` over the same functions
- nested edge expansion to any depth (forward or ``~reverse``)
- ``shortest_path`` between two uids (BFS)

Mutations follow the Dgraph JSON convention: ``set`` with ``uid`` (or a
``_:blank`` to allocate) and scalar or ``{"uid": ...}`` edge values;
``delete`` by uid (node) or (uid, predicate) / (uid, predicate, target).
Transactions stage mutations and apply on commit (discard drops them).

The port's copy of ``gofr_tpu/datasource/graph/__init__.py``; it imports
nothing of the JAX package.
"""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any


class GraphError(Exception):
    status_code = 500


class EmbeddedGraph:
    def __init__(self) -> None:
        self._nodes: dict[str, dict[str, Any]] = {}  # uid → props
        self._edges: dict[tuple[str, str], list[str]] = {}  # (uid, pred) → [uid]
        self._reverse: dict[tuple[str, str], list[str]] = {}  # (uid, pred) → [src]
        self._ids = itertools.count(1)
        self._lock = threading.RLock()
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EmbeddedGraph":
        return cls()

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        if self._logger:
            self._logger.debug("embedded graph store ready")

    # -- mutations (Dgraph JSON set/delete) --------------------------------
    def mutate(self, set: list[dict] | None = None,
               delete: list[dict] | None = None) -> dict[str, str]:
        """Apply a mutation; returns blank-node → assigned-uid mapping."""
        with self._lock:
            return self._apply(set or [], delete or [])

    def _apply(self, sets: list[dict], deletes: list[dict]) -> dict[str, str]:
        assigned: dict[str, str] = {}

        def resolve_uid(ref: str) -> str:
            if ref.startswith("_:"):
                if ref not in assigned:
                    assigned[ref] = f"0x{next(self._ids):x}"
                    self._nodes.setdefault(assigned[ref], {})
                return assigned[ref]
            self._nodes.setdefault(ref, {})
            return ref

        for obj in sets:
            if "uid" not in obj:
                raise GraphError('set mutation needs a "uid" (use "_:name" to allocate)')
            uid = resolve_uid(str(obj["uid"]))
            for key, value in obj.items():
                if key == "uid":
                    continue
                if isinstance(value, dict) and "uid" in value:
                    self._add_edge(uid, key, resolve_uid(str(value["uid"])))
                elif isinstance(value, list) and value and all(
                    isinstance(v, dict) and "uid" in v for v in value
                ):
                    for v in value:
                        self._add_edge(uid, key, resolve_uid(str(v["uid"])))
                else:
                    self._nodes[uid][key] = value
        for obj in deletes:
            uid = str(obj.get("uid", ""))
            if not uid or uid not in self._nodes:
                continue
            pred = obj.get("predicate")
            if pred is None:
                self._drop_node(uid)
            else:
                target = obj.get("target")
                self._drop_edge(uid, pred, str(target) if target else None)
        return assigned

    def _add_edge(self, src: str, pred: str, dst: str) -> None:
        fwd = self._edges.setdefault((src, pred), [])
        if dst not in fwd:
            fwd.append(dst)
        rev = self._reverse.setdefault((dst, pred), [])
        if src not in rev:
            rev.append(src)

    def _drop_edge(self, src: str, pred: str, dst: str | None) -> None:
        fwd = self._edges.get((src, pred), [])
        doomed = [d for d in fwd if dst is None or d == dst]
        remaining = [d for d in fwd if d not in doomed]
        if remaining:
            self._edges[(src, pred)] = remaining
        else:
            # an empty key would keep has(pred) matching a node whose last
            # edge is gone
            self._edges.pop((src, pred), None)
        for d in doomed:
            rev = self._reverse.get((d, pred), [])
            if src in rev:
                rev.remove(src)
            if not rev:
                self._reverse.pop((d, pred), None)

    def _drop_node(self, uid: str) -> None:
        self._nodes.pop(uid, None)
        for (src, pred), dsts in list(self._edges.items()):
            if src == uid:
                del self._edges[(src, pred)]
            elif uid in dsts:
                dsts.remove(uid)
        for (dst, pred), srcs in list(self._reverse.items()):
            if dst == uid:
                del self._reverse[(dst, pred)]
            elif uid in srcs:
                srcs.remove(uid)

    # -- query engine ------------------------------------------------------
    def _eval_func(self, uid: str, func: dict) -> bool:
        props = self._nodes.get(uid, {})
        ((op, operand),) = func.items()
        if op == "uid":
            wanted = operand if isinstance(operand, list) else [operand]
            return uid in [str(u) for u in wanted]
        if op == "has":
            return operand in props or (uid, operand) in self._edges
        if op == "anyofterms":
            field, terms = operand
            hay = str(props.get(field, "")).lower().split()
            return any(t.lower() in hay for t in str(terms).split())
        field, value = operand
        have = props.get(field)
        if have is None:
            return False
        try:
            if op == "eq":
                return have == value
            if op == "gt":
                return have > value
            if op == "ge":
                return have >= value
            if op == "lt":
                return have < value
            if op == "le":
                return have <= value
        except TypeError:
            return False
        raise GraphError(f"unknown query function {op!r}")

    def _eval_filter(self, uid: str, flt: dict) -> bool:
        if "and" in flt:
            return all(self._eval_filter(uid, f) for f in flt["and"])
        if "or" in flt:
            return any(self._eval_filter(uid, f) for f in flt["or"])
        if "not" in flt:
            return not self._eval_filter(uid, flt["not"])
        return self._eval_func(uid, flt)

    def _expand(self, uid: str, spec: dict, depth: int = 0) -> dict[str, Any]:
        if depth > 16:
            raise GraphError("expansion too deep (cycle?)")
        out: dict[str, Any] = {"uid": uid, **self._nodes.get(uid, {})}
        for pred, sub in (spec or {}).items():
            reverse = pred.startswith("~")
            key = pred[1:] if reverse else pred
            table = self._reverse if reverse else self._edges
            children = table.get((uid, key), [])
            sub = sub or {}
            flt = sub.get("filter")
            kids = [
                self._expand(c, sub.get("expand", {}), depth + 1)
                for c in children
                if flt is None or self._eval_filter(c, flt)
            ]
            if kids:
                out[pred] = kids
        return out

    def query(self, func: dict, filter: dict | None = None,
              expand: dict | None = None, first: int | None = None) -> list[dict]:
        """Root function → filtered uids → nested expansion (the DQL
        block shape, as structured data instead of DQL text)."""
        with self._lock:
            if "uid" in func:
                wanted = func["uid"]
                roots = [str(u) for u in (wanted if isinstance(wanted, list) else [wanted])
                         if str(u) in self._nodes]
            else:
                roots = [u for u in self._nodes if self._eval_func(u, func)]
            if filter:
                roots = [u for u in roots if self._eval_filter(u, filter)]
            roots.sort()
            if first is not None:
                roots = roots[:first]
            return [self._expand(u, expand or {}) for u in roots]

    def shortest_path(self, src: str, dst: str,
                      predicates: list[str] | None = None) -> list[str]:
        """BFS over forward edges (optionally restricted to predicates);
        returns the uid path or [] when unreachable."""
        with self._lock:
            if src not in self._nodes or dst not in self._nodes:
                return []
            prev: dict[str, str] = {src: ""}
            q = deque([src])
            while q:
                cur = q.popleft()
                if cur == dst:
                    path = [cur]
                    while prev[path[-1]]:
                        path.append(prev[path[-1]])
                    return list(reversed(path))
                for (u, pred), dsts in self._edges.items():
                    if u != cur or (predicates and pred not in predicates):
                        continue
                    for d in dsts:
                        if d not in prev:
                            prev[d] = cur
                            q.append(d)
            return []

    # -- transactions (NewTxn, datasources.go:470-491) ---------------------
    def new_txn(self) -> "GraphTxn":
        return GraphTxn(self)

    # -- admin / health ----------------------------------------------------
    def alter(self, drop_all: bool = False) -> None:
        """The Alter(op) analogue — schema ops reduce to drop_all here."""
        if drop_all:
            with self._lock:
                self._nodes.clear()
                self._edges.clear()
                self._reverse.clear()

    def health_check(self) -> dict[str, Any]:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "embedded-graph",
                    "nodes": len(self._nodes),
                    "edges": sum(len(v) for v in self._edges.values()),
                },
            }

    def close(self) -> None:
        self.alter(drop_all=True)


class GraphTxn:
    """Staged mutations; queries inside the txn see committed state plus
    nothing (read-committed — matching Dgraph's default best-effort reads
    for this embedded engine)."""

    def __init__(self, graph: EmbeddedGraph) -> None:
        self._graph = graph
        self._sets: list[dict] = []
        self._deletes: list[dict] = []
        self._done = False

    def mutate(self, set: list[dict] | None = None,
               delete: list[dict] | None = None) -> None:
        if self._done:
            raise GraphError("transaction already finished")
        self._sets.extend(set or [])
        self._deletes.extend(delete or [])

    def query(self, **kw: Any) -> list[dict]:
        return self._graph.query(**kw)

    def commit(self) -> dict[str, str]:
        if self._done:
            raise GraphError("transaction already finished")
        self._done = True
        with self._graph._lock:
            return self._graph._apply(self._sets, self._deletes)

    def discard(self) -> None:
        self._done = True
        self._sets.clear()
        self._deletes.clear()
