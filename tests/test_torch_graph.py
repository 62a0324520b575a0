"""The port's graph datasource (``gofr_tpu_torch/datasource/graph``) against
the JAX package's (``gofr_tpu/datasource/graph``): seeded random sequences
of mutations (blank-node sets with scalar and edge values, edge and node
deletes), DQL-shaped queries (root functions, filters with and/or/not,
nested forward and reverse expansion, ``first``), shortest paths with and
without a predicate list, transactions committed and discarded, ``alter``
and health, run step by step through both graphs: every step's result, or
the error's kind and text, equal. Then the reference's own fixture held on
both."""

import numpy as np
import pytest

from gofr_tpu.datasource import graph as r_graph
from gofr_tpu_torch.datasource import graph as t_graph

SIDES = {"ref": r_graph, "port": t_graph}
NAMES = ["alice", "bob", "carol santana", "dave", "eve", "frank"]
PREDS = ["friend", "manages", "knows"]


def _ops(seed: int, n: int = 120) -> list:
    """A seeded op sequence over a small name space, so edges, deletes and
    queries keep hitting the same nodes."""
    rng = np.random.RandomState(seed)
    blanks = [f"_:{n.split()[0]}" for n in NAMES]
    uids = [f"0x{k:x}" for k in range(1, 12)]

    def ref():
        return blanks[rng.randint(len(blanks))] if rng.rand() < 0.5 else uids[rng.randint(len(uids))]

    def func():
        k = rng.randint(7)
        if k == 0:
            return {"eq": ["name", NAMES[rng.randint(len(NAMES))]]}
        if k == 1:
            return {["gt", "ge", "lt", "le"][rng.randint(4)]: ["age", int(rng.randint(20, 50))]}
        if k == 2:
            return {"has": [*PREDS, "age", "name"][rng.randint(5)]}
        if k == 3:
            return {"uid": [uids[i] for i in rng.choice(len(uids), 3, replace=False)]}
        if k == 4:
            return {"anyofterms": ["name", ["santana x", "bob", "zed"][rng.randint(3)]]}
        if k == 5:
            return {"eq": ["age", "not a number"]}
        return {"uid": uids[rng.randint(len(uids))]}

    def flt(depth=0):
        k = rng.randint(5 if depth < 2 else 2)
        if k == 2:
            return {"and": [flt(depth + 1), flt(depth + 1)]}
        if k == 3:
            return {"or": [flt(depth + 1), flt(depth + 1)]}
        if k == 4:
            return {"not": flt(depth + 1)}
        return func()

    def expand(depth=0):
        out = {}
        for p in PREDS:
            if rng.rand() < 0.4:
                key = ("~" + p) if rng.rand() < 0.3 else p
                sub = {}
                if rng.rand() < 0.3:
                    sub["filter"] = flt(1)
                if depth < 2 and rng.rand() < 0.5:
                    sub["expand"] = expand(depth + 1)
                out[key] = sub
        return out

    def set_obj():
        obj = {"uid": ref()}
        if rng.rand() < 0.6:
            obj["name"] = NAMES[rng.randint(len(NAMES))]
        if rng.rand() < 0.6:
            obj["age"] = int(rng.randint(18, 60))
        p = PREDS[rng.randint(len(PREDS))]
        k = rng.randint(3)
        if k == 1:
            obj[p] = {"uid": ref()}
        elif k == 2:
            obj[p] = [{"uid": ref()} for _ in range(rng.randint(1, 3))]
        return obj

    def delete_obj():
        obj = {"uid": uids[rng.randint(len(uids))]}
        k = rng.randint(3)
        if k >= 1:
            obj["predicate"] = PREDS[rng.randint(len(PREDS))]
        if k == 2:
            obj["target"] = uids[rng.randint(len(uids))]
        return obj

    ops = []
    for _ in range(n):
        k = rng.randint(11)
        if k <= 2:
            ops.append(("mutate", {"set": [set_obj() for _ in range(rng.randint(1, 4))]}))
        elif k == 3:
            ops.append(("mutate", {"delete": [delete_obj()]}))
        elif k == 4:
            ops.append(("mutate", {"set": [{"name": "no uid"}]}))
        elif k <= 7:
            kw = {"func": func()}
            if rng.rand() < 0.5:
                kw["filter"] = flt()
            if rng.rand() < 0.6:
                kw["expand"] = expand()
            if rng.rand() < 0.3:
                kw["first"] = int(rng.randint(0, 4))
            ops.append(("query", kw))
        elif k == 8:
            preds = [PREDS[rng.randint(len(PREDS))]] if rng.rand() < 0.5 else None
            ops.append(("shortest_path", (uids[rng.randint(len(uids))],
                                          uids[rng.randint(len(uids))], preds)))
        elif k == 9:
            ops.append(("txn", {"set": [set_obj() for _ in range(rng.randint(1, 3))],
                                "delete": [delete_obj()] if rng.rand() < 0.3 else [],
                                "commit": bool(rng.rand() < 0.6),
                                "query": {"func": func()}}))
        else:
            ops.append(("health", None))
    return ops


def _run(mod, ops) -> list:
    g = mod.EmbeddedGraph()
    g.connect()
    out = []
    for op, arg in ops:
        try:
            if op == "mutate":
                res = g.mutate(**arg)
            elif op == "query":
                res = g.query(**arg)
            elif op == "shortest_path":
                res = g.shortest_path(*arg)
            elif op == "txn":
                txn = g.new_txn()
                txn.mutate(set=arg["set"], delete=arg["delete"])
                seen = txn.query(**arg["query"])  # committed state only
                if arg["commit"]:
                    res = (seen, txn.commit())
                else:
                    txn.discard()
                    res = (seen, None)
                try:
                    txn.commit()
                    res = (*res, "second commit passed")
                except mod.GraphError as exc:
                    res = (*res, str(exc))
            else:
                res = g.health_check()
            out.append((op, res))
        except Exception as exc:  # the error's kind and text, whichever package raised it
            out.append((op, type(exc).__name__, str(exc)))
    g.alter(drop_all=True)
    out.append(("after_drop", g.health_check()))
    g.close()
    return out


@pytest.mark.parametrize("seed", range(10))
def test_seeded_sequences_agree(seed):
    ops = _ops(seed)
    got = {name: _run(mod, ops) for name, mod in SIDES.items()}
    assert got["port"] == got["ref"]
    kinds = {entry[0] for entry in got["port"]}
    assert {"mutate", "query", "shortest_path", "txn", "health"} <= kinds
    # the sequence reached the graph: some query found something
    assert any(op == "query" and len(rest) == 1 and rest[0] for op, *rest in got["port"])


def _fixture(mod):
    g = mod.EmbeddedGraph()
    g.uids = g.mutate(set=[
        {"uid": "_:alice", "name": "Alice", "age": 31},
        {"uid": "_:bob", "name": "Bob", "age": 40},
        {"uid": "_:carol", "name": "Carol Santana", "age": 25},
        {"uid": "_:alice", "friend": {"uid": "_:bob"}},
        {"uid": "_:bob", "friend": {"uid": "_:carol"}},
        {"uid": "_:alice", "manages": [{"uid": "_:bob"}, {"uid": "_:carol"}]},
    ])
    return g


@pytest.mark.parametrize("side", sorted(SIDES))
def test_reference_fixture_on_both(side):
    """The reference's own fixture and assertions (``tests/test_graph.py``)
    on each package."""
    mod = SIDES[side]
    g = _fixture(mod)
    a, b, c = (g.uids[k] for k in ("_:alice", "_:bob", "_:carol"))
    assert len(set(g.uids.values())) == 3
    assert {n["name"] for n in g.query(func={"ge": ["age", 31]})} == {"Alice", "Bob"}
    rows = g.query(func={"has": "age"},
                   filter={"and": [{"gt": ["age", 24]}, {"not": {"eq": ["name", "Bob"]}}]})
    assert {n["name"] for n in rows} == {"Alice", "Carol Santana"}
    alice = g.query(func={"eq": ["name", "Alice"]}, expand={"friend": {"expand": {"friend": {}}}})[0]
    assert alice["friend"][0]["friend"][0]["name"] == "Carol Santana"
    rows = g.query(func={"eq": ["name", "Carol Santana"]}, expand={"~manages": {}})
    assert rows[0]["~manages"][0]["name"] == "Alice"
    assert len(g.shortest_path(a, c, predicates=["friend"])) == 3
    assert g.shortest_path(c, a) == [] and len(g.shortest_path(a, c)) == 2
    g.mutate(delete=[{"uid": a, "predicate": "manages", "target": b}])
    g.mutate(delete=[{"uid": b}])
    assert "friend" not in g.query(func={"uid": a}, expand={"friend": {}})[0]
    txn = g.new_txn()
    txn.mutate(set=[{"uid": "_:dave", "name": "Dave"}])
    assert g.query(func={"eq": ["name", "Dave"]}) == []
    assert "_:dave" in txn.commit()
    with pytest.raises(mod.GraphError):
        txn.commit()
    with pytest.raises(mod.GraphError):
        g.mutate(set=[{"name": "no uid"}])
    g.alter(drop_all=True)
    assert g.health_check()["details"] == {"backend": "embedded-graph", "nodes": 0, "edges": 0}
