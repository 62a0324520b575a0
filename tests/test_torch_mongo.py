"""The port's document family (``gofr_tpu_torch/datasource/document``: the
BSON codec, ``EmbeddedDocumentStore`` with its sessions, ``MongoClient``
over OP_MSG) and its ``MiniMongoServer`` beside the JAX package's:

- the cases of ``tests/test_mongo.py`` one by one with every client against
  every fake (either package's ``MongoClient`` on either package's
  ``MiniMongoServer``), each result equal to the reference's client on the
  reference's fake, object ids aside;
- the same operations on both packages' ``EmbeddedDocumentStore`` with
  equal results, and the sessions of ``tests/test_datasource_families.py``;
- the reference's per-backend answers kept: a duplicate ``_id`` is
  ``sqlite3.IntegrityError`` embedded and ``MongoError`` over the wire
  (ROADMAP Queue C 54), an equality filter does not match inside an array
  on either (C 55), and a second session's transaction on one connection is
  refused by the fake (C 57);
- the fakes' differences: the port's drops its live connections on
  ``close()``, so a client's health turns DOWN (C 56), and it counts the
  commands it served, which equal the client's ``app_mongo_stats``.
"""

import datetime as dt
import sqlite3
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import document as rdocument
from gofr_tpu.datasource.document import bson as rbson
from gofr_tpu.datasource.document import embedded as rembedded
from gofr_tpu.datasource.document import mongo as rmongo
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu.testutil.mongo_server import MiniMongoServer as RMiniMongoServer
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import document as tdocument
from gofr_tpu_torch.datasource.document import bson as tbson
from gofr_tpu_torch.datasource.document import embedded as tembedded
from gofr_tpu_torch.datasource.document import mongo as tmongo
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil import MiniMongoServer

PKGS = {
    "ref": types.SimpleNamespace(doc=rdocument, bson=rbson, embedded=rembedded, mongo=rmongo,
                                 server=RMiniMongoServer, config=RMapConfig,
                                 manager=r_new_metrics_manager),
    "port": types.SimpleNamespace(doc=tdocument, bson=tbson, embedded=tembedded, mongo=tmongo,
                                  server=MiniMongoServer, config=MapConfig,
                                  manager=new_metrics_manager),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]
OIDS = (rbson.ObjectId, tbson.ObjectId)


def norm(value):
    """Object ids (either package's) as one placeholder; nested values too."""
    if isinstance(value, OIDS):
        return "<oid>"
    if isinstance(value, dict):
        return {k: norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [norm(v) for v in value]
    return value


def outcome(fn, *args, **kw):
    try:
        return ("ok", norm(fn(*args, **kw)))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("raised", type(exc).__name__, str(exc))


# ------------------------------------------------------------- the scenarios
# each takes a store (a MongoClient or an EmbeddedDocumentStore) and returns
# what it saw; the wire-only ones use create_collection and raw commands
def insert_find(c):
    oid = c.insert_one("users", {"name": "ada", "age": 36})
    doc = c.find_one("users", {"name": "ada"})
    # an id the store made: an ObjectId over the wire, a uuid's hex embedded
    return [type(oid).__name__, {k: v for k, v in doc.items() if k != "_id"}, doc["_id"] == oid,
            outcome(c.find_one, "users", {"name": "nobody"})]


def insert_many_filters(c):
    ids = c.insert_many("nums", [{"n": i, "even": i % 2 == 0} for i in range(10)])
    return [len(ids), c.count_documents("nums", {}),
            sorted(d["n"] for d in c.find("nums", {"n": {"$gte": 7}})),
            c.count_documents("nums", {"even": True}),
            sorted(d["n"] for d in c.find("nums", {"n": {"$in": [1, 4, 99]}})),
            sorted(d["n"] for d in c.find("nums", {"n": {"$ne": 3}, "even": False})),
            sorted(d["n"] for d in c.find("nums", {"n": {"$gt": 2, "$lte": 5}}))]


def update_one_many_by_id(c):
    ids = c.insert_many("t", [{"v": 1}, {"v": 1}, {"v": 2}])
    out = [c.update_one("t", {"v": 1}, {"$set": {"v": 10}}),
           c.update_many("t", {"v": 1}, {"$inc": {"v": 5}}),
           c.update_by_id("t", ids[2], {"$set": {"v": 99}}),
           c.find_one("t", {"_id": ids[2]})["v"]]
    out.append(c.update_many("t", {}, {"$inc": {"hits": 1}}))  # $inc of a missing field
    out.append(c.update_one("t", {"v": 10}, {"$unset": {"hits": ""}}))
    out.append(c.update_one("t", {"v": 99}, {"w": 1}))  # a replacement keeps the id
    out.append(sorted(repr((d.get("v"), d.get("w"), d.get("hits"))) for d in c.find("t", {})))
    return out


def delete_one_many(c):
    c.insert_many("d", [{"k": i % 2} for i in range(6)])
    return [c.delete_one("d", {"k": 0}), c.delete_many("d", {"k": 0}),
            c.count_documents("d", {}), c.delete_many("d", {"k": 5})]


def transactions(c):
    sess = c.start_session()
    with sess.start_transaction():
        sess.insert_one("tx", {"v": 1})
        sess.insert_one("tx", {"v": 2})
    out = [c.count_documents("tx", {})]
    c.insert_one("tx2", {"v": 0})
    try:
        with sess.start_transaction():
            sess.insert_one("tx2", {"v": 1})
            raise RuntimeError("boom")
    except RuntimeError as exc:
        out.append(str(exc))
    out.append(c.count_documents("tx2", {}))

    def work(s):
        s.insert_one("tx3", {"v": 1})
        return "done"

    out += [sess.with_transaction(work), c.count_documents("tx3", {})]
    return out


def probes(c):
    """ROADMAP Queue C 54 and 55, and the operations the embedded store and
    the wire agree on."""
    c.insert_one("p", {"_id": "dup", "tok": [2, 3], "x": None})
    c.insert_one("p", {"_id": "two", "tok": [3, 4], "x": 1})
    return [outcome(c.insert_one, "p", {"_id": "dup"}),
            sorted(d["_id"] for d in c.find("p", {"tok": 3})),
            sorted(d["_id"] for d in c.find("p", {"tok": [2, 3]})),
            sorted(d["_id"] for d in c.find("p", {"x": None})),
            sorted(d["_id"] for d in c.find("p", {"x": {"$ne": None}}))]


def getmore(c):
    c.insert_many("big", [{"n": i} for i in range(250)])
    docs = c.find("big", {})
    return [len(docs), sorted(d["n"] for d in docs) == list(range(250))]


def values_roundtrip(c):
    """What a document keeps through a store: the wire keeps BSON's types;
    the embedded store keeps JSON's."""
    when = dt.datetime(2026, 10, 18, 6, 4, 40, tzinfo=dt.timezone.utc)
    doc = {"_id": "v", "s": "x", "i": 7, "f": 1.5, "b": True, "n": None, "l": [1, "a"],
           "d": {"k": [{"z": 0}]}}
    try:
        c.insert_one("vals", {**doc, "_id": "w", "when": when, "blob": b"\x00\x01"})
        wire = c.find_one("vals", {"_id": "w"})
    except TypeError as exc:  # the embedded store's JSON cannot hold them
        wire = ("raised", type(exc).__name__)
    c.insert_one("vals", doc)
    return [c.find_one("vals", {"_id": "v"}), norm(wire)]


def drop_and_create(c):
    c.create_collection("fresh")
    c.insert_one("fresh", {"x": 1})
    c.drop("fresh")
    out = [c.count_documents("fresh", {})]
    c.drop("neverexisted")
    return out + [outcome(c._command, {"nonsenseCommand": 1})]


def interleaved_sessions(c):
    """ROADMAP Queue C 57: two sessions' transactions on one connection."""
    a, b = c.start_session(), c.start_session()
    a.start_transaction()
    a.insert_one("i", {"_id": "a"})
    b.start_transaction()
    out = [outcome(b.insert_one, "i", {"_id": "b"})]
    a.commit_transaction()
    out.append(outcome(b.abort_transaction))
    return out + [sorted(d["_id"] for d in c.find("i", {}))]


SHARED = [insert_find, insert_many_filters, update_one_many_by_id, delete_one_many,
          transactions, probes, getmore, values_roundtrip]
WIRE = SHARED + [drop_and_create, interleaved_sessions]


@pytest.fixture
def servers():
    out = {side: PKGS[side].server().start() for side in SIDES}
    yield out
    for s in out.values():
        s.close()


def client(side: str, server, database: str = "testdb"):
    c = PKGS[side].mongo.MongoClient(host="127.0.0.1", port=server.port, database=database)
    c.connect()
    return c


def on_wire(scenario, c_side: str, server) -> list:
    c = client(c_side, server)
    try:
        return scenario(c)
    finally:
        c.close()


@pytest.mark.parametrize("scenario", WIRE, ids=lambda f: f.__name__)
@pytest.mark.parametrize("client_side,server_side", CROSS)
def test_wire_cases_crossed_both_ways(servers, client_side, server_side, scenario):
    ref_server = RMiniMongoServer().start()
    try:
        want = on_wire(scenario, "ref", ref_server)
    finally:
        ref_server.close()
    got = on_wire(scenario, client_side, servers[server_side])
    assert got == want


@pytest.mark.parametrize("scenario", SHARED, ids=lambda f: f.__name__)
def test_embedded_store_answers_as_the_reference(scenario):
    got = {side: scenario(PKGS[side].embedded.EmbeddedDocumentStore()) for side in SIDES}
    assert got["port"] == got["ref"]


def test_backends_keep_the_references_answers():
    """Queue C 54 and 55 as the reference has them, on the port."""
    embedded = probes(tembedded.EmbeddedDocumentStore())
    server = MiniMongoServer().start()
    try:
        wire = on_wire(probes, "port", server)
    finally:
        server.close()
    assert embedded[0][:2] == ("raised", "IntegrityError")
    assert issubclass(sqlite3.IntegrityError, sqlite3.Error)
    assert wire[0][:2] == ("raised", "MongoError") and "UNIQUE" in wire[0][2]
    # equality does not reach into an array on either backend
    assert embedded[1:] == wire[1:] == [[], ["dup"], ["dup"], ["two"]]
    vals = values_roundtrip(tembedded.EmbeddedDocumentStore())
    assert vals[1] == ["raised", "TypeError"]


# ------------------------------------------------------------- sessions
def txn_cases(store, mod) -> list:
    """The session cases of ``TestDocumentTransactions``, in one run."""
    store.insert_one("accounts", {"_id": "a", "balance": 100})
    store.insert_one("accounts", {"_id": "b", "balance": 50})
    bal = lambda k: (store.find_one("accounts", {"_id": k}) or {}).get("balance")  # noqa: E731
    out = []
    s = store.start_session()
    with s.start_transaction():
        s.update_by_id("accounts", "a", {"$inc": {"balance": -30}})
        s.update_by_id("accounts", "b", {"$inc": {"balance": 30}})
        out.append(s.find_one("accounts", {"_id": "a"})["balance"])  # reads its own writes
    out += [bal("a"), bal("b")]
    try:
        with s.start_transaction():
            s.update_by_id("accounts", "a", {"$inc": {"balance": -30}})
            s.insert_one("audit", {"event": "transfer"})
            raise RuntimeError("boom")
    except RuntimeError:
        out.append("rolled back")
    out += [bal("a"), store.count_documents("audit", {})]
    with s.start_transaction():
        s.update_by_id("accounts", "a", {"$set": {"balance": 0}})
        raise mod.TransactionAborted()
    out.append(bal("a"))
    out.append(s.with_transaction(lambda x: x.update_by_id("accounts", "b", {"$inc": {"balance": 1}})))
    with s.start_transaction():
        out.append(outcome(s.start_transaction))
        inner = store.start_session()
        out.append(outcome(inner.start_transaction))
        s.abort_transaction()
    out.append(outcome(s.commit_transaction))
    with s.start_transaction():
        s.update_by_id("accounts", "b", {"$set": {"balance": 7}})
        s.commit_transaction()
    out.append(bal("b"))
    s.end_session()
    return out


def test_sessions_and_transactions_equal_the_reference():
    got = {side: txn_cases(PKGS[side].embedded.EmbeddedDocumentStore(), PKGS[side].embedded)
           for side in SIDES}
    assert got["port"] == got["ref"]
    assert got["port"][:6] == [70, 70, 80, "rolled back", 70, 0]


def test_wire_session_ids_and_txn_numbers():
    s = tmongo.MongoClient().start_session()
    assert isinstance(s.lsid["id"], tbson.Binary) and s.lsid["id"].subtype == 4
    s.start_transaction()
    fields = s._txn_fields()
    assert isinstance(fields["txnNumber"], tbson.Int64) and fields["startTransaction"] is True
    assert "startTransaction" not in s._txn_fields()


# ------------------------------------------------------------- health, fakes
@pytest.mark.parametrize("client_side,server_side", CROSS)
def test_health_up_then_down_on_close(client_side, server_side):
    srv = PKGS[server_side].server().start()
    c = client(client_side, srv)
    up = c.health_check()
    c.close()
    down = c.health_check()
    srv.close()
    assert (up["status"], up["details"]["backend"], down["status"]) == ("UP", "mongo-wire", "DOWN")


@pytest.mark.parametrize("client_side", SIDES)
def test_a_stopped_fake(client_side):
    """Queue C 56: the port's fake drops its connections on close(), so a
    client's health turns DOWN and its next command fails; the reference's
    keeps answering ping on them (health UP) while every store command fails."""
    got = {}
    for server_side in SIDES:
        srv = PKGS[server_side].server().start()
        c = client(client_side, srv)
        c.insert_one("x", {"_id": 1})
        srv.close()
        got[server_side] = (c.health_check()["status"], outcome(c.insert_one, "x", {"_id": 2})[:2])
        c.close()
    assert got["ref"] == ("UP", ("raised", "MongoError"))
    assert got["port"][0] == "DOWN" and got["port"][1][0] == "raised"


@pytest.mark.parametrize("side", SIDES)
def test_factory_picks_the_backend(side, servers):
    mod, cfg = PKGS[side].doc, PKGS[side].config
    wire = mod.new_document_store(cfg({"MONGO_HOST": "127.0.0.1",
                                       "MONGO_PORT": str(servers[side].port)}, use_env=False))
    assert isinstance(wire, PKGS[side].mongo.MongoClient)
    uri = mod.new_document_store(cfg({"MONGO_URI": f"mongodb://u:p@127.0.0.1:"
                                      f"{servers[side].port}/jobs?w=1"}, use_env=False))
    assert (uri.host, uri.port, uri.database) == ("127.0.0.1", servers[side].port, "jobs")
    embedded = mod.new_document_store(cfg({}, use_env=False))
    assert isinstance(embedded, PKGS[side].embedded.EmbeddedDocumentStore)
    assert embedded.path == ":memory:" and sorted(mod.__all__) == sorted(rdocument.__all__)


def test_stats_series_equal_the_reference_and_the_commands_served():
    """``app_mongo_stats`` (the wire client) and ``app_document_stats`` (the
    embedded store): registered with the reference's kind and description,
    listed in the port's catalog, one observation an operation; the wire
    client's equal the store commands the port's fake served."""
    from gofr_tpu_torch.serving.metrics_catalog import SELF_REGISTERED_METRICS

    got = {}
    for side in SIDES:
        p = PKGS[side]
        srv, manager = MiniMongoServer().start(), p.manager()
        c = p.mongo.MongoClient(host="127.0.0.1", port=srv.port)
        c.use_metrics(manager)
        c.use_metrics(manager)
        c.connect()
        insert_many_filters(c)
        transactions(c)
        c.health_check()
        c.close()
        store = p.embedded.EmbeddedDocumentStore()
        store.use_metrics(manager)
        insert_many_filters(store)
        series = {}
        for name in ("app_mongo_stats", "app_document_stats"):
            hist = manager.get(name)
            with hist._lock:
                series[name] = (type(hist).__name__, hist.description,
                                sum(state[2] for state in hist._series.values()))
        got[side] = (series, dict(srv.commands))
        srv.close()
    assert got["port"] == got["ref"]
    series, served = got["port"]
    store_ops = sum(n for k, n in served.items()
                    if k not in ("hello", "ping", "commitTransaction", "abortTransaction"))
    assert series["app_mongo_stats"][2] == store_ops == 15
    for name, (kind, description, _) in series.items():
        assert ("histogram", name, description, None) in SELF_REGISTERED_METRICS
