"""The port's vendor facades (``gofr_tpu_torch/datasource/compat.py``:
``OracleFacade``/``OracleTxFacade`` over SQL, ``SurrealFacade`` and
``CouchbaseFacade`` over the document family, ``ArangoFacade`` over the
document and graph families) against the JAX package's
(``gofr_tpu/datasource/compat.py``): each facade over each package's
backends runs one script (the reference's ``tests/test_compat_facades.py``
flows, with explicit ids where the facade would draw a random one), and
every result, error and health report equals the reference facade's over
the reference's backends. The port's facades satisfy the port's contracts
(``container/datasources.py``), and ``app.add_datasource`` wires them into
``ctx.datasource`` and health."""

import dataclasses

import pytest

from gofr_tpu.datasource import compat as r_compat
from gofr_tpu.datasource.document import EmbeddedDocumentStore as RDocs
from gofr_tpu.datasource.graph import EmbeddedGraph as RGraph
from gofr_tpu.datasource.sql import SQLite as RSQLite
from gofr_tpu_torch.container import datasources as contracts
from gofr_tpu_torch.datasource import compat as t_compat
from gofr_tpu_torch.datasource.document import EmbeddedDocumentStore as TDocs
from gofr_tpu_torch.datasource.graph import EmbeddedGraph as TGraph
from gofr_tpu_torch.datasource.sql.sqlite import SQLite as TSQLite

FACADES = {"ref": r_compat, "port": t_compat}
BACKENDS = {"ref": {"sql": RSQLite, "docs": RDocs, "graph": RGraph},
            "port": {"sql": TSQLite, "docs": TDocs, "graph": TGraph}}


@dataclasses.dataclass
class Emp:
    id: int
    name: str


def _attempt(record, what, fn):
    try:
        record.append((what, "ok", fn()))
    except Exception as exc:  # the error's kind and text, whichever package raised it
        record.append((what, type(exc).__name__, str(exc)))


def _oracle(mod, b) -> list:
    out: list = []
    sql = b["sql"](":memory:")
    sql.connect()
    ora = mod.OracleFacade(sql)
    ora.connect()
    _attempt(out, "ddl", lambda: ora.exec("CREATE TABLE emp (id INTEGER PRIMARY KEY, name TEXT)"))
    _attempt(out, "insert", lambda: ora.exec("INSERT INTO emp VALUES (?, ?)", 1, "scott"))
    _attempt(out, "select", lambda: ora.select(Emp, "SELECT id, name FROM emp"))
    _attempt(out, "dup", lambda: ora.exec("INSERT INTO emp VALUES (?, ?)", 1, "again"))
    tx = ora.begin()
    _attempt(out, "tx_exec", lambda: tx.exec_context("INSERT INTO emp VALUES (?, ?)", 2, "tiger"))
    _attempt(out, "tx_select", lambda: tx.select_context(dict, "SELECT name FROM emp ORDER BY id"))
    _attempt(out, "commit", tx.commit)
    tx = ora.begin()
    _attempt(out, "tx_delete", lambda: tx.exec_context("DELETE FROM emp"))
    _attempt(out, "rollback", tx.rollback)
    _attempt(out, "after", lambda: ora.select(dict, "SELECT id, name FROM emp ORDER BY id"))
    out.append(("health", ora.health_check()))
    return out


def _surreal(mod, b) -> list:
    out: list = []
    surreal = mod.SurrealFacade(b["docs"]())
    surreal.connect()
    surreal.create_namespace("app")
    surreal.create_database("prod")
    surreal.use("app", "prod")
    created = surreal.create("person", {"name": "ada", "role": "eng"})
    out.append(("random_id", created["_id"].startswith("person:"), len(created["_id"])))
    _attempt(out, "create", lambda: surreal.create("person", {"_id": "person:alan", "name": "alan",
                                                              "role": "eng"}))
    _attempt(out, "select", lambda: sorted(r["name"] for r in surreal.select("person")))
    _attempt(out, "query", lambda: surreal.query("SELECT * FROM person WHERE name = $n",
                                                 {"n": "alan"}))
    _attempt(out, "query_all", lambda: len(surreal.query("SELECT * FROM person;")))
    _attempt(out, "update", lambda: surreal.update("person", "person:alan", {"role": "founder"}))
    _attempt(out, "delete", lambda: surreal.delete("person", created["_id"]))
    _attempt(out, "after", lambda: surreal.select("person"))
    surreal.use("app", "staging")
    _attempt(out, "other_db", lambda: surreal.select("person"))
    _attempt(out, "unsupported", lambda: surreal.query("DELETE person"))
    surreal.drop_database("staging")
    surreal.drop_namespace("app")
    out.append(("known", sorted(surreal._known)))
    out.append(("health", surreal.health_check()))
    return out


def _arango(mod, b) -> list:
    out: list = []
    arango = mod.ArangoFacade(b["docs"](), b["graph"]())
    arango.connect()
    arango.create_db("social")
    arango.create_collection("social", "persons", is_edge=False)
    arango.create_collection("social", "knows", is_edge=True)
    _attempt(out, "graph", lambda: arango.create_graph("social", "friends",
                                                       {"edge_collection": "knows"}))
    _attempt(out, "nil_graph", lambda: arango.create_graph("social", "bad", None))
    _attempt(out, "p1", lambda: arango.create_document("social", "persons",
                                                       {"_id": "persons/1", "name": "ada"}))
    _attempt(out, "p2", lambda: arango.create_document("social", "persons",
                                                       {"_id": "persons/2", "name": "alan"}))
    _attempt(out, "edge", lambda: arango.create_document(
        "social", "knows", {"_id": "knows/1", "_from": "persons/1", "_to": "persons/2"}))
    _attempt(out, "get", lambda: arango.get_document("social", "persons", "persons/1"))
    _attempt(out, "update", lambda: arango.update_document("social", "persons", "persons/1",
                                                           {"name": "ada lovelace"}))
    _attempt(out, "get2", lambda: arango.get_document("social", "persons", "persons/1"))
    _attempt(out, "edges1", lambda: arango.get_edges("social", "friends", "knows", "persons/1"))
    _attempt(out, "edges2", lambda: arango.get_edges("social", "friends", "knows", "persons/2"))
    _attempt(out, "graph_nodes", lambda: arango.graph.query(func={"has": "edge_src"}))
    _attempt(out, "delete", lambda: arango.delete_document("social", "persons", "persons/2"))
    _attempt(out, "gone", lambda: arango.get_document("social", "persons", "persons/2"))
    arango.drop_graph("social", "friends")
    arango.drop_collection("social", "persons")
    _attempt(out, "dropped", lambda: arango.get_document("social", "persons", "persons/1"))
    arango.drop_db("social")
    out.append(("state", sorted(arango._collections), sorted(arango._graphs)))
    out.append(("health", arango.health_check()))
    return out


def _couchbase(mod, b) -> list:
    out: list = []
    docs = b["docs"]()
    docs.connect()
    cb = mod.CouchbaseFacade(docs, bucket="apps")
    cb.connect()
    _attempt(out, "insert", lambda: cb.insert("u:1", {"name": "ada", "plan": "pro"}))
    _attempt(out, "dup", lambda: cb.insert("u:1", {"name": "dup"}))
    _attempt(out, "upsert", lambda: cb.upsert("u:2", {"name": "alan", "plan": "free", "x": 1}))
    _attempt(out, "replace", lambda: cb.upsert("u:2", {"name": "alan", "plan": "pro"}))
    _attempt(out, "get", lambda: [cb.get("u:1"), cb.get("u:2"), cb.get("missing")])
    _attempt(out, "query", lambda: cb.query("SELECT * FROM `apps` WHERE plan = $p", {"p": "pro"}))
    _attempt(out, "analytics", lambda: cb.analytics_query("SELECT * FROM apps"))
    _attempt(out, "unsupported", lambda: cb.query("UPDATE apps SET x = 1"))

    def bad_logic(session):
        session.update_by_id("apps", "u:1", {"$set": {"plan": "canceled"}})
        raise RuntimeError("boom")

    def good_logic(session):
        session.update_by_id("apps", "u:1", {"$set": {"plan": "team"}})

    _attempt(out, "txn_abort", lambda: cb.run_transaction(bad_logic))
    _attempt(out, "rolled_back", lambda: cb.get("u:1"))
    _attempt(out, "txn_commit", lambda: cb.run_transaction(good_logic))
    _attempt(out, "committed", lambda: cb.get("u:1"))
    _attempt(out, "remove", lambda: cb.remove("u:2"))
    _attempt(out, "removed", lambda: cb.get("u:2"))
    out.append(("health", cb.health_check()))
    return out


SCRIPTS = {"oracle": _oracle, "surreal": _surreal, "arango": _arango, "couchbase": _couchbase}


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("facade", sorted(FACADES))
@pytest.mark.parametrize("kind", sorted(SCRIPTS))
def test_facade_over_each_backend_matches_the_reference(kind, facade, backend):
    want = SCRIPTS[kind](FACADES["ref"], BACKENDS["ref"])
    got = SCRIPTS[kind](FACADES[facade], BACKENDS[backend])
    assert got == want
    health = next(entry[1] for entry in got if entry[0] == "health")
    assert health["status"] == "UP"
    assert health["details"]["facade"] == {"oracle": "oracle", "surreal": "surrealdb",
                                           "arango": "arangodb", "couchbase": "couchbase"}[kind]


def test_port_facades_satisfy_the_port_contracts():
    sql = TSQLite(":memory:")
    docs = TDocs()
    assert isinstance(t_compat.OracleFacade(sql), contracts.OracleDB)
    assert isinstance(t_compat.SurrealFacade(docs), contracts.SurrealDB)
    assert isinstance(t_compat.ArangoFacade(docs, TGraph()), contracts.ArangoDB)
    assert isinstance(t_compat.CouchbaseFacade(docs), contracts.Couchbase)


def test_add_datasource_wires_the_facades_into_handlers_and_health():
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig

    app = App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"},
                        use_env=False))
    sql = TSQLite(":memory:")
    facades = {"oracle": t_compat.OracleFacade(sql),
               "surrealdb": t_compat.SurrealFacade(TDocs()),
               "arangodb": t_compat.ArangoFacade(TDocs(), TGraph()),
               "couchbase": t_compat.CouchbaseFacade(TDocs())}
    for name, f in facades.items():
        app.add_datasource(name, f)
    assert all(app.container.extra_datasources[n] is f for n, f in facades.items())
    # add_datasource connected each backend: the Oracle facade's sqlite answers
    facades["oracle"].exec("CREATE TABLE t (a INTEGER)")
    details = app.container.health()["details"]
    assert {n: (details[n]["status"], details[n]["details"]["facade"]) for n in facades} == {
        n: ("UP", n) for n in facades}
