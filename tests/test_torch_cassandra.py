"""The port's wide-column family (``gofr_tpu_torch/datasource/widecolumn``:
``EmbeddedWideColumnStore`` over sqlite, the CQL v4 codec and
``CassandraClient``) and its ``MiniCassandraServer`` beside the JAX
package's:

- the driver cases of ``tests/test_cassandra.py`` one by one with every
  client against every fake (either package's ``CassandraClient`` on either
  package's ``MiniCassandraServer``), each result equal to the reference's
  client on the reference's fake;
- the same statements on both packages' ``EmbeddedWideColumnStore`` with
  equal results: rows, typed values, CAS's applied and not-applied answers,
  logged batches all or nothing, the errors;
- health, the factory, and ``app_cassandra_stats`` equal to the reference's
  and to the requests the port's fake served.
The codec's frames are held byte for byte in
``tests/test_torch_golden_frames.py``."""

import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import widecolumn as rwide
from gofr_tpu.datasource.widecolumn import cassandra as rcass
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu.testutil.cassandra_server import MiniCassandraServer as RMiniCassandraServer
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import widecolumn as twide
from gofr_tpu_torch.datasource.widecolumn import cassandra as tcass
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil import MiniCassandraServer

PKGS = {
    "ref": types.SimpleNamespace(wide=rwide, cass=rcass, server=RMiniCassandraServer,
                                 config=RMapConfig, manager=r_new_metrics_manager),
    "port": types.SimpleNamespace(wide=twide, cass=tcass, server=MiniCassandraServer,
                                  config=MapConfig, manager=new_metrics_manager),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]
USERS = "CREATE TABLE users (id INTEGER PRIMARY KEY, name TEXT, score REAL)"
LOGGED, UNLOGGED = rwide.LOGGED_BATCH, rwide.UNLOGGED_BATCH  # the same in both packages


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("raised", type(exc).__name__, str(exc))


def q(c, stmt: str, *values) -> list:
    target: list = []
    out = c.query(target, stmt, *values)
    assert out == target
    return target


# ------------------------------------------------------------- the scenarios
def exec_query(c):
    c.exec("INSERT INTO users VALUES (?, ?, ?)", 1, "ada", 9.5)
    c.exec("INSERT INTO users VALUES (?, ?, ?)", 2, "o'brien", 8.0)
    c.exec("INSERT INTO users VALUES (?, ?, ?)", 3, "t", None)
    r = q(c, "SELECT id, name, score FROM users WHERE id = 3")
    return [q(c, "SELECT * FROM users WHERE id = ?", 1),
            sorted(x["name"] for x in q(c, "SELECT name FROM users")),
            q(c, "SELECT * FROM users WHERE name = ?", "o'brien"),
            [type(v).__name__ for v in r[0].values()], q(c, "SELECT 1 AS one")]


def errors(c):
    return [outcome(c.exec, "INSERT INTO missing_table VALUES (1)")[:2],
            q(c, "SELECT 1 AS alive")]  # the session survives the error


def cas(c):
    out = [c.exec_cas([], "INSERT INTO users VALUES (9, 'x', 1.0) IF NOT EXISTS"),
           c.exec_cas([], "INSERT INTO users VALUES (9, 'dupe', 2.0) IF NOT EXISTS"),
           q(c, "SELECT name FROM users WHERE id = 9")]
    c.exec("INSERT INTO users VALUES (5, 'v1', 1.0)")
    out += [c.exec_cas([], "UPDATE users SET name='v2' WHERE id=5 IF name='v1'"),
            c.exec_cas([], "UPDATE users SET name='v3' WHERE id=5 IF name='v1'"),
            c.exec_cas([], "INSERT INTO users (id, name) VALUES (?, ?) IF NOT EXISTS", 6, "p"),
            q(c, "SELECT id, name FROM users WHERE id IN (5, 6) ORDER BY id")]
    return out


def batches(c):
    c.new_batch("b1", LOGGED)
    c.batch_query("b1", "INSERT INTO users VALUES (?, ?, ?)", 10, "a", 0.0)
    c.batch_query("b1", "INSERT INTO users VALUES (?, ?, ?)", 11, "b", 0.0)
    c.batch_query("b1", "UPDATE users SET score = ? WHERE id = ?", 4.5, 10)
    c.execute_batch("b1")
    out = [q(c, "SELECT id, score FROM users WHERE id >= 10 ORDER BY id")]
    c.new_batch("b2", UNLOGGED)
    c.batch_query("b2", "INSERT INTO users VALUES (?, ?, ?)", 12, "c", 0.0)
    c.batch_query("b2", "INSERT INTO nope VALUES (1)")
    out.append(outcome(c.execute_batch, "b2")[:2])
    out.append(q(c, "SELECT id FROM users WHERE id = 12"))
    out += [outcome(c.batch_query, "ghost", "SELECT 1")[:2], outcome(c.execute_batch, "ghost")[:2],
            outcome(c.execute_batch, "b1")[:2]]  # a batch runs once
    return out


def batch_cas(c):
    c.new_batch("c1")
    c.batch_query("c1", "INSERT INTO users VALUES (20, 'x', 0.0) IF NOT EXISTS")
    c.batch_query("c1", "INSERT INTO users VALUES (21, 'y', 0.0)")
    first = c.execute_batch_cas("c1")
    c.new_batch("c2")
    c.batch_query("c2", "INSERT INTO users VALUES (20, 'z', 0.0) IF NOT EXISTS")
    c.batch_query("c2", "INSERT INTO users VALUES (22, 'w', 0.0)")
    return [first, c.execute_batch_cas("c2"),
            q(c, "SELECT id, name FROM users WHERE id >= 20 ORDER BY id")]


SHARED = [exec_query, errors, cas, batches]
WIRE = SHARED + [batch_cas]


def run(scenario, c):
    c.exec(USERS)
    return scenario(c)


@pytest.fixture
def servers():
    out = {side: PKGS[side].server().start() for side in SIDES}
    yield out
    for s in out.values():
        s.close()


def client(side: str, server):
    c = PKGS[side].cass.CassandraClient(host="127.0.0.1", port=server.port)
    c.connect()
    return c


@pytest.mark.parametrize("scenario", WIRE, ids=lambda f: f.__name__)
@pytest.mark.parametrize("client_side,server_side", CROSS)
def test_wire_cases_crossed_both_ways(servers, client_side, server_side, scenario):
    ref_server = RMiniCassandraServer().start()
    c = client("ref", ref_server)
    try:
        want = run(scenario, c)
    finally:
        c.close()
        ref_server.close()
    c = client(client_side, servers[server_side])
    try:
        got = run(scenario, c)
    finally:
        c.close()
    assert got == want


@pytest.mark.parametrize("scenario", SHARED, ids=lambda f: f.__name__)
def test_embedded_store_answers_as_the_reference(scenario):
    got = {side: run(scenario, PKGS[side].wide.EmbeddedWideColumnStore()) for side in SIDES}
    assert got["port"] == got["ref"]


def test_embedded_and_wire_agree_on_cas_and_batches(servers):
    """The applied answers and the rows are the backend's semantics, not
    the transport's: the embedded store and the wire give the same."""
    c = client("port", servers["port"])
    try:
        wire = [run(cas, c)]
        c.exec("DROP TABLE users")
        wire.append(run(batches, c)[:3])
    finally:
        c.close()
    embedded = [run(cas, twide.EmbeddedWideColumnStore()),
                run(batches, twide.EmbeddedWideColumnStore())[:3]]
    assert embedded[0] == wire[0]
    assert embedded[1][0] == wire[1][0] and embedded[1][2] == wire[1][2] == []
    assert embedded[1][1] == ("raised", "OperationalError")
    assert wire[1][1] == ("raised", "CQLError")


def test_exports_and_constants_match():
    assert (twide.LOGGED_BATCH, twide.UNLOGGED_BATCH) == (rwide.LOGGED_BATCH, rwide.UNLOGGED_BATCH)
    assert (tcass.LOGGED_BATCH, tcass.UNLOGGED_BATCH) == (rcass.LOGGED_BATCH, rcass.UNLOGGED_BATCH)
    assert issubclass(twide.CASError, RuntimeError) and issubclass(tcass.CQLError, Exception)


@pytest.mark.parametrize("client_side,server_side", CROSS)
def test_health_up_then_down_on_close(client_side, server_side):
    srv = PKGS[server_side].server().start()
    c = client(client_side, srv)
    up = c.health_check()
    c.close()
    down = c.health_check()
    srv.close()
    assert (up["status"], up["details"]["backend"], down["status"]) == (
        "UP", "cassandra-wire", "DOWN")


@pytest.mark.parametrize("side", SIDES)
def test_factory_and_the_embedded_health(side, servers):
    mod, cfg = PKGS[side].wide, PKGS[side].config
    wire = mod.new_widecolumn_store(cfg({"CASSANDRA_HOST": "127.0.0.1",
                                         "CASSANDRA_PORT": str(servers[side].port),
                                         "CASSANDRA_KEYSPACE": "ks"}, use_env=False))
    assert isinstance(wire, PKGS[side].cass.CassandraClient)
    assert (wire.port, wire.keyspace) == (servers[side].port, "ks")
    wire.connect()  # USE "ks" is answered with SET_KEYSPACE
    assert wire.health_check()["details"]["keyspace"] == "ks"
    wire.close()
    embedded = mod.new_widecolumn_store(cfg({}, use_env=False))
    assert isinstance(embedded, mod.EmbeddedWideColumnStore)
    assert embedded.health_check() == {
        "status": "UP", "details": {"backend": "embedded-widecolumn", "path": ":memory:"}}
    embedded.close()
    assert embedded.health_check()["status"] == "DOWN"


def test_stats_series_equal_the_reference_and_the_requests_served():
    """``app_cassandra_stats``: registered by the wire client and the
    embedded store with the reference's kind and description (listed in the
    port's catalog), one observation an operation; the wire client's equal
    the requests the port's fake served, less its health probe."""
    from gofr_tpu_torch.serving.metrics_catalog import SELF_REGISTERED_METRICS

    got = {}
    for side in SIDES:
        p = PKGS[side]
        srv, manager = MiniCassandraServer().start(), p.manager()
        c = p.cass.CassandraClient(host="127.0.0.1", port=srv.port)
        c.use_metrics(manager)
        c.connect()
        run(cas, c)
        c.new_batch("x")
        c.batch_query("x", "INSERT INTO users VALUES (30, 'q', 0.0)")
        c.execute_batch("x")
        c.health_check()
        c.close()
        hist = manager.get("app_cassandra_stats")
        with hist._lock:
            observed = {dict(k)["operation"]: s[2] for k, s in hist._series.items()}
        store, m2 = p.wide.EmbeddedWideColumnStore(), p.manager()
        store.use_metrics(m2)
        run(cas, store)
        with m2.get("app_cassandra_stats")._lock:
            embedded = {dict(k)["operation"]: s[2]
                        for k, s in m2.get("app_cassandra_stats")._series.items()}
        got[side] = (observed, embedded, dict(srv.commands), hist.description)
        srv.close()
    assert got["port"] == got["ref"]
    observed, embedded, served, description = got["port"]
    assert embedded == {"exec": 2, "exec_cas": 5, "query": 2}
    assert observed == {**embedded, "execute_batch": 1}
    assert sum(observed.values()) == served["QUERY"] - served["PROBE"] + served["BATCH"]
    assert ("histogram", "app_cassandra_stats", description, None) in SELF_REGISTERED_METRICS
