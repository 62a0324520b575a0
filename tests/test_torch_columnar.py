"""The port's ClickHouse client and its HTTP fake
(``gofr_tpu_torch/datasource/columnar``, ``testutil/clickhouse_server.py``)
against the JAX package's (``gofr_tpu/datasource/columnar``,
``testutil/clickhouse_server.py``): each client against each package's
fake runs one script (auth, DDL, JSONEachRow bulk insert, server-side
parameter binding, a select into dicts and into a dataclass, async_insert,
typed errors with their HTTP statuses, the FORMAT rule, health,
from_config, a dark server), and all four give the same rows, errors and
statuses; the port's fake sets TCP_NODELAY on each accepted socket; the
client records ``app_sql_stats`` with ``database=clickhouse``."""

import dataclasses
import socket

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import columnar as r_columnar
from gofr_tpu.testutil.clickhouse_server import MiniClickHouseServer as RServer
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.datasource import columnar as t_columnar
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil import MiniClickHouseServer as TServer
from gofr_tpu_torch.testutil import get_free_port

CLIENTS = {"ref": (r_columnar, RMapConfig), "port": (t_columnar, TMapConfig)}
FAKES = {"ref": RServer, "port": TServer}


@dataclasses.dataclass
class Row:
    route: str
    ms: float


def _attempt(record, what, fn):
    try:
        record.append((what, "ok", fn()))
    except Exception as exc:  # the error's kind, text and status, whichever package raised it
        record.append((what, type(exc).__name__, str(exc), getattr(exc, "http_status", None)))


def _script(mod, map_config, server) -> list:
    out: list = []
    bad = mod.ClickHouseClient(url=server.url, user="gofr", password="wrong")
    _attempt(out, "auth", bad.connect)
    ch = mod.ClickHouseClient(url=server.url, user="gofr", password="ck")
    _attempt(out, "connect", ch.connect)
    _attempt(out, "ddl", lambda: ch.exec(
        "CREATE TABLE IF NOT EXISTS events (ts INTEGER, route TEXT, ms REAL)"))
    _attempt(out, "insert", lambda: ch.insert_rows("events", [
        {"ts": 1, "route": "/generate", "ms": 12.5}, {"ts": 2, "route": "/embed", "ms": 3.25},
        {"ts": 3, "route": "/generate", "ms": 14.0}, {"ts": 4, "route": "/x", "ms": 1.5}]))
    _attempt(out, "aggregate", lambda: ch.select(
        dict, "SELECT route, count(*) AS n, avg(ms) AS mean FROM events "
        "WHERE route = {r:String} GROUP BY route", params={"r": "/generate"}))
    _attempt(out, "int_param", lambda: ch.select(
        dict, "SELECT ts FROM events WHERE ts > {t:UInt8} ORDER BY ts", {"t": 1}))
    _attempt(out, "bool_param", lambda: ch.select(dict, "SELECT {b:Bool} AS b", {"b": True}))
    _attempt(out, "dataclass", lambda: ch.select(
        Row, "SELECT route, ms FROM events WHERE ts = {t:UInt8}", {"t": "4"}))
    _attempt(out, "async_insert", lambda: ch.async_insert(
        "INSERT INTO events VALUES ({ts:UInt8}, {r:String}, {ms:Float64})",
        params={"ts": 5, "r": "x'; DROP TABLE events; --", "ms": 0.5}))
    _attempt(out, "after_async", lambda: ch.select(dict, "SELECT * FROM events ORDER BY ts"))
    _attempt(out, "sql_error", lambda: ch.exec("SELECT FROM nonsense"))
    _attempt(out, "missing_param", lambda: ch.select(dict, "SELECT {missing:String}"))
    _attempt(out, "own_format", lambda: ch.select(dict, "SELECT 1 FORMAT TSV"))
    _attempt(out, "semicolon", lambda: ch.select(dict, "SELECT 1 AS x;"))
    _attempt(out, "tsv_format", lambda: ch.exec("SELECT route FROM events FORMAT Pretty"))
    health = ch.health_check()
    health["details"].pop("url")
    out.append(("health", health))
    built = mod.ClickHouseClient.from_config(map_config({
        "CLICKHOUSE_URL": server.url, "CLICKHOUSE_USER": "gofr", "CLICKHOUSE_PASSWORD": "ck",
        "CLICKHOUSE_DATABASE": "analytics"}, use_env=False))
    _attempt(out, "from_config", lambda: (built.connect(), built.user, built.database)[1:])
    dark = mod.ClickHouseClient(url=f"http://127.0.0.1:{get_free_port()}", timeout=0.3)
    dark_health = dark.health_check()
    out.append(("dark", dark_health["status"], sorted(dark_health["details"])))
    return out


@pytest.mark.parametrize("fake", sorted(FAKES))
@pytest.mark.parametrize("client", sorted(CLIENTS))
def test_each_client_against_each_fake_matches_the_reference_pair(client, fake):
    """The same rows, errors and statuses as the reference's client on the
    reference's fake."""
    got = {}
    for name, (c, f) in {"ref": ("ref", "ref"), "case": (client, fake)}.items():
        server = FAKES[f](user="gofr", password="ck")
        try:
            got[name] = _script(*CLIENTS[c], server)
        finally:
            server.close()
    assert got["case"] == got["ref"]
    kinds = {entry[0]: entry[1] for entry in got["case"] if len(entry) > 2}
    assert kinds["auth"] == "ColumnarError" and kinds["sql_error"] == "ColumnarError"
    assert kinds["aggregate"] == "ok" and kinds["dataclass"] == "ok"


def test_statuses_and_rows_spelled_out():
    """What the matrix compares, held to fixed values on the port's pair."""
    server = TServer(user="gofr", password="ck")
    try:
        out = {e[0]: e[1:] for e in _script(t_columnar, TMapConfig, server)}
    finally:
        server.close()
    assert out["auth"][0] == "ColumnarError" and out["auth"][2] == 403
    assert out["aggregate"] == ("ok", [{"route": "/generate", "n": 2, "mean": 13.25}])
    assert out["dataclass"] == ("ok", [Row(route="/x", ms=1.5)])
    assert out["after_async"][1][-1] == {"ts": 5, "route": "x'; DROP TABLE events; --",
                                         "ms": 0.5}
    assert out["sql_error"][0] == "ColumnarError" and out["sql_error"][2] == 400
    assert "DB::Exception" in out["sql_error"][1]
    assert out["own_format"][2] == 400 and out["semicolon"] == ("ok", [{"x": 1}])
    assert out["tsv_format"][2] == 400
    assert out["health"][0]["status"] == "UP"
    assert out["health"][0]["details"]["version"] == "23.8-gofr-mini"
    assert out["from_config"] == ("ok", ("gofr", "analytics"))
    assert out["dark"][0] == "DOWN"


def test_port_fake_sets_nodelay_and_counts_the_stats_histogram(monkeypatch):
    """Each socket the port's fake accepts has TCP_NODELAY set (the port's
    rule for wire fakes); every request the client sends is one
    ``app_sql_stats`` observation labelled ``database=clickhouse``."""
    from gofr_tpu_torch.testutil import clickhouse_server

    seen = []
    real = clickhouse_server._NoDelayServer.get_request

    def recorded(self):
        sock, addr = real(self)
        seen.append(sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))
        return sock, addr

    monkeypatch.setattr(clickhouse_server._NoDelayServer, "get_request", recorded)
    server = TServer()
    try:
        m = new_metrics_manager()
        m.new_histogram("app_sql_stats", "d")
        ch = t_columnar.ClickHouseClient(url=server.url)
        ch.use_metrics(m)
        ch.connect()
        ch.insert_rows("t", [{"a": 1}])
        assert ch.select(dict, "SELECT a FROM t") == [{"a": 1}]
        lines = [ln for ln in m.expose_prometheus().splitlines()
                 if ln.startswith("app_sql_stats_count")]
        assert lines == [f'app_sql_stats_count{{database="clickhouse",hostname="{server.url}"}} 3']
    finally:
        server.close()
    assert len(seen) == 3 and all(seen)
