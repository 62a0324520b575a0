"""The port's wire dialects (``gofr_tpu_torch/datasource/sql``: ``pg_wire``,
``postgres``, ``mysql_wire``, ``mysql``, ``pool``, ``base``) beside the JAX
package's.

- The codecs byte for byte: every frame and digest the port builds equals
  the reference's on seeded values, and each side decodes the other's.
- The port's ``PostgresDB`` and ``MySQLDB`` against the port's fakes
  (``gofr_tpu_torch/testutil``) and against the reference's fakes, the cases
  of ``tests/test_postgres.py`` and ``tests/test_mysql.py``: auth and a
  wrong password, placeholders and escapes, a typed SQL error with the
  session surviving, commit and rollback, pool exhaustion and reconnect
  after a server kill, and the pool gauges. MySQL's text rows stay strings,
  as on the reference.

Each fake server is module-scoped on 127.0.0.1; each test runs under an
alarm of ``TEST_TIMEOUT_S`` so that a wedged socket fails its test instead of
hanging the run."""

import hashlib
import random
import signal
import threading
import time

import pytest

from gofr_tpu.datasource.sql import mysql_wire as rmy
from gofr_tpu.datasource.sql import pg_wire as rpg
from gofr_tpu.datasource.sql.postgres import rewrite_placeholders as r_rewrite
from gofr_tpu.testutil.mysql_server import MiniMySQLServer as RMiniMySQLServer
from gofr_tpu.testutil.postgres_server import MiniPostgresServer as RMiniPostgresServer
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.sql import MySQLDB, PostgresDB, new_sql
from gofr_tpu_torch.datasource.sql import mysql_wire as tmy
from gofr_tpu_torch.datasource.sql import pg_wire as tpg
from gofr_tpu_torch.datasource.sql.pool import PoolTimeout
from gofr_tpu_torch.datasource.sql.postgres import rewrite_placeholders
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil.mysql_server import MiniMySQLServer
from gofr_tpu_torch.testutil.postgres_server import MiniPostgresServer

SEEDS = range(4)
TEST_TIMEOUT_S = 60


@pytest.fixture(autouse=True)
def _alarm():
    def _expired(signum, frame):
        raise TimeoutError(f"wire test exceeded {TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _text(rng: random.Random, n: int = 12) -> str:
    return "".join(rng.choice("abcXYZ019 _'\"?$\\é-") for _ in range(rng.randint(0, n)))


def _value(rng: random.Random):
    return rng.choice([None, True, False, rng.randint(-2**40, 2**40), rng.random() * 1e6,
                       _text(rng), _text(rng).encode(), {"k": _text(rng)}, [1, 2]])


# -- Postgres codec --------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_pg_frames_equal_the_reference(seed):
    rng = random.Random(seed)
    user, password, db = _text(rng) or "u", _text(rng), _text(rng) or "d"
    salt = bytes(rng.randrange(256) for _ in range(4))
    assert tpg.md5_password(user, password, salt) == rpg.md5_password(user, password, salt)
    want = "md5" + hashlib.md5(
        hashlib.md5((password + user).encode()).hexdigest().encode() + salt).hexdigest()
    assert tpg.md5_password(user, password, salt) == want
    params = {_text(rng) or "k": _text(rng)}
    assert tpg.startup_message(user, db) == rpg.startup_message(user, db)
    assert tpg.startup_message(user, db, params) == rpg.startup_message(user, db, params)
    sql = f"SELECT {_text(rng)!r}"
    values = [_value(rng) for _ in range(rng.randint(0, 6))]
    for build in ("parse_message", "bind_message"):
        args = ("s", sql) if build == "parse_message" else ("p", "s", values)
        assert getattr(tpg, build)(*args) == getattr(rpg, build)(*args)
    for build, args in (("describe_portal", ("p",)), ("execute_message", ("p", 7)),
                        ("sync_message", ()), ("query_message", (sql,)),
                        ("terminate_message", ()), ("password_message", (password,)),
                        ("encode_ready", (b"T",)), ("encode_auth", (5, salt)),
                        ("encode_command_complete", ("INSERT 0 3",)),
                        ("encode_param_status", ("server_version", "16.0 gofr-mini")),
                        ("encode_error", ("boom", "42P01"))):
        assert getattr(tpg, build)(*args) == getattr(rpg, build)(*args), build
    for v in values:
        assert tpg.encode_text_param(v) == rpg.encode_text_param(v)
        assert tpg.oid_for_python(v) == rpg.oid_for_python(v)


@pytest.mark.parametrize("seed", SEEDS)
def test_pg_rows_decode_across_packages(seed):
    rng = random.Random(seed)
    row = [rng.choice([None, rng.randint(-99, 99), rng.random(), _text(rng), True])
           for _ in range(rng.randint(1, 6))]
    cols = [(f"c{i}", tpg.oid_for_python(v)) for i, v in enumerate(row)]
    desc, data = tpg.encode_row_description(cols), tpg.encode_data_row(row)
    assert desc == rpg.encode_row_description(cols) and data == rpg.encode_data_row(row)
    for codec in (tpg, rpg):
        (mtype, r) = codec.read_message(_reader(desc))
        got_cols = codec.decode_row_description(r)
        assert mtype == b"T" and got_cols == cols
        (_, r) = codec.read_message(_reader(data))
        decoded = codec.decode_data_row(r, got_cols)
        assert list(decoded) == [c for c, _ in cols]
        assert decoded == tpg.decode_data_row(tpg.read_message(_reader(data))[1], cols)
    err = tpg.encode_error("no such table", "42P01")
    fields = [c.error_fields(c.read_message(_reader(err))[1]) for c in (tpg, rpg)]
    assert fields[0] == fields[1] and fields[0]["C"] == "42P01"


def _reader(buf: bytes):
    pos = [0]

    def take(n: int) -> bytes:
        out = buf[pos[0]:pos[0] + n]
        pos[0] += n
        return out

    return take


def test_rewrite_placeholders_equals_the_reference():
    cases = ["SELECT ?", "a = ? AND b = ?", "SELECT '?' , ?", "no params",
             "SELECT data ?? 'k' FROM t WHERE id = ?",
             'SELECT "odd?col" FROM t -- why?\nWHERE a = ?', "SELECT $1, '?'",
             "INSERT INTO t VALUES (?, 'it''s ?', ?)"]
    for sql in cases:
        assert rewrite_placeholders(sql) == r_rewrite(sql)
    assert rewrite_placeholders("a = ? AND b = ?") == "a = $1 AND b = $2"


# -- MySQL codec -----------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_mysql_frames_equal_the_reference(seed):
    rng = random.Random(seed)
    nonce = bytes(rng.randrange(1, 256) for _ in range(20))
    password, user, db = _text(rng), _text(rng) or "u", _text(rng)
    assert tmy.native_password_scramble(password, nonce) == \
        rmy.native_password_scramble(password, nonce)
    if password:
        h1 = hashlib.sha1(password.encode()).digest()
        h3 = hashlib.sha1(nonce + hashlib.sha1(h1).digest()).digest()
        assert tmy.native_password_scramble(password, nonce) == bytes(
            a ^ b for a, b in zip(h1, h3))
    tid, caps = rng.randrange(2**31), 0xF7FF | (0x0008 << 16)
    greet = tmy.handshake_v10("8.0.0-gofr", tid, nonce, caps)
    assert greet == rmy.handshake_v10("8.0.0-gofr", tid, nonce, caps)
    assert tmy.parse_handshake_v10(greet) == rmy.parse_handshake_v10(greet)
    resp = tmy.handshake_response_41(user, password, db, nonce)
    assert resp == rmy.handshake_response_41(user, password, db, nonce)
    assert tmy.parse_handshake_response(resp) == rmy.parse_handshake_response(resp)
    n = rng.choice([0, 250, 251, 2**16 - 1, 2**16, 2**24 - 1, 2**24, 2**40])
    assert tmy.lenenc_int(n) == rmy.lenenc_int(n)
    assert tmy.read_lenenc_int(tmy.lenenc_int(n), 0) == rmy.read_lenenc_int(rmy.lenenc_int(n), 0)
    blob = _text(rng, 300).encode()
    assert tmy.lenenc_str(blob) == rmy.lenenc_str(blob)
    ok = tmy.ok_packet(rng.randrange(2**20), rng.randrange(2**30), rng.randrange(9))
    assert ok == rmy.ok_packet(*_ok_args(ok)) and tmy.parse_ok(ok) == rmy.parse_ok(ok)
    err = tmy.err_packet(1064, "42000", _text(rng))
    assert err == rmy.err_packet(1064, "42000", err[9:].decode())
    te, re_ = tmy.parse_err(err), rmy.parse_err(err)
    assert (te.code, te.sqlstate, str(te)) == (re_.code, re_.sqlstate, str(re_))
    assert tmy.eof_packet(3, 0x0022) == rmy.eof_packet(3, 0x0022)
    name = _text(rng) or "c"
    assert tmy.column_definition(name) == rmy.column_definition(name)
    assert tmy.parse_column_definition(tmy.column_definition(name)) == name
    row = [rng.choice([None, rng.randint(-9, 9), _text(rng), 1.25]) for _ in range(5)]
    assert tmy.text_row(row) == rmy.text_row(row)
    assert tmy.parse_text_row(tmy.text_row(row), 5) == rmy.parse_text_row(rmy.text_row(row), 5)


def _ok_args(ok: bytes) -> tuple[int, int, int]:
    parsed = tmy.parse_ok(ok)
    return parsed["affected_rows"], parsed["last_insert_id"], parsed["warnings"]


@pytest.mark.parametrize("seed", SEEDS)
def test_mysql_escaping_and_interpolation_equal_the_reference(seed):
    rng = random.Random(seed)
    values = tuple(rng.choice([None, True, rng.randint(-99, 99), rng.random(), _text(rng),
                               _text(rng).encode()]) for _ in range(rng.randint(0, 5)))
    for v in values:
        assert tmy.escape_value(v) == rmy.escape_value(v)
    sql = "SELECT " + ", ".join("?" for _ in values) + " FROM t WHERE a = 'x?' AND b = \"y\\\"?\""
    assert tmy.interpolate(sql, values) == rmy.interpolate(sql, values)
    for codec in (tmy, rmy):
        with pytest.raises(codec.MySQLError):
            codec.interpolate("SELECT ?, ?", (1,))
    assert tmy.interpolate("SELECT 'O\\'Brien', ?", (5,)) == "SELECT 'O\\'Brien', 5"


# -- drivers against both packages' fakes ------------------------------------------
@pytest.fixture(scope="module", params=["port", "reference"])
def pg_server(request):
    cls = MiniPostgresServer if request.param == "port" else RMiniPostgresServer
    server = cls(user="gofr", password="secret")
    yield server
    server.close()


@pytest.fixture(scope="module", params=["port", "reference"])
def my_server(request):
    cls = MiniMySQLServer if request.param == "port" else RMiniMySQLServer
    server = cls()
    yield server
    server.close()


def _pg(server, **kw) -> PostgresDB:
    db = PostgresDB(host="127.0.0.1", port=server.port, user=server.user,
                    password=server.password, database=server.database,
                    connect_timeout=5.0, **kw)
    db.connect()
    return db


def _my(server, **kw) -> MySQLDB:
    db = MySQLDB(host="127.0.0.1", port=server.port, user=server.user,
                 password=server.password, database=server.database,
                 connect_timeout=5.0, **kw)
    db.connect()
    return db


def test_pg_auth_and_a_wrong_password(pg_server):
    db = _pg(pg_server)
    try:
        assert "server_version" in db._server_params
        assert db.health_check()["status"] == "UP"
        assert "gofr-mini" in db.health_check()["details"]["server"]
    finally:
        db.close()
    bad = PostgresDB(host="127.0.0.1", port=pg_server.port, user="gofr", password="wrong")
    with pytest.raises(tpg.PgError) as err:
        bad.connect()
    assert err.value.code == "28P01"
    assert PostgresDB(host="127.0.0.1", port=1, connect_timeout=0.3).health_check()["status"] \
        == "DOWN"


def test_pg_placeholders_rows_and_typed_values(pg_server):
    db = _pg(pg_server)
    try:
        db.exec("CREATE TABLE IF NOT EXISTS wusers (id INTEGER PRIMARY KEY, name TEXT, age INTEGER)")
        db.exec("DELETE FROM wusers")
        tag = db.exec("INSERT INTO wusers (id, name, age) VALUES (?, ?, ?)", 1, "o'brien", 36)
        assert tag.startswith("INSERT")
        db.exec("INSERT INTO wusers (id, name, age) VALUES (?, ?, ?)", 2, "what?", None)
        rows = db.query("SELECT id, name, age FROM wusers ORDER BY id")
        assert rows == [{"id": 1, "name": "o'brien", "age": 36},
                        {"id": 2, "name": "what?", "age": None}]
        assert db.query_row("SELECT name FROM wusers WHERE id = ?", 99) is None
        assert db.query_row("SELECT '?' AS q, ? AS p", "x") == {"q": "?", "p": "x"}
    finally:
        db.close()


def test_pg_sql_error_is_typed_and_the_session_survives(pg_server):
    db = _pg(pg_server, max_open_conns=1)
    try:
        with pytest.raises(tpg.PgError) as err:
            db.query("SELECT * FROM no_such_table")
        assert err.value.code
        assert db.query("SELECT 1 AS one") == [{"one": 1}]
        tx = db.begin()
        with pytest.raises(tpg.PgError):
            tx.exec("SELECT * FROM definitely_missing_table")
        tx.rollback()
        assert db.pool_stats()["open"] == 1  # the session was not shredded
    finally:
        db.close()


def test_pg_commit_and_rollback(pg_server):
    db = _pg(pg_server)
    try:
        db.exec("CREATE TABLE IF NOT EXISTS wacct (id TEXT PRIMARY KEY, bal INTEGER)")
        db.exec("DELETE FROM wacct")
        db.exec("INSERT INTO wacct VALUES (?, ?)", "a", 100)
        tx = db.begin()
        tx.exec("UPDATE wacct SET bal = bal - ? WHERE id = ?", 40, "a")
        assert tx.query_row("SELECT bal FROM wacct WHERE id = ?", "a")["bal"] == 60
        tx.commit()
        tx = db.begin()
        tx.exec("UPDATE wacct SET bal = 0 WHERE id = ?", "a")
        tx.rollback()
        assert db.query_row("SELECT bal FROM wacct WHERE id = ?", "a")["bal"] == 60
        with pytest.raises(RuntimeError, match="already finished"):
            tx.commit()
    finally:
        db.close()


def test_pg_pool_exhaustion_reconnect_and_gauges(pg_server):
    metrics = new_metrics_manager()
    metrics.new_gauge("app_sql_open_connections")
    metrics.new_gauge("app_sql_inuse_connections")
    db = PostgresDB(host="127.0.0.1", port=pg_server.port, user=pg_server.user,
                    password=pg_server.password, database=pg_server.database,
                    max_open_conns=1, ping_interval=0.2)
    db.use_metrics(metrics)
    db.connect()
    try:
        db._pool.checkout_timeout = 0.3
        tx = db.begin()
        assert _gauges(metrics, "postgres") == (1, 1)
        with pytest.raises(PoolTimeout):
            db.query("SELECT 1")
        tx.rollback()
        assert _gauges(metrics, "postgres") == (1, 0)
        assert db.query_row("SELECT 1 AS one")["one"] == 1
        pg_server.kill_connections()
        assert _recovers(lambda: db.query_row("SELECT 1 AS one")["one"] == 1)
    finally:
        db.close()
    assert _gauges(metrics, "postgres") == (0, 0)


def _gauges(metrics, dialect: str) -> tuple[float, float]:
    return (metrics.get("app_sql_open_connections").value({"dialect": dialect}),
            metrics.get("app_sql_inuse_connections").value({"dialect": dialect}))


def _recovers(probe, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            if probe():
                return True
        except (OSError, ConnectionError):
            time.sleep(0.05)
    return False


def test_my_auth_and_a_wrong_password(my_server):
    db = _my(my_server)
    try:
        health = db.health_check()
        assert health["status"] == "UP" and health["details"]["dialect"] == "mysql"
    finally:
        db.close()
    bad = MySQLDB(host="127.0.0.1", port=my_server.port, user=my_server.user,
                  password="wrong", database=my_server.database)
    with pytest.raises(tmy.MySQLError) as err:
        bad.connect()
    assert err.value.code == 1045


def test_my_escapes_text_rows_and_a_typed_error(my_server):
    db = _my(my_server)
    try:
        db.exec("CREATE TABLE IF NOT EXISTS wmy (id INTEGER PRIMARY KEY, name TEXT)")
        db.exec("DELETE FROM wmy")
        # (a backslash is left out: the sqlite-backed fakes store MySQL's
        # backslash escape as two characters; its bytes are compared above)
        for name in ("ada", "o'brien", 'say "hi"', "what?"):
            db.exec("INSERT INTO wmy (name) VALUES (?)", name)
        rows = db.query("SELECT id, name FROM wmy ORDER BY id")
        assert [r["name"] for r in rows] == ["ada", "o'brien", 'say "hi"', "what?"]
        assert all(isinstance(r["id"], str) for r in rows)  # text protocol, as the reference
        with pytest.raises(tmy.MySQLError) as err:
            db.query("SELECT * FROM missing_table")
        assert err.value.code == 1064
        assert db.query("SELECT 2 AS two") == [{"two": "2"}]
    finally:
        db.close()


def test_my_commit_and_rollback(my_server):
    db = _my(my_server)
    try:
        db.exec("CREATE TABLE IF NOT EXISTS wtx (v TEXT)")
        db.exec("DELETE FROM wtx")
        tx = db.begin()
        tx.exec("INSERT INTO wtx (v) VALUES (?)", "committed")
        tx.commit()
        tx = db.begin()
        tx.exec("INSERT INTO wtx (v) VALUES (?)", "rolled-back")
        tx.rollback()
        assert db.query("SELECT v FROM wtx") == [{"v": "committed"}]
        with pytest.raises(RuntimeError, match="already finished"):
            tx.commit()
    finally:
        db.close()


def test_my_pool_concurrency_exhaustion_reconnect_and_gauges(my_server):
    metrics = new_metrics_manager()
    metrics.new_gauge("app_sql_open_connections")
    metrics.new_gauge("app_sql_inuse_connections")
    db = MySQLDB(host="127.0.0.1", port=my_server.port, user=my_server.user,
                 password=my_server.password, database=my_server.database,
                 max_open_conns=3, ping_interval=0.2)
    db.use_metrics(metrics)
    db.connect()
    try:
        db.exec("CREATE TABLE IF NOT EXISTS wc (n INTEGER)")
        db.exec("DELETE FROM wc")
        errors = []

        def worker(i):
            try:
                for j in range(5):
                    db.exec("INSERT INTO wc (n) VALUES (?)", i * 10 + j)
            except Exception as exc:  # recorded for the test thread
                errors.append(exc)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors and db.query_row("SELECT COUNT(*) AS n FROM wc")["n"] == "30"
        open_, in_use = _gauges(metrics, "mysql")
        assert 1 <= open_ <= 3 and in_use == 0
        my_server.kill_connections()
        assert _recovers(lambda: db.query_row("SELECT 1 AS one")["one"] == "1")
        my_server.kill_connections()  # idle: the keepalive loop alone redials
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and db.pool_stats()["idle"] == 0:
            time.sleep(0.1)
        assert db.pool_stats()["idle"] >= 1
    finally:
        db.close()
    db.close()
    assert db.query_row("SELECT 1 AS one")["one"] == "1"  # close then reuse: a fresh pool
    db.close()


def test_my_pool_exhaustion_and_gauges(my_server):
    metrics = new_metrics_manager()
    metrics.new_gauge("app_sql_open_connections")
    metrics.new_gauge("app_sql_inuse_connections")
    db = MySQLDB(host="127.0.0.1", port=my_server.port, user=my_server.user,
                 password=my_server.password, database=my_server.database, max_open_conns=1)
    db.use_metrics(metrics)
    db.connect()
    try:
        db._pool.checkout_timeout = 0.3
        tx = db.begin()  # pins the only connection
        assert _gauges(metrics, "mysql") == (1, 1)
        with pytest.raises(PoolTimeout):
            db.query("SELECT 1")
        tx.rollback()
        assert _gauges(metrics, "mysql") == (1, 0)
        assert db.query_row("SELECT 1 AS one") == {"one": "1"}
    finally:
        db.close()
    assert _gauges(metrics, "mysql") == (0, 0)


@pytest.mark.parametrize("dialect", ["postgres", "mysql"])
def test_new_sql_builds_a_connected_wire_client(dialect, pg_server, my_server):
    server = pg_server if dialect == "postgres" else my_server
    db = new_sql(MapConfig({"DB_DIALECT": dialect, "DB_HOST": "127.0.0.1",
                            "DB_PORT": str(server.port), "DB_USER": server.user,
                            "DB_PASSWORD": server.password, "DB_NAME": server.database},
                           use_env=False))
    db.connect()
    try:
        assert db.dialect == dialect and str(db.query_row("SELECT 1 AS one")["one"]) == "1"
    finally:
        db.close()
