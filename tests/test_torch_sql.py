"""The port's SQL datasource core (``gofr_tpu_torch/datasource/sql``: the
query builder, ``bind_rows``, ``SQLite``, ``new_sql``, the ``app_sql_stats``
series and the ``sql query``/``sql exec`` spans) beside the JAX package's
``gofr_tpu.datasource.sql`` on the same inputs. Every comparison is exact
equality: strings, rows, counts and names. Queue C 42 (the reference's
``SQLite.begin`` releases its lock before it returns the ``Tx``) is shown on
both: the reference keeps a rolled-back row that another thread's ``exec``
committed, the port does not."""

import dataclasses
import random
import sqlite3
import threading
import time

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import sql as rsql
from gofr_tpu.datasource.sql import query_builder as rqb
from gofr_tpu.datasource.sql import sqlite as rsqlite
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu.tracing import InMemoryExporter as RInMemoryExporter
from gofr_tpu.tracing import Tracer as RTracer
from gofr_tpu.tracing.export import SimpleSpanProcessor as RSimpleSpanProcessor
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import sql as tsql
from gofr_tpu_torch.datasource.sql import query_builder as tqb
from gofr_tpu_torch.datasource.sql import sqlite as tsqlite
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer

SEEDS = range(6)
WAIT_S = 5.0  # a thread that must finish does so within this


def _entity_shape(seed: int) -> tuple[str, list[str], str]:
    rng = random.Random(seed)
    letters = "abcdefghijklmnopqrstuvwxyz_"
    name = lambda: rng.choice(letters[:-1]) + "".join(  # noqa: E731
        rng.choice(letters + "0123456789") for _ in range(rng.randint(0, 9)))
    fields = list(dict.fromkeys(name() for _ in range(rng.randint(1, 7))))
    return name(), fields, fields[0]


# -- query builder -------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_query_builder_strings_equal_the_reference(seed):
    table, fields, pk = _entity_shape(seed)
    assert tqb.insert_query(table, fields) == rqb.insert_query(table, fields)
    assert tqb.select_all_query(table) == rqb.select_all_query(table)
    assert tqb.select_by_id_query(table, pk) == rqb.select_by_id_query(table, pk)
    assert tqb.update_by_id_query(table, fields, pk) == rqb.update_by_id_query(table, fields, pk)
    assert tqb.delete_by_id_query(table, pk) == rqb.delete_by_id_query(table, pk)


@pytest.mark.parametrize("bad", ["1abc", "a b", "t;DROP", "", "a-b", "é"])
def test_query_builder_refuses_the_same_identifiers(bad):
    for qb in (rqb, tqb):
        with pytest.raises(ValueError, match="invalid SQL identifier"):
            qb.insert_query(bad, ["id"])
        with pytest.raises(ValueError, match="invalid SQL identifier"):
            qb.select_by_id_query("t", bad)


# -- bind_rows -----------------------------------------------------------------
@dataclasses.dataclass
class Row:
    id: int = 0
    name: str = ""
    score: float = 0.0
    ok: bool = False
    note: object = None


def _rows(seed: int) -> list[dict]:
    """Seeded rows in the shapes the dialects return: typed (sqlite,
    postgres), all text (MySQL), upper-case column names, NULLs, and a
    column the target lacks."""
    rng = random.Random(seed)
    out = []
    for i in range(rng.randint(0, 6)):
        text = rng.random() < 0.5
        row = {"id": str(i) if text else i,
               "NAME" if rng.random() < 0.3 else "name": f"n{rng.randint(0, 99)}",
               "score": f"{rng.random():.6f}" if text else rng.random(),
               "ok": rng.choice([0, 1]),
               "note": rng.choice([None, "x", 3]),
               "extra": rng.random()}
        if rng.random() < 0.2:
            row["score"] = None
        out.append(row)
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_bind_rows_equals_the_reference(seed):
    rows = _rows(seed)
    for target in (None, dict):
        assert tsqlite.bind_rows(rows, target) == rsqlite.bind_rows(rows, target)
    got, want = tsqlite.bind_rows(rows, Row), rsqlite.bind_rows(rows, Row)
    assert got == want
    assert [tuple(map(type, dataclasses.astuple(r))) for r in got] == \
        [tuple(map(type, dataclasses.astuple(r))) for r in want]


def test_bind_rows_refuses_the_same_targets():
    for mod in (rsqlite, tsqlite):
        with pytest.raises(TypeError, match="dict or a dataclass"):
            mod.bind_rows([{"a": 1}], list)
        with pytest.raises(ValueError):  # a text value its int field cannot take
            mod.bind_rows([{"id": "x"}], Row)


# -- SQLite --------------------------------------------------------------------
STATEMENTS = [
    ("exec", "CREATE TABLE users (id INTEGER PRIMARY KEY, name TEXT, age INTEGER, w REAL)", ()),
    ("exec", "INSERT INTO users (name, age, w) VALUES (?, ?, ?)", ("ada", 36, 1.5)),
    ("exec", "INSERT INTO users (name, age, w) VALUES (?, ?, ?)", ("alan", 41, None)),
    ("exec", "INSERT INTO users (name, age, w) VALUES (?, ?, ?)", ("o'brien", 29, -2.25)),
    ("query", "SELECT * FROM users ORDER BY id", ()),
    ("query", "SELECT name, age FROM users WHERE age > ? ORDER BY age DESC", (30,)),
    ("query_row", "SELECT name FROM users WHERE id = ?", (2,)),
    ("query_row", "SELECT name FROM users WHERE id = ?", (99,)),
    ("exec", "UPDATE users SET age = age + 1 WHERE age < ?", (40,)),
    ("exec", "DELETE FROM users WHERE name = ?", ("nobody",)),
    ("query", "SELECT COUNT(*) AS n, SUM(age) AS s, MAX(w) AS m FROM users", ()),
]


def _drive(db) -> list:
    out = []
    for op, sql, args in STATEMENTS:
        res = getattr(db, op)(sql, *args)
        out.append((res.rowcount, res.lastrowid) if op == "exec" else res)
    out.append(db.select(Row, "SELECT id, name FROM users ORDER BY id"))
    out.append(db.select(dict, "SELECT id, age FROM users ORDER BY id"))
    tx = db.begin()
    tx.exec("INSERT INTO users (name, age) VALUES (?, ?)", "kept", 1)
    out.append(tx.query("SELECT COUNT(*) AS n FROM users"))
    out.append(tx.query_row("SELECT name FROM users WHERE age = ?", 1))
    tx.commit()
    tx = db.begin()
    tx.exec("DELETE FROM users")
    tx.rollback()
    out.append(db.query("SELECT id, name, age FROM users ORDER BY id"))
    return out


def test_sqlite_gives_the_references_rows(tmp_path):
    ref, port = rsql.SQLite(str(tmp_path / "r.db")), tsql.SQLite(str(tmp_path / "t.db"))
    ref.connect(), port.connect()
    assert _drive(port) == _drive(ref)
    up_r, up_t = ref.health_check(), port.health_check()
    assert up_t["status"] == up_r["status"] == "UP"
    assert up_t["details"]["dialect"] == up_r["details"]["dialect"] == "sqlite"
    ref.close(), port.close()
    down_r, down_t = ref.health_check(), port.health_check()
    assert down_t["status"] == down_r["status"] == "DOWN"
    assert set(down_t["details"]) == set(down_r["details"]) == {"database", "error"}
    port.close()  # twice is a no-op, as on the reference


def test_sqlite_raises_the_references_errors():
    ref, port = rsql.SQLite(":memory:"), tsql.SQLite(":memory:")
    ref.connect(), port.connect()
    for db in (ref, port):
        with pytest.raises(sqlite3.OperationalError, match="no such table"):
            db.query("SELECT * FROM missing")
        db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY)")
        db.exec("INSERT INTO t VALUES (1)")
        with pytest.raises(sqlite3.IntegrityError):
            db.exec("INSERT INTO t VALUES (1)")
        assert db.query("SELECT id FROM t") == [{"id": 1}]  # still usable


@pytest.mark.parametrize("dialect,cls", [
    ("sqlite", "SQLite"), ("SQLite", "SQLite"), ("postgres", "PostgresDB"),
    ("postgresql", "PostgresDB"), ("supabase", "PostgresDB"), ("cockroachdb", "PostgresDB"),
    ("mysql", "MySQLDB"), ("mariadb", "MySQLDB"),
])
def test_new_sql_dispatches_each_alias_like_the_reference(dialect, cls):
    values = {"DB_DIALECT": dialect, "DB_NAME": ":memory:", "DB_HOST": "127.0.0.1",
              "DB_PORT": "1", "DB_MAX_OPEN_CONNS": "3"}
    got = tsql.new_sql(MapConfig(values, use_env=False))
    want = rsql.new_sql(RMapConfig(values, use_env=False))
    assert type(got).__name__ == type(want).__name__ == cls
    assert type(got).__module__.startswith("gofr_tpu_torch.")
    assert got.dialect == want.dialect and got.database == want.database
    if cls != "SQLite":
        assert (got.host, got.port, got.user) == (want.host, want.port, want.user)
        assert got._pool.max_open == want._pool.max_open == 3


def test_new_sql_refuses_an_unknown_dialect_like_the_reference():
    values = {"DB_DIALECT": "oracle"}
    with pytest.raises(ValueError) as want:
        rsql.new_sql(RMapConfig(values, use_env=False))
    with pytest.raises(ValueError) as got:
        tsql.new_sql(MapConfig(values, use_env=False))
    assert str(got.value) == str(want.value)
    # unset is sqlite on both
    assert isinstance(tsql.new_sql(MapConfig({}, use_env=False)), tsql.SQLite)


def test_sql_series_and_spans_equal_the_references():
    """One ``app_sql_stats`` observation per statement on the database (not
    per statement inside a ``Tx``), labelled by host and dialect, and one
    ``sql query``/``sql exec`` client span each, on both packages."""
    seen = {}
    for name, pkg in (("ref", (rsql, r_new_metrics_manager, RTracer, RSimpleSpanProcessor,
                               RInMemoryExporter)),
                      ("port", (tsql, new_metrics_manager, Tracer, SimpleSpanProcessor,
                                InMemoryExporter))):
        sqlmod, new_manager, tracer_cls, processor_cls, exporter_cls = pkg
        metrics = new_manager()
        metrics.new_histogram("app_sql_stats", "Response time of SQL queries in milliseconds")
        exporter = exporter_cls()
        db = sqlmod.SQLite(":memory:")
        db.use_metrics(metrics)
        db.use_tracer(tracer_cls("t", processor_cls(exporter)))
        db.connect()
        db.exec("CREATE TABLE t (v INTEGER)")
        for i in range(5):
            db.exec("INSERT INTO t VALUES (?)", i)
        db.query("SELECT * FROM t")
        db.query_row("SELECT v FROM t WHERE v = ?", 3)
        db.select(dict, "SELECT v FROM t")
        tx = db.begin()
        tx.exec("INSERT INTO t VALUES (9)")
        tx.commit()
        hist = metrics.get("app_sql_stats")
        count = hist.snapshot({"hostname": ":memory:", "database": "sqlite"})[1]
        seen[name] = (count, [(s.name, s.kind) for s in exporter.spans], db.query("SELECT * FROM t"))
    assert seen["port"] == seen["ref"]
    assert seen["port"][0] == 9  # 6 exec + 3 query (the Tx's statements are not observed)


# -- Queue C 42 ------------------------------------------------------------------
def _probe(sqlmod) -> tuple[list, bool]:
    """Open a Tx and insert row 1 in it; another thread runs ``db.exec``
    inserting row 2; roll the Tx back. Returns the rows left and whether the
    other thread was still waiting when the rollback came."""
    db = sqlmod.SQLite(":memory:")
    db.connect()
    db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY, v TEXT)")
    tx = db.begin()
    tx.exec("INSERT INTO t VALUES (1, 'tx')")
    done = threading.Event()
    other = threading.Thread(target=lambda: (db.exec("INSERT INTO t VALUES (2, 'other')"),
                                             done.set()))
    other.start()
    done.wait(0.3)
    waited = not done.is_set()
    tx.rollback()
    other.join(WAIT_S)
    assert not other.is_alive()
    return db.query("SELECT id, v FROM t ORDER BY id"), waited


def test_queue_c42_the_reference_keeps_a_rolled_back_row():
    """The reference's fault, shown so that this test fails if the reference
    ever changes: the other thread's exec committed the Tx's row, and the
    rollback leaves both rows."""
    rows, waited = _probe(rsql)
    assert rows == [{"id": 1, "v": "tx"}, {"id": 2, "v": "other"}]
    assert not waited


def test_queue_c42_the_port_rolls_back_and_the_other_thread_waits():
    rows, waited = _probe(tsql)
    assert rows == [{"id": 2, "v": "other"}]
    assert waited


def test_port_tx_can_finish_on_another_thread():
    db = tsql.SQLite(":memory:")
    db.connect()
    db.exec("CREATE TABLE t (v INTEGER)")
    tx = db.begin()
    tx.exec("INSERT INTO t VALUES (1)")
    errors = []
    finisher = threading.Thread(target=lambda: _catch(errors, tx.commit))
    finisher.start()
    finisher.join(WAIT_S)
    assert not finisher.is_alive() and errors == []
    assert db.query("SELECT v FROM t") == [{"v": 1}]  # the lock is free again, here too
    tx2 = db.begin()  # and another thread may open the next one
    tx2.rollback()


def _catch(errors: list, fn) -> None:
    try:
        fn()
    except Exception as exc:  # recorded for the test thread to assert on
        errors.append(exc)


def test_port_refuses_a_statement_on_the_db_from_the_thread_of_its_open_tx():
    db = tsql.SQLite(":memory:")
    db.connect()
    db.exec("CREATE TABLE t (v INTEGER)")
    tx = db.begin()
    tx.exec("INSERT INTO t VALUES (1)")
    for call in (lambda: db.exec("INSERT INTO t VALUES (2)"), lambda: db.query("SELECT 1"),
                 lambda: db.select(dict, "SELECT 1"), db.begin):
        with pytest.raises(RuntimeError, match="open transaction"):
            call()
    assert db.health_check()["status"] == "DOWN"  # on this thread, and it says why
    tx.rollback()
    assert db.query("SELECT v FROM t") == []
    assert db.health_check()["status"] == "UP"


def test_port_tx_finishes_once_and_releases_once():
    db = tsql.SQLite(":memory:")
    db.connect()
    db.exec("CREATE TABLE t (v INTEGER)")
    tx = db.begin()
    tx.commit()
    for call in (tx.commit, tx.rollback, lambda: tx.exec("SELECT 1"), lambda: tx.query("SELECT 1")):
        with pytest.raises(RuntimeError, match="already finished"):
            call()
    # the lock was released exactly once: one begin takes it, a second waits
    tx = db.begin()
    got = []
    waiter = threading.Thread(target=lambda: got.append(db.begin()))
    waiter.start()
    waiter.join(0.3)
    assert waiter.is_alive()
    tx.rollback()
    waiter.join(WAIT_S)
    assert not waiter.is_alive()
    got[0].rollback()


def test_port_commit_that_fails_rolls_back_and_frees_the_lock():
    """A deferred foreign key fails the COMMIT itself: the Tx rolls back, the
    lock is free for other threads, and the Tx is finished."""
    db = tsql.SQLite(":memory:")
    db.connect()
    db.exec("PRAGMA foreign_keys = ON")
    db.exec("CREATE TABLE parent (id INTEGER PRIMARY KEY)")
    db.exec("CREATE TABLE child (id INTEGER PRIMARY KEY, p INTEGER REFERENCES parent(id) "
            "DEFERRABLE INITIALLY DEFERRED)")
    tx = db.begin()
    tx.exec("INSERT INTO child VALUES (1, 42)")
    with pytest.raises(sqlite3.IntegrityError, match="FOREIGN KEY"):
        tx.commit()
    with pytest.raises(RuntimeError, match="already finished"):
        tx.rollback()
    rows = []
    other = threading.Thread(target=lambda: rows.extend(db.query("SELECT * FROM child")))
    other.start()
    other.join(WAIT_S)
    assert not other.is_alive() and rows == []
    db.exec("INSERT INTO parent VALUES (42)")  # no transaction left open on the connection
    tx = db.begin()
    tx.exec("INSERT INTO child VALUES (1, 42)")
    tx.commit()
    assert db.query("SELECT * FROM child") == [{"id": 1, "p": 42}]


def test_port_writers_wait_out_a_tx_and_all_land():
    """Eight threads write while a Tx holds the connection: none lands before
    the Tx ends, all land after it, and the Tx's own row is gone."""
    db = tsql.SQLite(":memory:")
    db.connect()
    db.exec("CREATE TABLE t (id INTEGER PRIMARY KEY)")
    tx = db.begin()
    tx.exec("INSERT INTO t VALUES (0)")
    writers = [threading.Thread(target=db.exec, args=("INSERT INTO t VALUES (?)", i))
               for i in range(1, 9)]
    for w in writers:
        w.start()
    time.sleep(0.2)
    assert tx.query("SELECT id FROM t") == [{"id": 0}]
    tx.rollback()
    for w in writers:
        w.join(WAIT_S)
    assert [r["id"] for r in db.query("SELECT id FROM t ORDER BY id")] == list(range(1, 9))
