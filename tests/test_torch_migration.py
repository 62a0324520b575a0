"""The port's migrations (``gofr_tpu_torch/migration``) beside the JAX
package's ``run_migrations`` on the same sequences, each side over its own
stores built the same way:

- ``sqlite``: each package's ``SQLite`` in memory;
- ``postgres`` and ``mysql``: each package's wire client against its own
  package's fake server on 127.0.0.1;
- ``families``: sqlite plus each package's own in-memory Redis and KV
  stores and its embedded document, wide-column and search stores.

Compared with equality: the ``gofr_migration`` rows (version and method),
every store's bookkeeping, the migrations' own rows, which versions ran,
and the errors' messages. The sequences: apply, resume and a new version;
a failing ``up`` rolled back with nothing recorded; non-positive versions
refused; the last version as the union over the stores; failing
bookkeeping in a non-SQL store leaving the applied work in place; and a
``ds.tpu`` migration on each package's CPU device datasource that
compiles and executes once."""

import json
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.container.container import Container as RContainer  # noqa: E402
from gofr_tpu.datasource import sql as rsql  # noqa: E402
from gofr_tpu.datasource import document as rdocument  # noqa: E402
from gofr_tpu.datasource import kv as rkv  # noqa: E402
from gofr_tpu.datasource import redis as rredis  # noqa: E402
from gofr_tpu.datasource import search as rsearch  # noqa: E402
from gofr_tpu.datasource import widecolumn as rwidecolumn  # noqa: E402
from gofr_tpu.logging import Level as RLevel  # noqa: E402
from gofr_tpu.logging import new_logger as r_new_logger  # noqa: E402
from gofr_tpu import migration as rmig  # noqa: E402
from gofr_tpu.testutil.mysql_server import MiniMySQLServer as RMiniMySQLServer  # noqa: E402
from gofr_tpu.testutil.postgres_server import MiniPostgresServer as RMiniPostgresServer  # noqa: E402
from gofr_tpu_torch import migration as tmig  # noqa: E402
from gofr_tpu_torch.config import MapConfig  # noqa: E402
from gofr_tpu_torch.container.container import Container  # noqa: E402
from gofr_tpu_torch.datasource import document as tdocument  # noqa: E402
from gofr_tpu_torch.datasource import kv as tkv  # noqa: E402
from gofr_tpu_torch.datasource import redis as tredis  # noqa: E402
from gofr_tpu_torch.datasource import search as tsearch  # noqa: E402
from gofr_tpu_torch.datasource import sql as tsql  # noqa: E402
from gofr_tpu_torch.datasource import widecolumn as twidecolumn  # noqa: E402
from gofr_tpu_torch.datasource.tpu import TPUClient  # noqa: E402
from gofr_tpu_torch.logging import Level, new_logger  # noqa: E402
from gofr_tpu_torch.testutil.mysql_server import MiniMySQLServer  # noqa: E402
from gofr_tpu_torch.testutil.postgres_server import MiniPostgresServer  # noqa: E402

TRACKING = "gofr_migration"
TEST_TIMEOUT_S = 60
STORES = ["sqlite", "postgres", "mysql", "families"]


@pytest.fixture(autouse=True)
def _alarm():
    def _expired(signum, frame):
        raise TimeoutError(f"migration test exceeded {TEST_TIMEOUT_S}s")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class Side:
    """One package's container with its stores, and what its migrations did."""

    def __init__(self, name: str, stores: str, closers: list) -> None:
        self.name, self.stores = name, stores
        self.mig = rmig if name == "ref" else tmig
        if name == "ref":
            self.container = RContainer(RMapConfig({}, use_env=False),
                                        logger=r_new_logger(RLevel.FATAL, exit_on_fatal=False))
        else:
            self.container = Container(MapConfig({}, use_env=False),
                                       logger=new_logger(Level.FATAL, exit_on_fatal=False))
        closers.append(self.container.close)
        self.container.sql = self._sql(stores, closers)
        self.container.sql.connect()
        if stores == "families":
            # each side's own stores: the reference's on its container, the
            # port's on the port's
            doc, kv, redis, search, wide = (
                (rdocument, rkv, rredis, rsearch, rwidecolumn) if name == "ref" else
                (tdocument, tkv, tredis, tsearch, twidecolumn))
            for attr, store in (("redis", redis.InMemoryRedis()),
                                ("kv_store", kv.InMemoryKVStore())):
                setattr(self.container, attr, store)
            for key, cls in (("document", doc.EmbeddedDocumentStore),
                             ("widecolumn", wide.EmbeddedWideColumnStore),
                             ("search", search.EmbeddedSearch)):
                store = cls()
                store.connect()
                self.container.extra_datasources[key] = store
        self.ran: list[int] = []

    def _sql(self, stores: str, closers: list):
        pkg = rsql if self.name == "ref" else tsql
        if stores in ("sqlite", "families"):
            return pkg.SQLite(":memory:")
        if stores == "postgres":
            server = (RMiniPostgresServer if self.name == "ref" else MiniPostgresServer)()
            db = pkg.PostgresDB(host="127.0.0.1", port=server.port, user=server.user,
                                password=server.password, database=server.database)
        else:
            server = (RMiniMySQLServer if self.name == "ref" else MiniMySQLServer)()
            db = pkg.MySQLDB(host="127.0.0.1", port=server.port, user=server.user,
                             password=server.password, database=server.database)
        closers.append(server.close)
        return db

    def run(self, migrations: dict) -> None:
        self.mig.run_migrations({v: self.mig.Migrate(up=up) if callable(up) else up
                                 for v, up in migrations.items()}, self.container)

    def up(self, version: int, statements=(), fail: bool = False):
        """An UP function that records that it ran, runs its statements on
        the migration's transaction, then raises if asked."""
        def up(ds):
            self.ran.append(version)
            for sql, *args in statements:
                ds.sql.exec(sql, *args)
            if fail:
                raise RuntimeError(f"version {version} failed on purpose")
        return up

    def state(self) -> dict:
        """Everything the migrations left, with times dropped and MySQL's text
        integers read as integers."""
        c = self.container
        rows = c.sql.query(f"SELECT version, method, duration FROM {TRACKING} ORDER BY version")
        assert all(r["duration"] is not None and int(r["duration"]) >= 0 for r in rows)
        out = {"versions": [(int(r["version"]), r["method"]) for r in rows], "ran": self.ran}
        try:
            out["items"] = [(int(r["id"]), r["v"]) for r in
                            c.sql.query("SELECT id, v FROM items ORDER BY id")]
        except Exception as exc:  # a missing table is part of the state
            out["items"] = type(exc).__name__
        if self.stores == "families":
            redis = c.redis.hgetall("gofr_migrations")
            out["redis"] = sorted((k, json.loads(v)["method"]) for k, v in redis.items())
            out["kv"] = _kv_get(c.kv_store)
            extra = c.extra_datasources
            out["document"] = sorted(int(d["version"]) for d in extra["document"].find(TRACKING, {}))
            out["widecolumn"] = sorted(int(r["version"]) for r in extra["widecolumn"].query(
                [], f"SELECT version FROM {TRACKING}"))
            hits = extra["search"].search(TRACKING, {}, size=100)["hits"]["hits"]
            out["search"] = sorted(int(h["_source"]["version"]) for h in hits)
        return out


def _kv_get(kv) -> str | None:
    try:
        return kv.get("gofr_migration_version")
    except Exception:
        return None


@pytest.fixture
def pair(request):
    closers: list = []

    def make(stores: str) -> tuple[Side, Side]:
        return Side("ref", stores, closers), Side("port", stores, closers)

    yield make
    for close in reversed(closers):
        close()


CREATE = ("CREATE TABLE items (id INTEGER PRIMARY KEY, v TEXT)",)


@pytest.mark.parametrize("stores", STORES)
def test_apply_resume_and_a_new_version_equal_the_reference(pair, stores):
    ref, port = pair(stores)
    for side in (ref, port):
        side.run({1: side.up(1, [CREATE]),
                  2: side.up(2, [("INSERT INTO items VALUES (?, ?)", 1, "a"),
                                 ("INSERT INTO items VALUES (?, ?)", 2, "o'b")])})
        side.run({1: side.up(1, [CREATE]), 2: side.up(2)})  # resume: nothing runs
        side.run({1: side.up(1), 2: side.up(2),
                  3: side.up(3, [("UPDATE items SET v = ? WHERE id = ?", "b", 2)])})
    assert port.state() == ref.state()
    assert port.state()["versions"] == [(1, "UP"), (2, "UP"), (3, "UP")]
    assert port.ran == [1, 2, 3] and port.state()["items"] == [(1, "a"), (2, "b")]


@pytest.mark.parametrize("stores", STORES)
def test_a_failing_up_is_rolled_back_with_nothing_recorded(pair, stores):
    ref, port = pair(stores)
    errors = []
    for side in (ref, port):
        side.run({1: side.up(1, [CREATE])})
        with pytest.raises(side.mig.MigrationError) as err:
            side.run({1: side.up(1), 2: side.up(2, [("INSERT INTO items VALUES (?, ?)", 7, "x"),
                                                    ("CREATE TABLE half (v INTEGER)",)],
                                             fail=True)})
        errors.append(str(err.value))
        with pytest.raises(side.mig.MigrationError):  # the next run tries version 2 again
            side.run({1: side.up(1), 2: side.up(2, fail=True)})
    assert errors[1] == errors[0] == "migration 2 failed: version 2 failed on purpose"
    assert port.state() == ref.state()
    assert port.state()["versions"] == [(1, "UP")] and port.state()["items"] == []
    assert port.ran == [1, 2, 2]
    with pytest.raises(Exception):  # the failed version's DDL was rolled back too
        port.container.sql.query("SELECT v FROM half")


@pytest.mark.parametrize("versions", [{0: None}, {-1: None}, {2: None, 0: None}])
def test_non_positive_versions_are_refused(pair, versions):
    ref, port = pair("sqlite")
    errors = []
    for side in (ref, port):
        with pytest.raises(side.mig.MigrationError) as err:
            side.run({v: side.up(v, [CREATE]) for v in versions})
        errors.append(str(err.value))
    assert errors[1] == errors[0] == "migration versions must be positive integers"
    assert port.ran == ref.ran == []
    assert port.container.sql.query_row("SELECT name FROM sqlite_master WHERE name = ?",
                                         TRACKING) is None  # refused before any store is touched


def test_the_last_version_is_the_union_over_the_stores(pair):
    """A wiped SQL table does not re-run a version that another store
    remembers, and a version past every store's runs once."""
    ref, port = pair("families")
    for side in (ref, port):
        side.run({1: side.up(1, [CREATE]), 2: side.up(2)})
        side.container.sql.exec(f"DELETE FROM {TRACKING}")
        side.run({1: side.up(1, [CREATE]), 2: side.up(2), 3: side.up(3)})
    assert port.state() == ref.state()
    state = port.state()
    assert port.ran == [1, 2, 3] and state["versions"] == [(3, "UP")]
    assert state["document"] == state["widecolumn"] == state["search"] == [1, 2, 3]
    assert state["redis"] == [("1", "UP"), ("2", "UP"), ("3", "UP")]
    assert state["kv"] is None  # kv tracks only when no other store does


def test_kv_tracks_alone_when_it_is_the_only_store(pair):
    ref, port = pair("families")
    for side in (ref, port):
        c = side.container
        c.sql, c.redis, c.extra_datasources = None, None, {}
        side.run({1: side.up(1), 2: side.up(2)})
        side.run({1: side.up(1), 2: side.up(2), 3: side.up(3)})
    assert port.ran == ref.ran == [1, 2, 3]
    assert _kv_get(port.container.kv_store) == _kv_get(ref.container.kv_store) == "3"


class _BrokenRedis:
    """The reference's in-memory Redis whose bookkeeping writes fail."""

    def __init__(self, inner) -> None:
        self._inner = inner

    def hgetall(self, key):
        return self._inner.hgetall(key)

    def hset(self, *args):
        raise ConnectionError("redis went away")


def test_failing_bookkeeping_leaves_the_applied_work(pair):
    ref, port = pair("families")
    for side in (ref, port):
        redis = side.container.redis
        side.container.redis = _BrokenRedis(redis)
        side.run({1: side.up(1, [CREATE]),
                  2: side.up(2, [("INSERT INTO items VALUES (?, ?)", 1, "kept")])})
        side.container.redis = redis
    assert port.state() == ref.state()
    state = port.state()
    assert state["versions"] == [(1, "UP"), (2, "UP")] and state["items"] == [(1, "kept")]
    assert state["redis"] == [] and state["document"] == [1, 2]


def test_a_device_migration_compiles_and_executes_once(pair):
    """``ds.tpu`` on each package's CPU device datasource: version 1 compiles
    a function and executes it once; a second run skips it and compiles
    nothing. The outputs are equal (f32, exact: x * 2 + 1 on small integers)."""
    import jax.numpy as jnp

    from gofr_tpu.datasource.tpu import TPUClient as JTPUClient

    ref, port = pair("sqlite")
    x = np.arange(8, dtype=np.float32)
    outs, clients = {}, {}
    for side in (ref, port):
        if side.name == "ref":
            client, arg = JTPUClient(mesh_spec="dp=-1"), jnp.asarray(x)
            zeros = jnp.zeros((8,), jnp.float32)
        else:
            client, arg, zeros = TPUClient(device="cpu"), torch.from_numpy(x), torch.zeros(8)
        client.connect()
        side.container.tpu = clients[side.name] = client

        def up(ds, side=side, arg=arg, zeros=zeros):
            side.ran.append(1)
            ds.tpu.compile("affine", lambda t: t * 2 + 1, zeros)
            outs[side.name] = np.asarray(ds.tpu.execute("affine", arg, block=True))
            ds.sql.exec("CREATE TABLE warm (name TEXT)")
            ds.sql.exec("INSERT INTO warm VALUES (?)", "affine")

        side.run({1: up})
        side.run({1: up, 2: side.up(2)})
    np.testing.assert_array_equal(outs["port"], outs["ref"])
    np.testing.assert_array_equal(outs["port"], x * 2 + 1)
    assert port.ran == ref.ran == [1, 2]
    assert port.state()["versions"] == ref.state()["versions"] == [(1, "UP"), (2, "UP")]
    assert list(clients["port"]._exec_meta) == ["affine"]
    assert clients["port"]._exec_meta["affine"]["replays"] == 1
    for client in clients.values():
        client.close()


def test_port_refuses_the_database_around_a_migrations_transaction(pair):
    """Queue C 42 in a migration: an UP function that writes through the
    container's database instead of ``ds.sql`` would commit its version's
    transaction half done on the reference; the port raises on that thread,
    and the version rolls back with nothing recorded."""
    _, port = pair("sqlite")
    db = port.container.sql

    def up(ds):
        ds.sql.exec("CREATE TABLE t (v INTEGER)")
        db.exec("INSERT INTO t VALUES (1)")

    with pytest.raises(tmig.MigrationError, match="open transaction"):
        port.run({1: up})
    assert db.query(f"SELECT * FROM {TRACKING}") == []
    assert db.query_row("SELECT name FROM sqlite_master WHERE name = 't'") is None
