"""The port's Redis datasource (``gofr_tpu_torch/datasource/redis``: the RESP2
client and ``InMemoryRedis``) and its RESP2 test server
(``gofr_tpu_torch/testutil/redis_server.py``) beside the JAX package's
``gofr_tpu.datasource.redis``. Every comparison is exact equality (bytes,
replies, dicts, counts) unless a case says otherwise:

- ``_encode`` gives the reference's bytes on seeded commands;
- ``_read_reply`` decodes the same frames to the same values over a
  socketpair, on both packages;
- each package's ``RedisClient``, against the port's server over each
  package's ``InMemoryRedis`` (cross-wired), gives the replies that
  package's ``InMemoryRedis`` gives called directly, on a seeded op
  sequence;
- TTLs and expiry under a patched clock, directly and over the wire;
- ``health_check`` dicts, a down server logged at ``connect`` and not
  raised, ``app_redis_stats`` per command and the port's span per command;
- the migrations' Redis tracking hash through the port's ``InMemoryRedis``
  and through the port's client, held to the reference's."""

import json
import random
import socket
import types

import pytest

from gofr_tpu.container.container import Container as RContainer
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource.redis import InMemoryRedis as RInMemoryRedis
from gofr_tpu.datasource.redis import client as rclient
from gofr_tpu.datasource.redis import memory as rmemory
from gofr_tpu.logging import Level as RLevel
from gofr_tpu.logging import new_logger as r_new_logger
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu import migration as rmig
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.datasource.redis import InMemoryRedis, RedisClient, new_redis
from gofr_tpu_torch.datasource.redis import client as tclient
from gofr_tpu_torch.datasource.redis import memory as tmemory
from gofr_tpu_torch.logging import Level, new_logger
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch import migration as tmig
from gofr_tpu_torch.testutil.redis_server import MiniRedisServer
from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer

PKGS = {
    "ref": types.SimpleNamespace(client=rclient, memory=rmemory, Store=RInMemoryRedis),
    "port": types.SimpleNamespace(client=tclient, memory=tmemory, Store=InMemoryRedis),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]


class Clock:
    """A stand-in for ``time.monotonic`` that moves only when told."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg.memory, "time", types.SimpleNamespace(monotonic=c.monotonic))
    return c


def _client(side: str, server: MiniRedisServer, **kw):
    c = PKGS[side].client.RedisClient(host="127.0.0.1", port=server.port, **kw)
    c.connect()
    return c


# ---------------------------------------------------------------- framing
def test_encode_gives_the_references_bytes_on_seeded_commands():
    rng = random.Random(0)
    atoms = ["GET", "SET", "k", "", "ünïcode", "a b\r\nc", 0, -7, 2 ** 40, 1.5, b"\x00\xffraw"]
    for _ in range(200):
        parts = [rng.choice(atoms) for _ in range(rng.randint(1, 6))]
        assert tclient._encode(parts) == rclient._encode(parts), parts


FRAMES = [
    (b"+OK\r\n", "OK"),
    (b"+\r\n", ""),
    (b":0\r\n", 0),
    (b":-42\r\n", -42),
    (b"$0\r\n\r\n", ""),
    (b"$-1\r\n", None),
    (b"$10\r\nhello\r\nyou\r\n", "hello\r\nyou"),
    ("$5\r\nünï\r\n".encode(), "ünï"),
    (b"$2\r\n\xff\xfe\r\n", "��"),
    (b"*0\r\n", []),
    (b"*-1\r\n", None),
    (b"*3\r\n:1\r\n$-1\r\n*2\r\n+a\r\n$1\r\nb\r\n", [1, None, ["a", "b"]]),
]


@pytest.mark.parametrize("side", SIDES)
def test_read_reply_decodes_the_spec_frames_as_the_reference(side):
    a, b = socket.socketpair()
    try:
        c = PKGS[side].client.RedisClient()
        c._sock, c._file = b, b.makefile("rb")
        a.sendall(b"".join(f for f, _ in FRAMES))
        got = [c._read_reply() for _ in FRAMES]
        assert got == [want for _, want in FRAMES]
        a.sendall(b"?what\r\n")
        with pytest.raises(PKGS[side].client.RedisError, match="bad RESP type byte"):
            c._read_reply()
        a.close()
        with pytest.raises(PKGS[side].client.RedisError, match="connection closed"):
            c._read_reply()
    finally:
        b.close()


# ---------------------------------------------------------------- the op sequence
KEYS = ["a", "b", "c", "h1", "h2"]


def _ops(seed: int, n: int = 160) -> list[tuple]:
    """A seeded sequence over few keys, so reads meet writes, hashes meet
    strings, and deletes meet both."""
    rng = random.Random(seed)
    ops = []
    for _ in range(n):
        k = rng.choice(KEYS)
        kind = rng.choice(["get", "set", "set_ttl", "delete", "exists", "incr", "hset", "hget",
                           "hgetall", "expire", "ping"])
        if kind == "get":
            ops.append(("get", k))
        elif kind == "set":
            ops.append(("set", k, rng.choice(["1", "v", "41", "x y"])))
        elif kind == "set_ttl":
            ops.append(("set", k, str(rng.randint(0, 9)), 300.0))
        elif kind == "delete":
            ops.append(("delete", *rng.sample(KEYS, rng.randint(1, 3))))
        elif kind == "exists":
            ops.append(("exists", *rng.sample(KEYS, rng.randint(1, 3))))
        elif kind == "incr":
            ops.append(("incr", rng.choice(["a", "b", "n"])))
        elif kind == "hset":
            ops.append(("hset", rng.choice(["h1", "h2"]), rng.choice("fgh"), str(rng.randint(0, 9))))
        elif kind == "hget":
            ops.append(("hget", rng.choice(["h1", "h2"]), rng.choice("fgh")))
        elif kind == "hgetall":
            ops.append(("hgetall", rng.choice(["h1", "h2", "a"])))
        elif kind == "expire":
            ops.append(("expire", k, 120.0))
        else:
            ops.append(("ping",))
    return ops


def _apply(store, ops: list[tuple]) -> list:
    """Each op's reply, or the name of the error it raised."""
    out = []
    for name, *args in ops:
        try:
            out.append(getattr(store, name)(*args))
        except Exception:  # noqa: BLE001 - the error is part of the reply
            out.append(("error", name))
    return out


@pytest.mark.parametrize("client_side,store_side", CROSS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clients_over_the_server_give_the_in_memory_replies(client_side, store_side, seed,
                                                            clock):
    """The client over the wire and the store called directly take the same
    op sequence and give the same replies. A wrong-type INCR raises on both
    (``RedisError`` against ``ValueError``); ``ttl`` is compared after."""
    ops = _ops(seed)
    direct = PKGS[store_side].Store()
    served = PKGS[store_side].Store()
    server = MiniRedisServer(store=served)
    try:
        c = _client(client_side, server)
        got = _apply(c, ops)
        want = _apply(direct, ops)
        for i, (g, w) in enumerate(zip(got, want)):
            if isinstance(w, bool) and not isinstance(g, bool):
                assert g == w, (i, ops[i], g, w)
            else:
                assert g == w and type(g) is type(w), (i, ops[i], g, w)
        # the state the wire left is the state the direct calls left
        for k in KEYS:
            assert served.get(k) == direct.get(k) and served.hgetall(k) == direct.hgetall(k)
            # PTTL in ms over the wire: TTLs are whole seconds here, the clock still
            want_ttl = direct.ttl(k)
            if want_ttl >= 0:
                assert c.ttl(k) == want_ttl
            else:  # -1 (no TTL) or -2 (no key) in ms: the reference client's reading
                assert c.ttl(k) == (-0.001 if direct.exists(k) else -0.002)
        c.close()
    finally:
        server.close()


@pytest.mark.parametrize("side", SIDES)
def test_ttl_and_expiry_under_a_patched_clock(side, clock):
    store = PKGS[side].Store()
    server = MiniRedisServer(store=PKGS[side].Store())
    try:
        wire = _client(side, server)
        seen = {}
        for name, s in (("direct", store), ("wire", wire)):
            s.set("k", "v", ttl_seconds=2.5)
            s.set("forever", "1")
            s.hset("h", "f", "1")
            rows = [s.ttl("k"), s.exists("k"), s.expire("h", 1.0), s.ttl("h")]
            clock.now += 1.0
            rows += [s.get("k"), s.ttl("k"), s.hget("h", "f"), s.exists("h")]
            clock.now += 1.5
            rows += [s.get("k"), s.exists("k", "forever"), s.expire("k", 5.0)]
            s.set("k", "again", ttl_seconds=1.0)
            s.set("k", "no ttl")  # SET without PX clears the TTL
            clock.now += 10.0
            rows += [s.get("k"), s.incr("n"), s.delete("k", "forever", "n")]
            seen[name] = rows
            clock.now += 1000.0
        assert seen["direct"] == [2.5, 1, True, 1.0, "v", 1.5, None, 0, None, 1, False,
                                  "no ttl", 1, 3]
        assert seen["wire"] == seen["direct"]
        wire.close()
    finally:
        server.close()


def test_in_memory_redis_matches_the_reference_on_a_long_sequence(clock):
    """The two ``InMemoryRedis`` classes called directly, with the clock
    moving between ops so keys expire mid-sequence."""
    rng = random.Random(7)
    ref, port = RInMemoryRedis(), InMemoryRedis()
    for op in _ops(11, n=600):
        clock.now += rng.choice([0.0, 0.0, 30.0, 200.0])
        assert _apply(port, [op]) == _apply(ref, [op]), op
        for k in KEYS:
            assert port.ttl(k) == ref.ttl(k)


# ---------------------------------------------------------------- config, health, logs
def test_from_config_reads_the_references_keys():
    values = {"REDIS_HOST": "h", "REDIS_PORT": "6380", "REDIS_USER": "u",
              "REDIS_PASSWORD": "p", "REDIS_DB": "3", "REDIS_TLS_ENABLED": "TRUE"}
    fields = ("host", "port", "username", "password", "db", "use_tls", "timeout")
    for given in (values, {}):
        ref = rclient.new_redis(RMapConfig(given, use_env=False))
        port = new_redis(MapConfig(given, use_env=False))
        assert [getattr(port, f) for f in fields] == [getattr(ref, f) for f in fields]
    assert (port.host, port.port, port.db, port.use_tls) == ("localhost", 6379, 0, False)


class RecordingLogger:
    def __init__(self) -> None:
        self.lines: list[tuple[str, str]] = []

    def __getattr__(self, level: str):
        return lambda msg, *a, **k: self.lines.append((level, str(msg)))


@pytest.mark.parametrize("client_side,store_side", CROSS)
def test_auth_select_and_health_checks(client_side, store_side):
    server = MiniRedisServer(store=PKGS[store_side].Store(), password="pw", username="app")
    try:
        good = _client(client_side, server, username="app", password="pw", db=2)
        assert good.set("k", "v") and good.get("k") == "v"
        assert server.dbs[2].get("k") == "v" and server.store.get("k") is None
        health = good.health_check()
        assert health == {"status": "UP", "details": {"host": f"127.0.0.1:{server.port}"}}
        assert PKGS[store_side].Store().health_check() == {"status": "UP",
                                                           "details": {"backend": "in-memory"}}
        with pytest.raises(PKGS[client_side].client.RedisError, match="WRONGPASS"):
            _client(client_side, server, password="nope").get("k")
        bare = PKGS[client_side].client.RedisClient(host="127.0.0.1", port=server.port)
        with pytest.raises(PKGS[client_side].client.RedisError, match="NOAUTH"):
            bare.get("k")
        with pytest.raises(PKGS[client_side].client.RedisError, match="unknown command"):
            good.command("LPUSH", "l", "x")
        server.close()
        assert good.health_check() == {"status": "DOWN", "details": {
            "host": f"127.0.0.1:{server.port}", "error": "ping failed"}}
        with pytest.raises(OSError):
            good.get("k")
    finally:
        server.close()


def test_a_down_server_is_logged_at_connect_not_raised():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # nothing listens here once closed
    lines = {}
    for side in SIDES:
        c = PKGS[side].client.RedisClient(host="127.0.0.1", port=port, timeout=0.5)
        log = RecordingLogger()
        c.use_logger(log)
        c.connect()  # no raise
        lines[side] = [(lvl, msg.rsplit(": ", 1)[0]) for lvl, msg in log.lines]
        assert not c.ping()
        assert c.health_check()["status"] == "DOWN"
    assert lines["port"] == lines["ref"] == [
        ("error", f"could not connect to redis at 127.0.0.1:{port}")]


@pytest.mark.parametrize("store_side", SIDES)
def test_query_logs_stats_and_spans(store_side):
    """One ``app_redis_stats`` observation and one debug ``RedisLog`` per
    command on both packages, labelled by the server's address and the
    command; the port's client also opens a ``redis <command>`` client span
    per command (the reference's keeps its tracer unused)."""
    server = MiniRedisServer(store=PKGS[store_side].Store())
    try:
        seen = {}
        for side, new_manager in (("ref", r_new_metrics_manager), ("port", new_metrics_manager)):
            m = new_manager()
            m.new_histogram("app_redis_stats", "Response time of Redis commands in milliseconds")
            log = RecordingLogger()
            exporter = InMemoryExporter()
            c = PKGS[side].client.RedisClient(host="127.0.0.1", port=server.port)
            c.use_logger(log)
            c.use_metrics(m)
            c.use_tracer(Tracer("t", SimpleSpanProcessor(exporter)))
            c.connect()
            c.set(f"{side}:k", "1", ttl_seconds=60)
            c.get(f"{side}:k")
            c.incr(f"{side}:n")
            c.incr(f"{side}:n")
            c.hgetall("nope")
            with pytest.raises(PKGS[side].client.RedisError):
                c.command("NOPE")
            counts = {t: m.get("app_redis_stats").snapshot(
                {"hostname": server.address, "type": t})[1]
                for t in ("set", "get", "incr", "hgetall", "nope")}
            debug = [msg.split()[2] for lvl, msg in log.lines if lvl == "debug"]
            spans = [(s.name, s.kind, s.attributes.get("db.system"), s.status_code)
                     for s in exporter.spans]
            seen[side] = (counts, debug, spans)
            c.close()
        assert seen["port"][:2] == seen["ref"][:2]
        assert seen["port"][0] == {"set": 1, "get": 1, "incr": 2, "hgetall": 1, "nope": 0}
        assert seen["port"][1] == ["SET", "GET", "INCR", "INCR", "HGETALL"]
        assert seen["ref"][2] == []
        assert seen["port"][2] == [("redis set", "client", "redis", "UNSET"),
                                   ("redis get", "client", "redis", "UNSET"),
                                   ("redis incr", "client", "redis", "UNSET"),
                                   ("redis incr", "client", "redis", "UNSET"),
                                   ("redis hgetall", "client", "redis", "UNSET"),
                                   ("redis nope", "client", "redis", "ERROR")]
    finally:
        server.close()


def test_the_server_answers_only_the_clients_commands():
    """Anything the client does not send is an unknown command; a wrong
    arity, a SET option other than PX and AUTH without a password set are
    Redis's errors. The client retries once on an error reply (a reconnect),
    so the server sees each failing command twice."""
    server = MiniRedisServer()
    try:
        c = RedisClient(host="127.0.0.1", port=server.port)
        for cmd in (("LPUSH", "l", "x"), ("KEYS", "*"), ("FLUSHALL",)):
            with pytest.raises(tclient.RedisError, match="unknown command"):
                c.command(*cmd)
        with pytest.raises(tclient.RedisError, match="wrong number of arguments"):
            c.command("GET")
        with pytest.raises(tclient.RedisError, match="syntax error"):
            c.command("SET", "k", "v", "EX", "5")
        with pytest.raises(tclient.RedisError, match="without any password"):
            c.command("AUTH", "x")
        assert c.set("s", "text")
        with pytest.raises(tclient.RedisError, match="not an integer"):
            c.incr("s")
        assert c.command("PING", "echo") == "echo"
        c.close()
    finally:
        server.close()
    assert {k: server.commands[k] for k in ("LPUSH", "KEYS", "GET", "SET", "INCR", "PING")} == {
        "LPUSH": 2, "KEYS": 2, "GET": 2, "SET": 3, "INCR": 2, "PING": 1}


# ---------------------------------------------------------------- migrations
def _containers():
    ref = RContainer(RMapConfig({}, use_env=False),
                     logger=r_new_logger(RLevel.FATAL, exit_on_fatal=False))
    port = Container(MapConfig({}, use_env=False), logger=new_logger(Level.FATAL,
                                                                     exit_on_fatal=False))
    return ref, port


@pytest.mark.parametrize("port_store", ["memory", "wire"])
def test_migrations_track_versions_in_the_redis_hash_like_the_reference(port_store):
    """``run_migrations`` with only a Redis store: the tracking hash
    ``gofr_migrations`` holds each version with method UP, a resumed run
    skips what is recorded, and the UP functions see the store as
    ``ds.redis``."""
    ref, port = _containers()
    server = None
    ref.redis = RInMemoryRedis()
    if port_store == "memory":
        port.redis = InMemoryRedis()
    else:
        server = MiniRedisServer()
        port.redis = RedisClient(host="127.0.0.1", port=server.port)
        port.redis.connect()
    try:
        states = {}
        for side, c, mig in (("ref", ref, rmig), ("port", port, tmig)):
            ran = []

            def up(v):
                def fn(ds):
                    ran.append(v)
                    ds.redis.set(f"seeded:{v}", str(v * 10))
                return mig.Migrate(up=fn)

            mig.run_migrations({1: up(1), 2: up(2)}, c)
            mig.run_migrations({1: up(1), 2: up(2), 3: up(3)}, c)
            tracked = c.redis.hgetall("gofr_migrations")
            states[side] = (
                ran,
                sorted((k, json.loads(v)["method"], sorted(json.loads(v))) for k, v in
                       tracked.items()),
                [c.redis.get(f"seeded:{v}") for v in (1, 2, 3)],
            )
        assert states["port"] == states["ref"]
        assert states["port"][0] == [1, 2, 3]
        assert [k for k, *_ in states["port"][1]] == ["1", "2", "3"]
    finally:
        ref.close()
        port.close()
        if server is not None:
            server.close()
