"""The port's membership layer against the JAX package's, on the CPU:

- ``Heartbeat.to_json`` is byte-identical to the reference's for seeded
  field values, and each side's ``from_json`` reads the other's bytes;
- ``MembershipTable`` against the reference's over seeded sequences of
  ``register``, ``observe``, ``mark_down``, ``forget``, ``candidates``,
  ``state_of``, ``aggregate_queue_wait`` and ``min_hbm_headroom``, with
  explicit clocks; RECLAIMING, DRAINING and WEDGED are never candidates;
- ``ReplicaAnnouncer.compose`` over a port engine and a JAX engine at
  ``LlamaConfig.tiny`` gives equal beats apart from the id, seq and clock
  fields, on the dense and paged layouts;
- a ``router.heartbeat`` fault drops the beat and counts it, and the
  port's in-memory broker carries beats as the reference's does.
"""

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu.datasource.pubsub import InMemoryBroker as JBroker  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import membership as jms  # noqa: E402
from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.pubsub import InMemoryBroker  # noqa: E402
from gofr_tpu_torch.serving import membership as tms  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

SEEDS = (0, 101, 202, 303)
STATES = ("UP", "SUSPECT", "RESTARTING", "DRAINING", "WEDGED", "DOWN", "RECLAIMING")
ROLES = ("prefill", "decode", "unified", "unknown-role")
IDS = ("r0", "r1", "r2", "r3", "r4")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _beat_fields(rng, rid: str, seq: int) -> dict:
    """Seeded values of every Heartbeat field (None where a field may be)."""
    return dict(
        replica_id=rid, seq=seq, state=str(rng.choice(STATES)), role=str(rng.choice(ROLES)),
        queue_wait_s=float(rng.choice([0.0, rng.uniform(0, 3)])),
        queue_depth=int(rng.integers(0, 40)), slots_free=int(rng.integers(0, 9)),
        kv_free_frac=float(rng.uniform(0, 1)),
        hbm_free_frac=None if rng.random() < 0.3 else float(rng.uniform(0, 1)),
        ts=float(rng.uniform(1e9, 2e9)), preemptible=bool(rng.random() < 0.4),
        reclaim_deadline_s=None if rng.random() < 0.6 else float(rng.uniform(0, 5)),
        prefix_keys=None if rng.random() < 0.5 else
        [[f"k{int(rng.integers(0, 1000))}", str(rng.choice(["device", "host"]))]
         for _ in range(int(rng.integers(0, 4)))],
        epoch=int(rng.integers(0, 5)),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_bytes_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    assert [f.name for f in dataclasses.fields(tms.Heartbeat)] == \
        [f.name for f in dataclasses.fields(jms.Heartbeat)]
    for i in range(50):
        fields = _beat_fields(rng, IDS[i % len(IDS)], i)
        mine, ref = tms.Heartbeat(**fields), jms.Heartbeat(**fields)
        assert mine.to_json() == ref.to_json()
        assert dataclasses.asdict(tms.Heartbeat.from_json(ref.to_json())) == fields
        assert dataclasses.asdict(jms.Heartbeat.from_json(mine.to_json())) == fields
    # an unknown field from a newer announcer is dropped on both sides
    raw = b'{"replica_id": "x", "seq": 3, "from_the_future": 1}'
    assert dataclasses.asdict(tms.Heartbeat.from_json(raw)) == \
        dataclasses.asdict(jms.Heartbeat.from_json(raw))


def _table_ops(seed: int, n: int = 300):
    """A seeded op sequence over explicit clocks. Observation times sit
    well inside each timer band against the wall clock read at the end
    (fresh, suspect at 3-10 s old, down past 10 s), so reads of the two
    tables a moment apart classify every replica the same."""
    rng = np.random.default_rng(seed)
    seqs = {rid: 0 for rid in IDS}
    ops = []
    for _ in range(n):
        rid = str(rng.choice(IDS))
        kind = rng.choice(["register", "observe", "observe", "observe", "stale", "mark_down",
                           "forget", "read"], p=[.1, .2, .2, .2, .05, .07, .05, .13])
        if kind == "register":
            ops.append(("register", rid, str(rng.choice(ROLES[:3])), bool(rng.random() < 0.5)))
        elif kind in ("observe", "stale"):
            if kind == "observe":
                seqs[rid] += int(rng.integers(1, 3))
            fields = _beat_fields(rng, rid, max(seqs[rid], 0))
            age = float(rng.choice([0.5, 6.0, 30.0]))
            ops.append(("observe", fields, age))
        elif kind == "mark_down":
            ops.append(("mark_down", rid, str(rng.choice(["breaker-open", "probe"]))))
        elif kind == "forget":
            ops.append(("forget", rid))
            seqs[rid] = 0
        else:
            ops.append(("read", str(rng.choice(ROLES[:3] + (None,)))))
    return ops


def _run_table(ms, ops, base: float) -> list:
    table = ms.MembershipTable(suspect_after_s=3.0, down_after_s=10.0)
    out = []
    for op in ops:
        if op[0] == "register":
            table.register(op[1], op[2], preemptible=op[3])
        elif op[0] == "observe":
            out.append(table.observe(ms.Heartbeat(**op[1]), now=base - op[2]))
        elif op[0] == "mark_down":
            table.mark_down(op[1], op[2])
        elif op[0] == "forget":
            table.forget(op[1])
        else:
            role = op[1]
            now = time.monotonic()
            out.append((
                table.candidates(now, role=role),
                {rid: table.state_of(rid, now=now) for rid in IDS},
                round(table.aggregate_queue_wait(role), 9),
                table.min_hbm_headroom(role),
                {rid: (table.load_of(rid), table.headroom_of(rid), table.epoch_of(rid),
                       table.is_preemptible(rid), table.role_of(rid)) for rid in IDS},
                sorted(table.roles_present(now)),
            ))
    out.append(table.snapshot(base))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_membership_table_matches_the_reference(seed):
    ops = _table_ops(seed)
    base = time.monotonic()
    assert _run_table(tms, ops, base) == _run_table(jms, ops, base)


@pytest.mark.parametrize("ms", [tms, jms], ids=["port", "jax"])
def test_never_routable_states(ms):
    t = ms.MembershipTable()
    for i, state in enumerate(STATES):
        t.observe(ms.Heartbeat(f"r{i}", 1, state=state), now=0.0)
    assert t.candidates(now=0.1) == ["r0"]  # only UP (SUSPECT is silence-derived)
    for state in ("RECLAIMING", "DRAINING", "WEDGED", "RESTARTING", "DOWN"):
        assert state in ms._NEVER_ROUTE
    assert ms.STATE_VALUES == jms.STATE_VALUES


# -------------------------------------------------------------- announcer


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=16,
            prefill_chunk_tokens=16, prefix_cache_entries=16)


class _Sink:
    def __init__(self):
        self.beats = []

    def publish(self, topic, payload, metadata=None):
        self.beats.append((topic, payload))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_compose_over_engines_matches_the_reference(models, layout):
    """Each engine serves the same two prompts, then idles; the beats of a
    port and a JAX engine differ only in the replica id, seq and clock."""
    jcfg, jparams, tcfg, tparams = models
    conf = {**BASE, "preemptible": True, "role": "decode",
            **({"kv_layout": "paged", "kv_page_size": 8} if layout == "paged" else {})}
    engines = [JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer()),
               ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu")]
    beats = []
    for ms, engine, rid in zip((jms, tms), engines, ("jax", "port")):
        engine.start()
        try:
            for p in ("the shared system prompt " * 2, "short"):
                engine.submit(p, max_new_tokens=4).result(120)
            sink = _Sink()
            ann = ms.ReplicaAnnouncer(rid, engine, sink, interval_s=99.0)
            assert ann.beat() and ann.beat()
            beats.append([ms.Heartbeat.from_json(b) for _, b in sink.beats])
        finally:
            engine.stop()
    (j1, j2), (t1, t2) = beats
    assert (t1.seq, t2.seq) == (j1.seq, j2.seq) == (1, 2)
    assert j1.prefix_keys and t1.prefix_keys  # the caches advertise their entries
    skip = {"replica_id", "seq", "ts"}
    mine = {k: v for k, v in dataclasses.asdict(t1).items() if k not in skip}
    ref = {k: v for k, v in dataclasses.asdict(j1).items() if k not in skip}
    assert mine == ref
    assert mine["preemptible"] is True and mine["role"] == "decode"
    assert mine["state"] == "UP" and mine["slots_free"] == 4


@pytest.mark.parametrize("seed", (101, 202, 303))
def test_heartbeat_fault_drops_and_counts(seed):
    """A ``router.heartbeat`` fault is a partition: the beat is dropped
    and counted, never raised into the engine; each side under its own
    injector drops the same beats."""
    from gofr_tpu_torch.testutil.replica import StubReplicaEngine
    from gofr_tpu.testutil.replica import StubReplicaEngine as JStub

    dropped = []
    for ms, chaos, stub in ((tms, tchaos, StubReplicaEngine("s")), (jms, jchaos, JStub("s"))):
        sink = _Sink()
        ann = ms.ReplicaAnnouncer("s", stub, sink, interval_s=99.0)
        with chaos.active(chaos.ChaosInjector(seed, {"router.heartbeat": 0.5})):
            sent = [ann.beat() for _ in range(12)]
        assert ann.dropped_beats == sent.count(False) == 12 - len(sink.beats)
        dropped.append(sent)
    assert dropped[0] == dropped[1]
    assert False in dropped[0]


def test_beats_ride_the_brokers_alike():
    """Beats published on each side's in-memory broker come back in order,
    at least once until committed; the port's broker matches the
    reference's delivery."""
    out = []
    for broker, ms in ((InMemoryBroker(consumer_group="router", poll_timeout=0.01), tms),
                       (JBroker(consumer_group="router", poll_timeout=0.01), jms)):
        for seq in (1, 2, 3):
            broker.publish(ms.HEARTBEAT_TOPIC, ms.Heartbeat("a", seq).to_json())
        got = []
        first = broker.subscribe(ms.HEARTBEAT_TOPIC)
        again = broker.subscribe(ms.HEARTBEAT_TOPIC)  # uncommitted: redelivered
        got.append((first.value == again.value, ms.Heartbeat.from_json(first.value).seq))
        first.commit()
        while (msg := broker.subscribe(ms.HEARTBEAT_TOPIC)) is not None:
            got.append(ms.Heartbeat.from_json(msg.value).seq)
            msg.commit()
        out.append((got, broker.backlog(ms.HEARTBEAT_TOPIC), broker.health_check()))
    assert out[0] == out[1]
    assert out[0][0] == [(True, 1), 2, 3]
