"""The port's Kafka driver (``gofr_tpu_torch/pubsub/kafka.py`` over
``kafka_wire.py``) and its in-process broker (``testutil/kafka_broker.py``)
beside the JAX package's: the reference's cases of ``tests/test_kafka.py``
(the codec, produce and fetch, record headers, the committed offset across
a restart, consumer groups, ``auto_offset_reset``, an out-of-range offset,
topic admin and backlog, health, the subscriber loop, the broker refusing
the legacy framings, and the nack emulation) run on each package against
its own broker with the same observables; then each of them cross-wire,
the port's client against the reference's broker and the reference's
client against the port's; and the reference's chaos delivery invariant
(``tests/test_pubsub_chaos.py``) over the port's wire driver."""

import asyncio
import socket
import time
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.container.container import Container as RContainer
from gofr_tpu.datasource.pubsub import kafka_wire as rwire
from gofr_tpu.datasource.pubsub.kafka import KafkaClient as RKafka
from gofr_tpu.subscriber import SubscriptionManager as RManager
from gofr_tpu.testutil.kafka_broker import MiniKafkaBroker as RBroker
from gofr_tpu_torch import chaos as tchaos
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.container.container import Container as TContainer
from gofr_tpu_torch.pubsub import kafka_wire as twire
from gofr_tpu_torch.pubsub.delivery import (
    DLQ_ATTEMPTS_KEY,
    DLQ_ERROR_KEY,
    DLQ_SOURCE_TOPIC_KEY,
    DLQ_SUFFIX,
)
from gofr_tpu_torch.pubsub.kafka import KafkaClient as TKafka
from gofr_tpu_torch.subscriber import STOPPED
from gofr_tpu_torch.subscriber import SubscriptionManager as TManager
from gofr_tpu_torch.testutil import MiniKafkaBroker as TBroker
from gofr_tpu_torch.testutil import new_mock_container

CLIENTS = {"ref": types.SimpleNamespace(Client=RKafka, wire=rwire, Manager=RManager,
                                        Container=RContainer, MapConfig=RMapConfig),
           "port": types.SimpleNamespace(Client=TKafka, wire=twire, Manager=TManager,
                                         Container=TContainer, MapConfig=TMapConfig)}
BROKERS = {"ref": RBroker, "port": TBroker}


def pair(client_side: str, broker_side: str):
    """A case's view: one package's client, codec and subscriber over one
    package's broker."""
    return types.SimpleNamespace(**vars(CLIENTS[client_side]), Broker=BROKERS[broker_side])


def make_client(pkg, broker, group="g1", **kw):
    c = pkg.Client(broker.address, consumer_group=group, poll_timeout=0.05, **kw)
    c.connect()
    return c


class Brokered:
    """A fresh broker for one case, closed after it."""

    def __init__(self, pkg):
        self.pkg = pkg

    def __enter__(self):
        self.broker = self.pkg.Broker()
        return self.broker

    def __exit__(self, *exc):
        self.broker.close()


async def until(pred, timeout=15.0):
    """Poll ``pred`` on the running loop until it holds or ``timeout``."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        await asyncio.sleep(0.005)
    return pred()


# ------------------------------------------------------------------ codec
def codec_message_set_roundtrip(w):
    return w.decode_message_set(w.encode_message_set([(0, None, b"v0"), (1, b"k", b"v1"),
                                                      (2, b"", b"")]))


def codec_partial_trailing_message_tolerated(w):
    data = w.encode_message_set([(0, None, b"whole")])
    return w.decode_message_set(data + w.encode_message_set([(1, None, b"cut")])[:10])


def codec_crc_mismatch_detected(w):
    data = bytearray(w.encode_message_set([(0, None, b"x" * 32)]))
    data[-1] ^= 0xFF
    try:
        w.decode_message_set(bytes(data))
    except w.KafkaError:
        return "KafkaError"
    return "accepted"


def codec_nullable_string(w):
    r = w.Reader(w.string(None) + w.string("ab"))
    return w.string(None), r.string(), r.string()


def codec_crc32c_known_answer(w):
    return w.crc32c(b"123456789"), w.crc32c(b"")


VARINTS = [0, 1, -1, 63, -64, 300, -300, 2**31, -(2**31), 2**62]


def codec_varint_zigzag_roundtrip(w):
    return [w.Reader(w.varint(v)).varint() for v in VARINTS]


def codec_record_batch_roundtrip_with_headers(w):
    entries = [(b"k1", b"v1", [("h", b"x"), ("h2", b"y")]), (None, b"v2", [])]
    return w.decode_record_batches(w.encode_record_batch(7, entries))


def codec_decode_rejects_magic0(w):
    try:
        w.decode_record_batches(w.encode_message_set([(0, None, b"old")]))
    except w.KafkaError:
        return "KafkaError"
    return "accepted"


def codec_decode_rejects_bad_crc(w):
    batch = bytearray(w.encode_record_batch(0, [(None, b"v", [])]))
    batch[-1] ^= 0xFF
    try:
        w.decode_record_batches(bytes(batch))
    except w.KafkaError:
        return "KafkaError"
    return "accepted"


CODEC = {
    "message_set_roundtrip": (codec_message_set_roundtrip,
                              [(0, None, b"v0"), (1, b"k", b"v1"), (2, b"", b"")]),
    "partial_trailing_message_tolerated": (codec_partial_trailing_message_tolerated,
                                           [(0, None, b"whole")]),
    "crc_mismatch_detected": (codec_crc_mismatch_detected, "KafkaError"),
    "nullable_string": (codec_nullable_string, (b"\xff\xff", None, "ab")),
    "crc32c_known_answer": (codec_crc32c_known_answer, (0xE3069283, 0)),
    "varint_zigzag_roundtrip": (codec_varint_zigzag_roundtrip, VARINTS),
    "record_batch_roundtrip_with_headers": (codec_record_batch_roundtrip_with_headers, [
        (7, b"k1", b"v1", [("h", b"x"), ("h2", b"y")]), (8, None, b"v2", [])]),
    "decode_rejects_magic0": (codec_decode_rejects_magic0, "KafkaError"),
    "decode_rejects_bad_crc": (codec_decode_rejects_bad_crc, "KafkaError"),
}


@pytest.mark.parametrize("case", list(CODEC))
def test_codec_case_equals_the_reference(case):
    fn, want = CODEC[case]
    assert fn(twire) == fn(rwire) == want


# ------------------------------------------------------------------ driver
def case_produce_fetch_roundtrip(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker)
        try:
            c.publish("orders", b"order-1")
            c.publish("orders", b"order-2")
            m1, m2 = c.subscribe("orders"), c.subscribe("orders")
            return {"values": (m1.value, m2.value), "topic": m1.topic,
                    "ids": (m1.message_id, m2.message_id), "log": broker.log("orders")}
        finally:
            c.close()


def case_metadata_rides_record_headers(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker)
        try:
            c.publish("t", b"payload", {"trace_id": "abc"})
            msg = c.subscribe("t")
            return {"metadata": msg.metadata, "header": msg.header("trace_id"),
                    "log": broker.log("t")}
        finally:
            c.close()


def case_commit_resumes_after_restart(pkg):
    with Brokered(pkg) as broker:
        c1 = make_client(pkg, broker, group="workers")
        try:
            for i in range(4):
                c1.publish("jobs", f"job-{i}".encode())
            m0, m1 = c1.subscribe("jobs"), c1.subscribe("jobs")
            m0.commit()
            m1.commit()
            c1.subscribe("jobs")  # job-2 delivered, not committed
        finally:
            c1.close()
        committed = broker.committed("workers", "jobs")
        c2 = make_client(pkg, broker, group="workers")
        try:
            return {"committed": committed, "redelivered": c2.subscribe("jobs").value,
                    "then": c2.subscribe("jobs").value}
        finally:
            c2.close()


def case_independent_consumer_groups(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, group="pub")
        a = make_client(pkg, broker, group="group-a")
        b = make_client(pkg, broker, group="group-b")
        try:
            pub.publish("fan", b"x")
            ma, mb = a.subscribe("fan"), b.subscribe("fan")
            ma.commit()
            return {"values": (ma.value, mb.value), "a": broker.committed("group-a", "fan"),
                    "b": broker.committed("group-b", "fan")}
        finally:
            pub.close(), a.close(), b.close()


def case_auto_offset_reset_latest(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker)
        late = None
        try:
            pub.publish("stream", b"old")
            late = make_client(pkg, broker, group="latecomer", auto_offset_reset="latest")
            first = late.subscribe("stream")  # starts at the end
            pub.publish("stream", b"new")
            return {"first": first, "next": late.subscribe("stream").value}
        finally:
            pub.close()
            if late is not None:
                late.close()


def case_offset_out_of_range_resets_to_policy(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="w")
        try:
            for i in range(3):
                c.publish("t2", f"m{i}".encode())
            for _ in range(3):
                c.subscribe("t2").commit()
            c.delete_topic("t2")
            c.create_topic("t2")
            c.publish("t2", b"new")
            c._positions.pop("t2", None)  # a fresh session: the position from the commits
            msg, polls = None, 0
            while msg is None and polls < 5:
                msg, polls = c.subscribe("t2"), polls + 1
            return {"value": msg.value, "polls": polls}
        finally:
            c.close()


def case_topic_admin_and_backlog(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker)
        try:
            c.create_topic("managed")
            listed = "managed" in c.topics()
            c.publish("managed", b"a")
            c.publish("managed", b"b")
            backlog = [c.backlog("managed")]
            c.subscribe("managed").commit()
            backlog.append(c.backlog("managed"))
            c.delete_topic("managed")
            return {"listed": listed, "backlog": backlog, "after_delete": "managed" in c.topics()}
        finally:
            c.close()


def case_health_check_up_down(pkg):
    broker = pkg.Broker()
    c = make_client(pkg, broker)
    try:
        up = c.health_check()
    finally:
        c.close()
    broker.close()
    down = pkg.Client(broker.address, connect_timeout=0.3).health_check()
    return {"up": up["status"], "details": sorted(up["details"]), "backend": up["details"]["backend"],
            "topics": up["details"]["topics"], "down": down["status"],
            "down_details": sorted(down["details"])}


def case_connection_refused_raises(pkg):
    c = pkg.Client("127.0.0.1:1", connect_timeout=0.3)
    try:
        c.connect()
    except OSError as exc:
        return {"raised": isinstance(exc, OSError)}
    return {"raised": False}


def case_app_subscriber_loop_consumes(pkg):
    """The framework subscriber loop consumes from Kafka and commits on
    handler success."""
    with Brokered(pkg) as broker:
        container = pkg.Container(pkg.MapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
        driver = pkg.Client(broker.address, consumer_group="app", poll_timeout=0.05)
        driver.connect()
        container.pubsub = driver
        manager = pkg.Manager(container)
        seen = []
        manager.register("events", lambda ctx: seen.append(ctx.bind(str)))
        pub = make_client(pkg, broker, group="producer")

        async def scenario():
            await manager.start()
            try:
                for i in range(3):
                    pub.publish("events", f"evt-{i}".encode())
                assert await until(lambda: len(seen) >= 3), f"only saw {seen}"
                await until(lambda: broker.committed("app", "events") >= 3, 5)
            finally:
                await manager.stop()

        try:
            asyncio.run(scenario())
            return {"seen": seen, "committed": broker.committed("app", "events")}
        finally:
            pub.close()
            driver.close()


def _raw_produce(pkg, broker, version: int, topic: str, with_txn: bool):
    w = pkg.wire
    msg_set = w.encode_message_set([(0, None, b"legacy")])
    body = ((w.string(None) if with_txn else b"") + w.int16(-1) + w.int32(1000)
            + w.array([w.string(topic) + w.array([w.int32(0) + w.int32(len(msg_set)) + msg_set])]))
    sock = socket.create_connection(("127.0.0.1", broker.port), timeout=5)
    try:
        sock.sendall(w.encode_request(w.PRODUCE, version, 7, "legacy", body))
        r = w.Reader(w.read_frame(lambda n: w.recv_exact(sock, n)))
        correlation = r.int32()
        r.int32(), r.string(), r.int32(), r.int32()
        return {"correlation": correlation, "code": r.int16(), "log": broker.log(topic)}
    finally:
        sock.close()


def case_broker_rejects_legacy_produce_version(pkg):
    with Brokered(pkg) as broker:
        return _raw_produce(pkg, broker, 0, "t", with_txn=False)


def case_broker_rejects_magic0_payload_in_v3_produce(pkg):
    with Brokered(pkg) as broker:
        return _raw_produce(pkg, broker, pkg.wire.PRODUCE_API_VERSION, "t2", with_txn=True)


def case_nack_requeue_redelivers_from_held_offset(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="nack-rq")
        try:
            c.publish("jobs", b"j1")
            c.publish("jobs", b"j2")
            m1 = c.subscribe("jobs")
            m1.nack(True)  # rewind and drop the buffer
            again = c.subscribe("jobs")
            again.commit()
            m2 = c.subscribe("jobs")
            m2.commit()
            return {"first": m1.value, "again": again.value, "ids": (m1.message_id,
                                                                    again.message_id),
                    "next": m2.value, "committed": broker.committed("nack-rq", "jobs")}
        finally:
            c.close()


def case_nack_drop_commits_past_the_message(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="nack-drop")
        try:
            c.publish("drops", b"poison")
            c.publish("drops", b"fine")
            c.subscribe("drops").nack(False)
            nxt = c.subscribe("drops")
            nxt.commit()
        finally:
            c.close()
        c2 = make_client(pkg, broker, group="nack-drop")
        try:
            return {"next": nxt.value, "fresh_client": c2.subscribe("drops"),
                    "committed": broker.committed("nack-drop", "drops")}
        finally:
            c2.close()


def case_nack_is_idempotent_after_commit(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="nack-idem")
        try:
            c.publish("idem", b"x")
            m = c.subscribe("idem")
            m.commit()
            m.nack(True)  # settled: no rewind
            return {"after": c.subscribe("idem"), "committed": broker.committed("nack-idem", "idem")}
        finally:
            c.close()


# each case with what the reference's test asserts of it
CASES = {
    "produce_fetch_roundtrip": (case_produce_fetch_roundtrip, {
        "values": (b"order-1", b"order-2"), "topic": "orders", "ids": ("0", "1"),
        "log": [(None, b"order-1", []), (None, b"order-2", [])]}),
    "metadata_rides_record_headers": (case_metadata_rides_record_headers, {
        "metadata": {"trace_id": "abc"}, "header": "abc", "log": [(None, b"payload",
                                                                   [("trace_id", b"abc")])]}),
    "commit_resumes_after_restart": (case_commit_resumes_after_restart, {
        "committed": 2, "redelivered": b"job-2", "then": b"job-3"}),
    "independent_consumer_groups": (case_independent_consumer_groups, {
        "values": (b"x", b"x"), "a": 1, "b": -1}),
    "auto_offset_reset_latest": (case_auto_offset_reset_latest, {"first": None, "next": b"new"}),
    "offset_out_of_range_resets_to_policy": (case_offset_out_of_range_resets_to_policy, None),
    "topic_admin_and_backlog": (case_topic_admin_and_backlog, {
        "listed": True, "backlog": [2, 1], "after_delete": False}),
    "health_check_up_down": (case_health_check_up_down, {
        "up": "UP", "details": ["backend", "consumer_group", "host", "topics"],
        "backend": "kafka", "topics": 0, "down": "DOWN",
        "down_details": ["backend", "error", "host"]}),
    "connection_refused_raises": (case_connection_refused_raises, {"raised": True}),
    "app_subscriber_loop_consumes": (case_app_subscriber_loop_consumes, {
        "seen": ["evt-0", "evt-1", "evt-2"], "committed": 3}),
    "broker_rejects_legacy_produce_version": (case_broker_rejects_legacy_produce_version, {
        "correlation": 7, "code": rwire.UNSUPPORTED_VERSION, "log": []}),
    "broker_rejects_magic0_payload_in_v3_produce": (
        case_broker_rejects_magic0_payload_in_v3_produce, {
            "correlation": 7, "code": rwire.CORRUPT_MESSAGE, "log": []}),
    "nack_requeue_redelivers_from_held_offset": (case_nack_requeue_redelivers_from_held_offset, {
        "first": b"j1", "again": b"j1", "ids": ("0", "0"), "next": b"j2", "committed": 2}),
    "nack_drop_commits_past_the_message": (case_nack_drop_commits_past_the_message, {
        "next": b"fine", "fresh_client": None, "committed": 2}),
    "nack_is_idempotent_after_commit": (case_nack_is_idempotent_after_commit, {
        "after": None, "committed": 1}),
}


def _check(case, got):
    want = CASES[case][1]
    if want is not None:
        assert got == want
    else:  # the reference's test: the new message within five polls
        assert got["value"] == b"new" and got["polls"] <= 5


@pytest.mark.parametrize("case", list(CASES))
def test_case_equals_the_reference(case):
    """Each package's client against its own broker: the same observables,
    and those the reference's test asserts."""
    fn = CASES[case][0]
    got = {side: fn(pair(side, side)) for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    _check(case, got["port"])


@pytest.mark.parametrize("client_side,broker_side", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("case", list(CASES))
def test_case_cross_wire(case, client_side, broker_side):
    """One package's client against the other package's broker gives what
    the reference's test asserts: the codecs interoperate byte for byte."""
    _check(case, CASES[case][0](pair(client_side, broker_side)))


# ------------------------------------------------- the chaos delivery invariant
CHAOS_SEEDS = (101, 202, 303)
N_MESSAGES = 12
MAX_ATTEMPTS = 3
RATES = {"pubsub.subscribe": 0.10, "pubsub.ack": 0.10, "pubsub.handler": 0.25}


def _chaos_configs():
    return {"PUBSUB_MAX_ATTEMPTS": str(MAX_ATTEMPTS), "PUBSUB_RETRY_BACKOFF_SECONDS": "0.01",
            "PUBSUB_RETRY_MAX_BACKOFF_SECONDS": "0.05"}


@pytest.mark.parametrize("seed", CHAOS_SEEDS)
def test_delivery_invariant_over_the_wire_driver(seed, run_async, monkeypatch):
    """The reference's invariant under a fixed-seed fault schedule at
    ``pubsub.subscribe``, ``pubsub.ack`` and ``pubsub.handler``, over the
    port's Kafka driver and broker: every published message is handled (once
    or more) or lands in ``<topic>.dlq`` with its attempt history; the
    poison messages are dead-lettered; deliveries stay bounded; the
    consumer is not parked."""
    import gofr_tpu_torch.subscriber as sub

    mini = TBroker()
    client = TKafka(mini.address, consumer_group=f"chaos-{seed}", poll_timeout=0.02)
    client.connect()
    container, _ = new_mock_container(_chaos_configs())
    container.register_datasource("pubsub", client)
    manager = TManager(container)
    manager._rng.seed(seed)
    topic = "chaos-kafka"
    handled: dict = {}
    poison = {b"msg-1", b"msg-8"}
    dlq_published: list = []
    real_publish = client.publish

    def spying_publish(t, value, metadata=None):
        real_publish(t, value, metadata)
        if t.endswith(DLQ_SUFFIX):
            dlq_published.append(bytes(value))

    client.publish = spying_publish

    def handler(ctx):
        value = ctx.request.value
        if value in poison:
            raise ValueError(f"poison {value!r}")
        handled[value] = handled.get(value, 0) + 1

    manager.register(topic, handler)
    payloads = [f"msg-{i}".encode() for i in range(N_MESSAGES)]
    monkeypatch.setattr(sub, "ERROR_BACKOFF_SECONDS", 0.02)

    def settled():
        return all(handled.get(p, 0) >= 1 or p in dlq_published for p in payloads)

    async def workload():
        for p in payloads:  # publishes stay outside the fault schedule
            client.publish(topic, p)
        await manager.start()
        try:
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline and not settled():
                await asyncio.sleep(0.02)
            await asyncio.sleep(0.1)  # let the last settlement land
        finally:
            await manager.stop()

    inj = tchaos.ChaosInjector(seed, RATES, max_faults=2)
    try:
        with tchaos.active(inj):
            run_async(workload())
        assert settled(), [p for p in payloads if not handled.get(p) and p not in dlq_published]
        assert any(v["faults"] for v in inj.stats().values())  # the chaos hit
        dead, misses = [], 0
        while misses < 3:
            m = client.subscribe(topic + DLQ_SUFFIX)
            if m is None:
                misses += 1
                continue
            m.commit()
            dead.append(m)
    finally:
        client.close()
        mini.close()
    dead_values = [m.value for m in dead]
    for p in poison:
        assert p not in handled and p in dead_values
    for m in dead:
        assert m.metadata[DLQ_SOURCE_TOPIC_KEY] == topic
        assert int(m.metadata[DLQ_ATTEMPTS_KEY]) >= MAX_ATTEMPTS
        assert m.metadata[DLQ_ERROR_KEY]
        assert float(m.metadata["gofr_dlq_first_delivery_ts"]) <= float(
            m.metadata["gofr_dlq_last_delivery_ts"])
    total = sum(handled.values()) + sum(int(m.metadata[DLQ_ATTEMPTS_KEY]) for m in dead)
    assert total <= N_MESSAGES * (MAX_ATTEMPTS + 4)
    consumer = manager._consumers[topic]
    assert consumer.state == STOPPED and not consumer.parked
