"""The port's NATS driver (``gofr_tpu_torch/pubsub/nats.py``) and its
in-process broker (``testutil/nats_broker.py``, which redelivers after
``ack_wait``) beside the JAX package's: the reference's cases of
``tests/test_nats.py`` (the handshake and health, ``HPUB`` headers, queue
groups, redelivery of an unacked message, subject wildcards, ``UNSUB``, the
header codec, the backend switch, a dark broker, a lost and restarted
broker, ``-NAK`` and ``+TERM``) run on each package against its own broker
with the same observables, then each of them cross-wire: the port's client
against the reference's broker and the reference's client against the
port's. A case waits on what the broker or the client shows (a
subscription registered, a delivery), never on a fixed sleep; a check that
nothing comes back waits past the broker's ``ack_wait``."""

import time
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource.pubsub import build_pubsub as rbuild
from gofr_tpu.datasource.pubsub import nats as rnats
from gofr_tpu.testutil.nats_broker import MiniNatsBroker as RBroker
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.pubsub import build_pubsub as tbuild
from gofr_tpu_torch.pubsub import nats as tnats
from gofr_tpu_torch.testutil import MiniNatsBroker as TBroker

ACK_WAIT = 0.5
CLIENTS = {"ref": types.SimpleNamespace(nats=rnats, build=rbuild, MapConfig=RMapConfig),
           "port": types.SimpleNamespace(nats=tnats, build=tbuild, MapConfig=TMapConfig)}
BROKERS = {"ref": RBroker, "port": TBroker}


def pair(client_side: str, broker_side: str):
    return types.SimpleNamespace(**vars(CLIENTS[client_side]), Broker=BROKERS[broker_side])


def make_client(pkg, broker, group="g1", **kw):
    c = pkg.nats.NatsClient(server=broker.address, consumer_group=group, **kw)
    c.connect()
    return c


def poll(client, topic, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        msg = client.subscribe(topic)
        if msg is not None:
            return msg
    return None


def wait_subscribed(broker, subject, n=1, timeout=5.0):
    """Until the broker holds ``n`` subscriptions on ``subject``: a publish
    before that reaches no one (core NATS)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with broker._lock:
            if sum(s.subject == subject for s in broker._subs) >= n:
                return
        time.sleep(0.002)
    raise AssertionError(f"{n} subscriptions on {subject} never registered")


class Brokered:
    def __init__(self, pkg):
        self.pkg = pkg

    def __enter__(self):
        self.broker = self.pkg.Broker(ack_wait=ACK_WAIT)
        return self.broker

    def __exit__(self, *exc):
        self.broker.close()


def case_handshake_and_health(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker)
        try:
            h = c.health_check()
            return {"status": h["status"], "server_name": h["details"]["server_name"],
                    "details": sorted(h["details"])}
        finally:
            c.close()


def case_publish_subscribe_with_headers(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="hdr")
        try:
            c.subscribe("orders.new")  # registers the queue-group subscription
            wait_subscribed(broker, "orders.new")
            c.publish("orders.new", b"o-1", {"trace": "t9"})
            msg = poll(c, "orders.new")
            msg.commit()
            return {"value": msg.value, "metadata": msg.metadata, "topic": msg.topic}
        finally:
            c.close()


def case_queue_group_delivers_once_per_group(pkg):
    with Brokered(pkg) as broker:
        a = make_client(pkg, broker, group="workers")
        b = make_client(pkg, broker, group="workers")
        other = make_client(pkg, broker, group="auditors")
        pub = make_client(pkg, broker, group="pub")
        try:
            for c in (a, b, other):
                c.subscribe("jobs")
            wait_subscribed(broker, "jobs", 3)
            for i in range(4):
                pub.publish("jobs", f"j{i}".encode())
            per_worker = {id(a): [], id(b): []}
            deadline = time.monotonic() + 5
            while sum(map(len, per_worker.values())) < 4 and time.monotonic() < deadline:
                for c in (a, b):
                    m = c.subscribe("jobs")
                    if m is not None:
                        per_worker[id(c)].append(m.value)
                        m.commit()
            audit = []
            deadline = time.monotonic() + 5
            while len(audit) < 4 and time.monotonic() < deadline:
                m = other.subscribe("jobs")
                if m is not None:
                    audit.append(m.value)
                    m.commit()
            return {"workers": sorted(sum(per_worker.values(), [])),
                    "split": sorted(map(len, per_worker.values())), "auditors": sorted(audit)}
        finally:
            for c in (a, b, other, pub):
                c.close()


def case_unacked_message_redelivered(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="redeliver")
        try:
            c.subscribe("tasks")
            wait_subscribed(broker, "tasks")
            c.publish("tasks", b"work")
            first = poll(c, "tasks")
            again = poll(c, "tasks")  # no commit: redelivered after ack_wait
            again.commit()
            after = poll(c, "tasks", timeout=2.4 * ACK_WAIT)
            return {"first": first.value, "first_header": first.metadata.get("Nats-Redelivered"),
                    "again": again.value, "header": again.metadata.get("Nats-Redelivered"),
                    "after_commit": after}
        finally:
            c.close()


def case_subject_wildcards(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="wild")
        try:
            c.subscribe("metrics.*.cpu")
            wait_subscribed(broker, "metrics.*.cpu")
            c.publish("metrics.host1.cpu", b"0.5")
            msg = poll(c, "metrics.*.cpu")
            msg.commit()
            return {"topic": msg.topic, "value": msg.value}
        finally:
            c.close()


def case_unsub_via_delete_topic(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="unsub")
        try:
            c.subscribe("gone")
            wait_subscribed(broker, "gone")
            c.delete_topic("gone")
            c.publish("gone", b"x")  # after the UNSUB on the same connection: no one
            t_end = time.monotonic() + 5
            while time.monotonic() < t_end:
                with broker._lock:
                    if not any(s.subject == "gone" for s in broker._subs):
                        break
                time.sleep(0.002)
            with broker._lock:
                left = sum(s.subject == "gone" for s in broker._subs)
            fresh = c.subscribe("gone")  # subscribes afresh; the message went to no one
            return {"subs_after_delete": left, "fresh": fresh, "subs": c.health_check()[
                "details"]["subscriptions"]}
        finally:
            c.close()


def case_headers_codec_roundtrip(pkg):
    n = pkg.nats
    h = {"a": "1", "b": "two words"}
    return {"roundtrip": n.decode_headers(n.encode_headers(h)),
            "empty": n.decode_headers(n.encode_headers({}))}


def case_backend_switch(pkg):
    with Brokered(pkg) as broker:
        c = pkg.build(pkg.MapConfig({"PUBSUB_BACKEND": "NATS", "NATS_SERVER": broker.address,
                                     "CONSUMER_ID": "switch"}, use_env=False))
        c.connect()
        try:
            return {"type": type(c) is pkg.nats.NatsClient, "group": c.consumer_group,
                    "status": c.health_check()["status"]}
        finally:
            c.close()


def case_health_down_when_dark(pkg):
    c = pkg.nats.NatsClient(server="127.0.0.1:1", connect_timeout=0.3)
    try:
        h = c.health_check()
        return {"status": h["status"], "details": sorted(h["details"])}
    finally:
        c.close()


def case_connection_loss_is_visible_and_recoverable(pkg):
    b1 = pkg.Broker(ack_wait=ACK_WAIT)
    c = make_client(pkg, b1, group="reconnect")
    up = c.health_check()["status"]
    port = b1.port
    reader = c._reader
    b1.close()
    reader.join(5)  # the reader sees the close and clears the client's state
    down = c.health_check()["status"]
    b2 = pkg.Broker(port=port, ack_wait=ACK_WAIT)
    try:
        revived = c.health_check()["status"]
        c.subscribe("revived")
        wait_subscribed(b2, "revived")
        c.publish("revived", b"back")
        msg = poll(c, "revived")
        msg.commit()
        return {"up": up, "down": down, "revived": revived, "value": msg.value}
    finally:
        c.close()
        b2.close()


def case_nack_requeue_redelivers_immediately(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="nak")
        pub = make_client(pkg, broker, group="nak-pub")
        try:
            c.subscribe("nak.tasks")
            wait_subscribed(broker, "nak.tasks")
            pub.publish("nak.tasks", b"retry-me")
            msg = poll(c, "nak.tasks")
            t0 = time.monotonic()
            msg.nack(True)  # -NAK on the ack inbox: redelivered at once
            again = poll(c, "nak.tasks", timeout=2.0)
            before_ack_wait = time.monotonic() - t0 < ACK_WAIT
            again.commit()
            after = poll(c, "nak.tasks", timeout=2.4 * ACK_WAIT)
            return {"again": again.value, "header": again.metadata.get("Nats-Redelivered"),
                    "before_ack_wait": before_ack_wait, "after_commit": after}
        finally:
            c.close()
            pub.close()


def case_nack_drop_settles_without_redelivery(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, group="term")
        pub = make_client(pkg, broker, group="term-pub")
        try:
            c.subscribe("nak.dead")
            wait_subscribed(broker, "nak.dead")
            pub.publish("nak.dead", b"drop-me")
            msg = poll(c, "nak.dead")
            msg.nack(False)  # +TERM: settled for good
            t_end = time.monotonic() + 5
            while broker.pending_count() and time.monotonic() < t_end:
                time.sleep(0.002)
            return {"value": msg.value, "pending": broker.pending_count(),
                    "after": poll(c, "nak.dead", timeout=2.4 * ACK_WAIT)}
        finally:
            c.close()
            pub.close()


CASES = {
    "handshake_and_health": (case_handshake_and_health, {
        "status": "UP", "server_name": "gofr-mini-nats",
        "details": ["backend", "consumer_group", "host", "server_name", "subscriptions"]}),
    "publish_subscribe_with_headers": (case_publish_subscribe_with_headers, {
        "value": b"o-1", "metadata": {"trace": "t9"}, "topic": "orders.new"}),
    "queue_group_delivers_once_per_group": (case_queue_group_delivers_once_per_group, {
        "workers": [b"j0", b"j1", b"j2", b"j3"], "split": [2, 2],
        "auditors": [b"j0", b"j1", b"j2", b"j3"]}),
    "unacked_message_redelivered": (case_unacked_message_redelivered, {
        "first": b"work", "first_header": None, "again": b"work", "header": "true",
        "after_commit": None}),
    "subject_wildcards": (case_subject_wildcards, {"topic": "metrics.host1.cpu", "value": b"0.5"}),
    "unsub_via_delete_topic": (case_unsub_via_delete_topic, {
        "subs_after_delete": 0, "fresh": None, "subs": 1}),
    "headers_codec_roundtrip": (case_headers_codec_roundtrip, {
        "roundtrip": {"a": "1", "b": "two words"}, "empty": {}}),
    "backend_switch": (case_backend_switch, {"type": True, "group": "switch", "status": "UP"}),
    "health_down_when_dark": (case_health_down_when_dark, {
        "status": "DOWN", "details": ["backend", "error", "host"]}),
    "connection_loss_is_visible_and_recoverable": (
        case_connection_loss_is_visible_and_recoverable, {
            "up": "UP", "down": "DOWN", "revived": "UP", "value": b"back"}),
    "nack_requeue_redelivers_immediately": (case_nack_requeue_redelivers_immediately, {
        "again": b"retry-me", "header": "true", "before_ack_wait": True, "after_commit": None}),
    "nack_drop_settles_without_redelivery": (case_nack_drop_settles_without_redelivery, {
        "value": b"drop-me", "pending": 0, "after": None}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_case_equals_the_reference(case):
    """Each package's client against its own broker: the same observables,
    and those the reference's test asserts."""
    fn, want = CASES[case]
    got = {side: fn(pair(side, side)) for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert got["port"] == want


CROSS = [c for c in CASES if c not in ("headers_codec_roundtrip", "health_down_when_dark")]


@pytest.mark.parametrize("client_side,broker_side", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("case", CROSS)
def test_case_cross_wire(case, client_side, broker_side):
    """One package's client against the other package's broker gives what
    the reference's test asserts."""
    fn, want = CASES[case]
    assert fn(pair(client_side, broker_side)) == want
