"""The port's MQTT 3.1.1 driver (``gofr_tpu_torch/pubsub/mqtt.py``) and its
in-process broker (``testutil/mqtt_broker.py``) beside the JAX package's:
the reference's cases of ``tests/test_mqtt.py`` (the codec, QoS 1 and 0,
wildcards, a QoS-1 message redelivered with DUP after a reconnect, order,
health, a refused connect, the subscriber loop, the local re-enqueue of a
nack and the PUBACK of a dropped one) run on each package against its own
broker with the same observables, then each of them cross-wire (the port's
client against the reference's broker and the reference's against the
port's); and the subscribe counter, which the reference's driver counts a
second time beside the subscriber loop (ROADMAP Queue C 46) and the port's
counts once."""

import asyncio
import time
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.container.container import Container as RContainer
from gofr_tpu.datasource.pubsub import build_pubsub as rbuild
from gofr_tpu.datasource.pubsub import mqtt as rmqtt
from gofr_tpu.subscriber import SubscriptionManager as RManager
from gofr_tpu.testutil.mqtt_broker import MiniMQTTBroker as RBroker
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.container.container import Container as TContainer
from gofr_tpu_torch.pubsub import build_pubsub as tbuild
from gofr_tpu_torch.pubsub import mqtt as tmqtt
from gofr_tpu_torch.subscriber import SubscriptionManager as TManager
from gofr_tpu_torch.testutil import MiniMQTTBroker as TBroker

CLIENTS = {"ref": types.SimpleNamespace(mqtt=rmqtt, build=rbuild, Manager=RManager,
                                        Container=RContainer, MapConfig=RMapConfig),
           "port": types.SimpleNamespace(mqtt=tmqtt, build=tbuild, Manager=TManager,
                                         Container=TContainer, MapConfig=TMapConfig)}
BROKERS = {"ref": RBroker, "port": TBroker}


def pair(client_side: str, broker_side: str):
    return types.SimpleNamespace(**vars(CLIENTS[client_side]), Broker=BROKERS[broker_side])


def make_client(pkg, broker, **kw):
    c = pkg.mqtt.MQTTClient("127.0.0.1", broker.port, **kw)
    c.connect()
    return c


def poll(client, topic, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        msg = client.subscribe(topic)
        if msg is not None:
            return msg
    return None


def subscribed(broker, client_id, topic):
    """Whether the broker's session for ``client_id`` holds ``topic``: a
    publish before that reaches no one."""
    with broker._mu:
        sess = broker._sessions.get(client_id)
        return sess is not None and topic in sess.subscriptions


async def until(pred, timeout=15.0):
    """Poll ``pred`` on the running loop until it holds or ``timeout``."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        await asyncio.sleep(0.005)
    return pred()


class Brokered:
    def __init__(self, pkg):
        self.pkg = pkg

    def __enter__(self):
        self.broker = self.pkg.Broker().start()
        return self.broker

    def __exit__(self, *exc):
        self.broker.stop()


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("side", ["ref", "port"])
def test_remaining_length_boundaries(side):
    enc = CLIENTS[side].mqtt.encode_remaining_length
    assert [enc(n) for n in (0, 127, 128, 16383, 16384)] == [
        b"\x00", b"\x7f", b"\x80\x01", b"\xff\x7f", b"\x80\x80\x01"]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_topic_matching(side):
    m = CLIENTS[side].mqtt.topic_matches
    assert m("a/b", "a/b") and m("a/+", "a/b") and m("a/#", "a/b/c") and m("#", "anything/at/all")
    assert not m("a/+", "a/b/c") and not m("a/b", "a") and not m("+", "a/b")


# ------------------------------------------------------------------ driver
def case_publish_subscribe_roundtrip(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, client_id="pub")
        sub = make_client(pkg, broker, client_id="sub")
        try:
            first = sub.subscribe("orders")  # registers the filter
            pub.publish("orders", b"order-1", None)
            msg = poll(sub, "orders")
            msg.commit()
            return {"first": first, "value": msg.value, "topic": msg.topic,
                    "metadata": msg.metadata, "id": msg.message_id is not None}
        finally:
            pub.close()
            sub.close()


def case_qos0(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, client_id="pub0", qos=0)
        sub = make_client(pkg, broker, client_id="sub0", qos=0)
        try:
            sub.subscribe("t0")
            pub.publish("t0", b"fire-and-forget", None)
            msg = poll(sub, "t0")
            return {"value": msg.value, "metadata": msg.metadata, "id": msg.message_id}
        finally:
            pub.close()
            sub.close()


def case_wildcard_subscription(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, client_id="wp")
        sub = make_client(pkg, broker, client_id="ws")
        try:
            sub.subscribe("sensors/+/temp")
            pub.publish("sensors/kitchen/temp", b"21.5", None)
            msg = poll(sub, "sensors/+/temp")
            return {"topic": msg.topic, "value": msg.value}
        finally:
            pub.close()
            sub.close()


def case_uncommitted_redelivered_after_reconnect(pkg):
    """QoS-1 at-least-once: no PUBACK, so a DUP redelivery on reconnect."""
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, client_id="rp")
        sub = make_client(pkg, broker, client_id="rsub")
        try:
            sub.subscribe("jobs")
            pub.publish("jobs", b"job-77", None)
            msg = poll(sub, "jobs")
            sub.close()  # no commit
            sub2 = make_client(pkg, broker, client_id="rsub")  # the same session
            msg2 = poll(sub2, "jobs")
            msg2.commit()
            sub2.close()  # close() waits out a PINGRESP: the PUBACK has landed
            sub3 = make_client(pkg, broker, client_id="rsub")
            third = sub3.subscribe("jobs")
            sub3.close()
            return {"first": msg.value, "redelivered": msg2.value, "third": third}
        finally:
            pub.close()


def case_many_messages_in_order(pkg):
    with Brokered(pkg) as broker:
        pub = make_client(pkg, broker, client_id="mp")
        sub = make_client(pkg, broker, client_id="ms")
        try:
            sub.subscribe("stream")
            for i in range(50):
                pub.publish("stream", f"m{i}".encode(), None)
            got = []
            deadline = time.monotonic() + 10
            while len(got) < 50 and time.monotonic() < deadline:
                msg = sub.subscribe("stream")
                if msg is not None:
                    got.append(msg.value.decode())
                    msg.commit()
            return {"got": got}
        finally:
            pub.close()
            sub.close()


def case_health_check(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, client_id="hc")
        try:
            h = c.health_check()
        finally:
            c.close()
        after = c.health_check()
        return {"status": h["status"], "backend": h["details"]["backend"],
                "details": sorted(h["details"]), "after_close": after["status"]}


def case_connect_refused_surfaces(pkg):
    c = pkg.mqtt.MQTTClient("127.0.0.1", 1)  # nothing listens on port 1
    try:
        c.connect()
    except OSError:
        return {"raised": True}
    return {"raised": False}


def case_backend_switch(pkg):
    with Brokered(pkg) as broker:
        c = pkg.build(pkg.MapConfig({"PUBSUB_BACKEND": "MQTT", "MQTT_HOST": "127.0.0.1",
                                     "MQTT_PORT": str(broker.port), "MQTT_CLIENT_ID": "switch",
                                     "MQTT_QOS": "0", "MQTT_KEEPALIVE": "10"}, use_env=False))
        c.connect()
        try:
            return {"type": type(c) is pkg.mqtt.MQTTClient, "id": c.client_id, "qos": c.qos,
                    "keepalive": c.keepalive, "status": c.health_check()["status"]}
        finally:
            c.close()


def case_app_subscriber_loop_consumes(pkg):
    """The framework's subscriber loop drives the MQTT driver exactly like
    the in-memory broker."""
    with Brokered(pkg) as broker:
        container = pkg.Container(pkg.MapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
        driver = pkg.mqtt.MQTTClient("127.0.0.1", broker.port, client_id="app-sub")
        container.register_datasource("pubsub", driver)  # metrics wired, as the App does
        manager = pkg.Manager(container)
        seen = []
        manager.register("events", lambda ctx: seen.append(ctx.bind(str)))
        pub = make_client(pkg, broker, client_id="app-pub")
        consumer = manager._consumers["events"]

        async def scenario():
            await manager.start()
            try:
                assert await until(lambda: subscribed(broker, "app-sub", "events"))
                for i in range(3):
                    pub.publish("events", f"evt-{i}".encode(), None)
                assert await until(lambda: len(seen) >= 3), f"only saw {seen}"
                await until(lambda: consumer.delivered >= 3)
            finally:
                await manager.stop()

        try:
            asyncio.run(scenario())
            m = container.metrics_manager
            return {"seen": sorted(seen), "delivered": consumer.delivered,
                    "subscribe_total": m.get("app_pubsub_subscribe_total_count").value(
                        {"topic": "events"}),
                    "subscribe_success": m.get("app_pubsub_subscribe_success_count").value(
                        {"topic": "events"})}
        finally:
            pub.close()
            driver.close()


def case_nack_requeue_redelivers_locally(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, client_id="nack-rq")
        try:
            c.subscribe("retries")
            c.publish("retries", b"again-please")
            msg = poll(c, "retries")
            msg.nack(True)  # 3.1.1 has no negative ack: a local re-enqueue
            again = c.subscribe("retries")
            again.commit()
            return {"again": again.value, "same_id": again.message_id == msg.message_id,
                    "after": c.subscribe("retries")}
        finally:
            c.close()


def case_nack_drop_pubacks(pkg):
    with Brokered(pkg) as broker:
        c = make_client(pkg, broker, client_id="nack-drop")
        try:
            c.subscribe("drops")
            c.publish("drops", b"gone")
            msg = poll(c, "drops")
            msg.nack(False)  # PUBACK without processing
            after = c.subscribe("drops")
        finally:
            c.close()
        with broker._mu:
            unacked = dict(broker._sessions["nack-drop"].unacked)
        return {"value": msg.value, "after": after, "unacked": unacked}


CASES = {
    "publish_subscribe_roundtrip": (case_publish_subscribe_roundtrip, {
        "first": None, "value": b"order-1", "topic": "orders", "metadata": {"qos": "1"},
        "id": True}),
    "qos0": (case_qos0, {"value": b"fire-and-forget", "metadata": {"qos": "0"}, "id": None}),
    "wildcard_subscription": (case_wildcard_subscription, {
        "topic": "sensors/kitchen/temp", "value": b"21.5"}),
    "uncommitted_redelivered_after_reconnect": (case_uncommitted_redelivered_after_reconnect, {
        "first": b"job-77", "redelivered": b"job-77", "third": None}),
    "many_messages_in_order": (case_many_messages_in_order, {"got": [f"m{i}" for i in range(50)]}),
    "health_check": (case_health_check, {
        "status": "UP", "backend": "MQTT",
        "details": ["backend", "client_id", "connected", "host", "subscriptions"],
        "after_close": "DOWN"}),
    "connect_refused_surfaces": (case_connect_refused_surfaces, {"raised": True}),
    "backend_switch": (case_backend_switch, {"type": True, "id": "switch", "qos": 0,
                                             "keepalive": 10, "status": "UP"}),
    "app_subscriber_loop_consumes": (case_app_subscriber_loop_consumes, None),
    "nack_requeue_redelivers_locally": (case_nack_requeue_redelivers_locally, {
        "again": b"again-please", "same_id": True, "after": None}),
    "nack_drop_pubacks": (case_nack_drop_pubacks, {"value": b"gone", "after": None,
                                                   "unacked": {}}),
}
LOOP = {"seen": ["evt-0", "evt-1", "evt-2"], "delivered": 3, "subscribe_success": 3}


@pytest.mark.parametrize("case", list(CASES))
def test_case_equals_the_reference(case):
    """Each package's client against its own broker: the same observables,
    and those the reference's test asserts. The subscriber loop's case
    differs in one counter only: the reference's driver counts every
    delivery a second time (Queue C 46)."""
    fn, want = CASES[case]
    got = {side: fn(pair(side, side)) for side in ("ref", "port")}
    if want is None:
        assert got["port"] == {**LOOP, "subscribe_total": 3}
        assert got["ref"] == {**LOOP, "subscribe_total": 6}
    else:
        assert got["port"] == got["ref"] == want


@pytest.mark.parametrize("client_side,broker_side", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("case", [c for c in CASES if c != "connect_refused_surfaces"])
def test_case_cross_wire(case, client_side, broker_side):
    """One package's client against the other package's broker gives what
    the reference's test asserts."""
    fn, want = CASES[case]
    got = fn(pair(client_side, broker_side))
    if want is None:
        want = {**LOOP, "subscribe_total": 3 if client_side == "port" else 6}
    assert got == want
