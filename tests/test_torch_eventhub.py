"""The port's Event Hubs driver (``gofr_tpu_torch/pubsub/eventhub.py`` over
``amqp_wire.py``) and its in-process AMQP 1.0 server
(``testutil/eventhub_server.py``) beside the JAX package's: the reference's
cases of ``tests/test_eventhub.py`` (the AMQP codec, the connection string,
publish and subscribe across partitions, the SASL PLAIN identity,
round-robin and partition keys, the checkpoint on commit across a
reconnect, the topic-management contract with the ``gofr_migrations``
carve-out, health, the backend switch, link credit, and the RELEASED and
ACCEPTED dispositions of a nack, with the deliveries a release sends twice)
run on each package against its own server with the same observables,
then each of them cross-wire (the port's
client against the reference's server and the reference's against the
port's); and the subscribe counters, which the reference's driver counts
itself beside the subscriber loop (every poll, and every delivery before
its handler ran: ROADMAP Queue C 46) and the port's leaves to the loop."""

import asyncio
import time
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.container.container import Container as RContainer
from gofr_tpu.datasource.pubsub import amqp_wire as ramqp
from gofr_tpu.datasource.pubsub import build_pubsub as rbuild
from gofr_tpu.datasource.pubsub import eventhub as reventhub
from gofr_tpu.subscriber import SubscriptionManager as RManager
from gofr_tpu.testutil.eventhub_server import MiniEventHubServer as RServer
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.container.container import Container as TContainer
from gofr_tpu_torch.pubsub import amqp_wire as tamqp
from gofr_tpu_torch.pubsub import build_pubsub as tbuild
from gofr_tpu_torch.pubsub import eventhub as teventhub
from gofr_tpu_torch.subscriber import SubscriptionManager as TManager
from gofr_tpu_torch.testutil import MiniEventHubServer as TServer

CLIENTS = {"ref": types.SimpleNamespace(eh=reventhub, amqp=ramqp, build=rbuild, Manager=RManager,
                                        Container=RContainer, MapConfig=RMapConfig),
           "port": types.SimpleNamespace(eh=teventhub, amqp=tamqp, build=tbuild, Manager=TManager,
                                         Container=TContainer, MapConfig=TMapConfig)}
SERVERS = {"ref": RServer, "port": TServer}


def pair(client_side: str, server_side: str):
    return types.SimpleNamespace(**vars(CLIENTS[client_side]), Server=SERVERS[server_side])


def make_client(pkg, server, group="$Default", **kw):
    c = pkg.eh.EventHubClient(host="127.0.0.1", port=server.port, eventhub_name="hub",
                              consumer_group=group, partitions=server.partitions, **kw)
    c.connect()
    return c


def poll(client, topic, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        msg = client.subscribe(topic)
        if msg is not None:
            return msg
    return None


def wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.002)
    return pred()


class Served:
    def __init__(self, pkg):
        self.pkg = pkg

    def __enter__(self):
        self.server = self.pkg.Server(partitions=2).start()
        return self.server

    def __exit__(self, *exc):
        self.server.close()


async def until(pred, timeout=15.0):
    """Poll ``pred`` on the running loop until it holds or ``timeout``."""
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        await asyncio.sleep(0.005)
    return pred()


# ------------------------------------------------------------------ codec
def _amqp_cases(a):
    return [None, True, False, 7, -300, "hello", a.Symbol("PLAIN"), b"\x00\x01",
            [1, "two", None], {"k": "v", a.Symbol("s"): 3}, a.Described(0x75, b"payload"),
            a.Uint(0), a.Uint(77), a.Uint(70000)]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_amqp_value_roundtrip(side):
    a = CLIENTS[side].amqp
    for v in _amqp_cases(a):
        assert a.Decoder(a.encode_value(v)).value() == v
    ours = [tamqp.encode_value(v) for v in _amqp_cases(tamqp)]
    assert ours == [ramqp.encode_value(v) for v in _amqp_cases(ramqp)]


@pytest.mark.parametrize("side", ["ref", "port"])
def test_frame_roundtrip(side):
    a = CLIENTS[side].amqp
    perf = a.Described(0x14, [a.Uint(3), a.Uint(9), b"tag", a.Uint(0), True])
    frame = a.encode_frame(0, perf, a.encode_message(b"body", {"a": "b"}))
    channel, ftype, got, payload = a.decode_frame(frame)
    assert (channel, ftype, got) == (0, 0, perf)
    assert a.decode_message(payload) == (b"body", {"a": "b"})


@pytest.mark.parametrize("side", ["ref", "port"])
def test_parse_connection_string(side):
    cs = ("Endpoint=sb://ns.servicebus.windows.net:5671/;"
          "SharedAccessKeyName=RootManageSharedAccessKey;"
          "SharedAccessKey=abc123=;EntityPath=myhub")
    parsed = CLIENTS[side].eh.parse_connection_string(cs)
    assert parsed == reventhub.parse_connection_string(cs)
    assert (parsed["host"], parsed["port"], parsed["SharedAccessKeyName"],
            parsed["EntityPath"]) == ("ns.servicebus.windows.net", "5671",
                                      "RootManageSharedAccessKey", "myhub")


@pytest.mark.parametrize("side", ["ref", "port"])
def test_partitions_must_be_positive(side):
    with pytest.raises(ValueError, match="PARTITIONS"):
        CLIENTS[side].eh.EventHubClient(host="x", port=1, partitions=0)


# ------------------------------------------------------------------ driver
def case_publish_subscribe_roundtrip(pkg):
    with Served(pkg) as server:
        c = make_client(pkg, server)
        try:
            c.publish("orders", b"first order", {"kind": "t"})
            msg = poll(c, "orders")
            msg.commit()
            return {"value": msg.value, "kind": msg.metadata["kind"],
                    "partition_ok": msg.metadata["partition"] in ("0", "1"),
                    "keys": sorted(msg.metadata)}
        finally:
            c.close()


def case_sasl_plain_identity_reaches_server(pkg):
    with Served(pkg) as server:
        cs = (f"Endpoint=sb://127.0.0.1:{server.port}/;"
              "SharedAccessKeyName=keyname;SharedAccessKey=secret;EntityPath=hub")
        c = pkg.eh.EventHubClient(connection_string=cs, partitions=server.partitions)
        c.connect()
        try:
            return {"attempts": list(server.auth_attempts), "hub": c.eventhub_name}
        finally:
            c.close()


def case_round_robin_spreads_partitions(pkg):
    with Served(pkg) as server:
        c = make_client(pkg, server)
        try:
            for i in range(4):
                c.publish("spread", f"m{i}".encode())
            seen, values = set(), []
            for _ in range(4):
                msg = poll(c, "spread")
                seen.add(msg.metadata["partition"])
                values.append(msg.value)
                msg.commit()
            return {"partitions": sorted(seen), "values": sorted(values)}
        finally:
            c.close()


def case_partition_key_pins_partition(pkg):
    with Served(pkg) as server:
        c = make_client(pkg, server)
        try:
            for i in range(3):
                c.publish("keyed", f"k{i}".encode(), {"partition-key": "user-1"})
            seen = set()
            for _ in range(3):
                msg = poll(c, "keyed")
                seen.add(msg.metadata["partition"])
                msg.commit()
            return {"partitions": len(seen)}
        finally:
            c.close()


def case_uncommitted_messages_redeliver(pkg):
    with Served(pkg) as server:
        c1 = make_client(pkg, server, group="workers")
        c1.publish("jobs", b"job-1")
        first = poll(c1, "jobs")
        c1.close()  # dies without a commit
        c2 = make_client(pkg, server, group="workers")
        try:
            again = poll(c2, "jobs")
            again.commit()
            drained = wait_until(lambda: server.topic_depth("jobs", "workers") == 0)
            return {"first": first.value, "again": again.value, "drained": drained}
        finally:
            c2.close()


def case_committed_messages_stay_consumed(pkg):
    with Served(pkg) as server:
        c1 = make_client(pkg, server, group="g")
        c1.publish("done", b"d1")
        msg = poll(c1, "done")
        msg.commit()
        checkpointed = wait_until(lambda: server.topic_depth("done", "g") == 0)
        c1.close()
        c2 = make_client(pkg, server, group="g")
        try:
            return {"value": msg.value, "checkpointed": checkpointed,
                    "after_reconnect": c2.subscribe("done")}
        finally:
            c2.close()


def case_topic_management_contract(pkg):
    errors = []

    class _Log:
        def error(self, msg, **kw):
            errors.append(msg)

        def log(self, msg, **kw):
            pass

        def warn(self, msg, **kw):
            pass

    with Served(pkg) as server:
        c = make_client(pkg, server)
        c.use_logger(_Log())
        try:
            c.create_topic("gofr_migrations")
            carve_out = list(errors)
            c.create_topic("anything-else")
            c.delete_topic("anything")
            return {"carve_out": carve_out, "errors": errors}
        finally:
            c.close()


def case_health_up_and_down(pkg):
    with Served(pkg) as server:
        c = make_client(pkg, server)
        try:
            up = c.health_check()
        finally:
            c.close()
    down = pkg.eh.EventHubClient(host="127.0.0.1", port=1, connect_timeout=0.2).health_check()
    return {"up": up["status"], "backend": up["details"]["backend"],
            "partitions": up["details"]["partitions"], "details": sorted(up["details"]),
            "down": down["status"], "error": "error" in down["details"]}


def case_backend_switch_builds_eventhub(pkg):
    with Served(pkg) as server:
        client = pkg.build(pkg.MapConfig({
            "PUBSUB_BACKEND": "EVENTHUB", "EVENTHUB_HOST": "127.0.0.1",
            "EVENTHUB_PORT": str(server.port), "EVENTHUB_NAME": "hub",
            "EVENTHUB_PARTITIONS": "2", "CONSUMER_ID": "switch"}, use_env=False))
        client.connect()
        try:
            client.publish("switch", b"x")
            msg = poll(client, "switch")
            msg.commit()
            return {"type": type(client) is pkg.eh.EventHubClient, "value": msg.value,
                    "group": client.consumer_group, "hub": client.eventhub_name}
        finally:
            client.close()


def case_publish_respects_link_credit(pkg):
    with Served(pkg) as server:
        client = make_client(pkg, server)
        try:
            link = client._sender("hub")
            with link.credit_cv:  # the grant FLOW trails the attach echo
                granted = link.credit_cv.wait_for(lambda: link.credit > 0, timeout=5)
            before = link.credit
            client.publish("hub", b"payload-0")
            one = before - link.credit
            for _ in range(1, 40):
                client.publish("hub", b"payload")
            return {"granted": granted, "one": one, "forty": before - link.credit,
                    "sent": link.sent}
        finally:
            client.close()


def case_nack_requeue_releases_the_delivery(pkg):
    with Served(pkg) as server:
        client = make_client(pkg, server)
        try:
            client.publish("hub", b"flaky-job")
            msg = poll(client, "hub")
            msg.nack(True)
            again = poll(client, "hub")
            again.commit()
            return {"first": msg.value, "again": again.value,
                    "same_partition": again.metadata["partition"] == msg.metadata["partition"],
                    "after": poll(client, "hub", timeout=0.5)}
        finally:
            client.close()


def case_nack_drop_checkpoints_past_the_message(pkg):
    with Served(pkg) as server:
        client = make_client(pkg, server)
        try:
            client.publish("hub", b"poison")
            msg = poll(client, "hub")
            msg.nack(False)  # ACCEPTED: the checkpoint advances
            after = poll(client, "hub", timeout=0.5)
            checkpointed = wait_until(lambda: server.topic_depth("hub") == 0)
        finally:
            client.close()
        c2 = make_client(pkg, server)
        try:
            return {"value": msg.value, "after": after, "checkpointed": checkpointed,
                    "fresh": poll(c2, "hub", timeout=0.5)}
        finally:
            c2.close()


def case_release_resends_the_held_deliveries_behind_it(pkg):
    """A nack (RELEASED) rewinds its partition's cursor to the released
    delivery, and the server sends again every delivery behind it, those
    the client already holds included: they come twice (Queue C 48)."""
    with Served(pkg) as server:
        client = make_client(pkg, server)
        try:
            for value in (b"first", b"second"):  # one partition
                client.publish("rel", value, {"partition-key": "k"})
            msg = poll(client, "rel")
            links = client._ensure_receivers("rel")
            held = wait_until(lambda: sum(lk.queue.qsize() for lk in links) == 1)
            msg.nack(True)
            then = []
            while (m := poll(client, "rel", timeout=0.5)) is not None:
                then.append(m.value)
                m.commit()
            return {"first": msg.value, "held": held, "then": sorted(then)}
        finally:
            client.close()


def case_app_subscriber_loop_consumes(pkg):
    """The framework's subscriber loop over Event Hubs, the driver wired
    with the container's metrics as the App wires it."""
    with Served(pkg) as server:
        container = pkg.Container(pkg.MapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
        driver = pkg.eh.EventHubClient(host="127.0.0.1", port=server.port, eventhub_name="hub",
                                       consumer_group="app", partitions=2)
        container.register_datasource("pubsub", driver)
        manager = pkg.Manager(container)
        seen = []
        manager.register("events", lambda ctx: seen.append(ctx.bind(str)))
        pub = make_client(pkg, server, group="producer")
        consumer = manager._consumers["events"]

        async def scenario():
            await manager.start()
            try:
                for i in range(3):
                    pub.publish("events", f"evt-{i}".encode())
                assert await until(lambda: len(seen) >= 3), f"only saw {seen}"
                await until(lambda: consumer.delivered >= 3)
                return await until(lambda: server.topic_depth("events", "app") == 0, 5)
            finally:
                await manager.stop()

        try:
            drained = asyncio.run(scenario())
            m = container.metrics_manager
            return {"seen": sorted(seen), "delivered": consumer.delivered, "drained": drained,
                    "subscribe_total": m.get("app_pubsub_subscribe_total_count").value(
                        {"topic": "events"}),
                    "subscribe_success": m.get("app_pubsub_subscribe_success_count").value(
                        {"topic": "events"})}
        finally:
            pub.close()
            driver.close()


CASES = {
    "publish_subscribe_roundtrip": (case_publish_subscribe_roundtrip, {
        "value": b"first order", "kind": "t", "partition_ok": True,
        "keys": ["kind", "partition"]}),
    "sasl_plain_identity_reaches_server": (case_sasl_plain_identity_reaches_server, {
        "attempts": [("PLAIN", "keyname")], "hub": "hub"}),
    "round_robin_spreads_partitions": (case_round_robin_spreads_partitions, {
        "partitions": ["0", "1"], "values": [b"m0", b"m1", b"m2", b"m3"]}),
    "partition_key_pins_partition": (case_partition_key_pins_partition, {"partitions": 1}),
    "uncommitted_messages_redeliver": (case_uncommitted_messages_redeliver, {
        "first": b"job-1", "again": b"job-1", "drained": True}),
    "committed_messages_stay_consumed": (case_committed_messages_stay_consumed, {
        "value": b"d1", "checkpointed": True, "after_reconnect": None}),
    "topic_management_contract": (case_topic_management_contract, {
        "carve_out": [], "errors": ["topic creation is not supported in Event Hub",
                                    "topic deletion is not supported in Event Hub"]}),
    "health_up_and_down": (case_health_up_and_down, {
        "up": "UP", "backend": "EVENTHUB", "partitions": 2,
        "details": ["backend", "consumer_group", "eventhub", "host", "partitions"],
        "down": "DOWN", "error": True}),
    "backend_switch_builds_eventhub": (case_backend_switch_builds_eventhub, {
        "type": True, "value": b"x", "group": "switch", "hub": "hub"}),
    "publish_respects_link_credit": (case_publish_respects_link_credit, {
        "granted": True, "one": 1, "forty": 40, "sent": 40}),
    "nack_requeue_releases_the_delivery": (case_nack_requeue_releases_the_delivery, {
        "first": b"flaky-job", "again": b"flaky-job", "same_partition": True, "after": None}),
    "nack_drop_checkpoints_past_the_message": (case_nack_drop_checkpoints_past_the_message, {
        "value": b"poison", "after": None, "checkpointed": True, "fresh": None}),
    "release_resends_the_held_deliveries_behind_it": (
        case_release_resends_the_held_deliveries_behind_it, {
            "first": b"first", "held": True, "then": [b"first", b"second", b"second"]}),
    "app_subscriber_loop_consumes": (case_app_subscriber_loop_consumes, None),
}
LOOP = {"seen": ["evt-0", "evt-1", "evt-2"], "delivered": 3, "drained": True}


def _check_loop(got, client_side):
    """The subscriber loop counts a subscribe per delivery and a success per
    commit; the reference's driver adds a subscribe per poll, empty ones
    included, and a success per delivery (Queue C 46)."""
    counts = {k: got.pop(k) for k in ("subscribe_total", "subscribe_success")}
    assert got == LOOP
    if client_side == "port":
        assert counts == {"subscribe_total": 3, "subscribe_success": 3}
    else:
        assert counts["subscribe_success"] == 6 and counts["subscribe_total"] > 3


@pytest.mark.parametrize("case", list(CASES))
def test_case_equals_the_reference(case):
    """Each package's client against its own server: the same observables,
    and those the reference's test asserts."""
    fn, want = CASES[case]
    got = {side: fn(pair(side, side)) for side in ("ref", "port")}
    if want is None:
        for side in ("ref", "port"):
            _check_loop(got[side], side)
    else:
        assert got["port"] == got["ref"] == want


@pytest.mark.parametrize("client_side,server_side", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("case", list(CASES))
def test_case_cross_wire(case, client_side, server_side):
    """One package's client against the other package's server gives what
    the reference's test asserts."""
    fn, want = CASES[case]
    got = fn(pair(client_side, server_side))
    if want is None:
        _check_loop(got, client_side)
    else:
        assert got == want
