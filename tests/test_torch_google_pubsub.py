"""The port's Google Pub/Sub driver and fake (``gofr_tpu_torch/pubsub/
google.py`` and ``testutil/google_pubsub.py``, over the port's own gRPC
wire) held to the JAX package's (``tests/test_google_pubsub.py``), on the CPU.

Every case of the reference's test file runs on each client × fake pair:
the port's client against the port's fake and against the reference's
grpcio fake, and the reference's grpcio client against the port's fake (the
reference's own pair beside them): topic and subscription management,
attribute metadata, ack-deadline redelivery, independent groups, the
backlog probe, topic admin and health, the nack paths. Then a Pull and a
Publish larger than 64 KiB (flow control both ways), the Pull long-poll
that returns a message published while it waits, a dark endpoint's DOWN
health, the ``PUBSUB_BACKEND=GOOGLE`` switch, and the port's subscriber
loop end to end through the driver."""

import asyncio
import time

import pytest

pytest.importorskip("grpc")

from gofr_tpu.datasource.pubsub.google import GooglePubSubClient as RClient  # noqa: E402
from gofr_tpu.testutil.google_pubsub import GooglePubSubServer as RServer  # noqa: E402

from gofr_tpu_torch.config import MapConfig  # noqa: E402
from gofr_tpu_torch.pubsub import build_pubsub  # noqa: E402
from gofr_tpu_torch.pubsub.google import GooglePubSubClient as TClient  # noqa: E402
from gofr_tpu_torch.testutil.google_pubsub import GooglePubSubServer as TServer  # noqa: E402

PAIRS = [("ref", "ref"), ("port", "port"), ("port", "ref"), ("ref", "port")]
IDS = [f"{c}-client-{s}-fake" for c, s in PAIRS]
CLIENTS = {"ref": RClient, "port": TClient}


@pytest.fixture(scope="module")
def fakes():
    out = {"ref": RServer(), "port": TServer()}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(params=PAIRS, ids=IDS)
def pair(request, fakes):
    client_side, fake_side = request.param
    made = []

    def make_client(group="g1", **kw):
        c = CLIENTS[client_side](endpoint=fakes[fake_side].address, project=f"proj-{client_side}",
                                 consumer_group=group, **kw)
        c.connect()
        made.append(c)
        return c

    yield make_client
    for c in made:
        c.close()


def test_publish_subscribe_roundtrip(pair):
    c = pair()
    c.create_topic("orders")  # subscription sees messages published after it
    c.subscribe("orders")
    c.publish("orders", b"o-1", {"trace": "t1"})
    c.publish("orders", b"o-2")
    m1 = c.subscribe("orders")
    assert (m1.value, m1.metadata) == (b"o-1", {"trace": "t1"})
    assert m1.message_id
    m1.commit()
    m2 = c.subscribe("orders")
    assert m2.value == b"o-2"
    m2.commit()
    assert c.subscribe("orders") is None


def test_unacked_message_redelivered_after_deadline(pair):
    c = pair(group="redeliver", ack_deadline_seconds=1)
    c.create_topic("jobs")
    c.subscribe("jobs")  # ensure subscription before publish
    c.publish("jobs", b"job-1")
    m = c.subscribe("jobs")
    assert m.value == b"job-1"
    # NOT committed: nothing visible until the deadline lapses
    assert c.subscribe("jobs") is None
    time.sleep(1.1)
    m2 = c.subscribe("jobs")
    assert m2 is not None and m2.value == b"job-1", "at-least-once redelivery"
    assert m2.message_id == m.message_id
    m2.commit()
    assert c.subscribe("jobs") is None


def test_groups_are_independent_subscriptions(pair):
    a = pair(group="ga")
    b = pair(group="gb")
    a.create_topic("fan")
    a.subscribe("fan")
    b.subscribe("fan")
    a.publish("fan", b"x")
    ma, mb = a.subscribe("fan"), b.subscribe("fan")
    assert ma.value == b"x" and mb.value == b"x", "each group gets a copy"
    ma.commit(), mb.commit()


def test_backlog_counts_without_consuming(pair):
    c = pair(group="lag")
    c.create_topic("lagt")
    c.subscribe("lagt")
    for i in range(3):
        c.publish("lagt", f"m{i}".encode())
    assert c.backlog("lagt") == 3
    # the probe nacked everything: all 3 still deliverable
    seen = []
    for _ in range(3):
        m = c.subscribe("lagt")
        seen.append(m.value)
        m.commit()
    assert sorted(seen) == [b"m0", b"m1", b"m2"]


def test_topic_admin_and_health(pair):
    c = pair(group="admin")
    c.create_topic("adm")
    health = c.health_check()
    assert health["status"] == "UP"
    assert health["details"]["backend"] == "google"
    assert health["details"]["topics"] >= 1
    c.delete_topic("adm")
    c.delete_topic("adm")  # idempotent


def test_nack_requeue_via_zero_ack_deadline(pair):
    """The native Pub/Sub nack: ModifyAckDeadline(0) → immediate
    redelivery; drop acknowledges."""
    c = pair(group="nackers")
    c.create_topic("retry")
    c.subscribe("retry")
    c.publish("retry", b"try-again")
    msg = c.subscribe("retry")
    assert msg is not None and msg.value == b"try-again"
    msg.nack(True)
    deadline = time.time() + 5
    again = None
    while again is None and time.time() < deadline:
        again = c.subscribe("retry")
    assert again is not None and again.value == b"try-again"
    again.commit()
    assert c.backlog("retry") == 0


def test_nack_drop_acknowledges(pair):
    c = pair(group="droppers")
    c.create_topic("dropt")
    c.subscribe("dropt")
    c.publish("dropt", b"dead")
    msg = c.subscribe("dropt")
    assert msg is not None
    msg.nack(False)
    assert c.backlog("dropt") == 0


def test_pull_and_publish_past_64kib(pair):
    """Forty 4 KiB messages pulled in one response (160 KiB) and one 200 KiB
    publish: both directions of each call ride the peers' WINDOW_UPDATEs."""
    c = pair(group="bulk")
    c.create_topic("bulk")
    c.subscribe("bulk")
    payloads = [bytes([i]) * 4096 for i in range(40)]
    for p in payloads:
        c.publish("bulk", p)
    big = bytes(range(256)) * 800
    c.publish("bulk", big)
    assert c.backlog("bulk") == 41  # one Pull of all 41 (~365 KiB), then a nack
    got = []
    for _ in range(41):
        m = c.subscribe("bulk")
        got.append(m.value)
        m.commit()
    assert sorted(got) == sorted(payloads + [big])


def test_health_down_when_endpoint_dark():
    for cls in (RClient, TClient):
        c = cls(endpoint="127.0.0.1:1", connect_timeout=0.3)
        health = c.health_check()
        assert health["status"] == "DOWN"
        c.close()


def test_port_fake_pull_long_polls(fakes):
    """A Pull that finds nothing waits up to ``long_poll_s`` for a publish:
    a message published while it waits comes back in that Pull."""
    fake = TServer(long_poll_s=2.0)
    try:
        sub = TClient(endpoint=fake.address, project="lp", consumer_group="lp")
        pub = TClient(endpoint=fake.address, project="lp", consumer_group="lp")
        sub.connect(), pub.connect()
        sub.create_topic("lp")
        sub.subscribe("lp")  # long-polls, empty
        timer = __import__("threading").Timer(0.3, lambda: pub.publish("lp", b"late"))
        timer.start()
        t0 = time.monotonic()
        m = sub.subscribe("lp")
        waited = time.monotonic() - t0
        timer.join()
        assert m is not None and m.value == b"late"
        assert 0.2 < waited < 1.9
        m.commit()
        sub.close(), pub.close()
    finally:
        fake.close()


def test_build_pubsub_backend_switch(fakes):
    cfg = MapConfig({"PUBSUB_BACKEND": "GOOGLE", "GOOGLE_PUBSUB_ENDPOINT": fakes["port"].address,
                     "GOOGLE_PROJECT_ID": "testproj", "CONSUMER_ID": "switch",
                     "GOOGLE_PUBSUB_ACK_DEADLINE_SECONDS": "7"}, use_env=False)
    c = build_pubsub(cfg)
    assert isinstance(c, TClient)
    assert (c.project, c.consumer_group, c.ack_deadline_seconds) == ("testproj", "switch", 7)
    c.connect()
    c.close()
    from gofr_tpu_torch.pubsub import InMemoryBroker

    assert isinstance(build_pubsub(MapConfig({"PUBSUB_BACKEND": "MEMORY"}, use_env=False)),
                      InMemoryBroker)
    assert build_pubsub(MapConfig({}, use_env=False)) is None
    with pytest.raises(ValueError):
        build_pubsub(MapConfig({"PUBSUB_BACKEND": "CARRIER_PIGEON"}, use_env=False))


@pytest.mark.parametrize("fake_side", ["port", "ref"])
def test_subscriber_loop_end_to_end(fakes, fake_side):
    """The port's subscriber loop consumes through the Google driver: the
    handler runs with a normal Context, commit-on-success."""
    from gofr_tpu_torch.subscriber import SubscriptionManager
    from gofr_tpu_torch.testutil import new_mock_container

    container, _ = new_mock_container()
    client = TClient(endpoint=fakes[fake_side].address, project="loop", consumer_group="loop")
    client.connect()
    client.create_topic("asr")
    client.subscribe("asr")  # ensure subscription exists before publishes
    container.pubsub = client

    got = []

    async def scenario():
        done = asyncio.Event()

        def handler(ctx):
            got.append(ctx.bind(dict))
            if len(got) >= 2:
                done.set()
            return None

        mgr = SubscriptionManager(container)
        mgr.register("asr", handler)
        await mgr.start()
        try:
            client.publish("asr", b'{"audio": "a1"}')
            client.publish("asr", b'{"audio": "a2"}')
            await asyncio.wait_for(done.wait(), timeout=20)
        finally:
            await mgr.stop()
            client.close()

    asyncio.run(scenario())
    assert {g["audio"] for g in got} == {"a1", "a2"}
