"""The port's supervised consumer runtime (``gofr_tpu_torch/subscriber.py``)
and delivery policy (``pubsub/delivery.py``) beside the JAX package's: the
reference's ten ``SubscriptionManager`` cases of
``tests/test_pubsub_delivery.py`` (a poison message dead-lettered while the
topic flows, a transient failure, the success metric after the commit, the
bounded idle poll, consumer health, the restart budget, a subscribe error,
a handler that settles itself, a publish fault through the context, a DLQ
that never chains) run on each package's in-memory broker with the same
observables; the policy's config and backoff ladder; and a generation
consumer on each package's ``App`` over a tiny engine, with a
``pubsub.handler`` fault and a poison job, over each ``PUBSUB_BACKEND``
(the in-memory broker, and Kafka, NATS, MQTT and Event Hubs each on its
package's own fake): the same results, redeliveries and dead letters."""

import asyncio
import json
import time
import types

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import gofr_tpu  # noqa: E402
import gofr_tpu.subscriber as rsub  # noqa: E402
import gofr_tpu_torch.subscriber as tsub  # noqa: E402
from gofr_tpu import chaos as rchaos  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.container.container import Container as RContainer  # noqa: E402
from gofr_tpu.datasource.pubsub import InMemoryBroker as RBroker  # noqa: E402
from gofr_tpu.datasource.pubsub import delivery as rdelivery  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.container.container import Container as TContainer  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.pubsub import InMemoryBroker as TBroker  # noqa: E402
from gofr_tpu_torch.pubsub import delivery as tdelivery  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, start_app, stop_app  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(sub=rsub, chaos=rchaos, delivery=rdelivery, Broker=RBroker,
                                 Container=RContainer, MapConfig=RMapConfig, App=gofr_tpu.App),
    "port": types.SimpleNamespace(sub=tsub, chaos=tchaos, delivery=tdelivery, Broker=TBroker,
                                  Container=TContainer, MapConfig=TMapConfig, App=TApp),
}


def make_manager(pkg, configs: dict | None = None):
    container = pkg.Container(pkg.MapConfig({"APP_NAME": "sub", "LOG_LEVEL": "FATAL",
                                             **(configs or {})}, use_env=False))
    broker = pkg.Broker(poll_timeout=0.02)
    container.register_datasource("pubsub", broker)
    mgr = pkg.sub.SubscriptionManager(container)
    mgr._rng.seed(0)
    return container, broker, mgr


async def drain_until(predicate, timeout: float = 15.0, interval: float = 0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval)
    return False


def _metric(container, name: str, topic: str) -> float:
    return container.metrics_manager.get(name).value({"topic": topic})


# ------------------------------------------------- the reference's ten cases
def case_poison_message_lands_in_dlq_and_topic_keeps_flowing(pkg):
    container, broker, mgr = make_manager(pkg, {"PUBSUB_T_MAX_ATTEMPTS": "3",
                                                "PUBSUB_RETRY_BACKOFF_SECONDS": "0.01"})
    deliveries, good = [], []

    def handler(ctx):
        value = ctx.request.value
        deliveries.append(value)
        if value == b"poison":
            raise ValueError("cannot digest this")
        good.append(value)

    mgr.register("T", handler)

    async def scenario():
        broker.publish("T", b"poison")
        broker.publish("T", b"wholesome")
        await mgr.start()
        try:
            assert await drain_until(lambda: b"wholesome" in good)
            assert await drain_until(lambda: mgr._consumers["T"].dlq == 1)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    dead = broker.subscribe("T.dlq")
    d = pkg.delivery
    return {"poison_deliveries": deliveries.count(b"poison"), "dead": dead.value,
            "source": dead.metadata[d.DLQ_SOURCE_TOPIC_KEY],
            "attempts": dead.metadata[d.DLQ_ATTEMPTS_KEY],
            "error": "cannot digest" in dead.metadata[d.DLQ_ERROR_KEY],
            "ts_ordered": float(dead.metadata[d.DLQ_FIRST_TS_KEY])
            <= float(dead.metadata[d.DLQ_LAST_TS_KEY]),
            "backlog": broker.backlog("T"),
            "dlq_total": _metric(container, "app_pubsub_dlq_total", "T"),
            "redeliveries": _metric(container, "app_pubsub_redeliveries_total", "T")}


def case_transient_failure_recovers_without_dlq(pkg):
    container, broker, mgr = make_manager(pkg, {"PUBSUB_RETRY_BACKOFF_SECONDS": "0.01"})
    seen, done, attempts_seen = {"n": 0}, [], []

    def handler(ctx):
        seen["n"] += 1
        attempts_seen.append(ctx.request.metadata[pkg.delivery.ATTEMPTS_KEY])
        if seen["n"] < 3:
            raise TimeoutError("downstream flapped")
        done.append(ctx.request.value)

    mgr.register("jobs", handler)

    async def scenario():
        broker.publish("jobs", b"job-1")
        await mgr.start()
        try:
            assert await drain_until(lambda: done)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    c = mgr._consumers["jobs"]
    return {"done": done, "attempts_seen": attempts_seen, "dlq": c.dlq,
            "dlq_topic": broker.subscribe("jobs.dlq"), "redeliveries": c.redeliveries,
            "tracked": c.attempts}


def case_success_metric_counts_only_after_commit_succeeds(pkg):
    container, broker, mgr = make_manager(pkg, {"PUBSUB_RETRY_BACKOFF_SECONDS": "0.01"})
    handled = []
    mgr.register("q", lambda ctx: handled.append(ctx.request.value))
    fail_once = {"left": 1}
    real_subscribe = broker.subscribe

    def flaky_subscribe(topic):
        msg = real_subscribe(topic)
        if msg is None or topic != "q":
            return msg
        real_committer = msg._committer

        def maybe_fail_commit():
            if fail_once["left"] > 0:
                fail_once["left"] -= 1
                raise ConnectionError("commit lost")
            real_committer()

        msg._committer = maybe_fail_commit
        return msg

    broker.subscribe = flaky_subscribe

    async def scenario():
        broker.publish("q", b"m")
        await mgr.start()
        try:
            assert await drain_until(lambda: broker.backlog("q") == 0 and len(handled) >= 2,
                                     timeout=45)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    return {"success": _metric(container, "app_pubsub_subscribe_success_count", "q"),
            "commit_fail": _metric(container, "app_pubsub_commit_fail_count", "q"),
            "commit_failures": mgr._consumers["q"].commit_failures}


def case_idle_poll_is_bounded_not_a_busy_spin(pkg):
    container = pkg.Container(pkg.MapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))

    class InstantNone:
        def __init__(self):
            self.polls = 0

        def subscribe(self, topic):
            self.polls += 1
            return None

    client = InstantNone()
    container.pubsub = client
    mgr = pkg.sub.SubscriptionManager(container)
    mgr.register("idle", lambda ctx: None)

    async def scenario():
        await mgr.start()
        await asyncio.sleep(0.3)
        await mgr.stop()

    asyncio.run(scenario())
    return {"bounded": 1 <= client.polls <= 12}


def case_consumer_state_in_container_health(pkg):
    container, broker, mgr = make_manager(pkg)
    mgr.register("t1", lambda ctx: None)
    out = {}

    async def scenario():
        await mgr.start()
        try:
            assert await drain_until(lambda: mgr._consumers["t1"].state == pkg.sub.RUNNING)
            health = container.health()
            consumers = health["details"]["pubsub_consumers"]
            out.update(status=consumers["status"], snap=consumers["details"]["topics"]["t1"],
                       overall=health["status"])
        finally:
            await mgr.stop()
        out["after_stop"] = mgr._consumers["t1"].state

    asyncio.run(scenario())
    return out


def case_supervisor_restarts_crashed_loop_then_parks_it(pkg, monkeypatch):
    sub = pkg.sub
    container, broker, mgr = make_manager(pkg)
    mgr.register("doomed", lambda ctx: None)
    crashes = {"n": 0}

    async def crashing_loop(consumer):
        crashes["n"] += 1
        raise RuntimeError("loop bug")

    mgr._loop = crashing_loop
    monkeypatch.setattr(sub, "ERROR_BACKOFF_SECONDS", 0.01)

    async def scenario():
        await mgr.start()
        try:
            assert await drain_until(lambda: crashes["n"] > sub.MAX_CONSECUTIVE_RESTARTS
                                     and mgr._consumers["doomed"].state == sub.STOPPED,
                                     timeout=10)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    return {"crashes": crashes["n"], "restarts": mgr._consumers["doomed"].restarts,
            "health": mgr.health()["status"], "parked": mgr._consumers["doomed"].parked}


def case_subscribe_error_backs_off_and_recovers(pkg, monkeypatch):
    container, broker, mgr = make_manager(pkg)
    state = {"fail": 2}
    real_subscribe = broker.subscribe

    def flaky(topic):
        if state["fail"] > 0:
            state["fail"] -= 1
            raise ConnectionError("broker hiccup")
        return real_subscribe(topic)

    broker.subscribe = flaky
    got = []
    mgr.register("r", lambda ctx: got.append(ctx.request.value))
    monkeypatch.setattr(pkg.sub, "ERROR_BACKOFF_SECONDS", 0.01)

    async def scenario():
        broker.publish("r", b"after-the-storm")
        await mgr.start()
        try:
            assert await drain_until(lambda: got)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    return {"got": got, "restarts": mgr._consumers["r"].restarts}


def case_handler_settled_message_is_not_double_settled(pkg):
    container, broker, mgr = make_manager(pkg)
    settled = []

    def handler(ctx):
        msg = ctx.request
        real = msg._committer
        msg._committer = lambda: settled.append("broker-commit") or real()
        msg.commit()

    mgr.register("manual", handler)

    async def scenario():
        broker.publish("manual", b"m")
        await mgr.start()
        try:
            assert await drain_until(lambda: broker.backlog("manual") == 0)
            await asyncio.sleep(0.05)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    return {"settled": settled}


def case_publish_fault_surfaces_typed_retriable_through_context(pkg):
    container, broker, mgr = make_manager(pkg, {"PUBSUB_RETRY_BACKOFF_SECONDS": "0.01"})
    caught = []

    def handler(ctx):
        try:
            ctx.get_publisher().publish("downstream", ctx.request.value)
        except pkg.chaos.ChaosFault as exc:
            caught.append((exc.point, exc.retriable))
            raise

    mgr.register("up", handler)
    inj = pkg.chaos.ChaosInjector(5, {"pubsub.publish": 1.0}, max_faults=1)

    async def scenario():
        broker.publish("up", b"payload")
        await mgr.start()
        try:
            with pkg.chaos.active(inj):
                assert await drain_until(
                    lambda: broker.backlog("up") == 0 and broker.backlog("downstream") > 0)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    msg = broker.subscribe("downstream")
    return {"caught": caught, "downstream": msg.value}


def case_dlq_topic_never_chains_another_dlq(pkg):
    container, broker, mgr = make_manager(pkg, {"PUBSUB_MAX_ATTEMPTS": "2",
                                                "PUBSUB_RETRY_BACKOFF_SECONDS": "0.01"})
    deliveries = []

    def bad_drainer(ctx):
        deliveries.append(ctx.request.value)
        raise RuntimeError("drainer bug")

    mgr.register("jobs.dlq", bad_drainer)

    async def scenario():
        broker.publish("jobs.dlq", b"dead-1")
        await mgr.start()
        try:
            assert await drain_until(lambda: len(deliveries) >= 4)
        finally:
            await mgr.stop()

    asyncio.run(scenario())
    return {"dlq": mgr._consumers["jobs.dlq"].dlq, "chained": broker.subscribe("jobs.dlq.dlq"),
            "backlog": broker.backlog("jobs.dlq"), "all_dead_1": set(deliveries) == {b"dead-1"}}


# each case with what the reference's test asserts of it
CASES = {
    "poison": (case_poison_message_lands_in_dlq_and_topic_keeps_flowing, {
        "poison_deliveries": 3, "dead": b"poison", "source": "T", "attempts": "3", "error": True,
        "ts_ordered": True, "backlog": 0, "dlq_total": 1, "redeliveries": 2}),
    "transient": (case_transient_failure_recovers_without_dlq, {
        "done": [b"job-1"], "attempts_seen": ["1", "2", "3"], "dlq": 0, "dlq_topic": None,
        "redeliveries": 2, "tracked": {}}),
    "success_after_commit": (case_success_metric_counts_only_after_commit_succeeds, {
        "success": 1, "commit_fail": 1, "commit_failures": 1}),
    "idle_poll": (case_idle_poll_is_bounded_not_a_busy_spin, {"bounded": True}),
    "health": (case_consumer_state_in_container_health, None),
    "restart_budget": (case_supervisor_restarts_crashed_loop_then_parks_it, {
        "crashes": 6, "restarts": 6, "health": "DOWN", "parked": True}),
    "subscribe_error": (case_subscribe_error_backs_off_and_recovers, {
        "got": [b"after-the-storm"], "restarts": 0}),
    "self_settled": (case_handler_settled_message_is_not_double_settled, {
        "settled": ["broker-commit"]}),
    "publish_fault": (case_publish_fault_surfaces_typed_retriable_through_context, {
        "caught": [("pubsub.publish", True)], "downstream": b"payload"}),
    "dlq_never_chains": (case_dlq_topic_never_chains_another_dlq, {
        "dlq": 0, "chained": None, "backlog": 1, "all_dead_1": True}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_delivery_case_equals_the_reference(case, monkeypatch):
    fn, want = CASES[case]
    kw = {"monkeypatch": monkeypatch} if "monkeypatch" in fn.__code__.co_varnames else {}
    got = {side: fn(pkg, **kw) for side, pkg in PKGS.items()}
    assert got["port"] == got["ref"]
    if want is not None:
        assert got["port"] == want
    else:
        assert got["port"]["status"] == "UP" and got["port"]["overall"] == "UP"
        assert got["port"]["snap"]["state"] == "RUNNING"
        assert got["port"]["snap"]["max_attempts"] == 5
        assert got["port"]["after_stop"] == "STOPPED"


# ------------------------------------------------------------- the policy
@pytest.mark.parametrize("values,topic", [
    ({}, "orders"),
    ({"PUBSUB_MAX_ATTEMPTS": "7", "PUBSUB_RETRY_BACKOFF_SECONDS": "0.5"}, "orders"),
    ({"PUBSUB_MAX_ATTEMPTS": "9", "PUBSUB_ASR_JOBS_MAX_ATTEMPTS": "2"}, "asr-jobs"),
    ({"PUBSUB_MAX_ATTEMPTS": "9", "PUBSUB_ASR_JOBS_MAX_ATTEMPTS": "2"}, "other"),
    ({"PUBSUB_MAX_ATTEMPTS": "0", "PUBSUB_RETRY_MULTIPLIER": "x"}, "t"),
    ({"PUBSUB_RETRY_MAX_BACKOFF_SECONDS": "1.5", "PUBSUB_T_MAX_ATTEMPTS": " 4 "}, "t"),
])
def test_policy_from_config_equals_the_reference(values, topic):
    ref = rdelivery.DeliveryPolicy.from_config(RMapConfig(values, use_env=False), topic)
    port = tdelivery.DeliveryPolicy.from_config(TMapConfig(values, use_env=False), topic)
    assert dataclass_tuple(port) == dataclass_tuple(ref)
    assert tdelivery.DeliveryPolicy.from_config(None, topic) == tdelivery.DeliveryPolicy()


def dataclass_tuple(p):
    return (p.max_attempts, p.backoff, p.multiplier, p.max_backoff, p.jitter)


def test_backoff_ladder_equals_the_reference():
    """The same seeded full-jitter draws and the same capped deterministic
    ladder, huge attempt counts included."""
    import random

    for kw in ({}, {"backoff": 1.0, "multiplier": 2.0, "max_backoff": 3.0}):
        ref, port = rdelivery.DeliveryPolicy(**kw), tdelivery.DeliveryPolicy(**kw)
        r1, r2 = random.Random(7), random.Random(7)
        attempts = [1, 2, 3, 6, 64, 1100, 10**9]
        assert [port.delay(a, r2) for a in attempts] == [ref.delay(a, r1) for a in attempts]
        det_r = rdelivery.DeliveryPolicy(**kw, jitter=False)
        det_p = tdelivery.DeliveryPolicy(**kw, jitter=False)
        assert [det_p.delay(a) for a in attempts] == [det_r.delay(a) for a in attempts]


def test_message_keys_and_dlq_names_equal_the_reference():
    for args in (("t", b"v", None, None), ("t", b"v", {"a": "1", "gofr_attempts": "3"}, None),
                 ("t", b"v", {"a": 1}, 42)):
        assert tdelivery.message_key(*args) == rdelivery.message_key(*args)
    assert tdelivery.dlq_topic("orders") == rdelivery.dlq_topic("orders") == "orders.dlq"
    assert tdelivery.is_dlq_topic("orders.dlq") and not tdelivery.is_dlq_topic("orders")
    rec = tdelivery.AttemptRecord()
    assert rec.record_delivery() == 1 and rec.record_delivery() == 2
    rec.last_error = "x" * 600
    meta = rec.dlq_metadata("orders")
    assert set(meta) == set(rdelivery.AttemptRecord().dlq_metadata("orders"))
    assert meta[tdelivery.DLQ_ATTEMPTS_KEY] == "2" and len(meta[tdelivery.DLQ_ERROR_KEY]) == 512


# ------------------------------------------------- a generation consumer
@pytest.fixture(scope="module")
def models():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    yield jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")
    torch.set_num_threads(threads)


ENGINE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), prefill_chunk_tokens=16)
JOBS = [[5, 6, 7], [40, 41, 42, 43, 44, 45], list(range(60, 80))]
BACKENDS = ["MEMORY", "KAFKA", "NATS", "MQTT", "EVENTHUB"]


def _broker_fake(side, backend):
    """(the fake, the App's configs for it, a user's client of it) of one
    package, or Nones for the in-memory broker (the test talks to the app's
    own broker then). The NATS fake's ``ack_wait`` is long enough that no
    job is redelivered for being slow: only a nack redelivers here."""
    if backend == "MEMORY":
        return None, {}, None
    if side == "ref":
        from gofr_tpu.datasource.pubsub.eventhub import EventHubClient
        from gofr_tpu.datasource.pubsub.kafka import KafkaClient
        from gofr_tpu.datasource.pubsub.mqtt import MQTTClient
        from gofr_tpu.datasource.pubsub.nats import NatsClient
        from gofr_tpu.testutil.eventhub_server import MiniEventHubServer
        from gofr_tpu.testutil.kafka_broker import MiniKafkaBroker
        from gofr_tpu.testutil.mqtt_broker import MiniMQTTBroker
        from gofr_tpu.testutil.nats_broker import MiniNatsBroker
    else:
        from gofr_tpu_torch.pubsub.eventhub import EventHubClient
        from gofr_tpu_torch.pubsub.kafka import KafkaClient
        from gofr_tpu_torch.pubsub.mqtt import MQTTClient
        from gofr_tpu_torch.pubsub.nats import NatsClient
        from gofr_tpu_torch.testutil import (MiniEventHubServer, MiniKafkaBroker, MiniMQTTBroker,
                                             MiniNatsBroker)
    if backend == "KAFKA":
        fake = MiniKafkaBroker()
        return (fake, {"PUBSUB_BROKER": fake.address, "CONSUMER_ID": "app"},
                KafkaClient(fake.address, consumer_group="user", poll_timeout=0.05))
    if backend == "NATS":
        fake = MiniNatsBroker(ack_wait=30.0)
        return fake, {"NATS_SERVER": fake.address}, NatsClient(fake.address, consumer_group="user")
    if backend == "MQTT":
        fake = MiniMQTTBroker().start()
        return (fake, {"MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(fake.port),
                       "MQTT_CLIENT_ID": "app"},
                MQTTClient("127.0.0.1", fake.port, client_id="user"))
    # four partitions, so that each job here has one to itself: a nack
    # (RELEASED) rewinds its partition's cursor, and the fake sends again every
    # delivery behind it that the client already holds, which would then be
    # served twice (Queue C 48, shown in test_torch_eventhub.py)
    fake = MiniEventHubServer(partitions=4).start()
    return (fake, {"EVENTHUB_HOST": "127.0.0.1", "EVENTHUB_PORT": str(fake.port),
                   "EVENTHUB_NAME": "hub", "EVENTHUB_PARTITIONS": "4"},
            EventHubClient(host="127.0.0.1", port=fake.port, eventhub_name="hub",
                           consumer_group="user", partitions=4))


def _subscribed(fake, backend, topic):
    """The fake holds the app's subscription to ``topic``. MQTT and NATS
    drop a publish no one has subscribed to, and the app's consumer sends
    its first SUBSCRIBE from a task of its own, which may run after the
    app answers on HTTP: a job published before it is lost (Queue C 63).
    The log-keeping brokers hold it for the consumer."""
    if backend == "MQTT":
        sess = fake._sessions.get("app")
        return sess is not None and topic in sess.subscriptions
    if backend == "NATS":
        return any(sub.subject == topic for sub in list(fake._subs))
    return True


def _generation_app(side, models, backend="MEMORY", broker_configs=None):
    jcfg, jparams, tcfg, tparams = models
    pkg = PKGS[side]
    app = pkg.App(pkg.MapConfig({
        "HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
        "HTTP_HOST": "127.0.0.1", "APP_NAME": f"gen-{side}", "LOG_LEVEL": "FATAL",
        "SHUTDOWN_GRACE_PERIOD": "5", "PUBSUB_BACKEND": backend,
        "PUBSUB_RETRY_BACKOFF_SECONDS": "0.01", "PUBSUB_GENERATE_MAX_ATTEMPTS": "3",
        **(broker_configs or {})}, use_env=False))
    if side == "ref":
        engine = JServingEngine(jcfg, jparams, JEngineConfig(**ENGINE), JByteTokenizer())
    else:
        engine = ServingEngine(tcfg, tparams, EngineConfig(**ENGINE), ByteTokenizer(),
                               device="cpu")

    async def generate_job(ctx):
        job = json.loads(ctx.request.value)
        r = await asyncio.wrap_future(engine.submit(job["prompt"], max_new_tokens=6,
                                                    temperature=0.0))
        ctx.get_publisher().publish("generate.results", json.dumps(
            {"job": job["job"], "tokens": r.token_ids, "finish_reason": r.finish_reason}).encode())

    app.subscribe("generate", generate_job)
    app.on_start(lambda ctx: engine.start())
    app.on_shutdown(engine.stop)
    return app, engine


def _serve_jobs(side, models, backend):
    """One package's generation app over ``backend``: three jobs under one
    injected ``pubsub.handler`` fault, then a poison job and a good one
    behind it. Returns the observables."""
    pkg = PKGS[side]
    fake, configs, user = _broker_fake(side, backend)
    app, engine = _generation_app(side, models, backend, configs)
    if user is not None:
        user.connect()
        for topic in ("generate.results", "generate.dlq"):
            user.subscribe(topic)  # NATS and MQTT drop what no one subscribed to
    thread = start_app(app)
    t_end = time.monotonic() + 60  # the app's consumer subscribes before the first job
    while fake is not None and not _subscribed(fake, backend, "generate") \
            and time.monotonic() < t_end:
        time.sleep(0.01)
    broker = user if user is not None else app.container.pubsub
    consumer = app.subscription_manager._consumers["generate"]
    handled = []
    real_handler = consumer.handler

    async def counting(ctx):
        handled.append(json.loads(ctx.request.value)["job"])
        return await real_handler(ctx)

    consumer.handler = counting
    try:
        def results(n):
            out, t_end = [], time.monotonic() + 120
            while len(out) < n and time.monotonic() < t_end:
                msg = broker.subscribe("generate.results")
                if msg is not None:
                    out.append(json.loads(msg.value))
                    msg.commit()
            return out

        with pkg.chaos.active(pkg.chaos.ChaosInjector(3, {"pubsub.handler": 1.0},
                                                      max_faults=1)):
            for k, p in enumerate(JOBS):
                broker.publish("generate", json.dumps({"job": k, "prompt": p}).encode())
            first = results(len(JOBS))
        after_fault = (consumer.redeliveries, consumer.dlq)
        broker.publish("generate", json.dumps({"job": "poison", "prompt": []}).encode())
        broker.publish("generate", json.dumps({"job": "after", "prompt": JOBS[0]}).encode())
        behind = results(1)
        t_end = time.monotonic() + 30  # the dead letter, and the last commit
        while (consumer.dlq < 1 or consumer.delivered < len(JOBS) + 1) \
                and time.monotonic() < t_end:
            time.sleep(0.01)
        dead, t_end = None, time.monotonic() + 30
        while dead is None and time.monotonic() < t_end:
            dead = broker.subscribe("generate.dlq")
        dead.commit()
        health = app.container.health()["details"]
        return {
            "results": sorted(first, key=lambda r: r["job"]), "behind": behind,
            "handled": sorted(map(str, handled)), "after_fault": after_fault,
            "redeliveries": consumer.redeliveries, "dlq": consumer.dlq,
            "dead": json.loads(dead.value)["job"],
            "dead_attempts": dead.metadata.get(pkg.delivery.DLQ_ATTEMPTS_KEY),
            "health": health["pubsub_consumers"]["status"],
            "broker_health": health["pubsub"]["status"], "delivered": consumer.delivered,
            "metrics": {n: _metric(app.container, n, "generate") for n in (
                "app_pubsub_subscribe_total_count", "app_pubsub_subscribe_success_count",
                "app_pubsub_redeliveries_total", "app_pubsub_dlq_total")}}
    finally:
        stop_app(app, thread)
        if user is not None:
            user.close()
            (fake.stop if backend == "MQTT" else fake.close)()


def _want(backend, side):
    """What one package's consumer shows over ``backend``. A NATS redelivery
    carries the ``Nats-Redelivered`` header; the reference's message key
    (``delivery.message_key``, used when a message has no id) keeps it, so
    there the first delivery and the rest count as two messages: the
    faulted job shows no redelivery, and the poison job is delivered 4
    times, dead-lettered at its third attempt under the second identity.
    The port's key leaves the marker out (Queue C 47). MQTT 3.1.1 carries
    no metadata, so its dead letter has no attempt count. The reference's
    MQTT driver counts each delivery a second time (Queue C 46)."""
    split = backend == "NATS" and side == "ref"
    deliveries = 9 if split else 8
    return {"after_fault": (0, 0) if split else (1, 0), "redeliveries": 2 if split else 3,
            "handled": sorted(["0", "1", "2", "after"] + ["poison"] * (deliveries - 5)),
            "dead_attempts": None if backend == "MQTT" else "3",
            "subscribe_total": deliveries * (2 if backend == "MQTT" and side == "ref" else 1)}


SUBSCRIBE_COUNTS = ("app_pubsub_subscribe_total_count", "app_pubsub_subscribe_success_count")
PER_SIDE = ("handled", "after_fault", "redeliveries", "metrics")


@pytest.mark.parametrize("backend", BACKENDS)
def test_generation_consumer_equals_the_reference(models, backend):
    """Each package's ``App`` with ``PUBSUB_BACKEND`` set to ``backend``,
    each over its own package's fake, and a generation subscriber: three
    jobs under one injected ``pubsub.handler`` fault (one redelivery, no
    dead letter), then a poison job (an empty prompt) that lands in
    ``generate.dlq`` after 3 attempts while the job behind it is served.
    The same results, dead letters and health on both, and the same
    redeliveries and metrics save where the reference is at fault: the
    subscribe counters of its MQTT and Event Hubs drivers (Queue C 46) and
    its NATS message identity (Queue C 47)."""
    got = {side: _serve_jobs(side, models, backend) for side in ("ref", "port")}
    for side, obs in got.items():
        want = _want(backend, side)
        # the injected fault fires before the handler runs: one delivery unhandled
        assert obs["handled"] == want["handled"], side
        assert (obs["after_fault"], obs["redeliveries"]) == (want["after_fault"],
                                                            want["redeliveries"]), side
        metrics = obs["metrics"]
        assert metrics["app_pubsub_redeliveries_total"] == want["redeliveries"], side
        assert metrics["app_pubsub_dlq_total"] == 1, side
        if backend == "EVENTHUB" and side == "ref":  # every poll; each delivery a success
            assert metrics["app_pubsub_subscribe_success_count"] == 4 + 8
            assert metrics["app_pubsub_subscribe_total_count"] > 2 * 8
        else:
            assert metrics["app_pubsub_subscribe_total_count"] == want["subscribe_total"], side
            assert metrics["app_pubsub_subscribe_success_count"] == 4, side
        assert obs["dead_attempts"] == want["dead_attempts"], side
    shared = [{k: v for k, v in obs.items() if k not in PER_SIDE} for obs in got.values()]
    assert shared[0] == shared[1]
    port = got["port"]
    assert [r["job"] for r in port["results"]] == [0, 1, 2]
    assert all(r["finish_reason"] == "length" and len(r["tokens"]) == 6 for r in port["results"])
    assert port["behind"][0]["tokens"] == port["results"][0]["tokens"]
    assert port["dlq"] == 1 and port["dead"] == "poison" and port["delivered"] == 4
    assert port["health"] == port["broker_health"] == "UP"


def test_redelivery_marker_is_not_part_of_the_message_key():
    """A NATS redelivery's ``Nats-Redelivered`` header: the reference's key
    of the redelivery differs from the first delivery's, the port's is the
    same (Queue C 47); every other header still counts."""
    first = {"trace": "t"}
    again = {"trace": "t", "Nats-Redelivered": "true"}
    assert rdelivery.message_key("t", b"v", first) != rdelivery.message_key("t", b"v", again)
    assert tdelivery.message_key("t", b"v", first) == tdelivery.message_key("t", b"v", again)
    assert tdelivery.message_key("t", b"v", first) == rdelivery.message_key("t", b"v", first)
    assert tdelivery.message_key("t", b"v", {"trace": "u"}) != tdelivery.message_key(
        "t", b"v", first)
