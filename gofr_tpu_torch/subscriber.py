"""Pub/Sub subscription manager: the supervised consumer runtime (a copy of
``gofr_tpu/subscriber.py``).

Reference parity: pkg/gofr/subscriber.go — one task per topic
(run.go:140-151, gofr.go:152-168), an infinite poll loop with backoff on
error (subscriber.go:27-44), per-message Context built from the Message
(which implements the Request contract), panic recovery, and commit-on-
success at-least-once semantics (subscriber.go:46-81).

Beyond the reference, every topic loop is **supervised** (docs/
robustness.md "The consumer plane"):

- a handler failure nacks the message and backs off with full jitter
  instead of silently returning — the broker's at-least-once contract then
  redelivers it;
- redelivery is **bounded** by a per-topic :class:`DeliveryPolicy`; a
  message that exhausts its budget is published to ``<topic>.dlq`` with
  its failure history and committed, so a poison message can never wedge
  its topic in a redelivery hot loop;
- a crashed loop task is restarted with a restart budget; the per-topic
  consumer state (``RUNNING``/``BACKOFF``/``STOPPED``), lag and
  redelivery counts surface through ``container.health`` and the metrics
  registry (``app_pubsub_redeliveries_total``, ``app_pubsub_dlq_total``,
  ``app_pubsub_consumer_lag``, ``app_pubsub_handler_duration_seconds``).

A handler runs on the event loop the HTTP and WebSocket surfaces share: a
generation handler awaits the engine's future (``asyncio.wrap_future``)
instead of blocking on ``result()``.
"""

from __future__ import annotations

import asyncio
import random
import time
from typing import Any, Awaitable, Callable

from gofr_tpu_torch import chaos
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.pubsub.delivery import (
    ATTEMPTS_KEY,
    AttemptRecord,
    DeliveryPolicy,
    dlq_topic,
    is_dlq_topic,
    message_key,
)

ERROR_BACKOFF_SECONDS = 2.0
# a broker client that returns None without blocking on its own poll timeout must
# not spin the event loop at 100%: a bounded idle sleep, small enough that
# delivery latency stays negligible next to ERROR_BACKOFF_SECONDS
IDLE_SLEEP_SECONDS = ERROR_BACKOFF_SECONDS / 40  # 50 ms
# supervisor restart budget: consecutive loop crashes before the topic is
# parked STOPPED; a loop that stayed up this long earns its budget back
MAX_CONSECUTIVE_RESTARTS = 5
RESTART_RESET_SECONDS = 30.0
# consumer lag is polled (broker round-trips) at most this often
LAG_INTERVAL_SECONDS = 5.0
# attempt records are pruned on settle; this cap bounds the map anyway
# (e.g. commits failing forever on a broker client that only redelivers after
# restart would otherwise strand one record per message)
MAX_TRACKED_ATTEMPTS = 4096

# consumer states reported through container.health
RUNNING = "RUNNING"
BACKOFF = "BACKOFF"
STOPPED = "STOPPED"

SubscribeFunc = Callable[[Context], Any]


class _TopicConsumer:
    """Per-topic supervision state + delivery bookkeeping."""

    def __init__(self, topic: str, handler: SubscribeFunc,
                 policy: DeliveryPolicy) -> None:
        self.topic = topic
        self.handler = handler
        self.policy = policy
        self.state = STOPPED
        self.parked = False  # restart budget spent — distinct from shutdown
        self.attempts: dict[tuple, AttemptRecord] = {}
        self.lag: int | None = None
        self._next_lag_poll = 0.0
        self._lag_inflight = False
        # counters mirrored into health (the metrics registry keeps the
        # canonical series; these make health self-contained)
        self.delivered = 0
        self.redeliveries = 0
        self.dlq = 0
        self.handler_failures = 0
        self.commit_failures = 0
        self.restarts = 0

    def snapshot(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "state": self.state,
            "parked": self.parked,
            "delivered": self.delivered,
            "redeliveries": self.redeliveries,
            "dlq": self.dlq,
            "handler_failures": self.handler_failures,
            "commit_failures": self.commit_failures,
            "restarts": self.restarts,
            "max_attempts": self.policy.max_attempts,
        }
        if self.lag is not None:
            out["lag"] = self.lag
        return out


class SubscriptionManager:
    def __init__(self, container: Any) -> None:
        self.container = container
        self.subscriptions: dict[str, SubscribeFunc] = {}
        self._consumers: dict[str, _TopicConsumer] = {}
        self._tasks: list[asyncio.Task] = []
        self._stopping = False
        self._rng = random.Random()  # tests may reseed for determinism
        # health backref: container.health() reports per-topic consumer
        # state without the App having to thread the manager through
        container.subscription_manager = self

    def register(self, topic: str, handler: SubscribeFunc) -> None:
        self.subscriptions[topic] = handler
        self._consumers[topic] = _TopicConsumer(
            topic, handler,
            DeliveryPolicy.from_config(getattr(self.container, "config", None), topic),
        )

    # -- introspection (container.health / tests) ------------------------------
    def consumer_states(self) -> dict[str, dict[str, Any]]:
        return {t: c.snapshot() for t, c in self._consumers.items()}

    def health(self) -> dict[str, Any]:
        topics = self.consumer_states()
        # a parked consumer means messages accumulate unseen — that must
        # show as DOWN (the aggregate flips to DEGRADED); a consumer
        # stopped by shutdown is not a failure
        parked = any(c.parked for c in self._consumers.values())
        return {"status": "DOWN" if parked else "UP", "details": {"topics": topics}}

    # -- lifecycle -------------------------------------------------------------
    async def start(self) -> None:
        if not self.subscriptions or self._tasks:
            return  # idempotent: a second start must not double-consume
        if self.container.get_subscriber() is None:
            self.container.logger.error(
                "subscriptions registered but no PubSub configured; skipping"
            )
            return
        self._stopping = False
        for topic in self.subscriptions:
            consumer = self._consumers[topic]
            consumer.parked = False  # a fresh start earns a fresh budget
            self._tasks.append(
                asyncio.create_task(
                    self._supervise(consumer), name=f"subscriber-{topic}"
                )
            )

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        for c in self._consumers.values():
            c.state = STOPPED

    # -- supervision -----------------------------------------------------------
    async def _supervise(self, consumer: _TopicConsumer) -> None:
        """Restart a crashed topic loop with a budget: transient breakage
        (a client bug surfacing on a weird frame, a broker flapping faster than
        the in-loop backoff absorbs) heals; a hard crash loop parks the
        topic STOPPED and says so in health instead of burning CPU."""
        logger = self.container.logger
        restarts = 0
        while not self._stopping:
            consumer.state = RUNNING
            started = time.monotonic()
            try:
                await self._loop(consumer)
                break  # clean exit: stop() flipped _stopping
            except asyncio.CancelledError:
                break
            except Exception as exc:
                if time.monotonic() - started >= RESTART_RESET_SECONDS:
                    restarts = 0  # a healthy run earns the budget back
                restarts += 1
                consumer.restarts += 1
                if restarts > MAX_CONSECUTIVE_RESTARTS:
                    logger.error(
                        f"subscriber loop for {consumer.topic} crashed "
                        f"{restarts} times in a row ({exc}); restart budget "
                        f"({MAX_CONSECUTIVE_RESTARTS}) spent — parking the "
                        "topic (state=STOPPED)"
                    )
                    consumer.state = STOPPED
                    consumer.parked = True
                    return
                logger.error(
                    f"subscriber loop for {consumer.topic} crashed: {exc}; "
                    f"restart {restarts}/{MAX_CONSECUTIVE_RESTARTS}"
                )
                consumer.state = BACKOFF
                try:
                    await asyncio.sleep(ERROR_BACKOFF_SECONDS)
                except asyncio.CancelledError:
                    break
        consumer.state = STOPPED

    async def _loop(self, consumer: _TopicConsumer) -> None:
        """subscriber.go:27-44 with supervision hooks. Broker-client calls
        (subscribe here, commit/nack/publish in settlement) are blocking
        broker round-trips by contract, so they run through
        ``_call_blocking`` — one topic's poll (or a client-internal lock
        held through a flapping broker's TCP timeout) must not stall the
        event loop every other consumer shares."""
        logger = self.container.logger
        subscriber = self.container.get_subscriber()
        topic = consumer.topic
        while not self._stopping:
            self._poll_lag(consumer, subscriber)
            try:
                chaos.maybe_fail("pubsub.subscribe")
                msg = await _call_blocking(subscriber.subscribe, topic)
            except asyncio.CancelledError:
                return
            except Exception as exc:
                logger.error(f"error subscribing to topic {topic}: {exc}")
                consumer.state = BACKOFF
                await asyncio.sleep(ERROR_BACKOFF_SECONDS)
                consumer.state = RUNNING
                continue
            if msg is None:
                # bounded idle yield: a broker client with no internal poll
                # timeout must not spin the event loop at 100%
                await asyncio.sleep(IDLE_SLEEP_SECONDS)
                continue
            await self._handle(consumer, msg)

    # -- message settlement ----------------------------------------------------
    async def _handle(self, consumer: _TopicConsumer, msg: Any) -> None:
        """subscriber.go:46-81: context from message, panic recovery —
        extended with bounded redelivery and dead-lettering. Every
        delivered message is settled exactly once: committed on success,
        nacked (requeue) while the attempt budget lasts, dead-lettered +
        committed when it is spent."""
        container = self.container
        topic = consumer.topic
        metrics = container.metrics_manager
        metrics.increment_counter("app_pubsub_subscribe_total_count", topic=topic)

        record = self._record_delivery(consumer, msg)
        span = container.tracer.start_span(f"subscribe {topic}", kind="consumer")
        try:
            with span:
                ctx = Context(msg, container)
                start = time.monotonic()
                try:
                    try:
                        chaos.maybe_fail("pubsub.handler")
                        result = consumer.handler(ctx)
                        if asyncio.iscoroutine(result):
                            result = await result
                    finally:
                        metrics.record_histogram(
                            "app_pubsub_handler_duration_seconds",
                            time.monotonic() - start, topic=topic,
                        )
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    consumer.handler_failures += 1
                    record.last_error = f"{type(exc).__name__}: {exc}"
                    container.logger.error(
                        f"error in subscriber handler for topic {topic} "
                        f"(attempt {record.attempts}/{consumer.policy.max_attempts}): {exc}"
                    )
                    await self._settle_failure(consumer, msg, record)
                    return
                # the settle is ATOMIC w.r.t. cancellation: stop() racing
                # this commit used to sever the broker ack (which completes
                # in the executor regardless) from its bookkeeping — the
                # attempt record leaked and success metrics went uncounted
                # for an acked message (the test_transient_failure flake:
                # drain_until returns the instant the handler appends, so
                # stop() lands exactly inside this await)
                if not await self._run_to_settlement(self._commit(
                        consumer, msg, record, success_metric=True)):
                    # the broker will redeliver and the handler will run
                    # again — pace it like any failed attempt, never a
                    # zero-backoff hot loop
                    await self._backoff(consumer, record.attempts)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            container.logger.error(f"subscriber loop error for {topic}: {exc}")

    @staticmethod
    async def _run_to_settlement(coro: Any) -> Any:
        """Run a settlement step (commit + its bookkeeping) to completion
        even when the awaiting consumer task is cancelled mid-flight.

        The broker ack runs in the executor and completes whether or not
        the await survives; honoring the cancel immediately would sever
        the ack from the prune/metric bookkeeping that must land with it.
        ``shield`` keeps the inner step alive; on cancellation we ride it
        out (settlement is bounded: one broker ack, no backoff waits)
        and THEN re-raise so the loop still unwinds promptly."""
        task = asyncio.ensure_future(coro)
        try:
            return await asyncio.shield(task)
        except asyncio.CancelledError:
            await task
            raise

    @staticmethod
    def _key_of(topic: str, msg: Any) -> tuple:
        return message_key(topic, getattr(msg, "value", b""),
                           getattr(msg, "metadata", None),
                           getattr(msg, "message_id", None))

    def _record_delivery(self, consumer: _TopicConsumer, msg: Any) -> AttemptRecord:
        record = consumer.attempts.setdefault(
            self._key_of(consumer.topic, msg), AttemptRecord()
        )
        while len(consumer.attempts) > MAX_TRACKED_ATTEMPTS:
            # FIFO eviction (dicts iterate in insertion order): the evicted
            # message just restarts its attempt count — at-least-once holds
            consumer.attempts.pop(next(iter(consumer.attempts)))
        attempts = record.record_delivery()
        if attempts > 1:
            consumer.redeliveries += 1
            self.container.metrics_manager.increment_counter(
                "app_pubsub_redeliveries_total", topic=consumer.topic
            )
        metadata = getattr(msg, "metadata", None)
        if isinstance(metadata, dict):
            # visible to the handler; brokers that persist metadata carry it
            metadata[ATTEMPTS_KEY] = str(attempts)
        return record

    def _forget(self, consumer: _TopicConsumer, msg: Any) -> None:
        consumer.attempts.pop(self._key_of(consumer.topic, msg), None)

    async def _commit(self, consumer: _TopicConsumer, msg: Any,
                      record: AttemptRecord, *, success_metric: bool) -> bool:
        """Commit, counting the success ONLY after the broker ack went
        through — a failed commit is a distinct failure mode (the message
        redelivers), not a success. Awaits coroutine commits so external
        async broker clients keep the contract."""
        metrics = self.container.metrics_manager
        commit = getattr(msg, "commit", None)
        try:
            if callable(commit):
                await _call_blocking(commit)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            consumer.commit_failures += 1
            metrics.increment_counter(
                "app_pubsub_commit_fail_count", topic=consumer.topic
            )
            self.container.logger.error(
                f"commit failed for topic {consumer.topic}: {exc}; the "
                "broker will redeliver (at-least-once)"
            )
            return False
        if success_metric:
            metrics.increment_counter(
                "app_pubsub_subscribe_success_count", topic=consumer.topic
            )
            consumer.delivered += 1
        self._forget(consumer, msg)
        return True

    async def _settle_failure(self, consumer: _TopicConsumer, msg: Any,
                              record: AttemptRecord) -> None:
        """Handler failed: nack-with-backoff while the attempt budget
        lasts; dead-letter + commit once it is spent. EVERY path that ends
        in a redelivery backs off first — a failing DLQ publish or commit
        must pace the retry exactly like a failing handler, or a poison
        message plus a down publisher becomes a zero-backoff hot loop.

        A DLQ topic never dead-letters again: chaining would migrate
        poison into an invisible ``<t>.dlq.dlq`` nothing consumes. A
        failing DLQ-drainer handler instead keeps redelivering at the
        max-ladder pace — never lost, bounded CPU, loud in
        ``handler_failures``/``app_pubsub_redeliveries_total``."""
        if is_dlq_topic(consumer.topic):
            await self._nack_requeue(consumer, msg)
            await self._backoff(consumer, max(record.attempts,
                                              consumer.policy.max_attempts))
            return
        if record.attempts >= consumer.policy.max_attempts:
            if (
                await self._dead_letter(consumer, msg, record)
                and await self._commit(consumer, msg, record,
                                       success_metric=False)
            ):
                return
            # DLQ publish or its commit failed: the message stays on the
            # topic (never lost; the dead-letter may duplicate — documented
            # at-least-once) — requeue and pace the next attempt
        await self._nack_requeue(consumer, msg)
        await self._backoff(consumer, record.attempts)

    async def _nack_requeue(self, consumer: _TopicConsumer, msg: Any) -> None:
        try:
            nack = getattr(msg, "nack", None)
            if callable(nack):
                await _call_blocking(nack, True)
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self.container.logger.error(
                f"nack failed for topic {consumer.topic}: {exc}; relying on "
                "broker redelivery"
            )

    async def _backoff(self, consumer: _TopicConsumer, attempts: int) -> None:
        consumer.state = BACKOFF
        try:
            await asyncio.sleep(consumer.policy.delay(attempts, self._rng))
        finally:
            consumer.state = RUNNING

    async def _dead_letter(self, consumer: _TopicConsumer, msg: Any,
                           record: AttemptRecord) -> bool:
        """Publish the poison message to ``<topic>.dlq`` with its failure
        history. Returns True when the publish went through."""
        container = self.container
        publisher = container.get_publisher()
        if publisher is None:
            container.logger.error(
                f"no publisher to dead-letter {consumer.topic}; message "
                "stays on the topic"
            )
            return False
        target = dlq_topic(consumer.topic)
        metadata = {
            str(k): str(v) for k, v in (getattr(msg, "metadata", None) or {}).items()
        }
        metadata.update(record.dlq_metadata(consumer.topic))
        try:
            await _call_blocking(
                publisher.publish, target, getattr(msg, "value", b""), metadata
            )
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            container.logger.error(
                f"dead-letter publish to {target} failed: {exc}; the message "
                f"stays on {consumer.topic} for redelivery"
            )
            return False
        consumer.dlq += 1
        container.metrics_manager.increment_counter(
            "app_pubsub_dlq_total", topic=consumer.topic
        )
        container.logger.error(
            f"message on {consumer.topic} exhausted its delivery budget "
            f"({record.attempts} attempts); dead-lettered to {target}"
        )
        return True

    def _poll_lag(self, consumer: _TopicConsumer, subscriber: Any) -> None:
        """Consumer lag via the broker client's ``backlog``, rate-limited and run
        in the executor — the kafka implementation costs broker round-trips
        (and a flapping broker a full TCP timeout), which must not stall
        the event loop the other topic consumers share."""
        now = time.monotonic()
        if now < consumer._next_lag_poll or consumer._lag_inflight:
            return
        backlog = getattr(subscriber, "backlog", None)
        if not callable(backlog):
            return
        consumer._next_lag_poll = now + LAG_INTERVAL_SECONDS
        consumer._lag_inflight = True
        try:
            future = asyncio.get_running_loop().run_in_executor(
                None, backlog, consumer.topic
            )
        except BaseException:
            # a rejecting/shut-down executor must not strand the flag —
            # the consumer may outlive this failure via supervisor restart
            consumer._lag_inflight = False
            raise

        def _done(f: Any) -> None:
            consumer._lag_inflight = False
            try:
                # gofrlint: disable=cancel-unreachable,unbounded-wire-call -- runs as add_done_callback: the future is already settled, result() cannot block
                consumer.lag = int(f.result())
            except Exception:
                return  # broker unreachable: keep the last known lag
            self.container.metrics_manager.set_gauge(
                "app_pubsub_consumer_lag", float(consumer.lag),
                topic=consumer.topic,
            )

        future.add_done_callback(_done)


async def _maybe_await(value: Any) -> Any:
    if isinstance(value, Awaitable):
        return await value
    return value


async def _call_blocking(fn: Any, *args: Any) -> Any:
    """Run a broker-client call off the event loop. Its commit/nack/publish
    are blocking broker round-trips by contract (and may block on a
    client-internal lock held through a flapping broker's TCP timeout) —
    the same reason ``subscribe`` runs in the executor. Async clients are
    awaited directly."""
    if asyncio.iscoroutinefunction(fn):
        return await fn(*args)
    result = await asyncio.get_running_loop().run_in_executor(
        None, lambda: fn(*args)
    )
    return await _maybe_await(result)
