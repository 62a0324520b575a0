"""In-process google.pubsub.v1 fake — the Pub/Sub emulator analogue (a copy
of ``gofr_tpu/testutil/google_pubsub.py`` on the port's gRPC server).

Serves the wire subset in ``pubsub/protos/pubsub_v1.proto``: topic CRUD,
per-subscription cursors, **ack-deadline redelivery** (an unacked message
returns to the pool when its deadline lapses; ModifyAckDeadline(0) nacks at
once), and Pull long-polling: a Pull that finds nothing waits up to
``long_poll_s`` (within its own deadline) for a publish, a nack or a lapsed
deadline. The server runs on a loop thread of its own and its handlers in a
thread pool, as ``grpc.server(ThreadPoolExecutor)`` runs the reference's;
each accepted socket sets ``TCP_NODELAY`` (``grpcx/h2.py``).
"""

from __future__ import annotations

import asyncio
import itertools
import threading
import time
from concurrent import futures
from typing import Any

from gofr_tpu_torch.grpcx.h2 import RpcServer, StatusCode
from gofr_tpu_torch.grpcx.runtime import method_handler
from gofr_tpu_torch.pubsub.google import _P, MESSAGES


class _Subscription:
    def __init__(self, name: str, topic: str, ack_deadline_s: int) -> None:
        self.name = name
        self.topic = topic
        self.ack_deadline_s = max(0, ack_deadline_s) or 10
        self.cursor = 0  # next topic-log index to deliver fresh
        self.outstanding: dict[str, tuple[int, float]] = {}  # ack_id → (idx, deadline)
        self.redeliver: list[int] = []  # nacked/expired indexes, FIFO
        self.acked: set[int] = set()


class GooglePubSubServer:
    def __init__(self, port: int = 0, long_poll_s: float = 0.2) -> None:
        self._topics: dict[str, list[Any]] = {}  # path → [PubsubMessage]
        self._subs: dict[str, _Subscription] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._data = threading.Condition(self._lock)
        self.long_poll_s = long_poll_s
        self._pool = futures.ThreadPoolExecutor(max_workers=8, thread_name_prefix="pubsub-fake")
        self._server = RpcServer(self._handlers().get, executor=self._pool)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="google-pubsub-fake", daemon=True)
        self._thread.start()
        self.port = asyncio.run_coroutine_threadsafe(
            self._server.start("127.0.0.1", port), self._loop).result(timeout=10)

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def close(self) -> None:
        if not self._thread.is_alive():
            return
        try:
            asyncio.run_coroutine_threadsafe(self._server.stop(0.2), self._loop).result(timeout=10)
        finally:
            with self._data:
                self._data.notify_all()
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)
            self._pool.shutdown(wait=False, cancel_futures=True)
            if not self._thread.is_alive():
                self._loop.close()

    # -- wiring ------------------------------------------------------------
    def _handlers(self) -> dict[str, Any]:
        def unary(fn, in_type: str):
            return method_handler(
                "unary_unary", fn,
                request_deserializer=MESSAGES[f"{_P}.{in_type}"].FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )

        return {
            f"/{_P}.Publisher/CreateTopic": unary(self._create_topic, "Topic"),
            f"/{_P}.Publisher/DeleteTopic": unary(self._delete_topic, "DeleteTopicRequest"),
            f"/{_P}.Publisher/ListTopics": unary(self._list_topics, "ListTopicsRequest"),
            f"/{_P}.Publisher/Publish": unary(self._publish, "PublishRequest"),
            f"/{_P}.Subscriber/CreateSubscription": unary(self._create_sub, "Subscription"),
            f"/{_P}.Subscriber/DeleteSubscription": unary(self._delete_sub,
                                                          "DeleteSubscriptionRequest"),
            f"/{_P}.Subscriber/Pull": unary(self._pull, "PullRequest"),
            f"/{_P}.Subscriber/Acknowledge": unary(self._ack, "AcknowledgeRequest"),
            f"/{_P}.Subscriber/ModifyAckDeadline": unary(self._modify, "ModifyAckDeadlineRequest"),
        }

    # -- Publisher ---------------------------------------------------------
    def _create_topic(self, request: Any, context: Any) -> Any:
        with self._lock:
            if request.name in self._topics:
                context.abort(StatusCode.ALREADY_EXISTS, "topic exists")
            self._topics[request.name] = []
        return request

    def _delete_topic(self, request: Any, context: Any) -> Any:
        with self._lock:
            if self._topics.pop(request.topic, None) is None:
                context.abort(StatusCode.NOT_FOUND, "no such topic")
        return MESSAGES[f"{_P}.Empty"]()

    def _list_topics(self, request: Any, context: Any) -> Any:
        resp = MESSAGES[f"{_P}.ListTopicsResponse"]()
        with self._lock:
            for name in sorted(self._topics):
                if not request.project or name.startswith(request.project + "/"):
                    resp.topics.add(name=name)
        return resp

    def _publish(self, request: Any, context: Any) -> Any:
        resp = MESSAGES[f"{_P}.PublishResponse"]()
        with self._data:
            log = self._topics.get(request.topic)
            if log is None:
                context.abort(StatusCode.NOT_FOUND, "no such topic")
            for m in request.messages:
                mid = str(next(self._ids))
                stored = MESSAGES[f"{_P}.PubsubMessage"]()
                stored.CopyFrom(m)
                stored.message_id = mid
                stored.publish_time = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                log.append(stored)
                resp.message_ids.append(mid)
            self._data.notify_all()
        return resp

    # -- Subscriber --------------------------------------------------------
    def _create_sub(self, request: Any, context: Any) -> Any:
        with self._lock:
            if request.name in self._subs:
                context.abort(StatusCode.ALREADY_EXISTS, "subscription exists")
            if request.topic not in self._topics:
                context.abort(StatusCode.NOT_FOUND, "no such topic")
            sub = _Subscription(request.name, request.topic, request.ack_deadline_seconds)
            # Pub/Sub semantics: a new subscription sees messages published
            # AFTER it exists
            sub.cursor = len(self._topics[request.topic])
            self._subs[request.name] = sub
        return request

    def _delete_sub(self, request: Any, context: Any) -> Any:
        with self._lock:
            if self._subs.pop(request.subscription, None) is None:
                context.abort(StatusCode.NOT_FOUND, "no such subscription")
        return MESSAGES[f"{_P}.Empty"]()

    def _expire_locked(self, sub: _Subscription) -> float | None:
        """Return lapsed deliveries to the pool; the next deadline, if any."""
        now = time.monotonic()
        expired = [aid for aid, (_i, dl) in sub.outstanding.items() if dl <= now]
        for aid in expired:
            idx, _ = sub.outstanding.pop(aid)
            if idx not in sub.acked:
                sub.redeliver.append(idx)
        return min((dl for _i, dl in sub.outstanding.values()), default=None)

    def _pull(self, request: Any, context: Any) -> Any:
        resp = MESSAGES[f"{_P}.PullResponse"]()
        remaining = context.time_remaining()
        wait_until = time.monotonic() + min(self.long_poll_s, max(0.0, (remaining or 1e9) - 0.05))
        with self._data:
            sub = self._subs.get(request.subscription)
            if sub is None:
                context.abort(StatusCode.NOT_FOUND, "no such subscription")
            n = max(1, request.max_messages)
            while True:
                next_deadline = self._expire_locked(sub)
                log = self._topics.get(sub.topic, [])
                while n > 0:
                    if sub.redeliver:
                        idx = sub.redeliver.pop(0)
                    elif sub.cursor < len(log):
                        idx = sub.cursor
                        sub.cursor += 1
                    else:
                        break
                    ack_id = f"{sub.name}:{idx}:{next(self._ids)}"
                    sub.outstanding[ack_id] = (idx, time.monotonic() + sub.ack_deadline_s)
                    resp.received_messages.add(ack_id=ack_id, message=log[idx])
                    n -= 1
                now = time.monotonic()
                if resp.received_messages or now >= wait_until or not self._thread.is_alive():
                    return resp
                # long poll: a publish or a nack wakes it, a lapsing ack
                # deadline ends the wait at that deadline
                until = wait_until if next_deadline is None else min(wait_until, next_deadline)
                self._data.wait(max(0.0, until - now))

    def _ack(self, request: Any, context: Any) -> Any:
        with self._lock:
            sub = self._subs.get(request.subscription)
            if sub is None:
                context.abort(StatusCode.NOT_FOUND, "no such subscription")
            for aid in request.ack_ids:
                entry = sub.outstanding.pop(aid, None)
                if entry is not None:
                    sub.acked.add(entry[0])
        return MESSAGES[f"{_P}.Empty"]()

    def _modify(self, request: Any, context: Any) -> Any:
        """deadline 0 = nack (immediate redelivery), else extend."""
        with self._data:
            sub = self._subs.get(request.subscription)
            if sub is None:
                context.abort(StatusCode.NOT_FOUND, "no such subscription")
            for aid in request.ack_ids:
                entry = sub.outstanding.pop(aid, None)
                if entry is None:
                    continue
                idx, _ = entry
                if request.ack_deadline_seconds <= 0:
                    if idx not in sub.acked:
                        sub.redeliver.append(idx)
                else:
                    sub.outstanding[aid] = (idx, time.monotonic() + request.ack_deadline_seconds)
            self._data.notify_all()
        return MESSAGES[f"{_P}.Empty"]()

    # -- test inspection ---------------------------------------------------
    def topic_size(self, topic_path: str) -> int:
        with self._lock:
            return len(self._topics.get(topic_path, []))


def start_google_pubsub(**kw: Any) -> GooglePubSubServer:
    return GooglePubSubServer(**kw)
