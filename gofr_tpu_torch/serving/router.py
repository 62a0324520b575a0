"""The multi-replica router tier: prefix-affinity routing with failover (a
copy of ``gofr_tpu/serving/router.py`` over the port's errors, chaos tier,
metrics and tracing; the port imports nothing of the JAX package).

What the port holds: ``RouterConfig``, ``prefix_affinity_key``,
``_HashRing`` (the reference's blake2b digests, so the same prompt lands on
the same replica id on either side), ``LocalReplica``, ``HTTPReplica`` (a
replica behind its HTTP surface: a breaker-only service client whose
breaker feeds membership, token streaming over ``serving/remote.py``, the
remote cancel wire, resume and ``fetch_kv`` for a ``KVMigrator`` peer) and
``Router``. ``RETRIABLE_ERRORS`` names the port's classes, and
``serving/remote.error_from_status`` rebuilds them from a replica's
status, so a failover decision (``isinstance(exc, RETRIABLE_ERRORS)``) is
taken the same way on what a port engine raises in-process and on what a
remote one answered.

One engine process serves one accelerator; millions of users need N of
them (ROADMAP item 3). This router fronts N replicas and makes the tier
survive the death, drain, or wedge of any individual replica with no
lost requests and bounded failover latency (AIBrix, arXiv:2504.03648 —
cache-aware routing + health-driven replica management is what turns a
fast engine into a serving *system*).

Four planes, each reusing a robustness layer of the engine tier:

- **Membership** (serving/membership.py): replicas heartbeat over the
  pubsub layer; missed beats → SUSPECT → DOWN, breaker-open → DOWN now.
  DRAINING/WEDGED replicas receive zero new routes.
- **Prefix affinity**: requests hash by prompt prefix onto a consistent
  ring (vnodes per replica), so repeated prefixes land on the replica
  whose ``prefix_cache.py`` already holds their prefill — falling back
  to least-estimated-wait when the affine replica is unhealthy or its
  shed queue-wait EWMA exceeds the spill bound. Affinity is a hint, not
  an invariant: spilling costs one prefill, routing to a dead replica
  costs the request.
- **Failover & hedging**: a replica failing a request *before its first
  token* (503/UNAVAILABLE + Retry-After — the warm-restart
  contract) re-routes to the next candidate with the original absolute
  deadline preserved. A request that already streamed tokens is NEVER
  silently re-run (the stream is not idempotent): the client gets the
  typed retriable error and decides. Optionally the *prefill admission*
  is hedged on a second replica after a p99-based delay; first token
  wins, the loser is canceled before it streams.
- **Observability**: per-replica ``app_router_replica_state``,
  ``app_router_failovers_total``, ``app_router_hedges_total``, aggregate
  queue-wait, and the ``/routerz`` view (serving/handlers.py).

The invariant the chaos tier (tests/test_router_chaos.py) enforces:
*every accepted request reaches exactly one terminal state on exactly
one replica, within its deadline or with a retriable error.*
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable

from gofr_tpu_torch import chaos
from gofr_tpu_torch.chaos.injector import ChaosFault
from gofr_tpu_torch.errors import (
    CircuitBreakerError,
    ErrorDeadlineExceeded,
    ErrorEntityNotFound,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.metrics.register import Histogram
from gofr_tpu_torch.serving import membership as ms
from gofr_tpu_torch.serving.prefix_index import (
    KV_WIRE_CONTENT_TYPE,
    PrefixIndex,
    decode_entries_binary,
    decode_entry,
)
from gofr_tpu_torch.tracing.trace import current_span, format_traceparent

# The typed-retriable error set: ONLY these may trigger a failover
# re-route or be swallowed while a better attempt lives. Everything else
# (400s, 413, deadline, programming errors) propagates to the client
# untouched — retrying a non-retriable error duplicates work at best and
# output at worst. gofrlint's ``router-retry-untyped`` rule pins this:
# except clauses in the retry-zone functions must name only this set.
RETRIABLE_ERRORS = (
    ErrorServiceUnavailable,   # 503 + Retry-After: warm restart / drain
    ErrorTooManyRequests,      # 429 shed: another replica may have room
    CircuitBreakerError,       # breaker open: the replica is gone
    ChaosFault,                # injected transient (chaos tier)
    ConnectionError,           # transport reset to a remote replica
    # 409 stale fence: THIS router's view of the replica lagged a warm
    # restart / reclaim / re-register (docs/robustness.md "The HA
    # plane"). The engine wire must hard-reject (a zombie router cannot
    # be allowed through), but for a merely-lagging router the right
    # move is a re-route — each attempt re-stamps fence_epoch from the
    # membership table, so the retry carries the refreshed fence.
    ErrorStaleEpoch,
)


@dataclasses.dataclass
class RouterConfig:
    """Every knob env-tunable, like EngineConfig (docs/robustness.md has
    the full table)."""

    heartbeat_s: float = 1.0
    suspect_after_s: float | None = None   # default: 3 × heartbeat_s
    down_after_s: float | None = None      # default: 10 × heartbeat_s
    # affine replica's queue-wait EWMA above this → spill to the
    # least-loaded healthy replica (0 disables spilling)
    spill_wait_s: float = 1.0
    # prompt units (tokens for id lists, utf-8 bytes for strings) that
    # define the affinity prefix — long enough to separate system
    # prompts, short enough that a trailing user turn doesn't break
    # affinity
    affinity_prefix_tokens: int = 32
    vnodes: int = 64               # ring positions per replica
    max_failovers: int = 3         # re-routes per request
    # hedge the prefill admission on a second replica when the first
    # token hasn't arrived after this many seconds (0 disables hedging)
    hedge_delay_s: float = 0.0
    # with enough TTFT observations, the hedge delay floors at the
    # observed p99 — hedging inside normal latency doubles prefill load
    # for nothing
    hedge_from_p99: bool = True
    # affine replica's reported HBM headroom (membership heartbeat
    # hbm_free_frac, fed by the device-telemetry poller) below this
    # fraction → spill like queue-wait pressure; 0 disables. Replicas
    # that report no HBM signal are never spilled on it.
    spill_hbm_frac: float = 0.05
    heartbeat_topic: str = ms.HEARTBEAT_TOPIC

    def __post_init__(self) -> None:
        if self.suspect_after_s is None:
            self.suspect_after_s = 3.0 * self.heartbeat_s
        if self.down_after_s is None:
            self.down_after_s = 10.0 * self.heartbeat_s

    @classmethod
    def from_config(cls, config: Any) -> "RouterConfig":
        hb = float(config.get_or_default("TPU_ROUTER_HEARTBEAT_S", "1.0"))
        suspect = config.get("TPU_ROUTER_SUSPECT_AFTER_S")
        down = config.get("TPU_ROUTER_DOWN_AFTER_S")
        return cls(
            heartbeat_s=hb,
            suspect_after_s=float(suspect) if suspect else None,
            down_after_s=float(down) if down else None,
            spill_wait_s=float(
                config.get_or_default("TPU_ROUTER_SPILL_WAIT_S", "1.0")
            ),
            affinity_prefix_tokens=int(
                config.get_or_default("TPU_ROUTER_AFFINITY_TOKENS", "32")
            ),
            vnodes=int(config.get_or_default("TPU_ROUTER_VNODES", "64")),
            max_failovers=int(
                config.get_or_default("TPU_ROUTER_MAX_FAILOVERS", "3")
            ),
            hedge_delay_s=float(
                config.get_or_default("TPU_ROUTER_HEDGE_DELAY_S", "0")
            ),
            hedge_from_p99=config.get_or_default(
                "TPU_ROUTER_HEDGE_P99", "true"
            ).lower() in ("1", "true", "yes"),
            spill_hbm_frac=float(
                config.get_or_default("TPU_ROUTER_SPILL_HBM_FRAC", "0.05")
            ),
            heartbeat_topic=config.get_or_default(
                "TPU_ROUTER_HEARTBEAT_TOPIC", ms.HEARTBEAT_TOPIC
            ),
        )


def prefix_affinity_key(prompt: str | list[int], prefix_units: int) -> bytes:
    """The affinity key: a digest of the prompt's leading units (token
    ids for pre-tokenized prompts, utf-8 bytes for strings). Mirrors the
    keying of serving/prefix_cache.py — two requests sharing a system
    prompt share a key, so the ring sends them to the replica whose
    prefix cache already holds that prefill."""
    if isinstance(prompt, str):
        head = prompt.encode("utf-8")[:prefix_units]
    else:
        import numpy as np

        head = np.asarray(list(prompt[:prefix_units]), np.int32).tobytes()
    return hashlib.blake2b(head, digest_size=8).digest()


class _HashRing:
    """Consistent hash over replica ids with ``vnodes`` positions each:
    adding/removing one replica remaps ~1/N of the key space instead of
    all of it (affinity survives membership churn)."""

    def __init__(self, replica_ids: list[str], vnodes: int) -> None:
        points: list[tuple[int, str]] = []
        for rid in replica_ids:
            for v in range(vnodes):
                digest = hashlib.blake2b(
                    f"{rid}#{v}".encode(), digest_size=8
                ).digest()
                points.append((int.from_bytes(digest, "big"), rid))
        points.sort()
        self._points = points

    def lookup(self, key: bytes) -> str | None:
        if not self._points:
            return None
        import bisect

        h = int.from_bytes(
            hashlib.blake2b(key, digest_size=8).digest(), "big"
        )
        idx = bisect.bisect_left(self._points, (h, ""))
        if idx == len(self._points):
            idx = 0
        return self._points[idx][1]


class LocalReplica:
    """An in-process engine replica handle (the chaos tier runs ≥2 of
    these side by side; production wraps one per process). The handle
    contract: ``submit(prompt, **kw) -> Future``, ``cancel(request_id)``,
    ``health_check()``."""

    def __init__(self, replica_id: str, engine: Any,
                 role: str | None = None) -> None:
        self.replica_id = replica_id
        self.engine = engine
        # disaggregation role seed for membership registration; the
        # engine's announcer remains authoritative via heartbeats
        self.role = role or getattr(engine, "role", None) or ms.ROLE_UNIFIED
        # preemptible capability seed, mirrored from the engine config —
        # heartbeats are authoritative after registration
        self.preemptible = bool(getattr(engine, "preemptible", False))

    def submit(self, prompt: str | list[int], **kw: Any) -> Any:
        return self.engine.submit(prompt, **kw)

    def cancel(self, request_id: int) -> None:
        self.engine.cancel(request_id)

    def resume(self, idempotency_key: str, *, last_seq: int = 0,
               stream_cb: Any = None, fence_epoch: int | None = None,
               deadline: float | None = None) -> Any:
        """Re-attach to a keyed stream on this replica (docs/serving.md
        "Resumable streams"); raises 404 when the engine never saw the
        key (the router's resume walk tries the next replica)."""
        del deadline  # in-process attach is immediate; no wire budget
        return self.engine.resume(
            idempotency_key, last_seq=last_seq, stream_cb=stream_cb,
            fence_epoch=fence_epoch,
        )

    def health_check(self) -> dict[str, Any]:
        return self.engine.health_check()


class HTTPReplica:
    """A remote engine replica behind its HTTP surface, through the
    service-client stack (the retry semantics stay with the ROUTER —
    the client here is breaker-only, because the router's failover IS
    the retry policy; stacking both would retry twice).

    The breaker's open/close transitions feed the membership table
    directly via ``on_state_change`` — the data path detecting a dead
    replica must not wait for the heartbeat timers."""

    def __init__(self, replica_id: str, address: str, *, logger: Any = None,
                 metrics: Any = None, breaker_threshold: int = 3,
                 breaker_interval: float = 5.0,
                 on_breaker_open: Callable[[str], None] | None = None,
                 role: str | None = None) -> None:
        from gofr_tpu_torch.service.client import new_http_service
        from gofr_tpu_torch.service.options import CircuitBreakerConfig

        self.replica_id = replica_id
        self.address = address
        self.role = role or ms.ROLE_UNIFIED  # membership registration seed
        self._svc = new_http_service(
            address, logger, metrics, None,
            CircuitBreakerConfig(breaker_threshold, breaker_interval),
        )
        if on_breaker_open is not None:
            self._svc.on_state_change = (
                lambda open_: on_breaker_open(replica_id) if open_ else None
            )
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=4, thread_name_prefix=f"replica-{replica_id}"
        )
        self._rid_mu = threading.Lock()
        self._next_rid = 0
        # local rid -> remote engine rid, learned from the stream's id
        # frame; the cancel wire posts the REMOTE id. None = id frame not
        # seen yet; a cancel arriving first parks in _cancel_early and
        # fires the moment the id lands.
        self._remote_ids: dict[int, int | None] = {}
        self._cancel_early: set[int] = set()

    def _build_payload(
        self, prompt: Any, kw: dict[str, Any]
    ) -> dict[str, Any]:
        payload: dict[str, Any] = {"prompt": prompt}
        if kw.get("max_new_tokens"):
            payload["max_tokens"] = kw["max_new_tokens"]
        for key in ("temperature", "top_k", "top_p"):
            if kw.get(key):
                payload[key] = kw[key]
        # disaggregation plane: ride the wire only when set (an older
        # replica's handler ignores unknown fields either way)
        if kw.get("prefill_only"):
            payload["prefill_only"] = True
        if kw.get("handoff_from"):
            payload["handoff_from"] = kw["handoff_from"]
        # multi-tenant plane: adapter + tenant ride the wire the same way
        if kw.get("adapter_id"):
            payload["adapter_id"] = kw["adapter_id"]
        if kw.get("tenant"):
            payload["tenant"] = kw["tenant"]
        # HA plane (docs/robustness.md "The HA plane"): the exactly-once
        # key and the per-attempt membership fence ride the wire when set
        if kw.get("idempotency_key"):
            payload["idempotency_key"] = kw["idempotency_key"]
        if kw.get("fence_epoch"):
            payload["fence_epoch"] = int(kw["fence_epoch"])
        return payload

    def submit(self, prompt: str | list[int], *, deadline: float | None = None,
               stream_cb: Any = None, trace_ctx: Any = None,
               **kw: Any) -> Any:
        with self._rid_mu:
            self._next_rid += 1
            rid = self._next_rid
        future: Any = concurrent.futures.Future()
        future.request_id = rid
        payload = self._build_payload(prompt, kw)
        headers: dict[str, str] = {}
        if deadline:
            headers["X-Request-Timeout"] = f"{deadline:.3f}"
        ctx_span = trace_ctx if trace_ctx is not None else current_span()
        if ctx_span is not None:
            # W3C propagation over the remote transport: the replica's
            # HTTP middleware continues this trace, so the cross-process
            # span tree stays connected
            headers["traceparent"] = format_traceparent(ctx_span)
        if stream_cb is not None:
            # token-level streaming (serving/remote.py): tokens reach the
            # router's stream claim the moment the replica decodes them —
            # remote TTFT decouples from completion time, and failover/
            # hedging keep their pre-first-token semantics over the wire
            with self._rid_mu:
                # cancelable from this instant: a cancel landing before
                # the id frame parks in _cancel_early (see cancel())
                self._remote_ids[rid] = None
            self._pool.submit(
                self._run_stream, rid, future, payload, headers or None,
                deadline, stream_cb,
            )
        else:
            self._pool.submit(
                self._run_unary, rid, future, payload, headers or None,
                deadline, stream_cb,
            )
        return future

    def _run_unary(self, rid: int, future: Any, payload: dict,
                   headers: dict | None, deadline: float | None,
                   stream_cb: Any) -> None:
        from gofr_tpu_torch.serving.remote import error_from_status

        try:
            resp = self._svc.post(
                "/generate", json=payload, headers=headers,
                timeout=deadline,
            )
            if not resp.ok:
                raise error_from_status(
                    resp.status_code,
                    f"replica {self.replica_id}: HTTP {resp.status_code}",
                    resp.headers,
                )
            body = resp.json()
            data = body.get("data") or body
            if stream_cb is not None:
                stream_cb(0, data.get("text", ""), False)
                stream_cb(0, "", True)
            future.set_result(_RemoteResult(rid, data))
        # gofrlint: disable=router-retry-untyped -- settles the future
        # with the error (no retry happens here); a narrow catch would
        # strand the client future forever on an unexpected failure
        except BaseException as exc:
            if isinstance(exc, OSError) and not isinstance(
                exc, ConnectionError
            ):
                exc = ConnectionError(str(exc))
            future.set_exception(exc)

    def _run_stream(self, rid: int, future: Any, payload: dict,
                    headers: dict | None, deadline: float | None,
                    stream_cb: Any) -> None:
        """One remote streaming generation, on a pool worker (the frame
        reads block by design — never the event loop). Mirrors the
        engine's settlement contract: tokens stream, the done frame
        fires, THEN the future resolves; failures settle the future
        FIRST (the router's claim guard reads that ordering)."""
        from gofr_tpu_torch.serving.remote import run_stream

        state: dict[str, Any] = {
            "ids": [], "pieces": [], "first_ms": 0.0, "t0": time.monotonic(),
        }

        def on_id(remote_id: int) -> None:
            fire = False
            with self._rid_mu:
                self._remote_ids[rid] = remote_id
                if rid in self._cancel_early:
                    self._cancel_early.discard(rid)
                    fire = True
            if fire:
                self._post_cancel(remote_id)

        def on_token(token_id: int, text: str) -> None:
            if not state["ids"]:
                state["first_ms"] = (
                    time.monotonic() - state["t0"]
                ) * 1e3
            state["ids"].append(token_id)
            state["pieces"].append(text)
            stream_cb(token_id, text, False)

        try:
            terminal = run_stream(
                self._svc, payload, headers=headers, timeout=deadline,
                on_id=on_id, on_token=on_token,
            )
            data = dict(terminal)
            usage = dict(data.get("usage") or {})
            # the replica reports prompt/completion; TTFT as OBSERVED
            # through this transport is what the router's hedge floor
            # must key on. The token stream itself is the result body —
            # rebuild it so a streamed remote result carries the same
            # token_ids/text a unary one does.
            usage.setdefault("ttft_ms", round(state["first_ms"], 3))
            data["usage"] = usage
            data.setdefault("token_ids", list(state["ids"]))
            data.setdefault("text", "".join(state["pieces"]))
            stream_cb(-1, "", True)
            future.set_result(_RemoteResult(rid, data))
        # gofrlint: disable=router-retry-untyped -- settles the future
        # with the error (no retry happens here); a narrow catch would
        # strand the client future forever on an unexpected failure
        except BaseException as exc:
            if isinstance(exc, OSError) and not isinstance(
                exc, ConnectionError
            ):
                exc = ConnectionError(str(exc))
            future.set_exception(exc)
            # trailing done frame AFTER the failed settlement, mirroring
            # ServingEngine._settle_future — the router's claim guard
            # refuses terminal frames of already-failed attempts
            try:
                stream_cb(-1, "", True)
            # gofrlint: disable=router-retry-untyped -- no retry here: a
            # client callback failing on the courtesy done frame must not
            # mask the already-settled transport error
            except Exception:
                pass
        finally:
            with self._rid_mu:
                self._remote_ids.pop(rid, None)
                self._cancel_early.discard(rid)

    def _post_cancel(self, remote_id: int) -> None:
        from gofr_tpu_torch.serving.remote import CANCEL_PATH

        try:
            self._svc.post(CANCEL_PATH, json={"id": remote_id}, timeout=2.0)
        except Exception:
            pass  # the replica may be gone; its supervisor reclaims

    def cancel(self, request_id: int) -> None:
        """The remote cancel wire: POST the replica's own request id (from
        the stream's id frame) to ``/generate/cancel`` — the engine
        retires the row at the next block sync, so a canceled hedge twin
        stops burning decode steps within one block instead of running to
        completion. A cancel racing the id frame parks and fires when the
        frame lands; unary submissions have no wire to cancel (bounded by
        their deadline, as before)."""
        with self._rid_mu:
            if request_id not in self._remote_ids:
                return  # unary, already finished, or never streamed
            remote_id = self._remote_ids.get(request_id)
            if remote_id is None:
                self._cancel_early.add(request_id)
                return
        self._post_cancel(remote_id)

    def resume(self, idempotency_key: str, *, last_seq: int = 0,
               stream_cb: Any = None, fence_epoch: int | None = None,
               deadline: float | None = None) -> Any:
        """Re-attach to a keyed stream on this remote replica
        (docs/serving.md "Resumable streams"): the pool worker drives
        ``resume_stream`` — ``Idempotency-Key`` + ``Last-Event-ID``
        headers, suffix frames replayed token-identically, then the live
        continuation. ``stream_cb`` is the 4-arg resumable wire
        ``(seq, token_id, piece, done)``. The future resolves to a
        GenerationResult-shaped view of the terminal whose ``token_ids``
        hold the REPLAYED SUFFIX (the client already holds the acked
        prefix). The head errors (404 unknown key, 409 stale fence, 503)
        raise SYNCHRONOUSLY — the router's resume walk classifies them
        and tries the next replica; only the frame drain runs on the
        pool."""
        from gofr_tpu_torch.serving.remote import open_resume

        with self._rid_mu:
            self._next_rid += 1
            rid = self._next_rid
        resp = open_resume(
            self._svc, idempotency_key, last_seq=int(last_seq),
            fence_epoch=fence_epoch, timeout=deadline,
        )
        future: Any = concurrent.futures.Future()
        future.request_id = rid
        deadline_abs = (
            time.monotonic() + deadline if deadline is not None else None
        )
        self._pool.submit(
            self._run_resume, rid, future, resp, int(last_seq),
            deadline_abs, stream_cb,
        )
        return future

    def _run_resume(self, rid: int, future: Any, resp: Any, last_seq: int,
                    deadline_abs: float | None, stream_cb: Any) -> None:
        from gofr_tpu_torch.serving.remote import drain_resume

        state: dict[str, Any] = {"seq": last_seq, "ids": [], "pieces": []}

        def on_frame(seq: int, token_id: int, text: str) -> None:
            state["seq"] = max(state["seq"], seq)
            state["ids"].append(token_id)
            state["pieces"].append(text)
            if stream_cb is not None:
                stream_cb(seq, token_id, text, False)

        try:
            terminal = drain_resume(
                resp, deadline_abs=deadline_abs, on_frame=on_frame,
            )
            data = dict(terminal)
            data.setdefault("token_ids", list(state["ids"]))
            data.setdefault("text", "".join(state["pieces"]))
            if stream_cb is not None:
                stream_cb(
                    int(terminal.get("seq") or (state["seq"] + 1)),
                    -1, "", True,
                )
            future.set_result(_RemoteResult(rid, data))
        # gofrlint: disable=router-retry-untyped -- settles the future
        # with the error (no retry happens here); a narrow catch would
        # strand the client future forever on an unexpected failure
        except BaseException as exc:
            if isinstance(exc, OSError) and not isinstance(
                exc, ConnectionError
            ):
                exc = ConnectionError(str(exc))
            future.set_exception(exc)

    def fetch_kv(self, keys: list[str],
                 timeout: float = 2.0,
                 fence_epoch: int | None = None) -> dict[str, tuple]:
        """Warm KV page migration, remote half (serving/prefix_index.py):
        fetch serialized prefix-cache slabs from this replica's
        ``/kv/fetch`` surface. Asks for the port's binary body of raw slabs
        (``KV_WIRE_CONTENT_TYPE``) and reads the JSON body from a server
        that answers with that (a reference replica). Returns {key:
        (logits, k, v)} as HOST tensors — the admitting engine uploads them
        asynchronously.
        Raises on transport failure; the migrator's fetch contract turns
        any raise into a clean compute miss. ``fence_epoch`` rides the
        payload when set: a fetch stamped against a replica that warm-
        restarted since is rejected at the wire (409) instead of serving
        slabs from a cache generation the caller never observed."""
        payload: dict[str, Any] = {"keys": list(keys)}
        if fence_epoch:
            payload["fence_epoch"] = int(fence_epoch)
        resp = self._svc.post(
            "/kv/fetch", json=payload, timeout=timeout,
            headers={"Accept": f"{KV_WIRE_CONTENT_TYPE}, application/json"},
        )
        if not resp.ok:
            raise ConnectionError(
                f"replica {self.replica_id}: /kv/fetch HTTP {resp.status_code}"
            )
        content_type = next((v for k, v in resp.headers.items()
                             if k.lower() == "content-type"), "")
        if content_type.startswith(KV_WIRE_CONTENT_TYPE):
            return decode_entries_binary(resp.body)
        body = resp.json()
        data = body.get("data") or body
        out: dict[str, tuple] = {}
        for key, payload in (data.get("entries") or {}).items():
            out[key] = decode_entry(payload)
        return out

    def health_check(self) -> dict[str, Any]:
        return self._svc.health_check()

    def close(self) -> None:
        self._pool.shutdown(wait=False)


class _RemoteResult:
    """GenerationResult-shaped view of a remote /generate response."""

    def __init__(self, rid: int, data: dict[str, Any]) -> None:
        usage = data.get("usage") or {}
        self.request_id = rid
        self.text = data.get("text", "")
        self.token_ids: list[int] = data.get("token_ids") or []
        self.finish_reason = data.get("finish_reason", "stop")
        self.prompt_tokens = usage.get("prompt_tokens", 0)
        self.completion_tokens = usage.get("completion_tokens", 0)
        self.ttft_s = usage.get("ttft_ms", 0.0) / 1000.0
        self.duration_s = usage.get("duration_ms", 0.0) / 1000.0


class _RouterRequest:
    """Per-request routing state: which replicas were tried, which
    attempt owns the client-visible stream, how many tokens crossed."""

    def __init__(self, rid: int, prompt: Any, kw: dict[str, Any],
                 stream_cb: Any, deadline_abs: float | None,
                 trace_ctx: Any = None) -> None:
        self.rid = rid
        self.prompt = prompt
        self.kw = kw
        self.stream_cb = stream_cb
        self.deadline_abs = deadline_abs
        self.trace_ctx = trace_ctx  # parent Span the attempt spans hang off
        self.future: Any = concurrent.futures.Future()
        self.future.request_id = rid
        self.mu = threading.Lock()
        self.tried: list[str] = []
        self.live: dict[str, Any] = {}   # replica_id -> replica future
        self.spans: dict[str, Any] = {}  # replica_id -> open attempt span
        self.winner: str | None = None
        self.first_token_at: float | None = None
        self.submitted_at = time.monotonic()
        self.failovers = 0
        self.hedge_timer: threading.Timer | None = None
        self.canceled = False
        # disaggregation (docs/robustness.md "The disaggregation plane"):
        # the role this request's GENERATION attempts must route to
        # (decode when the tier is role-split, None for unified routing —
        # failover and hedge re-walks read it so a re-route can never
        # land generation work on a prefill-only replica), and the live
        # prefill-phase attempt (replica_id, future, span) so cancel
        # reaches a handoff in flight
        self.phase_role: str | None = None
        self.prefill_attempt: tuple[str, Any, Any] | None = None

    def remaining(self) -> float | None:
        if self.deadline_abs is None:
            return None
        return self.deadline_abs - time.monotonic()


class Router:
    """Fronts N replicas: membership-aware, prefix-affine, failover- and
    hedge-capable submit surface mirroring ``ServingEngine.submit``."""

    def __init__(
        self,
        config: RouterConfig | None = None,
        *,
        broker: Any = None,
        metrics: Any = None,
        logger: Any = None,
        tracer: Any = None,
    ) -> None:
        self.config = config or RouterConfig()
        self.broker = broker
        self._metrics = metrics
        self._logger = logger
        self._tracer = tracer
        # shared TenantRegistry (serving/tenancy.py), wired by the
        # container/stack via use_tenants: lets the candidate walk
        # resolve a request's SLO class, so interactive traffic is
        # steered off preemptible capacity (docs/robustness.md "The
        # reclamation plane"). None = no steering (class unknown).
        self._tenants: Any = None
        self.membership = ms.MembershipTable(
            suspect_after_s=self.config.suspect_after_s or 3.0,
            down_after_s=self.config.down_after_s or 10.0,
        )
        # cluster-wide KV reuse (serving/prefix_index.py): per-replica
        # prefix advertisements ride the heartbeats this router already
        # consumes — the router (and any replica handed this index) can
        # locate the longest cached prefix anywhere in the tier. Purely
        # advisory: a stale entry degrades to a compute miss downstream.
        self.prefix_index = PrefixIndex()
        self._handles: dict[str, Any] = {}
        self._handles_mu = threading.Lock()
        # hash rings cached per candidate-set (sorted id tuple): a
        # disaggregated tier alternates prefill-pool and decode-pool
        # walks every request — a single-slot cache would rebuild the
        # 64-vnode ring twice per request, forever. Bounded (the
        # distinct routable sets of a tier are few); cleared on
        # membership-shape changes.
        self._rings: dict[tuple[str, ...], _HashRing] = {}
        self._requests: dict[int, _RouterRequest] = {}
        self._req_mu = threading.Lock()
        self._next_rid = 0
        self._failover_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="router-failover"
        )
        self._stop = threading.Event()
        self._consumer: threading.Thread | None = None
        # TTFT observations land in the SHARED registered
        # app_request_ttft_seconds histogram (label source=router) — one
        # series serves /metrics AND the hedge p99 floor. The private
        # instrument only backs routers wired without a metrics manager
        # (unit tests), through the identical Histogram type.
        self._private_ttft: Histogram | None = None
        # counters mirrored into /routerz (metrics keep the canonical
        # series; these make the health view self-contained). Guarded by
        # _stats_mu: they are bumped from caller threads, the failover
        # pool AND replica settlement threads at once — exactly during
        # the failover storms an operator reads them to understand.
        self._stats_mu = threading.Lock()
        self.routed_total = 0
        self.failovers_total = 0
        self.hedges_total = 0
        self.spills_total = 0
        self.no_replica_total = 0
        self.handoffs_total = 0           # prefill→decode KV handoffs hinted
        self.handoff_degraded_total = 0   # handoffs degraded to re-prefill
        self.last_resort_routes_total = 0  # SUSPECT-only pool routes
        self.routes_by_replica: dict[str, int] = {}
        # HA plane (docs/robustness.md "The HA plane"): idempotency-key →
        # replica-id fast path. Strictly an OPTIMIZATION — the replica-
        # side DedupRegistry is the exactly-once authority, so this map
        # may be stale, evicted, or empty (a freshly promoted standby
        # router starts cold) without any correctness loss: a miss just
        # means the duplicate walks the normal candidate order and the
        # owning replica's registry attaches it. Bounded LRU; guarded by
        # its own lock (touched on every keyed submit's hot path).
        self._idem_mu = threading.Lock()
        self._idem_routes: dict[str, str] = {}

    # -- provider pattern (lets the container own the router) ------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def use_tenants(self, registry: Any) -> None:
        self._tenants = registry

    def connect(self) -> None:
        pass

    # -- replica management ----------------------------------------------------
    def add_replica(self, handle: Any, role: str | None = None) -> None:
        """Register a replica handle (a LocalReplica, or any handle with its
        contract: ``replica_id``, ``submit``, ``cancel``). The
        replica stays SUSPECT until its first heartbeat lands. ``role``
        (or the handle's own ``role`` attribute) seeds its disaggregation
        role; the replica's heartbeats are authoritative after that."""
        with self._handles_mu:
            self._handles[handle.replica_id] = handle
            self._rings.clear()  # rebuilt lazily against the new set
        self.membership.register(
            handle.replica_id,
            role or getattr(handle, "role", None) or ms.ROLE_UNIFIED,
            preemptible=bool(getattr(handle, "preemptible", False)),
        )

    def remove_replica(self, replica_id: str) -> None:
        with self._handles_mu:
            self._handles.pop(replica_id, None)
            self._rings.clear()
        self.membership.forget(replica_id)
        self.prefix_index.drop_replica(replica_id)

    def mark_replica_down(self, replica_id: str,
                          reason: str = "breaker-open") -> None:
        """The breaker's fast path into membership. Also retracts the
        replica's prefix advertisements: a dead replica's entries would
        otherwise keep sending migrators into its transport timeout (a
        fresh UP beat re-advertises along with clearing the mark)."""
        self.membership.mark_down(replica_id, reason)
        self.prefix_index.drop_replica(replica_id)
        self._export_states()

    def _ring_for(self, ids: list[str]) -> _HashRing:
        key = tuple(sorted(ids))
        with self._handles_mu:
            ring = self._rings.get(key)
            if ring is None:
                if len(self._rings) >= 16:  # candidate-set churn bound
                    self._rings.clear()
                ring = _HashRing(list(key), self.config.vnodes)
                self._rings[key] = ring
            return ring

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> None:
        """Start the membership consumer (needs a broker; without one,
        feed ``membership.observe`` directly — unit tests do)."""
        if self._consumer is not None and self._consumer.is_alive():
            return
        self._stop.clear()
        self._consumer = threading.Thread(
            target=self._membership_loop, daemon=True,
            name="router-membership",
        )
        self._consumer.start()

    def stop(self) -> None:
        self._stop.set()
        consumer = self._consumer
        if consumer is not None:
            consumer.join(timeout=2.0)
        self._consumer = None
        self._failover_pool.shutdown(wait=False)

    def close(self) -> None:
        self.stop()

    def _membership_loop(self) -> None:
        """Poll heartbeats, commit each (observe is idempotent under the
        at-least-once contract: stale seqs are dropped), sweep timers and
        export gauges at most once per heartbeat interval."""
        topic = self.config.heartbeat_topic
        last_export = 0.0
        while not self._stop.is_set():
            msg = None
            if self.broker is not None:
                try:
                    msg = self.broker.subscribe(topic)
                except Exception as exc:
                    if self._logger is not None:
                        self._logger.debug(f"heartbeat poll failed: {exc}")
                    self._stop.wait(self.config.heartbeat_s)
            if msg is not None:
                try:
                    self.observe_heartbeat(ms.Heartbeat.from_json(msg.value))
                except (ValueError, KeyError, TypeError):
                    pass  # malformed beat: drop, never crash the loop
                try:
                    msg.commit()
                except Exception:
                    pass  # redelivery is harmless (seq-idempotent)
            else:
                # a driver whose subscribe() returns None without blocking
                # on its own poll timeout must not spin this thread at
                # 100% (the subscriber.py IDLE_SLEEP lesson); bounded so
                # beat-observation latency stays well inside suspect_after
                self._stop.wait(min(self.config.heartbeat_s, 0.05))
            now = time.monotonic()
            if now - last_export >= min(self.config.heartbeat_s, 0.5):
                last_export = now
                self._export_states()

    def observe_heartbeat(self, hb: ms.Heartbeat) -> bool:
        """Commit one heartbeat into membership AND the prefix index —
        both idempotent under the at-least-once pubsub contract (the
        beat's per-replica ``seq`` gates each)."""
        fresh = self.membership.observe(hb)
        if hb.prefix_keys is not None:
            self.prefix_index.observe(hb.replica_id, hb.seq, hb.prefix_keys)
        return fresh

    def _export_states(self) -> None:
        if self._metrics is None:
            return
        snapshot = self.membership.snapshot()
        for rid, view in snapshot.items():
            self._metrics.set_gauge(
                "app_router_replica_state",
                float(ms.STATE_VALUES.get(view["state"], ms.STATE_VALUES[ms.DOWN])),
                replica=rid,
            )
        self._metrics.set_gauge(
            "app_router_queue_wait_seconds",
            self.membership.aggregate_queue_wait(),
        )

    # -- routing ---------------------------------------------------------------
    def _is_interactive(self, tenant: str | None) -> bool:
        """True when ``tenant`` resolves to the interactive deadline
        class in the wired TenantRegistry. No registry (or a lookup
        failure) means the class is unknown — no steering, never a
        routing error."""
        if self._tenants is None:
            return False
        try:
            policy = self._tenants.policy(tenant)
        except Exception:
            return False
        return getattr(policy, "deadline_class", None) == "interactive"

    def _candidates_for(self, prompt: Any,
                        role: str | None = None,
                        adapter_id: str | None = None,
                        tenant: str | None = None) -> tuple[list[str], bool]:
        """Ordered candidate replicas for a new request: the prefix-
        affine replica first (when healthy and under the spill bound),
        then every other routable replica by least estimated wait.
        ``role`` restricts the pool to one disaggregation phase (the
        affinity ring is built over that pool, so shared prefixes keep
        landing on the same prefill replica's chunk cache).
        ``adapter_id`` joins the affinity key: same prompt under two
        adapters is two cache chains (the keys carry the adapter id), and
        same-adapter traffic pinning to one replica keeps that adapter
        device-resident there instead of thrashing every table in the
        tier (serving/lora.py). Returns (candidates, spilled)."""
        routable = self.membership.candidates(role=role)
        if not routable:
            return [], False
        key = prefix_affinity_key(prompt, self.config.affinity_prefix_tokens)
        if adapter_id:
            key = key + adapter_id.encode("utf-8")
        affine = self._ring_for(routable).lookup(key)
        spilled = False
        if affine in routable:
            wait, _depth = self.membership.load_of(affine)
            cap = self.config.spill_wait_s
            hbm_cap = self.config.spill_hbm_frac
            _kv_free, hbm_free = self.membership.headroom_of(affine)
            if (cap > 0 and wait > cap) or (
                hbm_cap > 0 and hbm_free is not None and hbm_free < hbm_cap
            ):
                # load-aware spill: the affine replica is healthy but
                # queued past the bound — or its heartbeat reports real
                # HBM pressure (device-telemetry hbm_free_frac below the
                # floor): one cold prefill elsewhere beats queueing
                # behind its backlog or OOMing its pools
                routable = [r for r in routable if r != affine] + [affine]
                spilled = True
            else:
                routable = [affine] + [r for r in routable if r != affine]
        if tenant is not None and self._is_interactive(tenant):
            # reclamation-aware steering: interactive-class traffic
            # prefers on-demand capacity — a preemptible replica can be
            # noticed away mid-stream, and an interactive SLO has no
            # budget for the resulting retry. Stable partition: the
            # affinity/spill order is preserved within each half, and a
            # pure-preemptible pool routes normally (steering picks
            # among candidates, it never shrinks the set).
            on_demand = [
                r for r in routable
                if not self.membership.is_preemptible(r)
            ]
            if on_demand and len(on_demand) < len(routable):
                back = set(on_demand)
                routable = on_demand + [
                    r for r in routable if r not in back
                ]
        return routable, spilled

    def submit(
        self,
        prompt: str | list[int],
        *,
        deadline: float | None = None,
        stream_cb: Callable[[int, str, bool], None] | None = None,
        trace_ctx: Any = None,
        **kw: Any,
    ) -> Any:
        """Route a request to a replica; returns a Future resolving to
        that replica's GenerationResult (annotated with ``replica_id``).
        Mirrors ``ServingEngine.submit`` so transports can front a
        router exactly like an engine. The deadline is the caller's
        remaining budget in seconds; across failovers the ORIGINAL
        absolute deadline is preserved — a re-route never resets the
        clock. ``trace_ctx`` (or the caller's active span) parents the
        per-attempt router spans, and propagates to each replica —
        in-process directly, over the wire as a W3C ``traceparent``."""
        with self._req_mu:
            self._next_rid += 1
            rid = self._next_rid
        deadline_abs = (
            time.monotonic() + deadline
            if deadline is not None and deadline > 0 else None
        )
        req = _RouterRequest(
            rid, prompt, dict(kw), stream_cb, deadline_abs,
            trace_ctx=trace_ctx if trace_ctx is not None else current_span(),
        )
        # disaggregated tier (a prefill pool AND a decode pool are both
        # live): the request splits into a prefill phase + KV handoff +
        # decode phase — a separate path because the prefill future must
        # be awaited asynchronously, never on this caller thread
        present = self.membership.roles_present()
        if ms.ROLE_PREFILL in present and ms.ROLE_DECODE in present:
            return self._submit_disagg(req)
        candidates, spilled = self._candidates_for(
            prompt, adapter_id=kw.get("adapter_id"), tenant=kw.get("tenant")
        )
        if not candidates:
            with self._stats_mu:
                self.no_replica_total += 1
            raise ErrorServiceUnavailable(
                "no routable replica (all draining, wedged, or down)",
                retry_after=self.config.heartbeat_s,
            )
        candidates = self._idem_fast_path(kw.get("idempotency_key"),
                                          candidates)
        self._note_last_resort(candidates)
        if spilled:
            with self._stats_mu:
                self.spills_total += 1
        # register BEFORE dispatching: a microsecond-fast settlement runs
        # _settle (which pops this rid) from the attempt's done-callback —
        # inserting afterwards would re-add a finished request that no
        # path ever removes (a permanent leak per occurrence)
        with self._req_mu:
            self._requests[rid] = req
        last_error: Exception | None = None
        dispatched = False
        try:
            for replica_id in candidates:
                try:
                    self._submit_attempt(req, replica_id)
                except RETRIABLE_ERRORS as exc:
                    last_error = exc
                    continue
                dispatched = True
                self._arm_hedge(req)
                return req.future
            # every candidate refused at admission: clean retriable
            # error — the client (or the LB above us) decides when to
            # come back
            assert last_error is not None
            raise last_error
        finally:
            if not dispatched:
                # nothing owns this request: unregister it (any raise —
                # retriable walk exhausted, deadline, non-retriable —
                # lands here; a dispatched request is removed by _settle)
                with self._req_mu:
                    self._requests.pop(rid, None)

    # -- disaggregated prefill/decode routing ----------------------------------
    def _submit_disagg(self, req: _RouterRequest) -> Any:
        """Two-phase routing for a role-split tier (ROADMAP item 2,
        AIBrix arXiv:2504.03648): admit the prompt on a PREFILL replica
        with ``prefill_only`` (it computes the prompt KV into its prefix
        cache and retires — no decode slots burned), then, when the
        prefill future settles, admit the generation on a DECODE replica
        with ``handoff_from`` naming the prefill source — the decode
        engine pulls the KV chain over the KV-migration transfer machinery
        under the two-phase-commit handoff discipline (kv.handoff).

        Crash-safety is the headline invariant: EVERY failure in the
        prefill phase — no prefill candidate, admission refused, the
        source dying mid-prefill — degrades to the decode phase without
        a handoff hint, where the decode replica simply re-prefills
        (roles are policy, not capability). The client future settles
        exactly once either way."""
        req.phase_role = ms.ROLE_DECODE  # generation attempts (primary,
        # failover, hedge) must never land on a prefill-only replica
        with self._req_mu:
            self._requests[req.rid] = req
        registered = True
        try:
            candidates, _ = self._candidates_for(
                req.prompt, role=ms.ROLE_PREFILL,
                adapter_id=req.kw.get("adapter_id"),
                tenant=req.kw.get("tenant"),
            )
            prefill_fut = None
            for replica_id in candidates:
                try:
                    prefill_fut = self._prefill_attempt(req, replica_id)
                except RETRIABLE_ERRORS:
                    continue
                break
            if prefill_fut is None:
                # no prefill replica would take it: the decode pool
                # serves the whole generation (one replica, no handoff)
                self._degrade_handoff(req, "no-prefill-candidate")
                self._failover_pool.submit(self._decode_phase, req)
            registered = False  # a phase now owns the request
            return req.future
        finally:
            if registered:
                # nothing owns this request (the prefill walk raised
                # non-retriably, or the pool rejected the phase task):
                # unregister before the raise reaches the caller
                with self._req_mu:
                    self._requests.pop(req.rid, None)

    def _open_attempt(
        self, req: _RouterRequest, replica_id: str, kind: str
    ) -> tuple[Any, Any, float | None]:
        """The admission prologue shared by EVERY attempt kind (primary/
        failover/hedge/prefill): deadline gate, handle lookup, the
        ``router.route`` chaos seam and the attempt span. One
        implementation so the two attempt paths cannot drift. Returns
        (handle, span, remaining_deadline); raises the typed admission
        errors."""
        remaining = req.remaining()
        if remaining is not None and remaining <= 0:
            raise ErrorDeadlineExceeded(
                f"request {req.rid}: deadline passed before reaching a replica"
            )
        with self._handles_mu:
            handle = self._handles.get(replica_id)
        if handle is None:
            raise ErrorServiceUnavailable(
                f"replica {replica_id} has no handle", retry_after=1.0
            )
        chaos.maybe_fail("router.route")
        span = None
        if self._tracer is not None:
            span = self._tracer.start_span(
                "router.attempt", parent=req.trace_ctx, kind="client",
                activate=False,
            )
            span.set_attribute("request.id", req.rid)
            span.set_attribute("replica.id", replica_id)
            span.set_attribute("attempt.kind", kind)
        return handle, span, remaining

    def _count_route(self, replica_id: str) -> None:
        with self._stats_mu:
            self.routed_total += 1
            self.routes_by_replica[replica_id] = (
                self.routes_by_replica.get(replica_id, 0) + 1
            )

    # -- HA plane (docs/robustness.md "The HA plane") ---------------------------
    _IDEM_ROUTES_CAP = 4096

    def _idem_fast_path(self, idempotency_key: Any,
                        candidates: list[str]) -> list[str]:
        """Reorder ``candidates`` so a keyed duplicate lands on the
        replica that (this router believes) owns the key's live request —
        one hop instead of a walk. The ``router.claim`` chaos seam sits
        on the lookup: a fault here degrades to the UNORDERED walk, and
        the replica-side registry still guarantees exactly-once (the
        point exists precisely to prove the fast path is not
        load-bearing)."""
        if not idempotency_key:
            return candidates
        try:
            chaos.maybe_fail("router.claim")
        except ChaosFault:
            return candidates
        with self._idem_mu:
            owner = self._idem_routes.get(str(idempotency_key))
        if owner and owner in candidates:
            return [owner] + [c for c in candidates if c != owner]
        return candidates

    def _record_idem_route(self, idempotency_key: Any,
                           replica_id: str) -> None:
        if not idempotency_key:
            return
        key = str(idempotency_key)
        with self._idem_mu:
            self._idem_routes.pop(key, None)
            self._idem_routes[key] = replica_id
            while len(self._idem_routes) > self._IDEM_ROUTES_CAP:
                # FIFO-ish bound (dict preserves insertion order): the
                # hint only matters for the key's in-flight window
                self._idem_routes.pop(next(iter(self._idem_routes)))

    def _attempt_kwargs(self, req: _RouterRequest,
                        replica_id: str) -> dict[str, Any]:
        """Per-attempt kwargs: the request's kw with ``fence_epoch``
        re-stamped from THIS router's membership view of THIS replica.
        Re-stamping per attempt (not per request) is what makes
        ``ErrorStaleEpoch`` retriable at the router: the failover
        attempt carries the refreshed fence, so a router that lagged a
        warm restart self-heals in one re-route instead of surfacing
        409 to the client. A replica whose heartbeat never carried an
        epoch (older replica, pre-beat registration) is not fenced."""
        kw = dict(req.kw)
        epoch = self.membership.epoch_of(replica_id)
        if epoch:
            kw["fence_epoch"] = epoch
        return kw

    def _note_last_resort(self, candidates: list[str]) -> None:
        """A route about to dispatch into a SUSPECT-only pool (no UP
        candidate anywhere): best-effort routing, loud in metrics — the
        operator's first signal that the tier is coasting on replicas
        that stopped heartbeating (satellite of the HA plane; mirrors
        health_check's DEGRADED)."""
        if any(
            self.membership.state_of(rid) == ms.UP for rid in candidates
        ):
            return
        with self._stats_mu:
            self.last_resort_routes_total += 1
        if self._metrics is not None:
            self._metrics.increment_counter(
                "app_router_last_resort_routes_total"
            )

    def resume(self, idempotency_key: str, *, last_seq: int = 0,
               stream_cb: Any = None, deadline: float | None = None) -> Any:
        """Re-attach to a keyed stream SOMEWHERE in the tier: the
        idempotency-route hint first, then every other routable replica
        — each attempt fence-stamped from membership. This is the
        survivor-router path after an active router dies mid-stream: the
        generation is still running on its replica; only the router-side
        subscription died with the router. 404 from a replica means
        "never saw the key, or its replay window evicted" — keep
        walking; when NO replica knows the key, the 404 propagates and
        the client falls back to a keyed submit (which dedups safely).
        ``stream_cb`` is the 4-arg resumable wire
        ``(seq, token_id, piece, done)``."""
        candidates = self.membership.candidates()
        with self._idem_mu:
            owner = self._idem_routes.get(str(idempotency_key))
        if owner and owner in candidates:
            candidates = [owner] + [c for c in candidates if c != owner]
        if not candidates:
            raise ErrorServiceUnavailable(
                "no routable replica to resume on",
                retry_after=self.config.heartbeat_s,
            )
        last_error: Exception | None = None
        for replica_id in candidates:
            with self._handles_mu:
                handle = self._handles.get(replica_id)
            if handle is None or not hasattr(handle, "resume"):
                continue
            epoch = self.membership.epoch_of(replica_id)
            try:
                future = handle.resume(
                    idempotency_key, last_seq=last_seq,
                    stream_cb=stream_cb, fence_epoch=epoch or None,
                    deadline=deadline,
                )
            except ErrorEntityNotFound as exc:
                last_error = exc
                continue
            except RETRIABLE_ERRORS as exc:
                last_error = exc
                continue
            self._record_idem_route(idempotency_key, replica_id)
            return future
        raise last_error if last_error is not None else ErrorEntityNotFound(
            "idempotency_key", str(idempotency_key)
        )

    def _prefill_attempt(self, req: _RouterRequest, replica_id: str) -> Any:
        """Admit the prefill phase on one prefill replica. Raises the
        replica's admission error (the caller's candidate walk decides);
        once admitted, the settlement callback drives the decode phase."""
        handle, span, remaining = self._open_attempt(req, replica_id, "prefill")
        submitted = False
        try:
            kw = {
                k: v for k, v in req.kw.items()
                if k in ("temperature", "top_k", "top_p", "priority",
                         "adapter_id", "tenant")
            }
            # the fence rides the prefill phase too — a prefill stamped
            # against a warm-restarted replica must not feed a handoff
            # hint pointing at a cache generation that no longer exists.
            # The idempotency key deliberately does NOT: the prefill is
            # an internal phase, keying it would dedup against the real
            # generation.
            epoch = self.membership.epoch_of(replica_id)
            if epoch:
                kw["fence_epoch"] = epoch
            prefill_fut = handle.submit(
                req.prompt, deadline=remaining, prefill_only=True,
                max_new_tokens=1,
                trace_ctx=span if span is not None else req.trace_ctx,
                **kw,
            )
            submitted = True
        finally:
            if not submitted and span is not None:
                span.set_attribute("attempt.outcome", "admission-failed")
                span.end()
        with req.mu:
            req.tried.append(replica_id)
            req.prefill_attempt = (replica_id, prefill_fut, span)
        self._count_route(replica_id)
        prefill_fut.add_done_callback(
            lambda f: self._on_prefill_done(req, replica_id, f)
        )
        return prefill_fut

    def _on_prefill_done(self, req: _RouterRequest, replica_id: str,
                         prefill_fut: Any) -> None:
        """The prefill phase settled (on the prefill replica's settlement
        thread): record the outcome, then hand the decode phase to the
        failover pool — never submit into a replica from a settlement
        callback."""
        exc = prefill_fut.exception()
        with req.mu:
            attempt = req.prefill_attempt
            span = attempt[2] if attempt is not None else None
            req.prefill_attempt = None
        if span is not None:
            span.set_attribute(
                "attempt.outcome",
                "ok" if exc is None else f"failed:{type(exc).__name__}",
            )
            span.end()
        if req.future.done():
            return  # canceled / expired while prefilling: settled already
        if req.canceled:
            # canceled during the prefill phase: the decode phase must
            # never run (it would serve a full generation the client
            # already walked away from). Mirror the unified path's
            # semantics — the client future settles with the cancel
            # result; a result still labeled "handoff" (cancel raced the
            # prefill's completion) is relabeled, it must not leak the
            # internal phase marker.
            if exc is None:
                result = prefill_fut.result()
                try:
                    if getattr(result, "finish_reason", None) == "handoff":
                        result.finish_reason = "cancel"
                except Exception:
                    pass  # frozen result types settle unlabeled
                self._settle(req, result=result, replica_id=replica_id)
            else:
                self._settle(req, error=exc, replica_id=replica_id)
            return
        if exc is None:
            # the handoff hint: the decode replica pulls the KV chain
            # directly from this source (no heartbeat-advertisement wait)
            req.kw["handoff_from"] = replica_id
            with self._stats_mu:
                self.handoffs_total += 1
        else:
            # source died mid-prefill (or refused late): the decode
            # replica re-prefills from the prompt — degraded, never lost
            self._degrade_handoff(req, f"prefill-failed:{type(exc).__name__}")
        try:
            self._failover_pool.submit(self._decode_phase, req)
        except RuntimeError:
            self._settle(req, error=ErrorServiceUnavailable(
                "router stopped during handoff; retry", retry_after=1.0,
            ), replica_id=None)

    def _degrade_handoff(self, req: _RouterRequest, reason: str) -> None:
        req.kw.pop("handoff_from", None)
        with self._stats_mu:
            self.handoff_degraded_total += 1
        if self._logger is not None:
            self._logger.debug(
                f"request {req.rid}: handoff degraded to re-prefill ({reason})"
            )

    def _decode_phase(self, req: _RouterRequest) -> None:
        """Admit the generation on the decode pool (runs on the failover
        pool). Mirrors submit's candidate walk; every exit settles the
        client future or hands ownership to the attempt machinery."""
        try:
            if req.future.done():
                return
            candidates, _ = self._candidates_for(
                req.prompt, role=req.phase_role,
                tenant=req.kw.get("tenant"),
            )
            with req.mu:
                tried = set(req.tried)
            # prefer untried decode replicas, but a handoff source that
            # is ALSO the only decode candidate may serve (tried only
            # covers this request's prefill walk, not failures)
            ordered = [c for c in candidates if c not in tried] or candidates
            if ordered:
                self._note_last_resort(ordered)
            last_error: Exception = ErrorServiceUnavailable(
                "no routable decode replica", retry_after=self.config.heartbeat_s,
            )
            for replica_id in ordered:
                try:
                    self._submit_attempt(req, replica_id)
                except RETRIABLE_ERRORS as exc:
                    last_error = exc
                    continue
                except ErrorDeadlineExceeded as exc:
                    self._settle(req, error=exc, replica_id=None)
                    return
                self._arm_hedge(req)
                return
            self._settle(req, error=last_error, replica_id=None)
        # gofrlint: disable=router-retry-untyped -- no retry happens here:
        # an unexpected raise would vanish into the failover pool and
        # strand the client future forever; settle it instead
        except BaseException as exc:
            self._settle(req, error=exc, replica_id=None)

    def _submit_attempt(self, req: _RouterRequest, replica_id: str,
                        kind: str = "primary") -> Any:
        """One submission to one replica. Raises the replica's admission
        error; the callers decide whether it is retriable (submit's
        candidate loop / the failover path). ``kind`` annotates the
        attempt span: primary, failover, or hedge."""
        handle, span, remaining = self._open_attempt(req, replica_id, kind)
        cb = self._attempt_cb(req, replica_id)
        submitted = False
        try:
            replica_future = handle.submit(
                req.prompt, deadline=remaining, stream_cb=cb,
                trace_ctx=span if span is not None else req.trace_ctx,
                **self._attempt_kwargs(req, replica_id),
            )
            submitted = True
        finally:
            # finally, not an except clause: the router-retry-untyped rule
            # pins WHICH errors may be handled here, and an admission
            # failure of any type must not leak the attempt span
            if not submitted and span is not None:
                span.set_attribute("attempt.outcome", "admission-failed")
                span.end()
        with req.mu:
            req.tried.append(replica_id)
            req.live[replica_id] = replica_future
            if span is not None:
                req.spans[replica_id] = span
        self._count_route(replica_id)
        self._record_idem_route(req.kw.get("idempotency_key"), replica_id)
        if req.canceled:
            # a cancel that landed in the async gap before this attempt
            # registered (the disaggregated decode phase runs off the
            # prefill settlement, after the caller already holds the
            # rid): nothing was live to cancel then — cancel NOW, and
            # the replica's cancel contract settles the attempt with the
            # cancel result through the normal done-callback
            self._cancel_attempt(replica_id, replica_future)
        replica_future.add_done_callback(
            lambda f: self._on_attempt_done(req, replica_id, f)
        )
        return replica_future

    def _attempt_cb(self, req: _RouterRequest,
                    replica_id: str) -> Callable[[int, str, bool], None]:
        """Per-attempt stream wrapper: the first token claims the stream
        for this attempt (canceling any hedge twin before IT streams);
        only the claimed winner's tokens reach the client — exactly-once
        on the wire, whatever the replicas do."""

        def cb(token_id: int, piece: str, done: bool) -> None:
            losers: list[tuple[str, Any]] = []
            with req.mu:
                if done and req.winner is None:
                    # terminal frame of an attempt that never streamed.
                    # The engine's failure contract settles the future
                    # FIRST and fires the done frame after — by now the
                    # attempt is out of req.live and the failover path
                    # owns this request: the dead attempt's frame must
                    # neither claim the stream nor cancel the re-route.
                    # (Same guard covers a frame racing registration.)
                    fut = req.live.get(replica_id)
                    if fut is None or (
                        fut.done() and fut.exception() is not None
                    ):
                        return
                if req.winner is None:
                    # first stream event claims the client-visible stream
                    # for this attempt
                    req.winner = replica_id
                    if not done and req.first_token_at is None:
                        req.first_token_at = time.monotonic()
                        self._observe_ttft(
                            req.first_token_at - req.submitted_at
                        )
                    losers = [
                        (lrid, lfut) for lrid, lfut in req.live.items()
                        if lrid != replica_id
                    ]
                is_winner = req.winner == replica_id
            for lrid, lfut in losers:
                self._cancel_attempt(lrid, lfut)
            if is_winner and req.stream_cb is not None:
                req.stream_cb(token_id, piece, done)

        return cb

    def _cancel_attempt(self, replica_id: str, replica_future: Any) -> None:
        with self._handles_mu:
            handle = self._handles.get(replica_id)
        if handle is None:
            return
        try:
            handle.cancel(replica_future.request_id)
        except Exception:
            pass  # the loser may have terminated on its own already

    def _on_attempt_done(self, req: _RouterRequest, replica_id: str,
                         replica_future: Any) -> None:
        """Terminal event from one replica attempt. Runs on the
        replica's settlement thread: decide, then hand any re-route to
        the failover pool — never re-enter a (possibly wedged) replica
        from here."""
        with req.mu:
            req.live.pop(replica_id, None)
            span = req.spans.pop(replica_id, None)
            live_others = bool(req.live)
            winner = req.winner
        exc = replica_future.exception()
        if span is not None:
            span.set_attribute(
                "attempt.outcome",
                "ok" if exc is None else f"failed:{type(exc).__name__}",
            )
            span.end()
        if exc is None:
            result = replica_future.result()
            with req.mu:
                claimed = req.winner is None or req.winner == replica_id
                if claimed and req.winner is None:
                    req.winner = replica_id
            if not claimed:
                return  # a canceled hedge loser completing: drop it
            self._settle(req, result=result, replica_id=replica_id)
            return
        # failed attempt —
        if req.future.done():
            # the request already concluded — the winner settled the
            # client future (or cancel/deadline did). A canceled hedge
            # twin's transport failing AFTER that is bookkeeping, not a
            # failover: it must bump no counter and schedule no re-route
            # (its span was ended above — nothing leaks).
            return
        if winner == replica_id:
            # the client-visible stream died mid-flight: this attempt
            # claimed the stream (tokens crossed the wire), so a silent
            # re-run would duplicate a non-idempotent stream. Clean typed
            # error; the client holds the partial output and the retry
            # decision. NOTE: winner identity, not a token count — a
            # LOSING hedge twin failing while the winner streams must
            # fall through to the live_others check below, never settle.
            self._settle(req, error=exc, replica_id=replica_id)
            return
        if live_others:
            return  # the hedge twin is still running: it IS the failover
        if not isinstance(exc, RETRIABLE_ERRORS):
            self._settle(req, error=exc, replica_id=replica_id)
            return
        remaining = req.remaining()
        if remaining is not None and remaining <= 0:
            self._settle(
                req,
                error=ErrorDeadlineExceeded(
                    f"request {req.rid}: deadline passed during failover"
                ),
                replica_id=replica_id,
            )
            return
        if req.failovers >= self.config.max_failovers or req.canceled:
            self._settle(req, error=exc, replica_id=replica_id)
            return
        req.failovers += 1
        with self._stats_mu:
            self.failovers_total += 1
        if self._metrics is not None:
            self._metrics.increment_counter("app_router_failovers_total")
        try:
            self._failover_pool.submit(self._failover, req, exc)
        except RuntimeError:
            # router stopped between the failure and the re-route: the
            # client must still get its terminal — never a stranded future
            self._settle(req, error=exc, replica_id=replica_id)

    def _failover(self, req: _RouterRequest, cause: Exception) -> None:
        """Re-route after a pre-first-token replica failure: next
        candidate, original absolute deadline, tried replicas excluded
        (a replica that just failed this request does not get it back
        before the untried ones)."""
        try:
            # phase_role restricts the re-route to the decode pool on a
            # disaggregated tier: a failover must never land generation
            # work on a prefill-only replica
            candidates, _ = self._candidates_for(
                req.prompt, role=req.phase_role,
                tenant=req.kw.get("tenant"),
            )
            with req.mu:
                tried = set(req.tried)
            ordered = [c for c in candidates if c not in tried] or candidates
            last_error: Exception = cause
            for replica_id in ordered:
                try:
                    self._submit_attempt(req, replica_id, kind="failover")
                    return
                except RETRIABLE_ERRORS as exc:
                    last_error = exc
                    continue
                except ErrorDeadlineExceeded as exc:
                    self._settle(req, error=exc, replica_id=None)
                    return
            self._settle(req, error=last_error, replica_id=None)
        # gofrlint: disable=router-retry-untyped -- no retry happens here:
        # an unexpected raise (a handle whose pool was closed mid-shutdown
        # raises RuntimeError) would vanish into the failover pool and
        # strand the client future forever; settle it instead
        except BaseException as exc:
            self._settle(req, error=exc, replica_id=None)

    # -- hedging ---------------------------------------------------------------
    _TTFT_METRIC = "app_request_ttft_seconds"
    _TTFT_LABELS = {"source": "router"}

    def _ttft_histogram(self) -> Histogram:
        """The shared registered TTFT histogram (container/container.py)
        when a metrics manager is wired; a private instance of the SAME
        instrument type otherwise — either way ``percentile()`` is the
        one percentile implementation (no private sample ring)."""
        if self._metrics is not None:
            inst = self._metrics.get(self._TTFT_METRIC)
            if isinstance(inst, Histogram):
                return inst
        if self._private_ttft is None:
            self._private_ttft = Histogram(
                self._TTFT_METRIC, "router-observed time to first token"
            )
        return self._private_ttft

    def hedge_delay(self) -> float:
        """The armed hedge delay: the configured floor, raised to the
        observed TTFT p99 once enough samples exist (hedging inside
        normal first-token latency doubles prefill load for nothing)."""
        base = self.config.hedge_delay_s
        if base <= 0:
            return 0.0
        if not self.config.hedge_from_p99:
            return base
        hist = self._ttft_histogram()
        _, n = hist.snapshot(self._TTFT_LABELS)
        if n < 20:
            return base
        return max(base, hist.percentile(0.99, self._TTFT_LABELS))

    def _observe_ttft(self, seconds: float) -> None:
        # source=router keeps the router's submit→first-token series
        # distinct from the engine's admission-side TTFT in the shared
        # histogram — the hedge floor must key on what the CLIENT waits
        self._ttft_histogram().record(seconds, dict(self._TTFT_LABELS))

    def _arm_hedge(self, req: _RouterRequest) -> None:
        delay = self.hedge_delay()
        if delay <= 0:
            return

        def fire() -> None:
            try:
                self._failover_pool.submit(self._hedge, req)
            except RuntimeError:
                pass  # router stopped: the primary attempt stands alone

        timer = threading.Timer(delay, fire)
        timer.daemon = True
        req.hedge_timer = timer
        timer.start()

    def _hedge(self, req: _RouterRequest) -> None:
        """Hedge the prefill admission: when the first token still
        hasn't arrived, admit the same request on the next-best replica.
        First token wins; the loser is canceled before it streams. The
        hedge twin inherits the ORIGINAL deadline, like any re-route."""
        with req.mu:
            if (
                req.first_token_at is not None
                or req.future.done()
                or req.canceled
                or not req.live
            ):
                return
            tried = set(req.tried)
        candidates, _ = self._candidates_for(
            req.prompt, role=req.phase_role, tenant=req.kw.get("tenant")
        )
        for replica_id in candidates:
            if replica_id in tried:
                continue
            try:
                self._submit_attempt(req, replica_id, kind="hedge")
            except RETRIABLE_ERRORS:
                continue
            except ErrorDeadlineExceeded:
                return
            with self._stats_mu:
                self.hedges_total += 1
            if self._metrics is not None:
                self._metrics.increment_counter("app_router_hedges_total")
            return

    # -- settlement ------------------------------------------------------------
    def _settle(self, req: _RouterRequest, *, result: Any = None,
                error: Exception | None = None,
                replica_id: str | None = None) -> None:
        """Resolve the client future exactly once; cancel the hedge
        timer and any still-live twin attempts."""
        with req.mu:
            if req.future.done():
                return
            timer = req.hedge_timer
            req.hedge_timer = None
            leftovers = list(req.live.items())
            req.live = {}
            stray_spans = list(req.spans.values())
            req.spans = {}
            prefill_attempt = req.prefill_attempt
            req.prefill_attempt = None
        if timer is not None:
            timer.cancel()
        if prefill_attempt is not None:
            # a handoff prefill still in flight when the request settles
            # (canceled / expired): stop it burning prefill compute, and
            # end its span (its done-callback no-ops once the future is
            # settled here)
            prid, pfut, pspan = prefill_attempt
            self._cancel_attempt(prid, pfut)
            if pspan is not None:
                pspan.end()
        for span in stray_spans:
            # normally ended by each attempt's done-callback; a handle
            # whose future never settles must not leak its span
            span.end()
        for lrid, lfut in leftovers:
            self._cancel_attempt(lrid, lfut)
        with self._req_mu:
            self._requests.pop(req.rid, None)
        if error is not None:
            req.future.set_exception(error)
            return
        if result is not None and replica_id is not None:
            try:
                result.replica_id = replica_id  # terminal attribution
            except Exception:
                pass  # frozen/slotted result types keep working unlabeled
        req.future.set_result(result)

    def cancel(self, request_id: int) -> None:
        """Cancel a routed request on every replica it is live on."""
        with self._req_mu:
            req = self._requests.get(request_id)
        if req is None:
            return
        with req.mu:
            req.canceled = True
            live = list(req.live.items())
            prefill_attempt = req.prefill_attempt
        for replica_id, replica_future in live:
            self._cancel_attempt(replica_id, replica_future)
        if prefill_attempt is not None:
            self._cancel_attempt(prefill_attempt[0], prefill_attempt[1])

    # -- observability ---------------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        routable = self.membership.candidates()
        if not routable:
            status = "DOWN"
        elif any(
            self.membership.state_of(rid) == ms.UP for rid in routable
        ):
            status = "UP"
        else:
            # only SUSPECT (last-resort) candidates: routing is
            # best-effort — loud in health, not a soothing UP
            status = "DEGRADED"
        return {
            "status": status,
            "details": {
                "replicas": self.membership.snapshot(),
                "routable": routable,
                "routed_total": self.routed_total,
                "failovers_total": self.failovers_total,
                "hedges_total": self.hedges_total,
            },
        }

    def _counters(self) -> dict[str, Any]:
        with self._stats_mu:
            return {
                "routed_total": self.routed_total,
                "failovers_total": self.failovers_total,
                "hedges_total": self.hedges_total,
                "spills_total": self.spills_total,
                "no_replica_total": self.no_replica_total,
                "handoffs_total": self.handoffs_total,
                "handoff_degraded_total": self.handoff_degraded_total,
                "last_resort_routes_total": self.last_resort_routes_total,
                "routes_by_replica": dict(self.routes_by_replica),
            }

    def routerz(self) -> dict[str, Any]:
        """The ``/routerz`` health view: membership, routing counters,
        and the live knob values — everything an operator needs to see
        why a request went where it went."""
        return {
            "replicas": self.membership.snapshot(),
            "routable": self.membership.candidates(),
            "roles_present": sorted(self.membership.roles_present()),
            "aggregate_queue_wait_s": round(
                self.membership.aggregate_queue_wait(), 4
            ),
            "prefix_index": self.prefix_index.snapshot(),
            "counters": self._counters(),
            "config": {
                "heartbeat_s": self.config.heartbeat_s,
                "suspect_after_s": self.config.suspect_after_s,
                "down_after_s": self.config.down_after_s,
                "spill_wait_s": self.config.spill_wait_s,
                "affinity_prefix_tokens": self.config.affinity_prefix_tokens,
                "vnodes": self.config.vnodes,
                "max_failovers": self.config.max_failovers,
                "spill_hbm_frac": self.config.spill_hbm_frac,
                "hedge_delay_s": self.config.hedge_delay_s,
                "hedge_delay_armed_s": round(self.hedge_delay(), 4),
            },
        }
