"""The remote token-stream transport, client half (a copy of
``gofr_tpu/serving/remote.py`` over the port's errors, chaos tier and
service client; docs/serving.md).

Before this module, a remote replica behind ``HTTPReplica`` served unary
``POST /generate``: the router could not see a single token until the
WHOLE generation finished, so remote TTFT was capped at completion
latency, failover/hedging lost their pre-first-token semantics across
the wire, and a canceled hedge twin kept burning decode steps to the
end. This is the fix's transport layer (ROADMAP item 2; the
vLLM-vs-TGI methodology, arXiv:2511.17593, makes token-level streaming
latency the measurable axis):

- the server side is ``POST /generate/stream`` (serving/handlers.py):
  Server-Sent Events over chunked transfer — an ``{"id": N}`` frame
  first (the cancel wire's name for the request), one
  ``{"token", "text"}`` frame per decoded token, a terminal
  ``{"finish_reason", "usage"}`` frame, then ``data: [DONE]``;
- this module drives the client side over
  ``HTTPService.stream`` (service/client.py), dispatching each frame
  the moment it arrives, and maps the wire's terminal/error frames back
  to the same typed errors the in-process engine raises — the router's
  failover machinery cannot tell a remote replica from a local one;
- ``POST /generate/cancel {"id": N}`` stops the remote decode: the
  engine retires the row at the next block sync (within one block),
  and the stream ends with finish_reason ``cancel``.

The ``stream.remote`` chaos point sits on every frame read: a fault
there IS the transport tearing mid-stream — the reader raises
``ConnectionError`` and the router decides (pre-first-token: failover;
after: the typed error reaches the client, a stream is not idempotent).

This module runs on HTTPReplica's worker pool threads, never the event
loop — the frame reads BLOCK by design, exactly like the engine's
stream_cb contract expects.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable

from gofr_tpu_torch import chaos
from gofr_tpu_torch.http.errors import (
    ErrorDeadlineExceeded,
    ErrorEntityNotFound,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.service.options import retry_after_from_headers

__all__ = [
    "iter_events", "run_stream", "open_resume", "drain_resume",
    "resume_stream", "error_from_status",
]

STREAM_PATH = "/generate/stream"
CANCEL_PATH = "/generate/cancel"


def error_from_status(status: int, detail: str,
                      headers: dict[str, str] | None = None) -> Exception:
    """Map a remote replica's HTTP status (response head or in-stream
    error frame) to the typed error the router's RETRIABLE_ERRORS set
    keys on — the wire must not demote a retriable 503 to an opaque
    RuntimeError."""
    if status == 503:
        return ErrorServiceUnavailable(
            detail, retry_after=retry_after_from_headers(headers or {})
        )
    if status == 429:
        return ErrorTooManyRequests(
            retry_after=retry_after_from_headers(headers or {})
        )
    if status == 504:
        return ErrorDeadlineExceeded(detail)
    if status == 409:
        # the HA fence (docs/robustness.md "The HA plane"): this caller's
        # view of the replica is stale — refresh membership, don't retry
        return ErrorStaleEpoch(detail)
    if status == 404:
        # resume wire: unknown idempotency key or evicted replay window —
        # nothing to re-attach to; the client falls back to a keyed
        # submit (which dedups safely)
        return ErrorEntityNotFound("resume", detail)
    return RuntimeError(detail)


def iter_events(resp: Any, deadline_abs: float | None = None) -> Any:
    """Parse SSE ``data:`` frames off a streaming response, yielding
    each decoded JSON event as it arrives; returns at ``[DONE]`` or
    stream end. Unparseable frames are skipped (forward compatibility:
    a newer server may interleave event types this client predates).

    ``deadline_abs`` (``time.monotonic()`` terms) bounds the WHOLE
    stream, not just each socket read: the open-time ``timeout`` only
    caps per-read stalls, so without this gate an expired request keeps
    the remote decode — and this worker thread — running to the final
    frame. Checked between frames; the in-flight read still ends within
    one socket timeout.

    Sequence numbers (docs/serving.md "Resumable streams"): an ``id:``
    line preceding a frame is attached to the decoded event as ``seq`` —
    the client's ``Last-Event-ID`` re-attach currency. Streams from
    servers that predate sequencing simply yield events without it."""
    last_id: int | None = None
    for line in resp.lines():
        if deadline_abs is not None and time.monotonic() > deadline_abs:
            raise ErrorDeadlineExceeded(
                "remote stream exceeded the request deadline between frames"
            )
        if line.startswith("id:"):
            try:
                last_id = int(line[3:].strip())
            except ValueError:
                last_id = None
            continue
        if not line.startswith("data:"):
            continue  # SSE comments / keepalives
        payload = line[5:].strip()
        if payload == "[DONE]":
            return
        # the mid-stream tear seam: a fault here is the transport dying
        # between two frames
        chaos.maybe_fail("stream.remote")
        try:
            event = json.loads(payload)
        except ValueError:
            continue
        if isinstance(event, dict):
            if last_id is not None:
                event.setdefault("seq", last_id)
                last_id = None
            yield event


def run_stream(
    svc: Any,
    payload: dict[str, Any],
    *,
    headers: dict[str, str] | None = None,
    timeout: float | None = None,
    on_id: Callable[[int], None] | None = None,
    on_token: Callable[[int, str], None] | None = None,
    path: str = STREAM_PATH,
) -> dict[str, Any]:
    """Drive one remote streaming generation to its terminal frame.

    Opens ``POST {path}`` through the (breaker-aware) service client's
    ``stream``, dispatches ``on_id`` with the remote request id (the
    cancel wire's handle) and ``on_token`` per token frame, and returns
    the terminal event (``finish_reason`` + ``usage``). Raises the
    typed error for admission-time statuses (503/429/504 — real
    statuses, the head was not 200), for in-stream error frames
    (late deadline/drain, delivered as events because the 200 head was
    already on the wire), and ``ConnectionError`` for a stream that
    tore before its terminal frame."""
    # the request's whole-stream budget: `timeout` is the caller's
    # remaining deadline (HTTPReplica passes its deadline through), so
    # it bounds the open AND the frame loop — per-read socket stalls
    # are capped by the transport, the total by this clock
    deadline_abs = (
        time.monotonic() + timeout if timeout is not None else None
    )
    resp = svc.stream(
        "POST", path, json=payload, headers=headers, timeout=timeout,
    )
    if not resp.ok:
        try:
            detail = resp.read_body().decode("utf-8", "replace")[:200]
        except Exception:
            detail = ""
        finally:
            resp.close()
        raise error_from_status(
            resp.status_code,
            f"remote stream: HTTP {resp.status_code} {detail}".strip(),
            resp.headers,
        )
    terminal: dict[str, Any] | None = None
    try:
        for event in iter_events(resp, deadline_abs=deadline_abs):
            if "error" in event:
                raise error_from_status(
                    int(event.get("status") or 0), str(event["error"])
                )
            if "finish_reason" in event:
                terminal = event
            elif "token" in event:
                if on_token is not None:
                    on_token(int(event["token"]), str(event.get("text", "")))
            elif "id" in event:
                if on_id is not None:
                    on_id(int(event["id"]))
    finally:
        resp.close()
    if terminal is None:
        # the transport died between frames (or the server aborted
        # without its terminal): a retriable transport error — the
        # router knows whether tokens already crossed
        raise ConnectionError("remote stream ended without a terminal frame")
    return terminal


def open_resume(
    svc: Any,
    idempotency_key: str,
    *,
    last_seq: int = 0,
    fence_epoch: int | None = None,
    timeout: float | None = None,
    path: str = STREAM_PATH,
) -> Any:
    """Open (only) a keyed re-attach: ``POST {path}`` with
    ``Idempotency-Key`` + ``Last-Event-ID`` headers and no body. Raises
    the typed head errors SYNCHRONOUSLY — 404 (unknown key / evicted
    replay window), 409 (stale ``fence_epoch``), 503 — which is what
    lets the router's resume walk classify a replica that never saw the
    key and move to the next one, while the frame drain
    (``drain_resume``) runs on a pool worker. Returns the open streaming
    response (caller owns closing it)."""
    headers = {
        "Idempotency-Key": str(idempotency_key),
        "Last-Event-ID": str(int(last_seq)),
    }
    if fence_epoch:
        headers["X-Fence-Epoch"] = str(int(fence_epoch))
    resp = svc.stream("POST", path, json={}, headers=headers, timeout=timeout)
    if not resp.ok:
        try:
            detail = resp.read_body().decode("utf-8", "replace")[:200]
        except Exception:
            detail = ""
        finally:
            resp.close()
        raise error_from_status(
            resp.status_code,
            f"remote resume: HTTP {resp.status_code} {detail}".strip(),
            resp.headers,
        )
    return resp


def drain_resume(
    resp: Any,
    *,
    deadline_abs: float | None = None,
    on_frame: Callable[[int, int, str], None] | None = None,
) -> dict[str, Any]:
    """Drive an open resume response to its terminal frame.
    ``on_frame(seq, token_id, text)`` fires per replayed or live token
    frame; returns the terminal event. Closes the response."""
    terminal: dict[str, Any] | None = None
    try:
        for event in iter_events(resp, deadline_abs=deadline_abs):
            if "error" in event:
                raise error_from_status(
                    int(event.get("status") or 0), str(event["error"])
                )
            if "finish_reason" in event:
                terminal = event
            elif "token" in event:
                if on_frame is not None:
                    on_frame(
                        int(event.get("seq") or 0),
                        int(event["token"]),
                        str(event.get("text", "")),
                    )
    finally:
        resp.close()
    if terminal is None:
        raise ConnectionError("remote resume ended without a terminal frame")
    return terminal


def resume_stream(
    svc: Any,
    idempotency_key: str,
    *,
    last_seq: int = 0,
    fence_epoch: int | None = None,
    timeout: float | None = None,
    on_frame: Callable[[int, int, str], None] | None = None,
    path: str = STREAM_PATH,
) -> dict[str, Any]:
    """Re-attach to a keyed remote stream (docs/serving.md "Resumable
    streams"): ``open_resume`` + ``drain_resume`` on the caller thread —
    the server replays every frame past ``last_seq`` token-identically
    and rides the live generation. Typed raises: 404 (unknown key /
    evicted replay window — fall back to a keyed submit, which dedups
    safely), 409 (stale ``fence_epoch``), plus everything ``run_stream``
    can."""
    deadline_abs = (
        time.monotonic() + timeout if timeout is not None else None
    )
    resp = open_resume(
        svc, idempotency_key, last_seq=last_seq, fence_epoch=fence_epoch,
        timeout=timeout, path=path,
    )
    return drain_resume(resp, deadline_abs=deadline_abs, on_frame=on_frame)
