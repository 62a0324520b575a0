"""Ready-made serving handlers (a copy of ``gofr_tpu/serving/handlers.py``
over the port's app): /generate (JSON + SSE stream), /generate/cancel,
/ws/generate (WebSocket), /v1/models, /requestz (the request flight
recorder), /kv/fetch (warm KV migration's server half), /routerz, the
admin drain and /embed.

Wire-up (mirrors the reference's route ergonomics)::

    app = gofr_tpu_torch.app.App()
    engine = ServingEngine(cfg, params, metrics=app.container.metrics_manager,
                           tracer=app.container.tracer, logger=app.logger)
    register_generation_routes(app, engine)

Streaming: ``"stream": true`` returns Server-Sent Events over chunked
transfer — each token a ``data:`` line, final event carries usage stats.
``register_generation_ws`` is the WebSocket twin: a frame per token, then a
summary frame. ``register_embedding_routes`` serves /embed from a BERT
encoder's params; its native PJRT path is not ported.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any

from gofr_tpu_torch.http.errors import (
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorMissingParam,
    HTTPError,
)
from gofr_tpu_torch.http.responder import WireResponse
from gofr_tpu_torch.tracing.trace import current_span


@dataclasses.dataclass
class GenerateRequest:
    prompt: str = ""
    max_tokens: int = 0
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stream: bool = False
    # disaggregated serving (docs/robustness.md "The disaggregation
    # plane"): prefill_only runs the prompt KV into the prefix cache and
    # retires (finish_reason "handoff"); handoff_from names the prefill
    # replica this request's admission pulls its KV chain from
    prefill_only: bool = False
    handoff_from: str = ""
    # multi-tenant plane (docs/serving.md "Multi-tenancy"): the request's
    # LoRA adapter (unknown ids 400 at submit) and tenant (SLO class,
    # rate budget, the timeline/span/metric label). The X-Tenant-Id
    # header overrides the body field so gateways can stamp tenancy
    # without rewriting payloads.
    adapter_id: str = ""
    tenant: str = ""
    # HA plane (docs/robustness.md "The HA plane"): the client's
    # Idempotency-Key — a duplicate submit attaches to the live request
    # or replays its terminal instead of dispatching twice (the header
    # outranks the body field, same contract as tenancy); fence_epoch
    # stamps the caller's view of the replica's fence epoch — stale
    # callers are rejected 409 before any engine state is touched.
    idempotency_key: str = ""
    fence_epoch: int = 0


def _shutdown_hook(engine: Any) -> Any:
    """Drain, not stop: SIGTERM lets in-flight generations finish within
    the drain deadline instead of abandoning their streams (engines
    without drain — injected test doubles — fall back to stop)."""
    return getattr(engine, "drain", None) or engine.stop


def _wire_lifecycle(app: Any, engine: Any, supervisor: Any) -> None:
    """Start/shutdown hooks for the generation surfaces. With a
    supervisor (serving/supervisor.py), IT owns the lifecycle: start
    brings up engine + watchdog, shutdown halts the watchdog FIRST so the
    deliberate drain quiet-period is never detected as a stall."""
    if supervisor is not None:
        app.on_start(lambda ctx: supervisor.start())
        app.on_shutdown(supervisor.drain)
    else:
        app.on_start(lambda ctx: engine.start())
        app.on_shutdown(_shutdown_hook(engine))


def deadline_from_ctx(ctx: Any) -> float | None:
    """The HTTP deadline contract: ``X-Request-Timeout`` (or bare
    ``Request-Timeout``), seconds, float. Invalid values are a client
    error, not a silently-ignored header."""
    raw = ctx.header("x-request-timeout") or ctx.header("request-timeout")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        raise ErrorInvalidParam("X-Request-Timeout") from None
    return value if value > 0 else None


def register_generation_routes(app: Any, engine: Any, prefix: str = "",
                               supervisor: Any = None) -> None:
    app.container.serving = engine
    _wire_lifecycle(app, engine, supervisor)

    async def generate(ctx: Any):
        body = ctx.bind(GenerateRequest)
        kw = _request_kwargs(ctx, body)
        if body.stream:
            return _sse_response(engine, body.prompt, kw)
        result = await engine.generate(body.prompt, **kw)
        return {
            "id": result.request_id,
            "text": result.text,
            "finish_reason": result.finish_reason,
            "usage": {
                "prompt_tokens": result.prompt_tokens,
                "completion_tokens": result.completion_tokens,
                "ttft_ms": round(result.ttft_s * 1000, 2),
                "duration_ms": round(result.duration_s * 1000, 2),
            },
        }

    def models(ctx: Any):
        cfg = engine.model_cfg
        return {
            "models": [
                {
                    "id": "flagship",
                    "family": "llama",
                    "n_layers": cfg.n_layers,
                    "d_model": cfg.d_model,
                    "vocab_size": cfg.vocab_size,
                    "max_seq_len": engine.config.max_seq_len,
                    "slots": engine.config.max_slots,
                }
            ]
        }

    async def generate_stream(ctx: Any):
        """The remote token-stream transport (docs/serving.md): always
        streams, whatever the body's ``stream`` flag says — a router's
        HTTPReplica needs a surface whose FIRST byte is the request id
        frame and whose tokens arrive as they decode, so remote TTFT is
        decoupled from completion time.

        Re-attach (docs/serving.md "Resumable streams"): a request with
        BOTH ``Last-Event-ID`` and ``Idempotency-Key`` headers resumes
        the keyed stream instead of submitting — the engine replays every
        frame past the acked seq token-identically and the response rides
        the still-running generation. No prompt needed (the original
        submit owns it), so the branch runs before body validation."""
        last_id = ctx.header("last-event-id")
        idem = ctx.header("idempotency-key")
        if last_id and idem and hasattr(engine, "resume"):
            return _sse_resume_response(engine, ctx, idem, last_id)
        body = ctx.bind(GenerateRequest)
        kw = _request_kwargs(ctx, body)
        return _sse_response(engine, body.prompt, kw)

    async def generate_cancel(ctx: Any):
        """The remote cancel wire: ``{"id": N}`` marks the request
        canceled — a running row frees its slot at the next block sync
        (its stream ends with finish_reason "cancel"), a queued one
        resolves at admission. Idempotent; an unknown id is a no-op
        (the request may have finished while the cancel was in flight)."""
        body = ctx.bind(dict) or {}
        rid = body.get("id")
        if rid is None:
            raise ErrorMissingParam("id")
        try:
            rid = int(rid)
        except (TypeError, ValueError):
            raise ErrorInvalidParam("id") from None
        engine.cancel(rid)
        return {"canceled": rid}

    app.post(prefix + "/generate", generate)
    app.post(prefix + "/generate/stream", generate_stream)
    app.post(prefix + "/generate/cancel", generate_cancel)
    app.get(prefix + "/v1/models", models)
    register_requestz_routes(app, engine, prefix + "/requestz")
    register_kv_fetch_routes(app, engine, prefix + "/kv/fetch")


def _sse_response(engine: Any, prompt: str, kw: dict) -> WireResponse:
    # submit EAGERLY, inside the handler, before the 200 head is committed:
    # admission-time rejections (shed 429 + Retry-After, drain 503) must
    # reach the client as real statuses retry middleware can key on, not
    # as error events buried in a 200 stream
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    def cb(token_id: int, piece: str, done: bool) -> None:
        loop.call_soon_threadsafe(q.put_nowait, (token_id, piece, done))

    future = engine.submit(prompt, stream_cb=cb, **kw)

    async def gen():
        try:
            # id frame FIRST (docs/serving.md wire format): the remote
            # cancel wire needs the request id before any token arrives —
            # a client that hedges/aborts pre-first-token must be able to
            # name what it is canceling. ``id:`` lines carry the frame
            # sequence (id frame 0, tokens 1..N, terminal N+1) — the
            # handler's local count provably matches the engine-side
            # replay ring (same ordered single-worker detok stream), so a
            # client's Last-Event-ID re-attach replays exactly the unseen
            # suffix (docs/serving.md "Resumable streams"). A keyed
            # duplicate that attached PAST the replay window starts at the
            # engine's true sequence (``stream_base_seq``), announced in
            # the head frame as ``attached_at`` — its ``id:`` lines still
            # name real engine frames, so a later Last-Event-ID resumes
            # correctly even on a truncated stream.
            base = getattr(future, "stream_base_seq", 0)
            head = {"id": future.request_id}
            if base:
                head["attached_at"] = base
            yield (
                f"id: {base}\ndata: " + json.dumps(head) + "\n\n"
            ).encode()
            seq = base
            while True:
                token_id, piece, done = await q.get()
                if done:
                    break
                seq += 1
                payload = json.dumps({"token": token_id, "text": piece})
                yield f"id: {seq}\ndata: {payload}\n\n".encode()
            result = await asyncio.wrap_future(future)
            if result is not None:
                # terminal event: finish_reason (stop/length/cancel/
                # deadline_exceeded) + usage, so streaming clients learn WHY
                # the stream ended, not just that it did
                yield (
                    f"id: {seq + 1}\ndata: " + json.dumps({
                        "finish_reason": result.finish_reason,
                        "usage": {
                            "prompt_tokens": result.prompt_tokens,
                            "completion_tokens": result.completion_tokens,
                        },
                    }) + "\n\n"
                ).encode()
            yield b"data: [DONE]\n\n"
        except asyncio.CancelledError:
            raise
        except HTTPError as exc:
            # the response head (200, chunked) is already on the wire by
            # now; a LATE typed error (queued-expiry 504, drain-deadline
            # 503) becomes a terminal error event instead of a torn
            # connection — admission errors never reach here, they raised
            # from the eager submit above with a real status. Error
            # frames carry no id: the dedup entry is forgotten on an
            # exception terminal, so there is nothing to resume past.
            yield (
                "data: " + json.dumps({
                    "error": exc.message, "status": exc.status_code,
                }) + "\n\n"
            ).encode()
            yield b"data: [DONE]\n\n"
        finally:
            # client disconnected mid-stream (server aclose()s the
            # generator): free the slot instead of decoding into the void.
            # A KEYED stream is resumable — the disconnect may be a dying
            # router whose survivor re-attaches — so it parks for the
            # orphan-grace window instead of canceling outright.
            if not future.done():
                if kw.get("idempotency_key") and hasattr(engine, "orphan"):
                    engine.orphan(future.request_id)
                else:
                    engine.cancel(future.request_id)

    return WireResponse(
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        },
        stream=gen(),
    )


def _sse_resume_response(engine: Any, ctx: Any, idem_key: str,
                         last_raw: str) -> WireResponse:
    """The ``Last-Event-ID`` re-attach wire: replays the keyed stream's
    unseen suffix (token-identical, from the engine's bounded replay
    ring or the stored terminal) and rides the live generation. Resume
    errors (unknown key 404, evicted window 404, stale epoch 409) raise
    BEFORE the head commits — real statuses clients can key on."""
    try:
        last_seq = int(last_raw)
    except (TypeError, ValueError):
        raise ErrorInvalidParam("Last-Event-ID") from None
    fence_raw = ctx.header("x-fence-epoch")
    fence_epoch = None
    if fence_raw:
        try:
            fence_epoch = int(fence_raw)
        except ValueError:
            raise ErrorInvalidParam("X-Fence-Epoch") from None
    loop = asyncio.get_running_loop()
    q: asyncio.Queue = asyncio.Queue()

    def cb(seq: int, token_id: int, piece: str, done: bool) -> None:
        loop.call_soon_threadsafe(q.put_nowait, (seq, token_id, piece, done))

    future = engine.resume(
        idem_key, last_seq=last_seq, stream_cb=cb, fence_epoch=fence_epoch
    )

    async def gen():
        try:
            # re-attach head frame: names the request and echoes the seq
            # the replay starts after; id stays at the client's own
            # high-water mark so a naive tracker never regresses
            yield (
                f"id: {last_seq}\ndata: " + json.dumps({
                    "id": future.request_id, "resumed": last_seq,
                }) + "\n\n"
            ).encode()
            term_seq = last_seq
            while True:
                seq, token_id, piece, done = await q.get()
                if done:
                    term_seq = seq
                    break
                payload = json.dumps({"token": token_id, "text": piece})
                yield f"id: {seq}\ndata: {payload}\n\n".encode()
            result = await asyncio.wrap_future(future)
            if result is not None:
                yield (
                    f"id: {term_seq}\ndata: " + json.dumps({
                        "finish_reason": result.finish_reason,
                        "usage": {
                            "prompt_tokens": result.prompt_tokens,
                            "completion_tokens": result.completion_tokens,
                        },
                    }) + "\n\n"
                ).encode()
            yield b"data: [DONE]\n\n"
        except asyncio.CancelledError:
            raise
        except HTTPError as exc:
            yield (
                "data: " + json.dumps({
                    "error": exc.message, "status": exc.status_code,
                }) + "\n\n"
            ).encode()
            yield b"data: [DONE]\n\n"
        finally:
            # a resumed stream is keyed by construction: its disconnect
            # parks for the grace window like the original stream's did
            if not future.done():
                orphan = getattr(engine, "orphan", None)
                if orphan is not None:
                    orphan(future.request_id)
                else:
                    engine.cancel(future.request_id)

    return WireResponse(
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
        },
        stream=gen(),
    )


def _validated_generate_kwargs(body: GenerateRequest) -> dict:
    """One binding/validation behavior for every generation surface
    (HTTP, SSE): raises the typed param errors."""
    if not body.prompt:
        raise ErrorMissingParam("prompt")
    if body.temperature < 0 or body.top_p <= 0 or body.top_p > 1:
        raise ErrorInvalidParam("temperature", "top_p")
    kw = dict(
        max_new_tokens=body.max_tokens or None,
        temperature=body.temperature,
        top_k=body.top_k,
        top_p=body.top_p,
    )
    # disaggregation flags ride only when set: engines without the
    # disaggregation plane (injected doubles) keep their old signature
    if body.prefill_only:
        kw["prefill_only"] = True
    if body.handoff_from:
        kw["handoff_from"] = body.handoff_from
    # tenancy flags likewise ride only when set
    if body.adapter_id:
        kw["adapter_id"] = body.adapter_id
    if body.tenant:
        kw["tenant"] = body.tenant
    # HA-plane flags ride only when set, same engine-double contract
    if body.idempotency_key:
        kw["idempotency_key"] = body.idempotency_key
    if body.fence_epoch:
        kw["fence_epoch"] = int(body.fence_epoch)
    return kw


def _request_kwargs(ctx: Any, body: GenerateRequest) -> dict:
    """The ONE per-request kwargs assembly every HTTP generation
    route uses: validated body kwargs, then the context-derived fields —
    the deadline header, the caller's trace context, and the tenancy
    contract: ``X-Tenant-Id`` outranks the body's ``tenant`` field (a
    gateway stamping tenancy must win over whatever the client
    claimed)."""
    kw = _validated_generate_kwargs(body)
    header_tenant = ctx.header("x-tenant-id")
    if header_tenant:
        kw["tenant"] = header_tenant
    header_idem = ctx.header("idempotency-key")
    if header_idem:
        kw["idempotency_key"] = header_idem
    # a gateway stamping the fence outranks the body's claim, same as
    # tenancy; 0 means unfenced (epochs start at 1), same as the body
    fence_raw = ctx.header("x-fence-epoch")
    if fence_raw:
        try:
            fence = int(fence_raw)
        except ValueError:
            raise ErrorInvalidParam("X-Fence-Epoch") from None
        if fence:
            kw["fence_epoch"] = fence
    kw["deadline"] = deadline_from_ctx(ctx)
    # hang the engine's lifecycle spans off the request's server span
    # (which carries the inbound W3C traceparent when one was sent)
    kw["trace_ctx"] = current_span()
    return kw


def register_generation_ws(app: Any, engine: Any, path: str = "/ws/generate",
                           supervisor: Any = None) -> None:
    """WebSocket token streaming: each inbound message is a generate
    request; tokens push back as JSON frames, then a final summary frame.
    The WS twin of the SSE stream (gofr websocket.go:30-49 handler loop ×
    the gRPC server-stream decode), for clients that want bidirectional
    framing. Wires the engine lifecycle like register_generation_routes,
    so registering only the WS surface still serves."""
    app.container.serving = engine
    _wire_lifecycle(app, engine, supervisor)

    async def ws_generate(ctx: Any):
        body = ctx.bind(GenerateRequest)
        kw = _request_kwargs(ctx, body)
        n = 0
        final: dict = {}
        try:
            async for token_id, piece in engine.stream(
                body.prompt, on_result=lambda r: final.setdefault("result", r),
                **kw,
            ):
                n += 1
                # AWAIT each frame: fire-and-forget sends could reorder
                # after the final summary frame, and a dead/closed socket
                # must surface HERE so engine.stream's finally cancels the
                # request instead of decoding into the void
                await ctx.websocket.send_async(
                    json.dumps({"token": token_id, "text": piece})
                )
        except (ConnectionError, OSError):
            # routine client departure mid-stream, not a server panic: the
            # stream generator's finally already canceled the request
            return None
        result = final.get("result")
        summary = {"done": True, "tokens": n}
        if result is not None:
            summary["finish_reason"] = result.finish_reason
        return summary

    app.websocket(path, ws_generate)


def register_requestz_routes(app: Any, engine: Any,
                             path: str = "/requestz") -> None:
    """The request flight recorder (docs/observability.md): GET
    ``/requestz`` returns every in-flight request timeline plus the
    bounded ring of recently completed ones; ``/requestz/<request_id>``
    returns one timeline in full. Pure host-side data stamped at points
    the engine thread already touches — scraping this view costs zero
    device syncs. Registered automatically by
    ``register_generation_routes``; callable directly for bare engines."""
    recorder = getattr(engine, "timeline", None)

    async def requestz(ctx: Any):
        if recorder is None:
            return {"in_flight": [], "completed": [],
                    "error": "engine has no timeline recorder"}
        raw_limit = ctx.param("limit")
        try:
            limit = int(raw_limit) if raw_limit else 64
        except ValueError:
            raise ErrorInvalidParam("limit") from None
        return recorder.snapshot(limit=limit)

    async def requestz_one(ctx: Any):
        if recorder is None:
            raise ErrorEntityNotFound("timeline", ctx.path_param("request_id"))
        raw = ctx.path_param("request_id")
        try:
            rid = int(raw)
        except ValueError:
            raise ErrorInvalidParam("request_id") from None
        tl = recorder.get(rid)
        if tl is None:
            raise ErrorEntityNotFound("timeline", raw)
        return tl.to_dict()

    app.get(path, requestz)
    app.get(path + "/{request_id}", requestz_one)


def register_kv_fetch_routes(app: Any, engine: Any,
                             path: str = "/kv/fetch") -> None:
    """Warm KV page migration, server half (docs/performance.md "KV
    reuse tiers"): POST ``{"keys": [...]}`` returns the requested
    prefix-cache entries — whole-prompt prefills and chunk-boundary K/V
    delta slabs — serialized for the wire
    (serving/prefix_index.encode_entry). Keys the cache no longer holds
    are simply absent from the response: the advertisement that named
    them was stale, and the fetching replica degrades to a compute miss.
    The device→host materialization (``encode_entry`` reads the card's
    tensors) runs in the event loop's executor, never on the engine thread
    or the event loop. Registered automatically by
    ``register_generation_routes``.

    A request whose ``Accept`` names ``KV_WIRE_CONTENT_TYPE`` (the port's
    ``HTTPReplica.fetch_kv`` sends it) gets the same entries as one binary
    body of raw slabs (``encode_entries_binary``); any other request, a
    reference client's included, gets the JSON body."""
    from gofr_tpu_torch.http.response import File
    from gofr_tpu_torch.serving.prefix_index import (
        KV_WIRE_CONTENT_TYPE,
        encode_entries_binary,
        encode_entry,
    )

    MAX_KEYS = 64  # one fetch moves at most one prompt's chain

    async def kv_fetch(ctx: Any):
        body = ctx.bind(dict) or {}
        # HA plane: a fenced caller (zombie router on a pre-restart
        # membership view) is rejected 409 before any cache is touched
        fence = body.get("fence_epoch")
        if fence is not None:
            try:
                fence = int(fence)
            except (TypeError, ValueError):
                # malformed fence is the CALLER's bug: a typed 400, not
                # an uncaught ValueError surfacing as a 500
                raise ErrorInvalidParam("fence_epoch") from None
            check = getattr(engine, "check_fence", None)
            if check is not None:
                check(fence)
        keys = body.get("keys")
        if not keys or not isinstance(keys, list):
            raise ErrorMissingParam("keys")
        if len(keys) > MAX_KEYS:
            raise ErrorInvalidParam("keys")
        binary = KV_WIRE_CONTENT_TYPE in ctx.header("Accept")

        def gather() -> Any:
            # peek, never get: serving a peer must not mutate this
            # replica's LRU order or pop its host-tier copies; a
            # tensor-parallel engine's entries come whole, from every rank
            found = engine.export_kv([str(key) for key in keys])
            if binary:
                return encode_entries_binary(found)
            return {key: encode_entry(value) for key, value in found.items()}

        # off the event loop: encoding materializes device arrays
        # host-side (a sync) and copies megabytes of slab
        out = await asyncio.get_running_loop().run_in_executor(None, gather)
        if binary:
            return File(content=out, content_type=KV_WIRE_CONTENT_TYPE)
        return {"entries": out}

    app.post(path, kv_fetch)


def register_router_routes(app: Any, router: Any,
                           path: str = "/routerz") -> None:
    """The router tier's health view (docs/robustness.md "The router
    plane"): GET ``/routerz`` returns membership (per-replica state,
    heartbeat age, queue-wait, KV headroom), routing counters and the
    live knob values. Also hands the router to the container so
    ``/.well-known/health`` aggregates it, and wires start/stop into the
    app lifecycle."""
    app.container.register_datasource("router", router)

    async def routerz_handler(ctx: Any):
        return router.routerz()

    app.get(path, routerz_handler)
    app.on_start(lambda ctx: router.start())
    app.on_shutdown(router.stop)


def register_admin_drain(app: Any, path: str = "/.well-known/drain") -> None:
    """The admin drain trigger: POST flips the app to DRAINING (same path
    SIGTERM takes — new work rejected with a retriable 503, in-flight
    generations finish within the drain deadline) and schedules shutdown.
    NOT registered by default: wire it behind auth middleware — an
    unauthenticated drain endpoint is a one-request denial of service. The
    port's auth middleware authenticates a POST under ``/.well-known/``
    (``http/middleware/auth.py``), so the default path is behind it."""

    async def drain_handler(ctx: Any):
        app.drain()
        return {"status": "DRAINING"}

    app.post(path, drain_handler)


def register_embedding_routes(app: Any, bert_cfg: Any, bert_params: Any,
                              tokenizer: Any, prefix: str = "",
                              native_embedder: Any = None) -> None:
    """The /embed endpoint (BASELINE.json configs[1]): tokenize, right-pad to
    a bucket (``pad_batch``), run ``models.bert.embed`` in the executor on
    the device the params live on. The body's ``input`` (or ``texts``) is a
    string or a list of them; the answer carries ``embeddings``, ``dim``,
    ``engine`` (``"torch"``) and ``usage.prompt_tokens``.

    The reference's native PJRT path (``native_embedder=``, or
    ``TPU_NATIVE_PJRT=1`` in the app's config) binds libtpu and has no
    counterpart on the card (ROADMAP Queue A item 7): either refuses here,
    at registration, instead of being ignored."""
    import numpy as np
    import torch

    from gofr_tpu_torch.models import bert as bert_model
    from gofr_tpu_torch.serving.tokenizer import pad_batch

    config = getattr(app.container, "config", None)
    if native_embedder is not None or (
        config is not None and config.get_or_default("TPU_NATIVE_PJRT", "0") == "1"
    ):
        raise NotImplementedError(
            "the native PJRT embedder binds libtpu and is not ported (ROADMAP Queue A "
            "item 7); /embed runs models.bert.embed"
        )
    # an id past the vocabulary would reach the embedding gather, a sticky
    # device assert on the card (the reference's gather clamps it): refuse
    # a tokenizer that says it makes such ids, and answer 400 to a request
    # whose ids still reach past it (ROADMAP Queue C 36)
    tok_vocab = getattr(tokenizer, "vocab_size", None)
    if tok_vocab is not None and tok_vocab > bert_cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocabulary {tok_vocab} exceeds the model's {bert_cfg.vocab_size}: "
            "its ids would index past the embedding"
        )
    device = bert_params["embedding"].device

    def run(arr: np.ndarray, lens: list[int]) -> np.ndarray:
        tokens = torch.from_numpy(arr).to(device)
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=device)
        return bert_model.embed(bert_cfg, bert_params, tokens, seq_lens).cpu().numpy()

    async def embed(ctx: Any):
        body = ctx.bind(dict) or {}
        texts = body.get("input") or body.get("texts")
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            raise ErrorMissingParam("input")
        arr, lens = pad_batch(tokenizer, texts, bert_cfg.max_seq_len)
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= bert_cfg.vocab_size):
            raise ErrorInvalidParam("input")  # host-side ids: no device sync
        emb = await asyncio.get_running_loop().run_in_executor(None, run, arr, lens)
        return {
            "embeddings": emb.tolist(),
            "dim": int(emb.shape[1]),
            "engine": "torch",
            "usage": {"prompt_tokens": int(sum(lens))},
        }

    app.post(prefix + "/embed", embed)
