"""The Inference gRPC service and client (a copy of
``gofr_tpu/grpcx/inference.py`` on the port's own wire).

The north-star serving surface over gRPC: unary Echo (the framework-overhead
probe), unary Generate, unary Embed, and server-streaming GenerateStream for
token-by-token decode. Wire format: JSON bytes with identity serializers —
the service is defined with generic method handlers, so no protoc step is
needed; any gRPC client sends ``application/grpc`` frames of UTF-8 JSON.

Servicers follow the reference's DI convention (grpc.go:222-269): a
``container`` attribute is injected at registration.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any

from gofr_tpu_torch.grpcx.h2 import Channel, StatusCode
from gofr_tpu_torch.grpcx.runtime import RpcMethodHandler, method_handler
from gofr_tpu_torch.http.errors import (
    ErrorDeadlineExceeded,
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.tracing.trace import current_span, format_traceparent

# the engine's typed lifecycle errors every generation RPC converts to a
# gRPC status instead of letting them surface as INTERNAL
LIFECYCLE_ERRORS = (
    ErrorTooManyRequests,
    ErrorServiceUnavailable,
    ErrorDeadlineExceeded,
    ErrorRequestEntityTooLarge,
)

SERVICE_NAME = "gofr.v1.Inference"


def _deadline_of(context: Any) -> float | None:
    """The gRPC-native deadline: clients set it on the call; the remaining
    budget propagates into the engine so queued work that cannot make it
    is dropped instead of decoded into the void."""
    try:
        remaining = context.time_remaining()
    except Exception:
        return None
    if remaining is None or remaining <= 0:
        return None
    return float(remaining)


async def _abort_lifecycle(context: Any, exc: Exception) -> None:
    """Map the engine's typed lifecycle errors onto gRPC status codes:
    shed → RESOURCE_EXHAUSTED (+ retry-delay detail), drain →
    UNAVAILABLE, expired → DEADLINE_EXCEEDED, can-never-fit →
    FAILED_PRECONDITION (permanent: retrying the same request is
    pointless, unlike every other status here)."""
    if isinstance(exc, ErrorRequestEntityTooLarge):
        await context.abort(StatusCode.FAILED_PRECONDITION, exc.message)
    if isinstance(exc, ErrorTooManyRequests):
        retry_after = exc.retry_after if exc.retry_after is not None else 1.0
        context.set_trailing_metadata((
            ("retry-delay-s", f"{retry_after:.3f}"),
        ))
        await context.abort(StatusCode.RESOURCE_EXHAUSTED, exc.message)
    if isinstance(exc, ErrorServiceUnavailable):
        await context.abort(StatusCode.UNAVAILABLE, exc.message)
    if isinstance(exc, ErrorDeadlineExceeded):
        await context.abort(StatusCode.DEADLINE_EXCEEDED, exc.message)
    raise exc

_identity = lambda b: b  # noqa: E731


def _trace_metadata() -> tuple | None:
    """Outbound W3C propagation: the caller's active span rides gRPC
    metadata as ``traceparent``, mirroring the HTTP header path."""
    span = current_span()
    if span is None:
        return None
    return (("traceparent", format_traceparent(span)),)


def _json_bytes(obj: Any) -> bytes:
    return json.dumps(obj).encode("utf-8")


async def _parse(request: bytes, context: Any) -> dict:
    """Malformed bodies are client errors: INVALID_ARGUMENT, not a handler
    panic/INTERNAL."""
    if not request:
        return {}
    try:
        data = json.loads(request.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError):
        await context.abort(StatusCode.INVALID_ARGUMENT, "request body must be UTF-8 JSON")
    return data if isinstance(data, dict) else {"value": data}


class InferenceService:
    """Register with ``app.register_grpc_service(InferenceService(engine))``
    or attach embedder params (``(bert_cfg, bert_params, tokenizer)``) for
    /Embed."""

    def __init__(self, engine: Any = None, embedder: Any = None) -> None:
        self.container: Any = None  # injected by GRPCServer.register
        self.engine = engine
        self.embedder = embedder  # (bert_cfg, bert_params, tokenizer)

    # -- gofr generic-service contract ----------------------------------------
    def gofr_service_name(self) -> str:
        return SERVICE_NAME

    def gofr_method_handlers(self) -> dict[str, RpcMethodHandler]:
        def unary(fn: Any) -> RpcMethodHandler:
            return method_handler("unary_unary", fn, _identity, _identity)

        return {
            "Echo": unary(self.echo),
            "Generate": unary(self.generate),
            "GenerateStream": method_handler("unary_stream", self.generate_stream,
                                             _identity, _identity),
            "Embed": unary(self.embed),
        }

    # -- methods ---------------------------------------------------------------
    async def echo(self, request: bytes, context: Any) -> bytes:
        """Framework-overhead calibration."""
        return request or b"{}"

    def _gen_kwargs(self, body: dict, context: Any = None) -> dict:
        kw = dict(
            max_new_tokens=int(body.get("max_tokens") or 0) or None,
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
        )
        # multi-tenant plane: adapter and tenant ride only when set,
        # mirroring the HTTP handlers; an x-tenant-id metadata entry (the
        # gateway's stamp) outranks the body field
        tenant = str(body.get("tenant") or "")
        if context is not None:
            try:
                for key, value in context.invocation_metadata() or ():
                    if key == "x-tenant-id" and value:
                        tenant = value
            except Exception:
                pass
        if body.get("adapter_id"):
            kw["adapter_id"] = str(body["adapter_id"])
        if tenant:
            kw["tenant"] = tenant
        return kw

    async def generate(self, request: bytes, context: Any) -> bytes:
        if self.engine is None:
            await context.abort(StatusCode.UNIMPLEMENTED, "no engine attached")
        body = await _parse(request, context)
        prompt = body.get("prompt")
        if not prompt:
            await context.abort(StatusCode.INVALID_ARGUMENT, "prompt required")
        try:
            # the interceptor's server span (which continued any inbound
            # traceparent metadata) is active here: hang the engine's
            # lifecycle spans off it
            result = await self.engine.generate(
                prompt, deadline=_deadline_of(context),
                trace_ctx=current_span(), **self._gen_kwargs(body, context)
            )
        except LIFECYCLE_ERRORS as exc:
            await _abort_lifecycle(context, exc)
        return _json_bytes(
            {
                "id": result.request_id,
                "text": result.text,
                "finish_reason": result.finish_reason,
                "usage": {
                    "prompt_tokens": result.prompt_tokens,
                    "completion_tokens": result.completion_tokens,
                    "ttft_ms": round(result.ttft_s * 1000, 2),
                },
            }
        )

    async def generate_stream(self, request: bytes, context: Any):
        """Server-streaming decode: one JSON frame per token. A client that
        cancels (RST_STREAM) cancels this task, and ``engine.stream``'s exit
        cancels the row, freeing its slot and pages."""
        if self.engine is None:
            await context.abort(StatusCode.UNIMPLEMENTED, "no engine attached")
        body = await _parse(request, context)
        prompt = body.get("prompt")
        if not prompt:
            await context.abort(StatusCode.INVALID_ARGUMENT, "prompt required")
        final: dict = {}
        try:
            async for token_id, piece in self.engine.stream(
                prompt, deadline=_deadline_of(context),
                on_result=lambda r: final.setdefault("result", r),
                trace_ctx=current_span(),
                **self._gen_kwargs(body, context),
            ):
                yield _json_bytes({"token": token_id, "text": piece})
        except LIFECYCLE_ERRORS as exc:
            await _abort_lifecycle(context, exc)
        result = final.get("result")
        done: dict[str, Any] = {"done": True}
        if result is not None:
            # deadline_exceeded mid-stream surfaces as the terminal frame's
            # finish_reason — the stream itself completed normally
            done["finish_reason"] = result.finish_reason
        yield _json_bytes(done)

    async def embed(self, request: bytes, context: Any) -> bytes:
        if self.embedder is None:
            await context.abort(StatusCode.UNIMPLEMENTED, "no embedder attached")
        import torch

        from gofr_tpu_torch.models import bert as bert_model
        from gofr_tpu_torch.serving.tokenizer import pad_batch

        body = await _parse(request, context)
        texts = body.get("input") or body.get("texts") or []
        if isinstance(texts, str):
            texts = [texts]
        if not texts:
            await context.abort(StatusCode.INVALID_ARGUMENT, "input required")
        bert_cfg, bert_params, tokenizer = self.embedder
        arr, lens = pad_batch(tokenizer, texts, bert_cfg.max_seq_len)
        # ids are checked on the host before the embedding gather on the card
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= bert_cfg.vocab_size):
            await context.abort(StatusCode.INVALID_ARGUMENT, "input ids past the vocabulary")
        device = bert_params["embedding"].device

        def run() -> Any:
            tokens = torch.from_numpy(arr).to(device)
            seq_lens = torch.tensor(lens, dtype=torch.int32, device=device)
            return bert_model.embed(bert_cfg, bert_params, tokens, seq_lens).cpu().numpy()

        emb = await asyncio.get_running_loop().run_in_executor(None, run)
        return _json_bytes({"embeddings": emb.tolist(), "dim": int(emb.shape[1])})


class InferenceClient:
    """Client for the Inference service over the port's channel (tests,
    the chip's smoke run, and the cluster plane's routing reuse it)."""

    def __init__(self, target: str) -> None:
        self.target = target
        self._channel = Channel(target)
        self._callables: dict[str, Any] = {}

    def _unary(self, method: str):
        # multicallables are stateless and reusable: one a method
        mc = self._callables.get(method)
        if mc is None:
            mc = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{method}",
                request_serializer=_identity,
                response_deserializer=_identity,
            )
            self._callables[method] = mc
        return mc

    async def echo(self, payload: dict) -> dict:
        resp = await self._unary("Echo")(_json_bytes(payload))
        return json.loads(resp)

    async def generate(self, prompt: str, **kw: Any) -> dict:
        resp = await self._unary("Generate")(
            _json_bytes({"prompt": prompt, **kw}), metadata=_trace_metadata()
        )
        return json.loads(resp)

    async def generate_stream(self, prompt: str, **kw: Any):
        stream = self._channel.unary_stream(
            f"/{SERVICE_NAME}/GenerateStream",
            request_serializer=_identity,
            response_deserializer=_identity,
        )(_json_bytes({"prompt": prompt, **kw}), metadata=_trace_metadata())
        async for frame in stream:
            yield json.loads(frame)

    async def embed(self, texts: list[str]) -> dict:
        resp = await self._unary("Embed")(_json_bytes({"input": texts}))
        return json.loads(resp)

    async def health(self) -> bool:
        check = self._channel.unary_unary(
            "/grpc.health.v1.Health/Check",
            request_serializer=_identity,
            response_deserializer=_identity,
        )
        resp = await check(b"")
        return resp == b"\x08\x01"

    async def close(self) -> None:
        await self._channel.close()
