"""Runtime support for the port's typed gRPC services (a copy of
``gofr_tpu/grpcx/runtime.py`` on the port's own wire).

Generated modules (``grpcx/codegen.py``) stay thin, as the reference's
gofr-cli output (``*_gofr.go``, chatservice_gofr.go:29-120) does: message
classes built from an embedded ``FileDescriptorSet`` and a servicer base
class a service; the behaviour lives here:

- :func:`load_messages`: one message class a type, over the port's
  protobuf wire (``grpcx/protowire.py``), in place of protobuf's descriptor
  pool and message factory;
- :class:`ProtoRequest`: a proto message as the framework's ``Request``, so
  ``ctx.bind`` works in gRPC handlers (request_gofr.go:15-53), binding
  through :meth:`protowire.Message.to_dict` with ``MessageToDict``'s rules;
- :class:`GofrStream`: the typed, instrumented stream endpoint (every
  ``send``/``recv`` logged at DEBUG and counted on
  ``app_grpc_message_total``);
- :class:`GofrGrpcService`: the generated ``METHODS`` table as method-handler
  records (:class:`RpcMethodHandler` from :func:`method_handler`, in place of
  ``grpc.*_rpc_method_handler``), a ``Context`` built first so user methods
  keep the Context-first signature.

``StatusCode``, ``RpcError``, ``AbortError`` and the servicer context come
from ``grpcx/h2.py`` and carry grpcio's names and values.
"""

from __future__ import annotations

import asyncio
import dataclasses
import inspect
from typing import Any, AsyncIterator, Callable

from gofr_tpu_torch.grpcx.h2 import AbortError, RpcError, ServicerContext, StatusCode
from gofr_tpu_torch.grpcx.protowire import load_messages

__all__ = [
    "AbortError", "GofrGrpcService", "GofrStream", "ProtoRequest", "RpcError",
    "RpcMethodHandler", "ServicerContext", "StatusCode", "load_messages", "method_handler",
]


@dataclasses.dataclass
class RpcMethodHandler:
    """One method's handler: its behaviour ``(request | request iterator,
    context)``, the kind, and the (de)serializers (``grpc.RpcMethodHandler``'s
    fields)."""

    behavior: Callable
    request_streaming: bool
    response_streaming: bool
    request_deserializer: Callable | None = None
    response_serializer: Callable | None = None


# kind → (request streaming, response streaming)
_KIND_FLAGS = {"unary_unary": (False, False), "unary_stream": (False, True),
               "stream_unary": (True, False), "stream_stream": (True, True)}


def method_handler(kind: str, behavior: Callable, request_deserializer: Callable | None = None,
                   response_serializer: Callable | None = None) -> RpcMethodHandler:
    req, resp = _KIND_FLAGS[kind]
    return RpcMethodHandler(behavior, req, resp, request_deserializer, response_serializer)


class ProtoRequest:
    """``Request`` implementation over a proto message + gRPC metadata."""

    def __init__(self, message: Any, context: Any = None) -> None:
        self.message = message
        self._context = context

    def param(self, key: str) -> str:
        try:
            return str(getattr(self.message, key))
        except AttributeError:
            return ""

    def params(self, key: str) -> list[str]:
        try:
            value = getattr(self.message, key)
        except AttributeError:
            return []
        if isinstance(value, (list, tuple)) or hasattr(value, "append"):
            return [str(v) for v in value]
        return [str(value)] if str(value) else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def header(self, key: str) -> str:
        if self._context is None:
            return ""
        for mk, mv in self._context.invocation_metadata() or ():
            if mk.lower() == key.lower():
                return mv
        return ""

    def host_name(self) -> str:
        return self._context.peer() if self._context is not None else ""

    def bind(self, target: Any) -> Any:
        """Bind the proto message into ``target``: the message itself, a
        dict, or a dataclass with matching field names."""
        if target is None or target is type(self.message) or isinstance(target, type(self.message)):
            return self.message
        as_dict = self.message.to_dict(preserving_proto_field_name=True)
        if target is dict:
            return as_dict
        cls = target if isinstance(target, type) else type(target)
        if dataclasses.is_dataclass(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in as_dict.items() if k in names})
        obj = target if not isinstance(target, type) else cls()
        for k, v in as_dict.items():
            setattr(obj, k, v)
        return obj


class GofrStream:
    """Typed stream endpoint handed to user handlers of streaming RPCs.

    ``recv()`` pulls the next client message (``None`` at end of stream);
    ``send()`` pushes a response frame; ``async for`` iterates requests.
    Every message movement is instrumented (per-Send/Recv DEBUG log +
    counter) like the reference's generated stream wrappers.
    """

    def __init__(
        self,
        method: str,
        container: Any,
        request_iterator: AsyncIterator[Any] | None,
        response_cls: type | None,
    ) -> None:
        self.method = method
        self._container = container
        self._requests = request_iterator
        self._response_cls = response_cls
        # frames queued by send(), drained concurrently by the behavior so
        # push-style handlers stream incrementally (no buffering to the end)
        self._out: "asyncio.Queue[Any]" = asyncio.Queue()
        self.sent = 0
        self.received = 0

    def _observe(self, direction: str, msg: Any) -> None:
        c = self._container
        if c is None:
            return
        c.logger.debug(f"gRPC {self.method} {direction} {type(msg).__name__}")
        m = getattr(c, "metrics_manager", None)
        if m is not None and m.get("app_grpc_message_total") is not None:
            m.increment_counter("app_grpc_message_total", method=self.method, direction=direction)

    async def recv(self) -> Any:
        if self._requests is None:
            raise RuntimeError(f"{self.method} has no client stream to recv from")
        try:
            msg = await self._requests.__anext__()
        except StopAsyncIteration:
            return None
        self.received += 1
        self._observe("recv", msg)
        return msg

    def __aiter__(self) -> "GofrStream":
        return self

    async def __anext__(self) -> Any:
        msg = await self.recv()
        if msg is None:
            raise StopAsyncIteration
        return msg

    def send(self, msg: Any) -> None:
        if self._response_cls is not None and not isinstance(msg, self._response_cls):
            raise TypeError(
                f"{self.method} must send {self._response_cls.__name__}, got {type(msg).__name__}"
            )
        self.sent += 1
        self._observe("send", msg)
        self._out.put_nowait(msg)


class GofrGrpcService:
    """Base class for generated servicers.

    Subclass contract (written by codegen): ``SERVICE_NAME``,
    ``FILE_DESCRIPTOR_SET`` (serialized bytes), ``MESSAGES`` (full-name →
    class) and ``METHODS`` (name → (kind, in_type, out_type)); one async
    method per RPC with the Context-first signature:

    - unary_unary:   ``async def M(self, ctx, request) -> Response``
    - unary_stream:  ``async def M(self, ctx, request, stream)`` —
      push frames with ``stream.send``; or an async generator
      ``async def M(self, ctx, request)`` yielding responses
    - stream_unary:  ``async def M(self, ctx, stream) -> Response``
    - stream_stream: ``async def M(self, ctx, stream)`` — ``recv`` and
      ``send`` freely; or an async generator over ``stream``
    """

    SERVICE_NAME: str = ""
    FILE_DESCRIPTOR_SET: bytes = b""
    MESSAGES: dict[str, Any] = {}
    METHODS: dict[str, tuple[str, str, str]] = {}

    def __init__(self) -> None:
        self.container: Any = None  # injected by GRPCServer.register

    # -- gofr generic-service contract ------------------------------------
    def gofr_service_name(self) -> str:
        return self.SERVICE_NAME

    def gofr_file_descriptor_set(self) -> bytes:
        return self.FILE_DESCRIPTOR_SET

    def _context(self, request: Any, grpc_context: Any) -> Any:
        from gofr_tpu_torch.context import Context

        return Context(ProtoRequest(request, grpc_context), self.container)

    def gofr_method_handlers(self) -> dict[str, RpcMethodHandler]:
        handlers: dict[str, RpcMethodHandler] = {}
        for name, (kind, in_type, out_type) in self.METHODS.items():
            in_cls = self.MESSAGES[in_type]
            out_cls = self.MESSAGES[out_type]
            user = getattr(self, name)
            behavior = getattr(self, f"_behavior_{kind}")(name, user, out_cls)
            handlers[name] = method_handler(
                kind, behavior,
                request_deserializer=in_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        return handlers

    # -- behaviors ---------------------------------------------------------
    def _check_response(self, name: str, out_cls: type, msg: Any) -> Any:
        if not isinstance(msg, out_cls):
            raise TypeError(
                f"{self.SERVICE_NAME}/{name} returned {type(msg).__name__}, "
                f"expected {out_cls.__name__}"
            )
        return msg

    def _behavior_unary_unary(self, name: str, user: Callable, out_cls: type) -> Callable:
        async def behavior(request: Any, context: Any) -> Any:
            ctx = self._context(request, context)
            return self._check_response(name, out_cls, await user(ctx, request))

        return behavior

    async def _pump(self, coro: Any, stream: GofrStream):
        """Run a push-style handler concurrently with draining its send
        queue, so frames reach the wire as they are sent."""
        sentinel = object()
        task = asyncio.ensure_future(coro)
        task.add_done_callback(lambda _t: stream._out.put_nowait(sentinel))
        try:
            while True:
                frame = await stream._out.get()
                if frame is sentinel:
                    break
                yield frame
            await task  # surface handler exceptions after the queue drains
            while not stream._out.empty():  # frames sent during teardown
                frame = stream._out.get_nowait()
                if frame is not sentinel:
                    yield frame
        finally:
            task.cancel()

    def _behavior_unary_stream(self, name: str, user: Callable, out_cls: type) -> Callable:
        method = f"/{self.SERVICE_NAME}/{name}"
        is_gen = inspect.isasyncgenfunction(user)

        async def behavior(request: Any, context: Any):
            ctx = self._context(request, context)
            stream = GofrStream(method, self.container, None, out_cls)
            if is_gen:
                async for msg in user(ctx, request):
                    stream.send(msg)  # instrument + type-check each frame
                    yield stream._out.get_nowait()
            else:
                async for frame in self._pump(user(ctx, request, stream), stream):
                    yield frame

        return behavior

    def _behavior_stream_unary(self, name: str, user: Callable, out_cls: type) -> Callable:
        method = f"/{self.SERVICE_NAME}/{name}"

        async def behavior(request_iterator: Any, context: Any) -> Any:
            ctx = self._context(None, context)
            stream = GofrStream(method, self.container, request_iterator, out_cls)
            return self._check_response(name, out_cls, await user(ctx, stream))

        return behavior

    def _behavior_stream_stream(self, name: str, user: Callable, out_cls: type) -> Callable:
        method = f"/{self.SERVICE_NAME}/{name}"
        is_gen = inspect.isasyncgenfunction(user)

        async def behavior(request_iterator: Any, context: Any):
            ctx = self._context(None, context)
            stream = GofrStream(method, self.container, request_iterator, out_cls)
            if is_gen:
                async for msg in user(ctx, stream):
                    stream.send(msg)
                    yield stream._out.get_nowait()
                while not stream._out.empty():  # frames pushed via send()
                    yield stream._out.get_nowait()
            else:
                async for frame in self._pump(user(ctx, stream), stream):
                    yield frame

        return behavior
