"""The gRPC server wrapper (a copy of ``gofr_tpu/grpcx/server.py`` on the
port's own HTTP/2 wire, ``grpcx/h2.py``).

Reference parity: pkg/gofr/grpc.go — recovery then observability around
every handler (grpc.go:96-104), optional reflection via
GRPC_ENABLE_REFLECTION (grpc.go:131-134; served from the descriptor sets
under ``grpcx/protos``), graceful stop (grpc.go:185-197), server status and
error metrics (grpc.go:114-119), and container injection into registered
servicers (grpc.go:222-269: the ``container`` attribute is set when present).

Services register either with an adder (``adder(servicer, server)``, which
calls :meth:`GRPCServer.add_generic_rpc_handlers`) or as gofr generic
services exposing ``gofr_service_name()`` + ``gofr_method_handlers()``.

The server runs on the app's event loop. A handler that is a plain function
(the health check, which reads the datasources' health) runs in the loop's
executor, so nothing here blocks the loop.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable

from gofr_tpu_torch.grpcx.h2 import AbortError, RpcServer, StatusCode
from gofr_tpu_torch.grpcx.runtime import RpcMethodHandler, method_handler
from gofr_tpu_torch.tracing.trace import extract_traceparent

GRPC_STATUS_LABELS = {True: "OK", False: "ERROR"}

# the series this server registers on its container's manager and emits,
# under the reference's names (serving/metrics_catalog.py)
GRPC_METRICS = ("app_grpc_server_stats", "app_grpc_stream_stats",
                "grpc_server_errors_total", "app_grpc_message_total",
                "grpc_server_status")


def _remote_trace(context: Any) -> tuple[str, str] | None:
    """Inbound W3C tracecontext from gRPC metadata: the ``traceparent``
    key carries the same header value HTTP does (grpc/log.go:179-202), so
    the server span continues the caller's trace."""
    try:
        metadata = dict(context.invocation_metadata() or ())
    except Exception:
        return None
    return extract_traceparent(metadata.get("traceparent"))


def _is_probe(method: str) -> bool:
    """Health/reflection keep serving during drain so orchestrators can
    observe NOT_SERVING instead of inferring it from UNAVAILABLE."""
    return method.startswith("/grpc.health.") or method.startswith("/grpc.reflection.")


class GenericRpcHandler:
    """``grpc.method_handlers_generic_handler``'s record: one service's
    method handlers by method name."""

    def __init__(self, service: str, handlers: dict[str, RpcMethodHandler]) -> None:
        self.service_name = service
        self.handlers = dict(handlers)

    def paths(self) -> dict[str, RpcMethodHandler]:
        return {f"/{self.service_name}/{m}": h for m, h in self.handlers.items()}


def _health_handlers(container: Any) -> GenericRpcHandler:
    """Standard grpc.health.v1.Health service, hand-framed protobuf:
    HealthCheckResponse{status=1} is `0x08 0x01` (SERVING) / `0x08 0x02`
    (NOT_SERVING)."""

    def check(request: bytes, context: Any) -> bytes:
        try:
            health = container.health()
            serving = health.get("status") == "UP"
        except Exception:
            serving = False
        return b"\x08\x01" if serving else b"\x08\x02"

    return GenericRpcHandler("grpc.health.v1.Health", {
        "Check": method_handler("unary_unary", check, lambda b: b, lambda b: b),
    })


async def _maybe_async(fn: Callable, *args: Any) -> Any:
    if asyncio.iscoroutinefunction(fn):
        return await fn(*args)
    # a plain function may block (a datasource's health check): off the loop
    result = await asyncio.get_running_loop().run_in_executor(None, fn, *args)
    if asyncio.iscoroutine(result):
        return await result
    return result


class _ObservabilityInterceptor:
    """Per-RPC span + structured log + ``app_grpc_server_stats`` histogram
    (grpc/log.go:150-251) around each handler behaviour; recovery included
    (a panic is INTERNAL, grpc_recovery's analogue)."""

    def __init__(self, container: Any) -> None:
        self.container = container
        # wrapped handlers by method, holding the source handler so a handler
        # that changes is wrapped anew; bounded by the method count
        self._wrapped: dict[str, tuple[Any, Any]] = {}

    def intercept(self, method: str, handler: RpcMethodHandler | None) -> RpcMethodHandler | None:
        if handler is None:
            return None
        cached = self._wrapped.get(method)
        if cached is not None and cached[0] is handler:
            return cached[1]
        container = self.container

        def start(context: Any) -> tuple[float, Any]:
            if getattr(container, "draining", False) and not _is_probe(method):
                # retriable by contract: clients/LBs re-resolve and hit
                # another replica (health keeps answering NOT_SERVING)
                context.abort(StatusCode.UNAVAILABLE, "server draining; retry on another replica")
            remote = _remote_trace(context)
            span = container.tracer.start_span(
                f"grpc {method}", kind="server",
                remote_trace_id=remote[0] if remote else None,
                remote_span_id=remote[1] if remote else None,
            )
            return time.perf_counter(), span

        def panic(context: Any, exc: Exception, what: str) -> None:
            container.logger.error(f"grpc {what} panic in {method}: {exc}")
            container.metrics_manager.increment_counter("grpc_server_errors_total", method=method)
            context.abort(StatusCode.INTERNAL, "internal error")

        def log(prefix: str, elapsed: float, ok: bool) -> None:
            container.logger.info(
                f"gRPC {prefix}{method} {'OK' if ok else 'ERROR'} {elapsed*1e6:.0f}µs")

        def wrap_unary(behavior: Callable) -> Callable:
            async def wrapped(request: Any, context: Any) -> Any:
                t0, span = start(context)
                ok = True
                try:
                    with span:
                        return await _maybe_async(behavior, request, context)
                except AbortError:
                    ok = False
                    raise
                except Exception as exc:
                    ok = False
                    panic(context, exc, "handler")
                finally:
                    elapsed = time.perf_counter() - t0
                    container.metrics_manager.record_histogram(
                        "app_grpc_server_stats", elapsed,
                        method=method, status=GRPC_STATUS_LABELS[ok])
                    log("", elapsed, ok)

            return wrapped

        def wrap_stream(behavior: Callable) -> Callable:
            async def wrapped(request: Any, context: Any):
                t0, span = start(context)
                ok = True
                try:
                    with span:
                        async for item in behavior(request, context):
                            yield item
                except AbortError:
                    ok = False
                    raise
                except Exception as exc:
                    ok = False
                    panic(context, exc, "stream")
                finally:
                    elapsed = time.perf_counter() - t0
                    container.metrics_manager.record_histogram(
                        "app_grpc_stream_stats", elapsed,
                        method=method, status=GRPC_STATUS_LABELS[ok])
                    log("stream ", elapsed, ok)

            return wrapped

        wrap = wrap_stream if handler.response_streaming else wrap_unary
        wrapped = RpcMethodHandler(
            wrap(handler.behavior), handler.request_streaming, handler.response_streaming,
            handler.request_deserializer, handler.response_serializer)
        self._wrapped[method] = (handler, wrapped)
        return wrapped


class GRPCServer:
    def __init__(self, container: Any, port: int, config: Any = None) -> None:
        self.container = container
        self.port = port
        self.config = config
        self._server: RpcServer | None = None
        self._pending: list[Any] = []  # registered before start
        self._handlers: dict[str, RpcMethodHandler] = {}
        self._interceptor = _ObservabilityInterceptor(container)
        self._register_metrics()

    def _register_metrics(self) -> None:
        m = self.container.metrics_manager
        if m.get("app_grpc_server_stats") is None:
            from gofr_tpu_torch.serving.metrics_catalog import SELF_REGISTERED_METRICS

            for kind, name, description, _buckets in SELF_REGISTERED_METRICS:
                if name in GRPC_METRICS:
                    getattr(m, f"new_{kind}")(name, description)

    def register(self, servicer: Any, adder: Callable | None = None) -> None:
        """RegisterService (grpc.go:200-220): container injection and a
        deferred add. Registration after start raises: a silent
        UNIMPLEMENTED is worse than an error."""
        if self._server is not None:
            raise RuntimeError("cannot register a gRPC service after the server has started")
        if hasattr(servicer, "container") and servicer.container is None:
            servicer.container = self.container
        elif hasattr(servicer, "use_container"):
            servicer.use_container(self.container)
        self._pending.append((servicer, adder))

    def add_generic_rpc_handlers(self, handlers: Any) -> None:
        for h in handlers:
            self._handlers.update(h.paths())

    def _lookup(self, path: str) -> RpcMethodHandler | None:
        return self._interceptor.intercept(path, self._handlers.get(path))

    async def start(self) -> None:
        self._handlers = {}
        self.add_generic_rpc_handlers((_health_handlers(self.container),))
        for servicer, adder in self._pending:
            if adder is not None:
                adder(servicer, self)
            elif hasattr(servicer, "gofr_method_handlers"):
                self.add_generic_rpc_handlers((GenericRpcHandler(
                    servicer.gofr_service_name(), servicer.gofr_method_handlers()),))
            else:
                raise TypeError(
                    f"servicer {type(servicer).__name__} has neither an adder "
                    "nor gofr_method_handlers()"
                )
        if self.config is not None and self.config.get_or_default(
            "GRPC_ENABLE_REFLECTION", "false"
        ).lower() == "true":
            # grpc.go:131-134: reflection gated by config, built from the
            # descriptor sets of the registered services
            from gofr_tpu_torch.grpcx.reflection import ReflectionRegistry, ReflectionService

            registry = ReflectionRegistry()
            for servicer, _adder in self._pending:
                name_fn = getattr(servicer, "gofr_service_name", None)
                fds_fn = getattr(servicer, "gofr_file_descriptor_set", None)
                if callable(name_fn):
                    registry.add_service(name_fn(), fds_fn() if callable(fds_fn) else None)
            reflection = ReflectionService(registry)
            self.add_generic_rpc_handlers((GenericRpcHandler(
                reflection.gofr_service_name(), reflection.gofr_method_handlers()),))
            self.container.logger.info("gRPC server reflection enabled")
        host = None
        if self.config is not None:
            host = self.config.get("HTTP_HOST") or None
        server = RpcServer(self._lookup)
        self.port = await server.start(host, self.port)
        self._server = server
        self.container.metrics_manager.set_gauge("grpc_server_status", 1)
        self.container.logger.info(f"grpc server listening on :{self.port}")

    async def shutdown(self, grace: float = 5.0) -> None:
        if self._server is not None:
            self.container.metrics_manager.set_gauge("grpc_server_status", 0)
            await self._server.stop(grace)
            self._server = None
