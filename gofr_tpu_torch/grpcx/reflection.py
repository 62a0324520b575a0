"""gRPC server reflection (v1alpha), a copy of ``gofr_tpu/grpcx/reflection.py``
(reference parity grpc.go:131-134) on the port's protobuf wire.

The service is built from the descriptor set under ``protos/``
(``reflection.binpb``, compiled from ``reflection.proto``). Registered
services contribute their ``FileDescriptorSet`` through
``gofr_file_descriptor_set()``; grpcurl-style clients can then
``list``/``describe`` every typed service plus grpc.health.v1. A file is
served with the bytes its set held, unchanged.
"""

from __future__ import annotations

import os
from typing import Any

from gofr_tpu_torch.grpcx.h2 import StatusCode
from gofr_tpu_torch.grpcx.protowire import FileDesc, load_messages, parse_descriptor_set
from gofr_tpu_torch.grpcx.runtime import RpcMethodHandler, method_handler

_PROTO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "protos")

SERVICE_NAME = "grpc.reflection.v1alpha.ServerReflection"


def _read_binpb(name: str) -> bytes:
    with open(os.path.join(_PROTO_DIR, name), "rb") as f:
        return f.read()


class ReflectionRegistry:
    """Symbol/file index over every registered service's descriptors."""

    def __init__(self) -> None:
        self._files: dict[str, FileDesc] = {}
        self._symbol_to_file: dict[str, str] = {}
        self.services: list[str] = []
        # the server's built-ins are always describable
        self.add_service("grpc.health.v1.Health", _read_binpb("health.binpb"))
        self.add_service(SERVICE_NAME, _read_binpb("reflection.binpb"))

    def add_service(self, service_name: str, fds_bytes: bytes | None) -> None:
        if service_name and service_name not in self.services:
            self.services.append(service_name)
        if not fds_bytes:
            return
        for fd in parse_descriptor_set(fds_bytes):
            if fd.name in self._files:
                continue
            self._files[fd.name] = fd
            self._index(fd)

    def _index(self, fd: FileDesc) -> None:
        pkg = fd.package

        def full(name: str) -> str:
            return f"{pkg}.{name}" if pkg else name

        for m in fd.all_messages():
            self._symbol_to_file[m.full_name] = fd.name
        for e in fd.enums:
            self._symbol_to_file[e.full_name] = fd.name
        for s in fd.services:
            self._symbol_to_file[full(s.name)] = fd.name
            for m in s.methods:
                self._symbol_to_file[f"{full(s.name)}.{m.name}"] = fd.name

    def file_by_filename(self, name: str) -> list[bytes] | None:
        if name not in self._files:
            return None
        return self._closure(name)

    def file_containing_symbol(self, symbol: str) -> list[bytes] | None:
        fname = self._symbol_to_file.get(symbol)
        if fname is None:
            return None
        return self._closure(fname)

    def _closure(self, root: str) -> list[bytes]:
        """The root file plus its transitive deps we know about — grpcurl
        needs the full closure to build a pool client-side."""
        out: list[bytes] = []
        seen: set[str] = set()
        stack = [root]
        while stack:
            name = stack.pop()
            if name in seen or name not in self._files:
                continue
            seen.add(name)
            fd = self._files[name]
            out.append(fd.raw)
            stack.extend(fd.dependencies)
        return out


class ReflectionService:
    """The ServerReflectionInfo bidi stream, as a gofr generic service."""

    def __init__(self, registry: ReflectionRegistry) -> None:
        self.container: Any = None  # injected at registration; unused
        self.registry = registry
        msgs = load_messages(_read_binpb("reflection.binpb"))
        self._req_cls = msgs["grpc.reflection.v1alpha.ServerReflectionRequest"]
        self._resp_cls = msgs["grpc.reflection.v1alpha.ServerReflectionResponse"]

    def gofr_service_name(self) -> str:
        return SERVICE_NAME

    def gofr_file_descriptor_set(self) -> bytes:
        return _read_binpb("reflection.binpb")

    def gofr_method_handlers(self) -> dict[str, RpcMethodHandler]:
        return {
            "ServerReflectionInfo": method_handler(
                "stream_stream", self._info,
                request_deserializer=self._req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        }

    async def _info(self, request_iterator: Any, context: Any):
        async for req in request_iterator:
            yield self._respond(req)

    def _respond(self, req: Any) -> Any:
        resp = self._resp_cls()
        resp.valid_host = req.host
        resp.original_request.CopyFrom(req)
        which = req.WhichOneof("message_request")
        if which == "list_services":
            for name in self.registry.services:
                resp.list_services_response.service.add().name = name
        elif which == "file_by_filename":
            self._file_response(resp, self.registry.file_by_filename(req.file_by_filename),
                                req.file_by_filename)
        elif which == "file_containing_symbol":
            self._file_response(
                resp, self.registry.file_containing_symbol(req.file_containing_symbol),
                req.file_containing_symbol)
        else:
            resp.error_response.error_code = StatusCode.UNIMPLEMENTED.value[0]
            resp.error_response.error_message = f"unsupported reflection request: {which}"
        return resp

    def _file_response(self, resp: Any, files: list[bytes] | None, what: str) -> None:
        if files is None:
            resp.error_response.error_code = StatusCode.NOT_FOUND.value[0]
            resp.error_response.error_message = f"not found: {what}"
            return
        for f in files:
            resp.file_descriptor_response.file_descriptor_proto.append(f)
