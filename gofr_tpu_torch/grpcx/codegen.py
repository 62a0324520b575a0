"""Typed gRPC code generation — the gofr-cli analogue (a copy of
``gofr_tpu/grpcx/codegen.py`` whose output rides the port's wire).

The reference ships a protoc-style generator whose output (`*_gofr.go`)
gives every service a Context-first typed handler interface with
instrumented streams (chatservice_gofr.go:29-120, request_gofr.go:15-53).
This module is the port's equivalent:

    python -m gofr_tpu_torch.grpcx.codegen chat.proto -o gen/
    # or from a pre-compiled descriptor set:
    python -m gofr_tpu_torch.grpcx.codegen chat.binpb -o gen/

A ``.proto`` is compiled with the system ``protoc`` (descriptor set only, no
protoc Python plugin), where there is one; a ``.binpb`` needs nothing. It
emits one ``<file>_gofr.py`` per root proto file containing:

- typed message classes for every message (built at import by
  ``grpcx/runtime.load_messages`` from the embedded descriptor set);
- a ``<Service>GofrServicer`` base class per service whose METHODS table
  ``grpcx/runtime.GofrGrpcService`` turns into instrumented handlers
  (register with ``app.register_grpc_service`` / ``GRPCServer.register``);
- a typed ``<Service>GofrClient`` over the port's channel (``grpcx/h2.py``).

Generated modules depend only on ``gofr_tpu_torch``.
"""

from __future__ import annotations

import base64
import os
import shutil
import subprocess
import sys
import tempfile

from gofr_tpu_torch.grpcx.protowire import FileDesc, parse_descriptor_set

_KIND = {
    (False, False): "unary_unary",
    (False, True): "unary_stream",
    (True, False): "stream_unary",
    (True, True): "stream_stream",
}


def compile_proto(proto_path: str, include_dirs: list[str] | None = None) -> bytes:
    """.proto → serialized FileDescriptorSet via the system protoc."""
    if shutil.which("protoc") is None:
        raise RuntimeError("compiling a .proto needs the system protoc; pass a .binpb instead")
    includes = list(include_dirs or [])
    proto_dir = os.path.dirname(os.path.abspath(proto_path)) or "."
    if proto_dir not in includes:
        includes.append(proto_dir)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.binpb")
        cmd = ["protoc", f"--descriptor_set_out={out}", "--include_imports"]
        cmd += [f"-I{d}" for d in includes]
        cmd.append(os.path.basename(proto_path))
        r = subprocess.run(cmd, cwd=proto_dir, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"protoc failed: {r.stderr.strip()}")
        with open(out, "rb") as f:
            return f.read()


def load_input(path: str, include_dirs: list[str] | None = None) -> bytes:
    """Accept a .proto (compiled here) or an already-serialized
    FileDescriptorSet (.binpb/.pb/.desc)."""
    if path.endswith(".proto"):
        return compile_proto(path, include_dirs)
    with open(path, "rb") as f:
        data = f.read()
    parse_descriptor_set(data)  # validate
    return data


def _message_names(fd: FileDesc) -> list[str]:
    return [m.full_name for m in fd.all_messages()]


def _py_ident(full_name: str) -> str:
    """chat.v1.ChatRequest → ChatRequest (module-level alias)."""
    return full_name.rsplit(".", 1)[-1]


def generate(fds_bytes: bytes) -> dict[str, str]:
    """FileDescriptorSet → {module_filename: python_source}. One module
    per non-dependency proto file that defines messages or services."""
    files = parse_descriptor_set(fds_bytes)
    b64 = base64.b64encode(fds_bytes).decode("ascii")
    # --include_imports pulls dependency files into the set; only the ROOT
    # files (not imported by anything else present) get modules
    imported = {dep for fd in files for dep in fd.dependencies}
    out: dict[str, str] = {}
    for fd in files:
        if fd.name in imported or (not fd.messages and not fd.services):
            continue
        stem = os.path.splitext(os.path.basename(fd.name))[0]
        out[f"{stem}_gofr.py"] = _render_module(fd, b64)
    return out


def _render_module(fd: FileDesc, fds_b64: str) -> str:
    lines: list[str] = []
    w = lines.append
    w('"""Generated by gofr-tpu-torch grpc codegen (grpcx/codegen.py) from '
      f'{fd.name} — DO NOT EDIT."""')
    w("")
    w("from __future__ import annotations")
    w("")
    w("import base64")
    w("from typing import Any")
    w("")
    w("from gofr_tpu_torch.grpcx.h2 import Channel")
    w("from gofr_tpu_torch.grpcx.runtime import GofrGrpcService, GofrStream, load_messages")
    w("")
    w("_FDS = base64.b64decode(")
    for i in range(0, len(fds_b64), 88):
        w(f"    {fds_b64[i:i + 88]!r}")
    w(")")
    w("MESSAGES = load_messages(_FDS)")
    w("")
    msg_names = _message_names(fd)
    for full in msg_names:
        w(f"{_py_ident(full)} = MESSAGES[{full!r}]")
    if msg_names:
        w("")

    for svc in fd.services:
        methods: list[tuple[str, str, str, str]] = []
        for m in svc.methods:
            kind = _KIND[(m.client_streaming, m.server_streaming)]
            methods.append((m.name, kind, m.input_type, m.output_type))

        # ---- servicer base class ----------------------------------------
        w(f"class {svc.name}GofrServicer(GofrGrpcService):")
        w('    """Subclass and implement each RPC with the Context-first')
        w('    signature; register via app.register_grpc_service()."""')
        w("")
        w(f"    SERVICE_NAME = {svc.full_name!r}")
        w("    FILE_DESCRIPTOR_SET = _FDS")
        w("    MESSAGES = MESSAGES")
        w("    METHODS = {")
        for name, kind, in_t, out_t in methods:
            w(f"        {name!r}: ({kind!r}, {in_t!r}, {out_t!r}),")
        w("    }")
        w("")
        for name, kind, in_t, out_t in methods:
            in_a, out_a = _py_ident(in_t), _py_ident(out_t)
            if kind == "unary_unary":
                w(f"    async def {name}(self, ctx: Any, request: {in_a}) -> {out_a}:")
            elif kind == "unary_stream":
                w(f"    async def {name}(self, ctx: Any, request: {in_a}, stream: GofrStream) -> None:")
            elif kind == "stream_unary":
                w(f"    async def {name}(self, ctx: Any, stream: GofrStream) -> {out_a}:")
            else:
                w(f"    async def {name}(self, ctx: Any, stream: GofrStream) -> None:")
            w(f"        raise NotImplementedError({name!r})")
            w("")

        # ---- typed client ------------------------------------------------
        w(f"class {svc.name}GofrClient:")
        w(f'    """Typed client for {svc.full_name} over the port\'s channel."""')
        w("")
        w("    def __init__(self, target: str) -> None:")
        w("        self._channel = Channel(target)")
        for name, kind, in_t, out_t in methods:
            # multicallables built once: a heartbeat-style hot path must not
            # make one a call
            w(f"        self._{name} = self._channel.{kind}(")
            w(f"            {f'/{svc.full_name}/{name}'!r},")
            w("            request_serializer=lambda m: m.SerializeToString(),")
            w(f"            response_deserializer={_py_ident(out_t)}.FromString,")
            w("        )")
        w("")
        for name, kind, in_t, out_t in methods:
            in_a, out_a = _py_ident(in_t), _py_ident(out_t)
            if kind == "unary_unary":
                w(f"    async def {name}(self, request: {in_a}, **kw: Any) -> {out_a}:")
                w(f"        return await self._{name}(request, **kw)")
            elif kind == "unary_stream":
                w(f"    def {name}(self, request: {in_a}, **kw: Any) -> Any:")
                w(f"        return self._{name}(request, **kw)")
            elif kind == "stream_unary":
                w(f"    async def {name}(self, requests: Any, **kw: Any) -> {out_a}:")
                w(f"        return await self._{name}(requests, **kw)")
            else:
                w(f"    def {name}(self, requests: Any, **kw: Any) -> Any:")
                w(f"        return self._{name}(requests, **kw)")
            w("")
        w("    async def close(self) -> None:")
        w("        await self._channel.close()")
        w("")

    return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    out_dir = "."
    includes: list[str] = []
    inputs: list[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-o", "--out"):
            i += 1
            out_dir = args[i]
        elif a.startswith("--out="):
            out_dir = a.split("=", 1)[1]
        elif a in ("-I", "--include"):
            i += 1
            includes.append(args[i])
        elif a.startswith("-I"):
            includes.append(a[2:])
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        else:
            inputs.append(a)
        i += 1
    if not inputs:
        print("usage: python -m gofr_tpu_torch.grpcx.codegen <file.proto|file.binpb> "
              "[-o DIR] [-I DIR]", file=sys.stderr)
        return 2
    os.makedirs(out_dir, exist_ok=True)
    for path in inputs:
        fds = load_input(path, includes)
        for fname, source in generate(fds).items():
            dest = os.path.join(out_dir, fname)
            with open(dest, "w") as f:
                f.write(source)
            print(f"wrote {dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
