"""The port's CLI — the gofr-cli analogue (a copy of ``gofr_tpu/__main__.py``),
built on the framework's own CMD transport (``cli/cmd.py``):

    python -m gofr_tpu_torch version
    python -m gofr_tpu_torch grpc-generate --proto=chat.proto --out=gen/
    python -m gofr_tpu_torch protos --dir=protos/ --out=gen/

``grpc-generate`` drives ``grpcx/codegen.py`` (a ``.binpb`` needs nothing; a
``.proto`` needs the system ``protoc``). ``bench`` is refused: the port's
bench is not written yet (it waits for a benchmark change, ROADMAP "Waits
for a ``benchmark`` PR"), and the reference's ``bench.py`` runs JAX.
"""

from __future__ import annotations

import os
import sys
from typing import Any

from gofr_tpu_torch.app import new_cmd


def _version(ctx: Any) -> str:
    from gofr_tpu_torch import version

    return f"gofr-tpu-torch {version.FRAMEWORK}"


def _write_generated(proto_path: str, out_dir: str,
                     includes: list[str] | None = None) -> list[str]:
    """Shared generate-and-write step for both codegen subcommands."""
    from gofr_tpu_torch.grpcx.codegen import generate, load_input

    fds = load_input(proto_path, includes or [])
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname, source in generate(fds).items():
        dest = os.path.join(out_dir, fname)
        with open(dest, "w") as f:
            f.write(source)
        written.append(dest)
    return written


def _grpc_generate(ctx: Any) -> str:
    proto = ctx.param("proto") or ctx.param("p")
    if not proto:
        raise ValueError("--proto <file.proto|file.binpb> is required")
    out_dir = ctx.param("out") or "."
    includes = [d for d in ctx.params("include") if d]
    written = _write_generated(proto, out_dir, includes)
    return "generated:\n  " + "\n  ".join(written)


def _protos(ctx: Any) -> str:
    """Batch grpc-generate over every .proto in a directory."""
    src_dir = ctx.param("dir") or "."
    out_dir = ctx.param("out") or src_dir
    written = []
    for name in sorted(os.listdir(src_dir)):
        if name.endswith(".proto"):
            written.extend(_write_generated(os.path.join(src_dir, name), out_dir))
    if not written:
        return f"no .proto files in {src_dir}"
    return "generated:\n  " + "\n  ".join(written)


def _bench(ctx: Any) -> str:
    raise NotImplementedError(
        "the port's bench is not written yet: it waits for a benchmark change "
        "(ROADMAP, 'Waits for a benchmark PR'); ./bench.py measures the JAX package"
    )


def main(argv: list[str] | None = None) -> int:
    from gofr_tpu_torch.cli import run_cmd
    from gofr_tpu_torch.config import MapConfig

    app = new_cmd(MapConfig({}, use_env=True))
    app.sub_command("version", _version, "print the framework version")
    app.sub_command("grpc-generate", _grpc_generate,
                    "typed gRPC codegen: --proto=FILE [--out=DIR] [--include=DIR]")
    app.sub_command("protos", _protos, "batch codegen: --dir=DIR [--out=DIR]")
    app.sub_command("bench", _bench, "refused: the port's bench is not written yet")
    return run_cmd(app, argv)


if __name__ == "__main__":
    sys.exit(main())
