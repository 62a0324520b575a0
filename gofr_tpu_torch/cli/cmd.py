"""Subcommand router + CLI Request/Responder (a copy of ``gofr_tpu/cli/cmd.py``).

Reference parity: cmd.go:35-164 — first non-flag argument selects the
subcommand by prefix match; ``-h``/``--help`` prints an auto-generated
help table; unknown commands list availables. cmd/request.go:14-60 —
``-flag``, ``--flag=value`` and bare ``key=value`` args become params.
"""

from __future__ import annotations

import asyncio
import sys
from typing import Any

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.handler import execute_handler
from gofr_tpu_torch.cli.terminal import Output


class CMDRequest:
    """Request impl over argv."""

    def __init__(self, args: list[str] | None = None) -> None:
        argv = args if args is not None else sys.argv[1:]
        self.raw_args = argv
        self.flags: dict[str, str] = {}
        self.positional: list[str] = []
        for arg in argv:
            if arg.startswith("--"):
                key, sep, val = arg[2:].partition("=")
                self.flags[key] = val if sep else "true"  # `--name=` means empty
            elif arg.startswith("-"):
                key, sep, val = arg[1:].partition("=")
                self.flags[key] = val if sep else "true"
            elif "=" in arg:
                key, _, val = arg.partition("=")
                self.flags[key] = val
            else:
                self.positional.append(arg)

    @property
    def command(self) -> str:
        return self.positional[0] if self.positional else ""

    def param(self, key: str) -> str:
        return self.flags.get(key, "")

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return v.split(",") if v else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def header(self, key: str) -> str:
        return ""

    def host_name(self) -> str:
        return ""

    def bind(self, target: Any) -> Any:
        if target is dict or target is None:
            return dict(self.flags)
        import dataclasses

        cls = target if isinstance(target, type) else type(target)
        if dataclasses.is_dataclass(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in self.flags.items() if k in names})
        obj = target if not isinstance(target, type) else cls()
        for k, v in self.flags.items():
            setattr(obj, k, v)
        return obj


def _print_help(app: Any, out: Output) -> None:
    out.println(f"Available commands for {app.container.app_name}:")
    for pattern, _handler, description in app._cmd_routes:
        out.println(f"  {pattern:<20} {description}")
    out.println("  -h, --help           show this help")


def run_cmd(app: Any, args: list[str] | None = None) -> int:
    """cmd.Run (cmd.go:35-108)."""
    request = CMDRequest(args)
    out = Output()

    if request.param("h") == "true" or request.param("help") == "true" or not request.command:
        _print_help(app, out)
        return 0

    # prefix match (cmd.go route matching)
    matches = [
        (pattern, handler)
        for pattern, handler, _desc in app._cmd_routes
        if pattern == request.command or pattern.startswith(request.command)
    ]
    exact = [m for m in matches if m[0] == request.command]
    if exact:
        matches = exact
    if not matches:
        out.error(f"unknown command: {request.command}")
        _print_help(app, out)
        return 1
    if len(matches) > 1:
        out.error(f"ambiguous command {request.command!r}: {', '.join(p for p, _ in matches)}")
        return 1

    _pattern, handler = matches[0]
    ctx = Context(request, app.container, out=out)
    result = asyncio.run(execute_handler(handler, ctx))
    if result.error is not None:
        out.error(str(result.error))
        return 1
    if result.data is not None:
        if isinstance(result.data, str):
            out.println(result.data)
        else:
            import json

            out.println(json.dumps(result.data, indent=2, default=str))
    return 0
