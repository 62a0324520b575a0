"""Free-port allocation + server config env (a copy of
``gofr_tpu/testutil/ports.py``; testutil/port.go:14-70)."""

from __future__ import annotations

import dataclasses
import os
import socket


def get_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class ServerConfigs:
    http_port: int
    metrics_port: int
    grpc_port: int

    @property
    def http_host(self) -> str:
        return f"http://localhost:{self.http_port}"

    @property
    def metrics_host(self) -> str:
        return f"http://localhost:{self.metrics_port}"


def new_server_configs(set_env: bool = True) -> ServerConfigs:
    """Allocate 3 kernel ports and (optionally) export HTTP_PORT /
    METRICS_PORT / GRPC_PORT (testutil/port.go:50-70)."""
    cfg = ServerConfigs(get_free_port(), get_free_port(), get_free_port())
    if set_env:
        os.environ["HTTP_PORT"] = str(cfg.http_port)
        os.environ["METRICS_PORT"] = str(cfg.metrics_port)
        os.environ["GRPC_PORT"] = str(cfg.grpc_port)
    return cfg
