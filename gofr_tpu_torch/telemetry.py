"""Anonymous usage telemetry (a copy of ``gofr_tpu/telemetry.py``; reference:
telemetry.go:9-38).

The reference POSTs an anonymous up/down ping to gofr.dev unless
``GOFR_TELEMETRY=false``. This build keeps the same opt-out contract and
payload shape but emits the ping through the logger at DEBUG instead of
the network by default — serving clusters routinely run with zero egress,
and a framework must never block startup on a phone-home. Deployments
that want the POST set ``TELEMETRY_ENDPOINT``.
"""

from __future__ import annotations

import json
import platform
import threading
import urllib.request
from typing import Any

from gofr_tpu_torch.container.container import FRAMEWORK_VERSION as FRAMEWORK

PING_TIMEOUT_SECONDS = 2.0


def telemetry_enabled(config: Any) -> bool:
    return config.get_or_default("GOFR_TELEMETRY", "true").lower() != "false"


def build_ping(config: Any, event: str) -> dict:
    """The anonymous payload (no hostnames, no config values)."""
    return {
        "event": event,  # "start" | "stop"
        "framework_version": FRAMEWORK,
        "python": platform.python_version(),
        "os": platform.system().lower(),
        "arch": platform.machine(),
    }


def send_ping(config: Any, event: str, logger: Any = None) -> None:
    """Fire-and-forget; never raises, never blocks the caller (own thread,
    short timeout)."""
    if not telemetry_enabled(config):
        return
    payload = build_ping(config, event)
    endpoint = config.get("TELEMETRY_ENDPOINT")

    def _send() -> None:
        if endpoint:
            try:
                req = urllib.request.Request(
                    endpoint,
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=PING_TIMEOUT_SECONDS)
            except Exception:
                pass  # telemetry must never surface errors
        elif logger is not None:
            logger.debug(f"telemetry {event}: {json.dumps(payload)}")

    threading.Thread(target=_send, daemon=True, name="telemetry").start()
