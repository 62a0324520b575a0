"""Run an app on a background thread and talk to it over real sockets:
``start_app`` boots ``app.run`` on a thread and waits for its
``/.well-known/alive``; ``stop_app`` asks it to stop and joins the thread;
``fetch`` is one ``urllib`` request that returns (status, headers, body)
whatever the status. Works on an ``App`` of either package."""

from __future__ import annotations

import threading
import time
import urllib.error
import urllib.request
from typing import Any


def wait_ready(url: str, timeout: float = 15.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=1):
                return
        except (urllib.error.URLError, ConnectionError, OSError):
            time.sleep(0.02)
    raise TimeoutError(f"server at {url} did not come up within {timeout}s")


def start_app(app: Any, host: str = "127.0.0.1", timeout: float = 15.0) -> threading.Thread:
    """``app.run`` on a daemon thread; returns once the app answers."""
    thread = threading.Thread(target=app.run, daemon=True, name="app")
    thread.start()
    wait_ready(f"http://{host}:{app.http_port}/.well-known/alive", timeout)
    return thread


def stop_app(app: Any, thread: threading.Thread, timeout: float = 30.0) -> None:
    """Ask ``app`` to shut down (its shutdown hooks run) and join it."""
    app.stop()
    thread.join(timeout=timeout)
    if thread.is_alive():
        raise TimeoutError(f"app did not stop within {timeout}s")


def fetch(url: str, method: str = "GET", body: bytes | None = None,
          headers: dict[str, str] | None = None, timeout: float = 30.0) -> tuple[int, dict, bytes]:
    req = urllib.request.Request(url, data=body, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()
