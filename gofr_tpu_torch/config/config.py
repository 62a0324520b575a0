"""Env-file layered configuration (a copy of ``gofr_tpu/config/config.py``).

Reference parity: pkg/gofr/config/config.go:1-6 (two-method interface),
pkg/gofr/config/godotenv.go:36-91 (layering: .env -> .local.env or
.{APP_ENV}.env -> process env wins).
"""

from __future__ import annotations

import os
from typing import Protocol


class Config(Protocol):
    """The two-method config contract (config/config.go:1-6)."""

    def get(self, key: str) -> str | None: ...

    def get_or_default(self, key: str, default: str) -> str: ...


def load_env_file(path: str) -> dict[str, str]:
    """Parse a dotenv file. Lines are KEY=VALUE; '#' starts a comment;
    surrounding single/double quotes on values are stripped; blank lines and
    malformed lines are ignored (godotenv semantics)."""
    out: dict[str, str] = {}
    try:
        with open(path, encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                if line.startswith("export "):
                    line = line[len("export "):].lstrip()
                key, _, val = line.partition("=")
                key = key.strip()
                val = val.strip()
                # strip inline comments only for unquoted values
                if val and val[0] in "\"'":
                    quote = val[0]
                    if len(val) >= 2 and val.endswith(quote):
                        val = val[1:-1]
                elif " #" in val:
                    val = val.split(" #", 1)[0].rstrip()
                if key:
                    out[key] = val
    except OSError:
        pass
    return out


class EnvConfig:
    """Layered env config (godotenv.go:36-91 semantics).

    1. ``{configs_dir}/.env`` is loaded as the base layer.
    2. ``{configs_dir}/.local.env`` — or ``.{APP_ENV}.env`` when ``APP_ENV``
       is set — overrides it.
    3. Real process environment variables always win.
    """

    def __init__(self, configs_dir: str = "./configs") -> None:
        self._file_vars: dict[str, str] = {}
        base = load_env_file(os.path.join(configs_dir, ".env"))
        self._file_vars.update(base)
        app_env = os.environ.get("APP_ENV", "")
        override = f".{app_env}.env" if app_env else ".local.env"
        self._file_vars.update(load_env_file(os.path.join(configs_dir, override)))

    def get(self, key: str) -> str | None:
        if key in os.environ:
            return os.environ[key]
        return self._file_vars.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        val = self.get(key)
        return val if val is not None and val != "" else default


class MapConfig:
    """In-memory config for tests (the reference passes plain maps in tests)."""

    def __init__(self, values: dict[str, str] | None = None, *, use_env: bool = True) -> None:
        self._values = dict(values or {})
        self._use_env = use_env

    def get(self, key: str) -> str | None:
        if key in self._values:
            return self._values[key]
        if self._use_env and key in os.environ:
            return os.environ[key]
        return None

    def get_or_default(self, key: str, default: str) -> str:
        val = self.get(key)
        return val if val is not None and val != "" else default
