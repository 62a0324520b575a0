"""Crontab: second-granularity scheduler with 5/6-field cron expressions (a
copy of ``gofr_tpu/cron.py``).

Reference parity: pkg/gofr/cron.go + cron_scheduler.go — a ticking scheduler
(cron.go:62-92), a parser supporting ranges, steps and lists over
minute/hour/dom/month/dow with an optional leading seconds field
(cron_scheduler.go:19-175), and per-job execution with its own traced
Context and panic recovery (cron.go:94-115).
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable

from gofr_tpu_torch.context import Context


class CronParseError(Exception):
    pass


_FIELDS_5 = (("minute", 0, 59), ("hour", 0, 23), ("dom", 1, 31), ("month", 1, 12), ("dow", 0, 6))
_FIELDS_6 = (("second", 0, 59),) + _FIELDS_5


def _parse_field(expr: str, lo: int, hi: int, name: str) -> set[int]:
    """One cron field: ``*``, ``*/step``, ``a-b``, ``a-b/step``, lists
    (cron_scheduler.go:19-175)."""
    values: set[int] = set()
    for part in expr.split(","):
        part = part.strip()
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            try:
                step = int(step_s)
            except ValueError as exc:
                raise CronParseError(f"bad step in {name}: {step_s!r}") from exc
            if step <= 0:
                raise CronParseError(f"step must be positive in {name}")
        if part in ("*", ""):
            lo_i, hi_i = lo, hi
        elif "-" in part:
            a, _, b = part.partition("-")
            try:
                lo_i, hi_i = int(a), int(b)
            except ValueError as exc:
                raise CronParseError(f"bad range in {name}: {part!r}") from exc
        else:
            try:
                lo_i = hi_i = int(part)
            except ValueError as exc:
                raise CronParseError(f"bad value in {name}: {part!r}") from exc
        if lo_i < lo or hi_i > hi or lo_i > hi_i:
            raise CronParseError(f"{name} value out of range [{lo},{hi}]: {part!r}")
        values.update(range(lo_i, hi_i + 1, step))
    return values


class Schedule:
    def __init__(self, expr: str) -> None:
        parts = expr.split()
        if len(parts) == 5:
            fields = _FIELDS_5
            self.has_seconds = False
        elif len(parts) == 6:
            fields = _FIELDS_6
            self.has_seconds = True
        else:
            raise CronParseError(f"cron expression must have 5 or 6 fields, got {len(parts)}")
        self.sets: dict[str, set[int]] = {}
        for part, (name, lo, hi) in zip(parts, fields):
            self.sets[name] = _parse_field(part, lo, hi, name)
        if not self.has_seconds:
            self.sets["second"] = {0}

    def matches(self, t: time.struct_time) -> bool:
        return (
            t.tm_sec in self.sets["second"]
            and t.tm_min in self.sets["minute"]
            and t.tm_hour in self.sets["hour"]
            and t.tm_mday in self.sets["dom"]
            and t.tm_mon in self.sets["month"]
            and (t.tm_wday + 1) % 7 in self.sets["dow"]  # python: Mon=0; cron: Sun=0
        )


class _NoopRequest:
    """cron.go:163-188 — the empty Request handed to cron job contexts."""

    def param(self, key: str) -> str:
        return ""

    def params(self, key: str) -> list[str]:
        return []

    def path_param(self, key: str) -> str:
        return ""

    def bind(self, target: Any) -> Any:
        return None

    def header(self, key: str) -> str:
        return ""

    def host_name(self) -> str:
        return ""


class Crontab:
    """cron.go:31-115: registry + 1 s ticker; each firing job runs as its own
    task with a traced context and panic isolation."""

    def __init__(self, container: Any) -> None:
        self.container = container
        self.jobs: list[tuple[str, Schedule, Callable]] = []
        self._task: asyncio.Task | None = None
        # strong refs to running jobs: the loop holds tasks weakly, and a
        # job task collected mid-run would vanish without a trace
        self._running: set[asyncio.Task] = set()

    def add(self, expr: str, name: str, handler: Callable) -> None:
        self.jobs.append((name, Schedule(expr), handler))

    async def start(self) -> None:
        if self.jobs:
            self._task = asyncio.create_task(self._loop(), name="crontab")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        last_tick = -1
        while True:
            now = time.time()
            tick = int(now)
            if tick != last_tick:
                last_tick = tick
                t = time.localtime(tick)
                for name, schedule, handler in self.jobs:
                    if schedule.matches(t):
                        task = asyncio.create_task(self._run_job(name, handler),
                                                   name=f"cron-{name}")
                        self._running.add(task)
                        task.add_done_callback(self._running.discard)
            await asyncio.sleep(max(0.0, (tick + 1) - time.time()))

    async def _run_job(self, name: str, handler: Callable) -> None:
        """cron.go:94-115."""
        container = self.container
        span = container.tracer.start_span(f"cron {name}", kind="internal")
        try:
            with span:
                ctx = Context(_NoopRequest(), container)
                result = handler(ctx)
                if asyncio.iscoroutine(result):
                    await result
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            container.logger.error(f"error in cron job {name}: {exc}")
