"""The port's crontab (``gofr_tpu_torch/cron.py``) beside the JAX package's
(``gofr_tpu/cron.py``): seeded 5-field expressions (ranges, steps, lists,
``*``) match the same minutes over a whole year, seeded 6-field ones the
same seconds over a whole day; malformed expressions fail with the same
message; a job runs in its own traced context, and one that raises is
logged and isolated while the ticker keeps firing the others."""

import asyncio
import io
import json
import time

import numpy as np
import pytest

from gofr_tpu import cron as rcron
from gofr_tpu_torch import cron as tcron
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.logging import Level, Logger
from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer

YEAR_START = 1767225600  # 2026-01-01T00:00:00Z
FIELDS = {"second": (0, 59), "minute": (0, 59), "hour": (0, 23), "dom": (1, 31),
          "month": (1, 12), "dow": (0, 6)}


def _field(rng, lo: int, hi: int) -> str:
    kind = rng.integers(0, 6)
    a, b = sorted(int(x) for x in rng.integers(lo, hi + 1, 2))
    step = int(rng.integers(2, 7))
    if kind == 0:
        return "*"
    if kind == 1:
        return f"*/{step}"
    if kind == 2:
        return f"{a}-{b}"
    if kind == 3:
        return f"{a}-{b}/{step}"
    if kind == 4:
        return ",".join(str(int(x)) for x in sorted(set(rng.integers(lo, hi + 1, 3))))
    return str(a)


def _expressions(n_fields: int, count: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    names = list(FIELDS)[1:] if n_fields == 5 else list(FIELDS)
    out = []
    for _ in range(count):
        fields = [_field(rng, *FIELDS[name]) for name in names]
        if n_fields == 5:
            fields[2:] = ["*"] * 3 if rng.integers(0, 2) else fields[2:]  # keep some frequent
        out.append(" ".join(fields))
    return out


# schedules whose matches over 2026 are known from the calendar: 261
# weekdays, 9 hours, 4 quarters; the 1st and 15th of 12 months
KNOWN_2026 = {"*/15 9-17 * * 1-5": 261 * 9 * 4, "0 0 1,15 * *": 24}
FIVE = _expressions(5, 8, 5) + list(KNOWN_2026)
SIX = _expressions(6, 8, 6) + ["* * * * * *", "*/10 30 12 * * *"]


def _sweep(expr: str, start: int, count: int, step: int):
    ref, port = rcron.Schedule(expr), tcron.Schedule(expr)
    got_ref, got_port = [], []
    for i in range(count):
        t = time.gmtime(start + i * step)
        if ref.matches(t):
            got_ref.append(i)
        if port.matches(t):
            got_port.append(i)
    return got_ref, got_port


@pytest.mark.parametrize("expr", FIVE)
def test_five_field_matches_every_minute_of_a_year(expr):
    got_ref, got_port = _sweep(expr, YEAR_START, 365 * 24 * 60, 60)
    assert got_port == got_ref
    assert tcron.Schedule(expr).sets == rcron.Schedule(expr).sets
    if expr in KNOWN_2026:
        assert len(got_port) == KNOWN_2026[expr]


@pytest.mark.parametrize("expr", SIX)
def test_six_field_matches_every_second_of_a_day(expr):
    got_ref, got_port = _sweep(expr, YEAR_START + 86400 * 40, 86400, 1)
    assert got_port == got_ref
    assert tcron.Schedule(expr).has_seconds


@pytest.mark.parametrize("expr", ["* * * *", "* * * * * * *", "60 * * * *", "* 24 * * *",
                                  "* * 0 * *", "* * * 13 *", "* * * * 7", "*/0 * * * *",
                                  "5-1 * * * *", "a * * * *", "1-x * * * *", "*/x * * * *"])
def test_malformed_expressions_fail_alike(expr):
    with pytest.raises(rcron.CronParseError) as ref:
        rcron.Schedule(expr)
    with pytest.raises(tcron.CronParseError) as port:
        tcron.Schedule(expr)
    assert str(port.value) == str(ref.value)


def _container(buf: io.StringIO, exporter: InMemoryExporter) -> Container:
    container = Container(MapConfig({"APP_NAME": "cron"}, use_env=False),
                          logger=Logger(Level.INFO, buf, buf, exit_on_fatal=False))
    container.tracer = Tracer("cron", SimpleSpanProcessor(exporter))
    return container


def test_job_panic_is_logged_and_isolated():
    """``_run_job``: each job in a span of its own (``cron <name>``) with an
    empty request; a raise is logged with the reference's text and does not
    escape."""
    buf, exporter = io.StringIO(), InMemoryExporter()
    crontab = tcron.Crontab(_container(buf, exporter))
    seen = []

    def good(ctx):
        seen.append((ctx.param("x"), ctx.path_param("y"), ctx.bind(dict), ctx.header("z")))

    def bad(ctx):
        raise ValueError("boom")

    asyncio.run(crontab._run_job("good", good))
    asyncio.run(crontab._run_job("bad", bad))
    assert seen == [("", "", None, "")]
    errors = [json.loads(line)["message"] for line in buf.getvalue().splitlines()
              if json.loads(line)["level"] == "ERROR"]
    assert errors == ["error in cron job bad: boom"]
    assert sorted(s.name for s in exporter.spans) == ["cron bad", "cron good"]


def test_ticker_keeps_firing_past_a_failing_job():
    """The 1 s ticker on a live loop: a ``* * * * * *`` job runs every second
    while another job raises at every tick; ``stop`` ends the loop."""
    buf, exporter = io.StringIO(), InMemoryExporter()
    crontab = tcron.Crontab(_container(buf, exporter))
    ticks = []
    crontab.add("* * * * * *", "tick", lambda ctx: ticks.append(time.monotonic()))

    async def failing(ctx):
        raise RuntimeError("always")

    crontab.add("* * * * * *", "fail", failing)

    async def scenario():
        await crontab.start()
        await asyncio.sleep(2.3)
        await crontab.stop()

    asyncio.run(scenario())
    assert 2 <= len(ticks) <= 4
    assert all(0.3 < b - a < 1.8 for a, b in zip(ticks[1:], ticks[2:]))
    assert buf.getvalue().count("error in cron job fail: always") == len(ticks)
    assert crontab._task is None
