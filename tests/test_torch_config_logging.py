"""The port's config and logging against the JAX package's
(``gofr_tpu/config``, ``gofr_tpu/logging``): ``EnvConfig`` layered from
``.env`` files the test writes, ``MapConfig``, level parsing, and ``Logger``
JSON lines equal apart from the time; ``trace_id``/``span_id`` taken from
each package's own current span (log correlation)."""

import io
import json

import pytest

from gofr_tpu.config import EnvConfig as REnvConfig
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.config import load_env_file as r_load_env_file
from gofr_tpu.http import errors as r_errors
from gofr_tpu.logging import ContextLogger as RContextLogger
from gofr_tpu.logging import Level as RLevel
from gofr_tpu.logging import Logger as RLogger
from gofr_tpu.logging.level import parse_level as r_parse_level
from gofr_tpu.tracing import Tracer as RTracer
from gofr_tpu_torch.config import EnvConfig as TEnvConfig
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.config import load_env_file as t_load_env_file
from gofr_tpu_torch.http import errors as t_errors
from gofr_tpu_torch.logging import ContextLogger as TContextLogger
from gofr_tpu_torch.logging import Level as TLevel
from gofr_tpu_torch.logging import Logger as TLogger
from gofr_tpu_torch.logging import parse_level as t_parse_level
from gofr_tpu_torch.tracing import Tracer as TTracer

ENV = """# comment
APP_NAME=from-env
export EXPORTED = yes
QUOTED="a # not a comment"
SINGLE='single'
INLINE=value # trailing comment
EMPTY=
malformed line
=novalue
OVERRIDDEN=base
WINS=file
"""
LOCAL = "OVERRIDDEN=local\nLOCAL_ONLY=1\n"
STAGING = "OVERRIDDEN=staging\n"
KEYS = ["APP_NAME", "EXPORTED", "QUOTED", "SINGLE", "INLINE", "EMPTY", "OVERRIDDEN", "WINS",
        "LOCAL_ONLY", "MISSING", ""]


@pytest.fixture
def configs(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text(ENV)
    (tmp_path / ".local.env").write_text(LOCAL)
    (tmp_path / ".staging.env").write_text(STAGING)
    monkeypatch.delenv("APP_ENV", raising=False)
    monkeypatch.setenv("WINS", "process")
    for key in KEYS:
        if key and key != "WINS":
            monkeypatch.delenv(key, raising=False)
    return tmp_path


@pytest.mark.parametrize("app_env", ["", "staging", "absent"])
def test_env_config_layers(configs, monkeypatch, app_env):
    if app_env:
        monkeypatch.setenv("APP_ENV", app_env)
    got = {}
    for name, cls in (("ref", REnvConfig), ("port", TEnvConfig)):
        c = cls(str(configs))
        got[name] = [(c.get(k), c.get_or_default(k, "dflt")) for k in KEYS]
    assert got["port"] == got["ref"]
    values = dict(zip(KEYS, got["port"]))
    assert values["WINS"][0] == "process"
    assert values["OVERRIDDEN"][0] == {"": "local", "staging": "staging", "absent": "base"}[app_env]
    assert values["EMPTY"] == ("", "dflt")


def test_load_env_file(configs):
    assert t_load_env_file(str(configs / ".env")) == r_load_env_file(str(configs / ".env"))
    assert t_load_env_file(str(configs / "missing.env")) == {}


@pytest.mark.parametrize("use_env", [True, False])
def test_map_config(monkeypatch, use_env):
    monkeypatch.setenv("FROM_ENV", "e")
    values = {"A": "1", "EMPTY": ""}
    out = []
    for cls in (RMapConfig, TMapConfig):
        c = cls(values, use_env=use_env)
        out.append([(c.get(k), c.get_or_default(k, "d")) for k in ("A", "EMPTY", "FROM_ENV", "X")])
    assert out[1] == out[0]


@pytest.mark.parametrize("name", ["debug", "INFO", " notice ", "Warn", "error", "FATAL", "bogus", ""])
def test_parse_level(name):
    assert t_parse_level(name).name == r_parse_level(name).name
    assert t_parse_level(name).value == r_parse_level(name).value


def test_levels_and_colors():
    assert [(l.name, l.value, l.color) for l in TLevel] == \
        [(l.name, l.value, l.color) for l in RLevel]


class Pretty:
    def __init__(self):
        self.method, self.uri = "GET", "/x"

    def pretty_print(self, writer):
        writer.write("pretty!")


def _lines(logger_cls, level, calls, *, ctx=None, tracer=None, errors=None):
    out, err = io.StringIO(), io.StringIO()
    logger = logger_cls(level, out, err, exit_on_fatal=False)
    target = ctx(logger, "t" * 32, "s" * 16) if ctx else logger
    span = tracer.start_span("op") if tracer else None
    try:
        for name, args, kw in calls:
            if name == "log_error":
                getattr(target, name)(errors(args[0]), *args[1:], **kw)
            else:
                getattr(target, name)(*args, **kw)
    finally:
        if span is not None:
            span.end()
    rows = []
    for sink, text in (("out", out.getvalue()), ("err", err.getvalue())):
        for line in text.splitlines():
            entry = json.loads(line)
            assert entry.pop("time")
            rows.append((sink, entry))
    return rows, span


CALLS = [
    ("debug", ("dbg",), {}),
    ("info", ("hello",), {}),
    ("info", ("%s has %d", "x", 3), {}),
    ("info", ("%d broken", "notint"), {}),
    ("notice", ("a", "b", 3), {}),
    ("warn", ("w",), {"field": 1, "none_field": None}),
    ("error", ("e",), {"stack": "trace"}),
    ("fatal", ("f",), {}),
    ("log", (), {}),
    ("info", (Pretty(),), {}),
    ("log_error", ("not_found",), {}),
    ("log_error", ("unavailable", "custom text"), {}),
    ("log_error", ("plain",), {}),
]


def _err(pkg_errors):
    return lambda name: {
        "not_found": pkg_errors.ErrorEntityNotFound("user", "1"),
        "unavailable": pkg_errors.ErrorServiceUnavailable(),
        "plain": KeyError("k"),
    }[name]


@pytest.mark.parametrize("level", ["DEBUG", "INFO", "WARN", "FATAL"])
def test_logger_json_lines(level, monkeypatch):
    monkeypatch.setenv("LOG_JSON", "true")
    ref, _ = _lines(RLogger, RLevel[level], CALLS, errors=_err(r_errors))
    port, _ = _lines(TLogger, TLevel[level], CALLS, errors=_err(t_errors))
    assert port == ref
    assert all("trace_id" not in e for _, e in port)


@pytest.mark.parametrize("ctx", [False, True])
def test_log_correlation_from_the_current_span(ctx, monkeypatch):
    """A line under an active span carries that span's ids, each package
    reading its own tracer's current span; a ContextLogger's explicit ids
    win over the span's."""
    monkeypatch.setenv("LOG_JSON", "true")
    calls = [("info", ("in span",), {}), ("warn", ("also",), {"k": "v"})]
    got = {}
    for name, logger_cls, ctx_cls, tracer in (("ref", RLogger, RContextLogger, RTracer("r")),
                                              ("port", TLogger, TContextLogger, TTracer("p"))):
        rows, span = _lines(logger_cls, RLevel.INFO if name == "ref" else TLevel.INFO, calls,
                            ctx=ctx_cls if ctx else None, tracer=tracer)
        want = ("t" * 32, "s" * 16) if ctx else (span.trace_id, span.span_id)
        for _, entry in rows:
            assert (entry.pop("trace_id"), entry.pop("span_id")) == want
        got[name] = rows
    assert got["port"] == got["ref"]


def test_pretty_terminal_output():
    class Tty(io.StringIO):
        def isatty(self):
            return True

    outs = []
    for cls, level in ((RLogger, RLevel.INFO), (TLogger, TLevel.INFO)):
        out = Tty()
        logger = cls(level, out, out, exit_on_fatal=False)
        logger.info("plain")
        logger.error(Pretty())
        outs.append([line.split("] ", 1)[1] for line in out.getvalue().splitlines()])
    assert outs[1] == outs[0]


def test_fatal_exits_unless_told_not_to():
    with pytest.raises(SystemExit):
        TLogger(TLevel.INFO, io.StringIO(), io.StringIO()).fatal("bye")
