"""Shared by the port's analyzer tests: run the JAX package's analyzer
tests as they are, record each fixture tree they lint, and lint the same
source text with the port's rules.

A reference fixture places its files under ``gofr_tpu/``; the port's
analyzers anchor paths at ``gofr_tpu_torch/``, so the port's copy of a
fixture goes there (the source text is unchanged).
"""

from __future__ import annotations

import functools
import importlib.util
import inspect
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def reference_module(name: str):
    """``tests/<name>.py`` of the JAX package, imported once."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(REPO_ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fixture_tests(name: str, helpers: tuple[str, ...]) -> list[str]:
    """The reference module's tests that take only ``tmp_path`` and lint
    a fixture through one of ``helpers``."""
    mod = reference_module(name)
    out = []
    for attr, fn in vars(mod).items():
        if not attr.startswith("test_") or not callable(fn):
            continue
        if list(inspect.signature(fn).parameters) != ["tmp_path"]:
            continue
        if any(f"{h}(" in inspect.getsource(fn) for h in helpers):
            out.append(attr)
    return sorted(out)


def port_path(rel: str) -> str:
    """A reference fixture path, moved under the port's package."""
    return "gofr_tpu_torch/" + rel[len("gofr_tpu/"):] if rel.startswith("gofr_tpu/") else rel


def materialize(root, files: dict[str, str]) -> str:
    """Write {relpath: source} under ``root``; returns the top directory."""
    for rel, source in files.items():
        full = root / rel
        full.parent.mkdir(parents=True, exist_ok=True)
        full.write_text(source)
    return str(root / sorted(files)[0].split("/")[0])


def record_fixtures(mod, helper: str, monkeypatch) -> list:
    """Wrap ``mod.<helper>`` so each call records (files, findings, args,
    kwargs) while returning what it returned."""
    calls: list = []
    real = getattr(mod, helper)

    def recording(tmp_path, files, *args, **kwargs):
        findings = real(tmp_path, files, *args, **kwargs)
        calls.append((dict(files), findings, args, kwargs))
        return findings

    monkeypatch.setattr(mod, helper, recording)
    return calls


def run_reference_test(mod, name: str, tmp_path) -> None:
    (tmp_path / "ref").mkdir()
    getattr(mod, name)(tmp_path / "ref")


def pairs(findings) -> list[tuple[str, int]]:
    return sorted((f.rule, f.line) for f in findings)
