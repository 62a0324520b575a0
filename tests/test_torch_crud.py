"""The port's CRUD handlers (``gofr_tpu_torch/crud.py``, ``App.add_rest_handlers``)
beside the JAX package's, each on its own ``App`` with its own sqlite
(``DB_DIALECT=sqlite``), booted on free ports and asked the same things
over real HTTP: one seeded sequence of POST, GET (all and by id), PUT and
DELETE; a missing id (404) and a non-integer id (400); a primary-key-only
entity (no PUT route: 405); and a custom ``get_all`` on the entity that
overrides the default. Statuses and JSON bodies are equal on both sides.
The port's two examples (``examples_torch/``) boot and answer too."""

import dataclasses
import importlib.util
import json
import random
from pathlib import Path

import pytest

import gofr_tpu
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu_torch.app import App as TApp
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.crud import scan_entity
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"ref": (gofr_tpu.App, RMapConfig), "port": (TApp, TMapConfig)}


@dataclasses.dataclass
class Book:
    id: int = 0
    title: str = ""
    year: int = 0
    price: float = 0.0


@dataclasses.dataclass
class Tag:
    name: str = ""


@dataclasses.dataclass
class Note:
    id: int = 0
    text: str = ""

    @staticmethod
    def get_all(ctx):
        rows = ctx.sql.query("SELECT id, text FROM note ORDER BY id DESC")
        return {"custom": True, "notes": rows}


def _config(cls, **extra):
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "APP_NAME": "crud-app", "LOG_LEVEL": "FATAL", "SHUTDOWN_GRACE_PERIOD": "5",
              "HTTP_HOST": "127.0.0.1", "DB_DIALECT": "sqlite"}
    values.update(extra)
    return cls(values, use_env=False)


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    booted = {}
    for side, (app_cls, config_cls) in SIDES.items():
        db = tmp_path_factory.mktemp(side) / "crud.db"
        app = app_cls(_config(config_cls, DB_NAME=str(db)))
        sql = app.container.sql
        sql.exec("CREATE TABLE book (id INTEGER PRIMARY KEY, title TEXT, year INTEGER, price REAL)")
        sql.exec("CREATE TABLE tag (name TEXT PRIMARY KEY)")
        sql.exec("CREATE TABLE note (id INTEGER PRIMARY KEY, text TEXT)")
        for entity in (Book, Tag, Note):
            app.add_rest_handlers(entity)
        booted[side] = (app, start_app(app), f"http://127.0.0.1:{app.http_port}")
    yield {side: base for side, (_, _, base) in booted.items()}
    for app, thread, _ in booted.values():
        stop_app(app, thread)


def _ask(base: str, method: str, path: str, body=None) -> tuple[int, object]:
    data = json.dumps(body).encode() if body is not None else None
    status, _, raw = fetch(base + path, method, data, {"Content-Type": "application/json"})
    return status, json.loads(raw) if raw else None


def _both(apps, method: str, path: str, body=None) -> tuple[int, object]:
    got = _ask(apps["port"], method, path, body)
    want = _ask(apps["ref"], method, path, body)
    assert got == want, f"{method} {path}"
    return got


def _sequence(seed: int) -> list[tuple[str, str, object]]:
    rng = random.Random(seed)
    ids = rng.sample(range(1, 1000), 6)
    seq = []
    for i in ids:
        seq.append(("POST", "/book", {"id": i, "title": f"t{rng.randint(0, 99)} o'b",
                                      "year": rng.randint(1900, 2026),
                                      "price": round(rng.random() * 100, 2)}))
    seq.append(("GET", "/book", None))
    for i in rng.sample(ids, 3):
        seq.append(("GET", f"/book/{i}", None))
        seq.append(("PUT", f"/book/{i}", {"id": i, "title": "new", "year": 2000, "price": 1.5}))
        seq.append(("GET", f"/book/{i}", None))
    for i in rng.sample(ids, 2):
        seq.append(("DELETE", f"/book/{i}", None))
        seq.append(("GET", f"/book/{i}", None))  # 404 now
        seq.append(("DELETE", f"/book/{i}", None))  # 404 too
    seq.append(("GET", "/book", None))
    return seq


@pytest.mark.parametrize("seed", range(2))
def test_a_seeded_crud_sequence_answers_like_the_reference(apps, seed):
    for method, path, body in _sequence(seed):
        status, out = _both(apps, method, path, body)
        assert status in (200, 201, 204, 404), (method, path, status, out)
    status, out = _both(apps, "GET", "/book")
    assert status == 200 and len(out["data"]) >= 4 and all(isinstance(b["year"], int)
                                                           for b in out["data"])


def test_missing_and_malformed_ids(apps):
    assert _both(apps, "GET", "/book/424242")[0] == 404
    assert _both(apps, "PUT", "/book/424242", {"id": 424242, "title": "x", "year": 1,
                                                 "price": 0.0})[0] == 404
    assert _both(apps, "DELETE", "/book/424242")[0] == 404
    for method in ("GET", "PUT", "DELETE"):
        body = {"id": 1, "title": "x", "year": 1, "price": 0.0} if method == "PUT" else None
        assert _both(apps, method, "/book/abc", body)[0] == 400


def test_a_primary_key_only_entity_has_no_put_route(apps):
    assert _both(apps, "POST", "/tag", {"name": "gpu"})[0] == 201
    assert _both(apps, "GET", "/tag/gpu") == (200, {"data": {"name": "gpu"}})
    assert _both(apps, "PUT", "/tag/gpu", {"name": "tpu"})[0] == 405
    assert _both(apps, "DELETE", "/tag/gpu")[0] == 204
    assert scan_entity(Tag).fields == ["name"] and scan_entity(Tag).primary_key == "name"


def test_a_custom_get_all_overrides_the_default(apps):
    for i, text in enumerate(["a", "b"], start=1):
        assert _both(apps, "POST", "/note", {"id": i, "text": text})[0] == 201
    status, out = _both(apps, "GET", "/note")
    assert status == 200 and out["data"]["custom"] is True
    assert [n["id"] for n in out["data"]["notes"]] == [2, 1]
    assert _both(apps, "GET", "/note/1") == (200, {"data": {"id": 1, "text": "a"}})


def test_a_non_dataclass_or_empty_entity_is_refused():
    from gofr_tpu.crud import scan_entity as r_scan_entity

    @dataclasses.dataclass
    class Empty:
        pass

    for scan in (scan_entity, r_scan_entity):
        with pytest.raises(TypeError, match="dataclass"):
            scan(dict)
        with pytest.raises(TypeError, match="primary key"):
            scan(Empty)


def _load_example(name: str):
    path = ROOT / "examples_torch" / name / "main.py"
    spec = importlib.util.spec_from_file_location(f"torch_example_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["using-migrations", "using-rest-handlers"])
def test_the_ports_examples_boot_and_answer(name):
    app = _load_example(name).build_app(_config(TMapConfig, DB_NAME=":memory:"))
    assert isinstance(app, TApp)
    thread = start_app(app)
    base = f"http://127.0.0.1:{app.http_port}"
    try:
        if name == "using-migrations":
            assert _ask(base, "GET", "/users") == (200, {"data": {"users": [
                {"id": 1, "name": "ada"}]}})
        else:
            assert _ask(base, "POST", "/book", {"id": 1, "title": "CUDA", "year": 2026})[0] == 201
            assert _ask(base, "GET", "/book/1") == (200, {"data": {
                "id": 1, "title": "CUDA", "year": 2026}})
            assert _ask(base, "GET", "/.well-known/health")[1]["data"]["details"]["sql"][
                "status"] == "UP"
    finally:
        stop_app(app, thread)
