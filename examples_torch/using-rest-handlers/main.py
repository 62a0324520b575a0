"""CRUD handlers derived from an entity class on the PyTorch port (the
port's copy of ``examples/using-rest-handlers``). POST, GET, PUT and
DELETE under ``/book`` come from the dataclass; the rows live in the
configured SQL dialect (``DB_DIALECT``).

Run it from its directory, ``cd examples_torch/using-rest-handlers && python
main.py``: the app reads ``configs/.env`` there (sqlite in memory)."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gofr_tpu_torch.app import App  # noqa: E402


@dataclasses.dataclass
class Book:
    id: int = 0
    title: str = ""
    year: int = 0


def build_app(config=None) -> App:
    app = App(config)
    app.container.sql.exec(
        "CREATE TABLE IF NOT EXISTS book (id INTEGER PRIMARY KEY, title TEXT, year INTEGER)"
    )
    app.add_rest_handlers(Book)
    return app


if __name__ == "__main__":
    build_app().run()
