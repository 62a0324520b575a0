"""Versioned migrations at startup on the PyTorch port (the port's copy of
``examples/using-migrations``). Each version is applied once, recorded in
the ``gofr_migration`` table, and runs in its own transaction.

Run it from its directory, ``cd examples_torch/using-migrations && python
main.py``: the app reads ``configs/.env`` there (sqlite in memory)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from gofr_tpu_torch.app import App  # noqa: E402
from gofr_tpu_torch.migration import Migrate  # noqa: E402


def build_app(config=None) -> App:
    app = App(config)
    app.migrate({
        1: Migrate(up=lambda ds: ds.sql.exec(
            "CREATE TABLE IF NOT EXISTS users (id INTEGER PRIMARY KEY, name TEXT)"
        )),
        2: Migrate(up=lambda ds: ds.sql.exec(
            "INSERT INTO users (id, name) VALUES (1, 'ada')"
        )),
    })
    app.get("/users", lambda ctx: {"users": ctx.sql.query("SELECT * FROM users")})
    return app


if __name__ == "__main__":
    build_app().run()
