"""CRUD query builders (reference: datasource/sql/query_builder.go, 138 LoC).

Generates the five statements AddRESTHandlers needs from an entity's field
list. Identifiers are validated (alnum + underscore) — values always travel
as bound parameters.

The port's copy of ``gofr_tpu/datasource/sql/query_builder.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import re

_IDENT = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _check(name: str) -> str:
    if not _IDENT.match(name):
        raise ValueError(f"invalid SQL identifier: {name!r}")
    return name


def insert_query(table: str, fields: list[str]) -> str:
    cols = ", ".join(_check(f) for f in fields)
    marks = ", ".join("?" for _ in fields)
    return f"INSERT INTO {_check(table)} ({cols}) VALUES ({marks})"


def select_all_query(table: str) -> str:
    return f"SELECT * FROM {_check(table)}"


def select_by_id_query(table: str, id_field: str) -> str:
    return f"SELECT * FROM {_check(table)} WHERE {_check(id_field)} = ?"


def update_by_id_query(table: str, fields: list[str], id_field: str) -> str:
    sets = ", ".join(f"{_check(f)} = ?" for f in fields if f != id_field)
    return f"UPDATE {_check(table)} SET {sets} WHERE {_check(id_field)} = ?"


def delete_by_id_query(table: str, id_field: str) -> str:
    return f"DELETE FROM {_check(table)} WHERE {_check(id_field)} = ?"
