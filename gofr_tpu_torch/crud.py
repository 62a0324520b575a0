"""CRUD auto-handlers.

Reference parity: pkg/gofr/crud_handlers.go — ``add_rest_handlers(app,
Entity)`` scans a dataclass (scanEntity :67-113: first field is the primary
key, field names become column names), registers POST/GET/GET-id/PUT/DELETE
routes with SQL-backed default implementations (:151-333, via the query
builders in datasource/sql/query_builder.py), each overridable by defining
``create/get_all/get_by_id/update/delete`` methods on the entity class
(:116-149 interface checks).

The port's copy of ``gofr_tpu/crud.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any

from gofr_tpu_torch.datasource.sql import query_builder as qb
from gofr_tpu_torch.http.errors import ErrorEntityNotFound, ErrorInvalidParam


@dataclasses.dataclass
class _EntityMeta:
    name: str
    cls: type
    fields: list[str]
    primary_key: str
    hints: dict[str, Any]


def scan_entity(cls: type) -> _EntityMeta:
    """crud_handlers.go:67-113."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError("add_rest_handlers requires a dataclass entity")
    fields = [f.name for f in dataclasses.fields(cls)]
    if not fields:
        raise TypeError("entity must have at least one field (primary key)")
    return _EntityMeta(
        name=cls.__name__.lower(),
        cls=cls,
        fields=fields,
        primary_key=fields[0],
        hints=typing.get_type_hints(cls),
    )


def _coerce_id(meta: _EntityMeta, raw: str) -> Any:
    hint = meta.hints.get(meta.primary_key, str)
    try:
        return hint(raw) if hint in (int, float) else raw
    except ValueError:
        raise ErrorInvalidParam(meta.primary_key)


def add_rest_handlers(app: Any, cls: type, table: str | None = None) -> None:
    meta = scan_entity(cls)
    table = table or meta.name
    route = f"/{meta.name}"

    def handler_or_default(name: str, default: Any) -> Any:
        custom = getattr(cls, name, None)
        return custom if callable(custom) and not dataclasses.is_dataclass(custom) else default

    def create(ctx: Any) -> Any:
        entity = ctx.bind(cls)
        values = [getattr(entity, f) for f in meta.fields]
        ctx.sql.exec(qb.insert_query(table, meta.fields), *values)
        return f"{cls.__name__} successfully created with id: {getattr(entity, meta.primary_key)}"

    def get_all(ctx: Any) -> Any:
        return ctx.sql.select(cls, qb.select_all_query(table))

    def get_by_id(ctx: Any) -> Any:
        entity_id = _coerce_id(meta, ctx.path_param("id"))
        rows = ctx.sql.select(cls, qb.select_by_id_query(table, meta.primary_key), entity_id)
        if not rows:
            raise ErrorEntityNotFound(meta.primary_key, str(entity_id))
        return rows[0]

    def update(ctx: Any) -> Any:
        entity_id = _coerce_id(meta, ctx.path_param("id"))
        entity = ctx.bind(cls)
        values = [getattr(entity, f) for f in meta.fields if f != meta.primary_key]
        cursor = ctx.sql.exec(
            qb.update_by_id_query(table, meta.fields, meta.primary_key), *values, entity_id
        )
        if getattr(cursor, "rowcount", 1) == 0:
            raise ErrorEntityNotFound(meta.primary_key, str(entity_id))
        return f"{cls.__name__} successfully updated with id: {entity_id}"

    def delete(ctx: Any) -> Any:
        entity_id = _coerce_id(meta, ctx.path_param("id"))
        cursor = ctx.sql.exec(qb.delete_by_id_query(table, meta.primary_key), entity_id)
        if getattr(cursor, "rowcount", 1) == 0:
            raise ErrorEntityNotFound(meta.primary_key, str(entity_id))
        return f"{cls.__name__} successfully deleted with id: {entity_id}"

    app.post(route, handler_or_default("create", create))
    app.get(route, handler_or_default("get_all", get_all))
    app.get(route + "/{id}", handler_or_default("get_by_id", get_by_id))
    if len(meta.fields) > 1 or getattr(cls, "update", None) is not None:
        # a PK-only entity has nothing to update; the default UPDATE would
        # be a syntax error (empty SET clause)
        app.put(route + "/{id}", handler_or_default("update", update))
    app.delete(route + "/{id}", handler_or_default("delete", delete))
