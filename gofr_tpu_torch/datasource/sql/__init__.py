"""SQL datasource.

Reference parity: pkg/gofr/datasource/sql/ — dialect selection (sql.go:212-237;
here sqlite in-tree, the rest pluggable), per-query structured log + the
``app_sql_stats`` histogram (db.go:47-66), reflect-based ``select`` into
dataclasses (db.go:214-334), transactions (db.go:124-185), health
(sql/health.go), and the CRUD query builder (query_builder.go).

The port's copy of ``gofr_tpu/datasource/sql/__init__.py``; it imports nothing of the JAX package.
"""

from gofr_tpu_torch.datasource.sql.sqlite import SQLite, new_sql
from gofr_tpu_torch.datasource.sql.postgres import PostgresDB
from gofr_tpu_torch.datasource.sql.mysql import MySQLDB
from gofr_tpu_torch.datasource.sql.pool import ConnectionPool, PoolTimeout
from gofr_tpu_torch.datasource.sql.query_builder import (
    delete_by_id_query,
    insert_query,
    select_all_query,
    select_by_id_query,
    update_by_id_query,
)

__all__ = [
    "SQLite",
    "PostgresDB",
    "MySQLDB",
    "ConnectionPool",
    "PoolTimeout",
    "new_sql",
    "insert_query",
    "select_all_query",
    "select_by_id_query",
    "update_by_id_query",
    "delete_by_id_query",
]
