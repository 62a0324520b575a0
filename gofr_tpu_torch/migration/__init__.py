"""Versioned migrations (reference: pkg/gofr/migration/).

An ordered int-keyed map of ``Migrate`` objects runs against the initialized
datasources (migration/migration.go:29-99): a ``gofr_migration`` tracking
table records applied versions with start time + duration; versions at or
below the last applied are skipped (resume semantics, :50-98); SQL
migrations run inside a transaction with rollback on failure. The
``Datasource`` facade hands the user's UP function scoped handles
(migration/datasource.go).

The reference's extension (SURVEY §5.4) hands the UP function the device
datasource too (``Datasource.tpu``), so a version can compile and check
device work, recorded like any schema change. On the port that work is a
one-time warm-up and check, not a cache: ``TPUClient.compile`` captures a
CUDA graph that dies with its process (ROADMAP Queue C 37 refuses
``TPU_COMPILE_CACHE_DIR``), so a restart skips the applied version and
keeps nothing of its capture, where the reference's XLA cache survives.

The port's copy of ``gofr_tpu/migration/__init__.py``; it imports nothing
of the JAX package.
"""

from gofr_tpu_torch.migration.migration import (
    Datasource,
    Migrate,
    MigrationError,
    run_migrations,
)

__all__ = ["Migrate", "Datasource", "MigrationError", "run_migrations"]
