"""Key-value stores.

Reference parity: pkg/gofr/datasource/kv-store/ — badger (embedded, 240 LoC)
maps to FileKVStore (embedded, persistent); dynamodb/nats-kv map to the same
KVStore contract (container/datasources.go:366-378) as pluggable drivers.

The port's copy of ``gofr_tpu/datasource/kv/__init__.py``; it imports nothing of the JAX package.
"""

from gofr_tpu_torch.datasource.kv.dynamodb import DynamoDBKVStore
from gofr_tpu_torch.datasource.kv.store import FileKVStore, InMemoryKVStore

__all__ = ["InMemoryKVStore", "FileKVStore", "DynamoDBKVStore"]
