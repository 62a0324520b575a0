"""Prompt-prefill (prefix) cache of the serving engine (a copy of
``gofr_tpu/serving/prefix_cache.py``; the port imports nothing of the JAX
package).

The engine keys an entry by (prefill bucket, prompt token ids), or by a
chunk boundary of a chunked prompt, and stores the prefill's outputs: the
last-position logits and the K/V slabs. A repeated prompt skips the whole
prefill forward and admits at decode cost. System prompts, retried
requests and health probes are the common repeats; sampling params are not
part of the key (sampling happens after the cached logits).

Device memory per entry is one prompt bucket of KV
(2 x L x bucket x Hkv x Dh in the model dtype; 33.5 MB for an 8B model at
bucket 256), bounded by LRU eviction over ``max_entries`` and
``max_bytes``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Hashable

import torch


def _value_bytes(value: Any) -> int:
    """Bytes of every leaf: a tensor's ``numel() * element_size()``, else
    its ``nbytes`` (numpy arrays)."""
    total = 0
    for leaf in _tree_leaves(value):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            nbytes = getattr(leaf, "nbytes", None)
            if nbytes is not None:
                total += int(nbytes)
    return total


def _tree_leaves(value: Any):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _tree_leaves(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tree_leaves(v)
    else:
        yield value


class PrefixCache:
    """Thread-safe LRU keyed by arbitrary hashables. Values are trees of
    device tensors; eviction drops the reference and lets the caching
    allocator reclaim the memory.

    Eviction is bounded by BOTH entry count and cumulative bytes: entry
    sizes vary ~64x across prefill buckets (32..2048 tokens), so an entry
    cap alone cannot bound device memory. ``size_of`` counts an entry's
    bytes: every leaf's (the tensor-parallel engine sets it to count its
    rank's slabs at their whole size, as the reference counts a sharded
    array)."""

    def __init__(self, max_entries: int = 32,
                 max_bytes: int = 256 * 1024 * 1024,
                 on_evict: Any = None) -> None:
        self.max_entries = max(1, max_entries)
        self.max_bytes = max_bytes
        self.size_of = _value_bytes
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._sizes: dict[Hashable, int] = {}
        self._total_bytes = 0
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        # capacity-eviction hook (the host-RAM spill tier,
        # serving/kv_spill.py): called OUTSIDE the lock with each
        # (key, value) the LRU dropped, so the lock stays leaf-only
        self.on_evict = on_evict

    def get(self, key: Hashable) -> Any | None:
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return value

    def put(self, key: Hashable, value: Any) -> bool:
        """Insert (or refresh) an entry; False when it can never fit and
        was not stored."""
        size = self.size_of(value)
        if size > self.max_bytes:
            # inserting then evicting would flush every useful entry to
            # make room for one that cannot fit anyway
            return False
        evicted: list[tuple[Hashable, Any]] = []
        with self._lock:
            if key in self._entries:
                self._total_bytes -= self._sizes.get(key, 0)
            self._entries[key] = value
            self._sizes[key] = size
            self._total_bytes += size
            self._entries.move_to_end(key)
            while self._entries and (
                len(self._entries) > self.max_entries
                or self._total_bytes > self.max_bytes
            ):
                old_key, old_value = self._entries.popitem(last=False)
                self._total_bytes -= self._sizes.pop(old_key, 0)
                evicted.append((old_key, old_value))
        if self.on_evict is not None:
            for old_key, old_value in evicted:
                try:
                    self.on_evict(old_key, old_value)
                except Exception:
                    pass  # the spill tier is advisory: a failed spill is a miss later
        return True

    def evict(self, key: Hashable) -> None:
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self._total_bytes -= self._sizes.pop(key, 0)

    def keys(self) -> list[Hashable]:
        """Resident keys, least recently used first."""
        with self._lock:
            return list(self._entries.keys())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._sizes.clear()
            self._total_bytes = 0

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "bytes": self._total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
            }
