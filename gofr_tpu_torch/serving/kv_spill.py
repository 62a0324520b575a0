"""Host-RAM KV spill tier: the host-memory layer under the card's memory
(port of ``gofr_tpu/serving/kv_spill.py``).

Prefix-cache entries (whole-prompt prefills and chunk-boundary K/V slabs)
are bounded on the card by the :class:`PrefixCache` LRU; without this
module a capacity eviction drops them, and a repeated system prompt whose
slabs aged out pays a full re-prefill. Host RAM is ~100x the device prefix
budget, and a re-upload is an asynchronous host-to-device copy the engine
never waits on.

:class:`TieredPrefixCache` keeps the cache contract over two tiers:

- **device**: the :class:`PrefixCache` LRU of device tensors;
- **host**: :class:`HostSpillTier`, a byte-bounded LRU of the same trees as
  host tensors in pinned memory.

An eviction from the device tier *offers* the entry to a single-worker
spill executor. The worker copies each tensor into pinned host memory (the
device-to-host wait happens on the spill thread, never the engine thread)
and files it in the host LRU. A device-tier miss that hits the host tier
re-uploads with ``non_blocking=True`` to the device the cache was built
for (ordered on the stream before the dispatch that reads it, with no host
sync) and promotes the entry back into the device tier.

A spill that fails on the worker (a host copy that raises, or the
``kv.spill`` chaos point) drops the entry: the tier is advisory, and a lost
spill is a compute miss later.

Lock discipline: the device tier's lock and the host tier's lock are both
leaf-only; neither tier calls into the other, or into a callback, while
holding its own lock.
"""

from __future__ import annotations

import concurrent.futures
import threading
from collections import OrderedDict
from typing import Any, Hashable

import torch

from gofr_tpu_torch import chaos
from gofr_tpu_torch._device import resolve_device
from gofr_tpu_torch.serving.prefix_cache import PrefixCache, _value_bytes

__all__ = ["HostSpillTier", "TieredPrefixCache"]


def _to_host(value: Any) -> Any:
    """Copy a tree of tensors to host memory, keeping its structure: a
    CUDA tensor into a fresh pinned buffer (so the re-upload can be
    asynchronous), any other tensor into a fresh CPU tensor. Runs on the
    spill worker thread only; a leaf it cannot copy raises there, and the
    entry is dropped."""
    if isinstance(value, tuple):
        return tuple(_to_host(v) for v in value)
    if isinstance(value, list):
        return [_to_host(v) for v in value]
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if value.is_cuda:
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        host.copy_(value)
        return host
    return value.to("cpu", copy=True)


def _to_device(value: Any, device: torch.device) -> Any:
    """Upload a host tree to ``device``: from pinned memory the copy is
    enqueued with no host sync, so it is safe on the engine thread."""
    if isinstance(value, tuple):
        return tuple(_to_device(v, device) for v in value)
    if isinstance(value, list):
        return [_to_device(v, device) for v in value]
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return value.to(device, non_blocking=True)


class HostSpillTier:
    """Byte-bounded LRU of host KV trees. Thread-safe; the lock is
    leaf-only (``score`` is read BEFORE taking it).

    ``score`` (optional, ``Callable[[key], number]``) turns the
    byte-pressure eviction order from raw LRU into observed reuse: among
    resident entries the LOWEST (score, LRU age) evicts first, so a hot
    system prompt's slabs outlive a one-shot prompt's even when the
    one-shot was touched more recently."""

    def __init__(self, max_bytes: int, score: Any = None) -> None:
        self.max_bytes = max_bytes
        self._score = score
        self.size_of = _value_bytes  # see PrefixCache
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._sizes: dict[Hashable, int] = {}
        self._total_bytes = 0
        self._mu = threading.Lock()
        self._hits = 0
        self._misses = 0

    def put(self, key: Hashable, host_value: Any) -> None:
        size = self.size_of(host_value)
        if size > self.max_bytes:
            return  # can never fit: do not flush the tier for it
        scores: dict[Hashable, float] = {}
        if self._score is not None:
            # snapshot the resident keys under the lock, score outside it
            # (the scorer may take a lock of its own); keys racing in
            # behind the snapshot score 0
            with self._mu:
                resident = list(self._entries.keys())
            for k in resident:
                try:
                    scores[k] = float(self._score(k))
                except Exception:
                    scores[k] = 0.0
        with self._mu:
            if key in self._entries:
                self._total_bytes -= self._sizes.get(key, 0)
            self._entries[key] = host_value
            self._sizes[key] = size
            self._total_bytes += size
            self._entries.move_to_end(key)
            while self._entries and self._total_bytes > self.max_bytes:
                if scores:
                    # lowest observed reuse first; ties in LRU order (min
                    # keeps the oldest). The key being inserted is exempt.
                    victims = [k for k in self._entries if k != key]
                    if not victims:
                        break
                    old_key = min(victims, key=lambda k: scores.get(k, 0.0))
                    self._entries.pop(old_key, None)
                else:
                    old_key, _ = self._entries.popitem(last=False)
                self._total_bytes -= self._sizes.pop(old_key, 0)

    def get(self, key: Hashable) -> Any | None:
        with self._mu:
            value = self._entries.get(key)
            if value is None:
                self._misses += 1
                return None
            self._entries.move_to_end(key)
            self._hits += 1
            return value

    def pop(self, key: Hashable) -> Any | None:
        with self._mu:
            value = self._entries.pop(key, None)
            if value is not None:
                self._total_bytes -= self._sizes.pop(key, 0)
                self._hits += 1
            else:
                self._misses += 1
            return value

    def keys(self) -> list[Hashable]:
        with self._mu:
            return list(self._entries.keys())

    @property
    def total_bytes(self) -> int:
        with self._mu:
            return self._total_bytes

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._sizes.clear()
            self._total_bytes = 0

    def stats(self) -> dict[str, Any]:
        with self._mu:
            return {
                "entries": len(self._entries),
                "bytes": self._total_bytes,
                "max_bytes": self.max_bytes,
                "hits": self._hits,
                "misses": self._misses,
            }


class TieredPrefixCache:
    """Two-tier prefix cache: a device :class:`PrefixCache` LRU over a
    host-RAM :class:`HostSpillTier`, with the same get/put/evict/keys/
    clear/stats contract, plus :meth:`get_with_tier` for per-request tier
    attribution.

    The spill executor has one worker: device-to-host copies queue behind
    it, so a burst of evictions never fans out, and ``flush()`` gives
    tests and drain a settle point. A bounded backlog (``MAX_PENDING``)
    refuses new offers while full (``spill_dropped_total``): a queue that
    grew without bound would only be a slower way to lose entries.

    ``on_spill`` (optional, ``Callable[[key], None]``) hears each
    device-tier eviction as it is offered, on the thread that evicted
    (the tensor-parallel engine's followers spill their own slices in the
    same order); :attr:`spilling` says whether a spill is still queued."""

    MAX_PENDING = 64

    def __init__(
        self,
        max_entries: int = 32,
        max_bytes: int = 256 * 1024 * 1024,
        spill_bytes: int = 1024 * 1024 * 1024,
        *,
        reuse_score: Any = None,
        device: str | torch.device | None = None,
        metrics: Any = None,
    ) -> None:
        self.device = resolve_device(device)  # where a host hit re-uploads to
        # with a Manager: app_kv_spill_bytes after each completed spill
        self._metrics = metrics
        self._device = PrefixCache(max_entries, max_bytes=max_bytes, on_evict=self._offer)
        self._host = HostSpillTier(spill_bytes, score=reuse_score)
        self.on_spill: Any = None
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="kv-spill"
        )
        self._pending = 0
        self._pending_mu = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self.spilled_total = 0
        self.dropped_total = 0

    # -- the cache contract ----------------------------------------------------
    def get(self, key: Hashable) -> Any | None:
        value, _tier = self.get_with_tier(key)
        return value

    def get_with_tier(self, key: Hashable) -> tuple[Any | None, str]:
        """Lookup across tiers: ``(value, tier)``, tier one of ``device``,
        ``host`` or ``miss``. A host hit re-uploads (no host sync),
        promotes the entry back into the device tier and removes the host
        copy; if the promotion is evicted again it re-spills as usual."""
        value = self._device.get(key)
        if value is not None:
            return value, "device"
        host_value = self._host.pop(key)
        if host_value is None:
            return None, "miss"
        device_value = _to_device(host_value, self.device)
        self._device.put(key, device_value)
        return device_value, "host"

    def put(self, key: Hashable, value: Any) -> bool:
        return self._device.put(key, value)

    @property
    def size_of(self) -> Any:
        return self._device.size_of

    @size_of.setter
    def size_of(self, fn: Any) -> None:
        self._device.size_of = self._host.size_of = fn

    @property
    def spilling(self) -> bool:
        """A spill is queued or running on the worker."""
        return not self._idle.is_set()

    def peek(self, key: Hashable) -> Any | None:
        """A read across tiers that changes nothing: no host-tier pop, no
        promotion. Device tensors from the device tier, host tensors from
        the spill tier."""
        value = self._device.get(key)
        if value is not None:
            return value
        return self._host.get(key)

    def keys(self) -> list[Hashable]:
        """Every resident key, the device tier first (LRU order within
        each tier)."""
        device = self._device.keys()
        seen = set(device)
        return device + [k for k in self._host.keys() if k not in seen]

    def evict(self, key: Hashable) -> None:
        self._device.evict(key)
        self._host.pop(key)

    def clear(self) -> None:
        """Drop both tiers."""
        self._device.clear()
        self._host.clear()

    def stats(self) -> dict[str, Any]:
        out = self._device.stats()
        out["host"] = self._host.stats()
        out["spilled_total"] = self.spilled_total
        out["spill_dropped_total"] = self.dropped_total
        return out

    def advertised(self, limit: int = 128) -> list[tuple[str, str]]:
        """(key, tier) pairs for the prefix index's advertisement
        (serving/prefix_index.py), newest first within each tier, the
        device tier first; bounded, so a heartbeat stays small."""
        out: list[tuple[str, str]] = []
        for key in reversed(self._device.keys()):
            out.append((str(key), "device"))
            if len(out) >= limit:
                return out
        for key in reversed(self._host.keys()):
            out.append((str(key), "host"))
            if len(out) >= limit:
                break
        return out

    # -- the spill path (device-tier eviction -> host tier) --------------------
    def _offer(self, key: Hashable, value: Any) -> None:
        """Device-tier eviction hook: hand the dropped entry to the spill
        worker. The engine thread's side reads nothing off the device."""
        if self.on_spill is not None:
            self.on_spill(key)
        with self._pending_mu:
            if self._pending >= self.MAX_PENDING:
                self.dropped_total += 1
                return
            self._pending += 1
            self._idle.clear()
        try:
            self._exec.submit(self._spill_task, key, value)
        except RuntimeError:  # executor shut down: the tier is closing
            self._spill_done()

    def _spill_task(self, key: Hashable, value: Any) -> None:
        try:
            chaos.maybe_fail("kv.spill")
            host_value = _to_host(value)
            self._host.put(key, host_value)
            with self._pending_mu:
                self.spilled_total += 1
            if self._metrics is not None:
                self._metrics.set_gauge("app_kv_spill_bytes", float(self._host.total_bytes))
        except Exception:
            # a host copy that raises, or the kv.spill chaos point, drops
            # the entry: a later lookup is a compute miss
            with self._pending_mu:
                self.dropped_total += 1
        finally:
            self._spill_done()

    def _spill_done(self) -> None:
        with self._pending_mu:
            self._pending -= 1
            if self._pending <= 0:
                self._idle.set()

    def flush(self, timeout: float = 5.0) -> bool:
        """Wait for every queued spill to settle (tests, drain)."""
        return self._idle.wait(timeout=timeout)

    def close(self) -> None:
        self._exec.shutdown(wait=False)

