"""Runtime reclaim tracer of the port: the dynamic twin of leakcheck's
static table.

The port's copy of ``gofr_tpu/analysis/leaktrace.py``. The lifecycle
tests assert the reclaim invariant end to end (every request terminal,
slots + pages freed, zero leaked spans) through the counters each
subsystem exposes; this shim instruments the acquire/release surfaces of
the serving control plane directly while installed:

- ``Scheduler`` / ``TPUClient`` construction → ``close()`` (and the
  Scheduler's quarantine ``leak()``) — the ``wrapper`` kind, where the
  reference instruments its native ``BlockAllocator``/``Scheduler``
  wrappers;
- ``BlockAllocator.alloc`` → ``free`` (``kv-seq``);
- ``PagedKVCache.alloc_slot``/``try_reserve_slot``/``try_reserve_chunk``
  → ``free_slot`` (``kv-slot``);
- ``TimelineRecorder.begin`` → ``finish`` (``timeline``).

Every observed event is recorded as ``(kind, acquire|release, name)``
and every live resource is tracked by identity, so two invariants become
directly assertable on a REAL engine workload:

1. **Balance** — after stop/drain, no live resource remains
   (:meth:`LeakTraceMonitor.check`): the dynamic reclaim audit.
2. **Coverage** — every runtime-observed acquire/release site is in
   leakcheck's static resource table
   (:func:`gofr_tpu_torch.analysis.leakcheck.check_coverage`): the
   analyzer has no blind spot for a resource the runtime actually cycles.
   A ``leak()`` release is matched through the table's
   transfer-annotated methods — a declared quarantine leak IS a
   documented disposition.

Usage:

    mon = leaktrace.install()
    try:
        ...  # real engine workload
    finally:
        leaktrace.uninstall()
    mon.check()                      # raises LeakTraceError on a leak
    leaktrace.export_to(mon, path)   # merge-write the observed pairs
"""

from __future__ import annotations

import json
import threading
from typing import Any

__all__ = [
    "LeakTraceError", "LeakTraceMonitor", "install", "uninstall",
    "export_to",
]


class LeakTraceError(AssertionError):
    pass


class LeakTraceMonitor:
    """Observed acquire/release events + the live-resource ledger."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # unique observed (kind, op, name) triples — the coverage set
        self._events: set[tuple[str, str, str]] = set()
        # (kind, identity-key) -> acquire name — the balance ledger
        self._live: dict[tuple[str, Any], str] = {}
        # (kind, acquire|release) -> events observed
        self._counts: dict[tuple[str, str], int] = {}

    def on_acquire(self, kind: str, name: str, key: Any) -> None:
        with self._mu:
            self._events.add((kind, "acquire", name))
            self._counts[(kind, "acquire")] = self._counts.get((kind, "acquire"), 0) + 1
            # re-acquire on a live key (try_reserve_slot growing an
            # already-allocated slot) keeps the original acquisition
            self._live.setdefault((kind, key), name)

    def on_release(self, kind: str, name: str, key: Any) -> None:
        with self._mu:
            self._events.add((kind, "release", name))
            self._counts[(kind, "release")] = self._counts.get((kind, "release"), 0) + 1
            self._live.pop((kind, key), None)

    def events(self) -> list[dict[str, str]]:
        with self._mu:
            return [
                {"kind": k, "op": op, "name": n}
                for k, op, n in sorted(self._events)
            ]

    def counts(self) -> dict[str, dict[str, int]]:
        """Events observed by kind: ``{kind: {"acquire": n, "release": m}}``
        (every call, where :meth:`events` keeps the distinct sites)."""
        with self._mu:
            out: dict[str, dict[str, int]] = {}
            for (kind, op), n in sorted(self._counts.items()):
                out.setdefault(kind, {"acquire": 0, "release": 0})[op] = n
            return out

    def unreclaimed(self) -> list[str]:
        with self._mu:
            return sorted(
                f"{kind} acquired via {name} (key {key!r}) never released"
                for (kind, key), name in self._live.items()
            )

    def export(self) -> dict:
        return {
            "version": 1,
            "events": self.events(),
            "counts": self.counts(),
            "unreclaimed": self.unreclaimed(),
        }

    def check(self) -> None:
        leaked = self.unreclaimed()
        if leaked:
            raise LeakTraceError(
                "leaktrace: resources acquired but never released "
                f"({len(leaked)}):\n  " + "\n  ".join(leaked)
            )


_active: LeakTraceMonitor | None = None
_originals: list[tuple[Any, str, Any]] = []


def _wrap(cls: Any, method: str, hook: Any) -> None:
    """Patch ``cls.method`` so ``hook(mon, self, result, *args)`` runs
    after the original (only on success — a raising acquire acquired
    nothing)."""
    original = getattr(cls, method)

    def wrapper(self: Any, *args: Any, **kwargs: Any) -> Any:
        result = original(self, *args, **kwargs)
        mon = _active
        if mon is not None:
            hook(mon, self, result, *args, **kwargs)
        return result

    wrapper.__name__ = method
    wrapper.__wrapped__ = original  # type: ignore[attr-defined]
    _originals.append((cls, method, original))
    setattr(cls, method, wrapper)


def install() -> LeakTraceMonitor:
    """Instrument the serving reclaim surfaces; returns the monitor.
    Raises if already installed (a nested install's uninstall would
    strip the outer tier's instrumentation)."""
    global _active
    if _active is not None:
        raise LeakTraceError("leaktrace already installed")
    from gofr_tpu_torch.datasource.tpu.client import TPUClient
    from gofr_tpu_torch.serving import block_alloc, kv_cache, scheduler, timeline

    mon = LeakTraceMonitor()

    for cls, releases in ((scheduler.Scheduler, ("close", "leak")),
                          (TPUClient, ("close",))):
        name = cls.__name__
        _wrap(cls, "__init__", lambda m, self, _r, *a, _n=name, **k:
              m.on_acquire("wrapper", _n, id(self)))
        for rel in releases:
            _wrap(cls, rel, lambda m, self, _r, *a, _n=rel, **k:
                  m.on_release("wrapper", _n, id(self)))

    _wrap(block_alloc.BlockAllocator, "alloc",
          lambda m, self, _r, seq_id, *a, **k:
          m.on_acquire("kv-seq", "alloc", (id(self), seq_id)))
    _wrap(block_alloc.BlockAllocator, "free",
          lambda m, self, _r, seq_id, *a, **k:
          m.on_release("kv-seq", "free", (id(self), seq_id)))

    def _slot_acquire(name: str) -> Any:
        def hook(m: LeakTraceMonitor, self: Any, result: Any,
                 slot: Any = None, *a: Any, **k: Any) -> None:
            if result is False:
                return  # try_reserve_* refused: nothing acquired
            key = slot if slot is not None else k.get("slot")
            if isinstance(key, list):  # try_reserve_chunk takes a list
                for s in key:
                    m.on_acquire("kv-slot", name, (id(self), s))
            else:
                m.on_acquire("kv-slot", name, (id(self), key))
        return hook

    _wrap(kv_cache.PagedKVCache, "alloc_slot", _slot_acquire("alloc_slot"))
    _wrap(kv_cache.PagedKVCache, "try_reserve_slot",
          _slot_acquire("try_reserve_slot"))
    _wrap(kv_cache.PagedKVCache, "try_reserve_chunk",
          _slot_acquire("try_reserve_chunk"))
    _wrap(kv_cache.PagedKVCache, "free_slot",
          lambda m, self, _r, slot, *a, **k:
          m.on_release("kv-slot", "free_slot", (id(self), slot)))

    _wrap(timeline.TimelineRecorder, "begin",
          lambda m, self, result, request_id, *a, **k:
          m.on_acquire("timeline", "begin", (id(self), request_id)))
    _wrap(timeline.TimelineRecorder, "finish",
          lambda m, self, _r, tl, *a, **k:
          m.on_release("timeline", "finish", (id(self), tl.request_id)))

    _active = mon
    return mon


def uninstall() -> LeakTraceMonitor | None:
    """Restore the original methods; already-created instances keep
    working (instance state was never touched)."""
    global _active
    for cls, method, original in reversed(_originals):
        setattr(cls, method, original)
    _originals.clear()
    mon, _active = _active, None
    return mon


def export_to(mon: LeakTraceMonitor, path: str) -> None:
    """Merge-write the monitor's observed pairs into ``path`` (several
    runs append to one export file; the union is
    what the static coverage check consumes)."""
    data = mon.export()
    try:
        with open(path, encoding="utf-8") as fp:
            prior = json.load(fp)
    except (OSError, ValueError):
        prior = {}
    seen = {
        (e.get("kind"), e.get("op"), e.get("name"))
        for e in prior.get("events", ())
    }
    events = list(prior.get("events", ()))
    for e in data["events"]:
        if (e["kind"], e["op"], e["name"]) not in seen:
            events.append(e)
    payload = {
        "version": 1,
        "events": sorted(
            events, key=lambda e: (e["kind"], e["op"], e["name"])
        ),
        "unreclaimed": sorted(
            set(prior.get("unreclaimed", ())) | set(data["unreclaimed"])
        ),
    }
    with open(path, "w", encoding="utf-8") as fp:
        json.dump(payload, fp, indent=2)
        fp.write("\n")
