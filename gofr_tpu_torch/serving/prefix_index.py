"""The distributed prefix index and warm KV page migration (port of
``gofr_tpu/serving/prefix_index.py``).

Without it, every prefix-cache hit stops at the replica boundary: a
prefix cached on one replica is a cold re-prefill on another after a
failover or a load spill. Two halves:

- :class:`PrefixIndex`: who has what. Replicas piggyback a bounded
  ``prefix_keys`` advertisement ([key, tier] pairs from their
  :class:`~gofr_tpu_torch.serving.kv_spill.TieredPrefixCache`, through
  ``ServingEngine.prefix_advertisement``) on the membership heartbeat,
  with the heartbeat's idempotent per-replica ``seq``: redelivered or
  reordered beats never overwrite a newer advertisement. Lookups are
  advisory: a stale entry degrades to a compute miss, never an error.

- :class:`KVMigrator`: go get it. When a replica admits a request whose
  prefix is cached elsewhere, the migrator finds the peer with the
  longest advertised chain of chunk-boundary keys and fetches the slabs:
  from a colocated in-process engine through :func:`local_engine_fetcher`
  (its cache's tensors, by reference: no copy), or as serialized pages
  from a remote one (:func:`encode_entry`/:func:`decode_entry`, the wire
  format of the reference, which carries bf16 as its raw 16-bit words; or
  the port's binary body, :func:`encode_entries_binary`, under
  :data:`KV_WIRE_CONTENT_TYPE`, which carries the same slabs unencoded).
  Fetched entries go through the engine's chunk-prefix commit path
  (``PagedKVCache.write_span`` / ``batch.insert_chunk``) and land in the
  local cache, so a migration is paid once per replica.

The ``kv.migrate`` chaos point sits on every peer fetch, ``kv.handoff`` on
every prefill-to-decode handoff and ``kv.evacuate`` on every bulk push: a
fault there is a source dying mid-transfer, and the engine computes what
was not fetched.

Lock discipline: the index lock is leaf-only (never held across a fetch
or any call out); the migrator is lock-free, its one caller being one
engine's admission thread (peers are registered before serving starts).
"""

from __future__ import annotations

import base64
import inspect
import json
import math
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from gofr_tpu_torch import chaos

__all__ = [
    "PrefixIndex",
    "KVMigrator",
    "local_engine_fetcher",
    "local_engine_store",
    "encode_entry",
    "decode_entry",
    "KV_WIRE_CONTENT_TYPE",
    "encode_entries_binary",
    "decode_entries_binary",
]


# -- slab serialization (the remote page-transfer wire format) -----------------

def encode_entry(value: Any) -> dict[str, Any]:
    """Serialize one prefix-cache entry, a (last_logits, k_slab, v_slab)
    tuple of tensors, to a JSON-safe dict. The caller pays the device to
    host read of each leaf: this runs on a transport's worker thread,
    never the engine thread. A bf16 leaf is written as the reference
    writes it: dtype ``"bfloat16"`` and its raw 16-bit words (numpy has no
    bfloat16)."""
    leaves = []
    for leaf in value:
        t = leaf.detach().to("cpu").contiguous()
        bf16 = t.dtype == torch.bfloat16
        arr = t.view(torch.int16).numpy() if bf16 else t.numpy()
        leaves.append({
            "shape": list(t.shape),
            "dtype": "bfloat16" if bf16 else arr.dtype.name,
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
        })
    return {"leaves": leaves}


def decode_entry(payload: dict[str, Any]) -> tuple:
    """Inverse of :func:`encode_entry`: host tensors (bf16 rebuilt from its
    16-bit words), ready for the engine's ``non_blocking`` upload at the
    commit site."""
    out = []
    for leaf in payload["leaves"]:
        raw = base64.b64decode(leaf["data"])
        if leaf["dtype"] == "bfloat16":
            words = np.frombuffer(raw, dtype=np.uint16).reshape(leaf["shape"])
            out.append(torch.from_numpy(words.copy()).view(torch.bfloat16))
        else:
            arr = np.frombuffer(raw, dtype=np.dtype(leaf["dtype"])).reshape(leaf["shape"])
            out.append(torch.from_numpy(arr.copy()))
    return tuple(out)


# The port's binary body for /kv/fetch: an 8-byte little-endian header
# length, a JSON header naming each leaf's dtype, shape, byte offset and
# byte count (offsets count from the end of the header), then the raw
# slabs back to back. A 1000-token entry at Llama-3-8B widths is 134 MB
# of K/V: base64 JSON makes it 180 MB and a second to encode, too slow
# for the migrator's 2 s fetch timeout. A server answers it only to a
# request whose Accept names this type; any other gets the JSON body.
KV_WIRE_CONTENT_TYPE = "application/x-gofr-kv-slabs"
_WIRE_DTYPES = {
    "float32": (np.float32, None), "float16": (np.float16, None), "int8": (np.int8, None),
    "int32": (np.int32, None), "int64": (np.int64, None), "uint8": (np.uint8, None),
    "bfloat16": (np.uint16, torch.bfloat16),
}


def encode_entries_binary(entries: dict[str, Any]) -> bytes:
    """Serialize {key: (last_logits, k_slab, v_slab)} to the binary body.
    Reads each leaf to the host (the caller's thread pays it); bf16 leaves
    cross as their 16-bit words, as in :func:`encode_entry`."""
    header: dict[str, list] = {}
    slabs: list[np.ndarray] = []
    offset = 0
    for key, value in entries.items():
        leaves = []
        for leaf in value:
            t = leaf.detach().to("cpu").contiguous()
            bf16 = t.dtype == torch.bfloat16
            arr = t.view(torch.uint16).numpy() if bf16 else t.numpy()
            name = "bfloat16" if bf16 else arr.dtype.name
            if name not in _WIRE_DTYPES:
                raise ValueError(f"dtype {name} does not cross the KV wire")
            leaves.append({"dtype": name, "shape": list(t.shape), "offset": offset,
                           "nbytes": arr.nbytes})
            slabs.append(arr)
            offset += arr.nbytes
        header[str(key)] = leaves
    head = json.dumps({"entries": header}).encode("utf-8")
    return b"".join([len(head).to_bytes(8, "little"), head,
                     *(a.reshape(-1).view(np.uint8) for a in slabs)])


def decode_entries_binary(body: bytes) -> dict[str, tuple]:
    """Inverse of :func:`encode_entries_binary`: host tensors, each a copy
    of its slab. A body that does not parse, or whose header names bytes
    the body does not hold, raises ``ValueError`` (the migrator's fetch
    contract turns that into a compute miss)."""
    view = memoryview(body)
    if len(view) < 8:
        raise ValueError("KV wire body shorter than its length prefix")
    n = int.from_bytes(view[:8], "little")
    if n > len(view) - 8:
        raise ValueError("KV wire header runs past the body")
    try:
        header = json.loads(bytes(view[8:8 + n]))["entries"]
    except (UnicodeDecodeError, json.JSONDecodeError, KeyError, TypeError) as exc:
        raise ValueError(f"KV wire header does not parse: {exc}") from exc
    if not isinstance(header, dict):
        raise ValueError("KV wire header holds no entry map")
    data = view[8 + n:]
    out: dict[str, tuple] = {}
    for key, leaves in header.items():
        tensors = []
        for leaf in leaves:
            try:
                np_dtype, torch_dtype = _WIRE_DTYPES[leaf["dtype"]]
                shape = [int(d) for d in leaf["shape"]]
                start, nbytes = int(leaf["offset"]), int(leaf["nbytes"])
            except (KeyError, TypeError, ValueError) as exc:
                raise ValueError(f"KV wire leaf of {key!r} is malformed: {leaf!r}") from exc
            itemsize = np.dtype(np_dtype).itemsize
            if (min(shape, default=0) < 0 or start < 0
                    or nbytes != math.prod(shape) * itemsize or start + nbytes > len(data)):
                raise ValueError(f"KV wire leaf of {key!r} does not fit the body: {leaf!r}")
            arr = np.frombuffer(data[start:start + nbytes], dtype=np_dtype).reshape(shape)
            t = torch.from_numpy(arr.copy())
            tensors.append(t.view(torch_dtype) if torch_dtype is not None else t)
        out[str(key)] = tuple(tensors)
    return out


# -- the cluster-wide index ----------------------------------------------------

class PrefixIndex:
    """digest → (replica, tier) advertisements, replica-versioned.

    ``observe`` REPLACES a replica's advertised set (each beat carries
    the replica's current bounded view, not a delta) and drops stale
    ``seq``s — the same idempotency discipline MembershipTable.observe
    applies to the beats these advertisements ride on."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # replica_id -> (seq, {key: tier})
        self._by_replica: dict[str, tuple[int, dict[str, str]]] = {}

    def observe(self, replica_id: str, seq: int,
                entries: list[Any] | None) -> bool:
        """Ingest one replica's advertisement. Returns False for
        stale/duplicate seqs (pubsub redelivery or reorder)."""
        if entries is None:
            return False
        keyed: dict[str, str] = {}
        for item in entries:
            try:
                key, tier = item[0], item[1]
            except (TypeError, IndexError, KeyError):
                continue  # malformed advertisement rows are dropped
            keyed[str(key)] = str(tier)
        with self._mu:
            prev = self._by_replica.get(replica_id)
            if prev is not None and seq <= prev[0]:
                return False
            self._by_replica[replica_id] = (int(seq), keyed)
            return True

    def drop_replica(self, replica_id: str) -> None:
        with self._mu:
            self._by_replica.pop(replica_id, None)

    def locate(self, key: str,
               exclude: str | None = None) -> list[tuple[str, str]]:
        """Replicas advertising ``key``, as (replica_id, tier) pairs —
        device tier first (a device-resident slab serves the transfer
        without its owner touching host RAM)."""
        out: list[tuple[str, str]] = []
        with self._mu:
            for rid, (_seq, entries) in self._by_replica.items():
                if rid == exclude:
                    continue
                tier = entries.get(key)
                if tier is not None:
                    out.append((rid, tier))
        out.sort(key=lambda rt: (rt[1] != "device", rt[0]))
        return out

    def longest_chain(self, keys: list[str],
                      exclude: str | None = None) -> tuple[str | None, int]:
        """The replica advertising the longest CONTIGUOUS leading run of
        ``keys`` (the chunk-boundary chain of one prompt) — the router's
        and the migrator's shared question: where does the warmest copy
        of this prefix live?"""
        best: tuple[str | None, int] = (None, 0)
        with self._mu:
            for rid, (_seq, entries) in self._by_replica.items():
                if rid == exclude:
                    continue
                n = 0
                for key in keys:
                    if key not in entries:
                        break
                    n += 1
                if n > best[1]:
                    best = (rid, n)
        return best

    def snapshot(self) -> dict[str, Any]:
        with self._mu:
            return {
                rid: {"seq": seq, "advertised": len(entries)}
                for rid, (seq, entries) in self._by_replica.items()
            }


# -- warm page migration -------------------------------------------------------

def local_engine_fetcher(engine: Any) -> Callable[[list[str]], dict[str, tuple]]:
    """Peer fetcher for a COLOCATED in-process replica: reads the
    owning engine's prefix cache directly — the slabs are already
    device arrays, so the 'transfer' is a reference (device-to-device
    by construction, zero copies). A tensor-parallel engine's entries
    come whole, gathered from its ranks (``ServingEngine.export_kv``)."""

    def fetch(keys: list[str]) -> dict[str, tuple]:
        if getattr(engine, "_mesh", None) is not None:
            return engine.export_kv(keys)
        cache = getattr(engine, "_prefix_cache", None)
        if cache is None:
            return {}
        # peek, never get: a peer read must not mutate the owner's LRU
        # order, promote host-tier entries into its device budget, or
        # destructively pop its only host copy (TieredPrefixCache.peek)
        read = getattr(cache, "peek", None) or cache.get
        out: dict[str, tuple] = {}
        for key in keys:
            value = read(key)
            if value is not None:
                out[key] = value
        return out

    return fetch


def local_engine_store(engine: Any) -> Callable[[list[tuple]], int]:
    """Survivor-side commit for an in-process bulk evacuation
    (:meth:`KVMigrator.evacuate_chain`): stages every pushed entry,
    audits the batch, then commits it into the target engine's prefix
    cache whole — or not at all (a mid-commit failure evicts what this
    batch already wrote, so a torn push can never leave a partial set
    masquerading as a complete one). REFUSES (raises) when the target is
    itself reclaiming/draining/stopped: a notice storm must never
    evacuate KV onto capacity that is about to need evacuating. A
    tensor-parallel target commits each entry on every rank, each its
    own KV heads, with the same all-or-nothing rule
    (``ServingEngine.import_kv``)."""

    def store(entries: list[tuple]) -> int:
        cache = getattr(engine, "_prefix_cache", None)
        if cache is None:
            raise RuntimeError("evacuation target has no prefix cache")
        if (getattr(engine, "_reclaiming", False)
                or getattr(engine, "draining", False)
                or not getattr(engine, "_running", True)):
            raise RuntimeError(
                "evacuation target is reclaiming/draining/stopped"
            )
        # phase one: audit the whole batch before any commit — one
        # malformed entry rejects the push entire
        staged: list[tuple[Any, tuple]] = []
        for item in entries:
            try:
                key, value = item
            except (TypeError, ValueError) as exc:
                raise ValueError(f"malformed evacuation entry: {exc}")
            if value is None or len(value) != 3:
                raise ValueError("malformed evacuation entry value")
            staged.append((key, value))
        # phase two: commit; a failure mid-batch discards the whole
        # batch (survivors degrade to re-prefill, never trust a torn set)
        if getattr(engine, "_mesh", None) is not None:
            return engine.import_kv(staged)
        committed: list[Any] = []
        try:
            for key, value in staged:
                cache.put(key, value)
                committed.append(key)
        except Exception:
            for key in committed:
                try:
                    cache.evict(key)
                except Exception:
                    pass
            raise
        return len(committed)

    return store


class KVMigrator:
    """The admitting replica's pull side of warm KV migration.

    ``peers`` maps replica_id → ``fetch(keys) -> {key: (logits, k, v)}``
    (device arrays from a local peer, host numpy from a remote one —
    the engine's commit path uploads either asynchronously). Every
    failure mode — peer gone, stale advertisement, chaos fault, torn
    transfer — degrades to a compute miss: the migrator returns the
    contiguous prefix it DID fetch and the engine prefills the rest.

    A FAILED fetch suppresses that peer for ``failure_backoff_s``: a
    dead replica's advertisements can outlive it (mark-down keeps no
    fresh beats coming, but nothing retracts the old ones), and without
    negative caching every cache-miss admission would block the engine
    thread up to the transport timeout, per request, forever. The
    single-caller discipline (one engine's admission thread) keeps the
    migrator lock-free.
    """

    def __init__(self, replica_id: str, index: PrefixIndex, *,
                 logger: Any = None, metrics: Any = None,
                 failure_backoff_s: float = 5.0,
                 fetch_timeout_s: float = 2.0) -> None:
        self.replica_id = replica_id
        self.index = index
        self._logger = logger
        self._metrics = metrics
        self.failure_backoff_s = failure_backoff_s
        self.fetch_timeout_s = fetch_timeout_s
        self._peers: dict[str, Callable[[list[str]], dict[str, tuple]]] = {}
        self._peer_bounded: dict[str, bool] = {}
        self._suppressed_until: dict[str, float] = {}
        # push side (reclamation evacuation): replica_id -> store(entries)
        self._push_peers: dict[str, Callable[[list[tuple]], int]] = {}
        self._push_bounded: dict[str, bool] = {}
        self.migrations_total = 0
        self.handoffs_total = 0
        self.failed_fetches_total = 0
        self.evacuations_total = 0
        self.failed_evacuations_total = 0

    def add_peer(self, replica_id: str,
                 fetch: Callable[[list[str]], dict[str, tuple]]) -> None:
        self._peers[replica_id] = fetch
        # a remote transport fetcher (an HTTP replica's fetch_kv) takes a
        # timeout kwarg; a local peek-based one doesn't block at all.
        # Detected once here so fetch_chain can clamp the wire wait to
        # the request's remaining deadline without changing the plain
        # fetch(keys) peer contract.
        try:
            self._peer_bounded[replica_id] = (
                "timeout" in inspect.signature(fetch).parameters
            )
        except (TypeError, ValueError):
            self._peer_bounded[replica_id] = False

    def remove_peer(self, replica_id: str) -> None:
        self._peers.pop(replica_id, None)
        self._peer_bounded.pop(replica_id, None)

    def add_push_peer(self, replica_id: str,
                      store: Callable[[list[tuple]], int]) -> None:
        """Register a survivor the bulk evacuation may push to:
        ``store(entries) -> committed count`` with all-or-nothing commit
        semantics (:func:`local_engine_store` in-process; a remote store
        takes a ``timeout`` kwarg, detected like :meth:`add_peer`)."""
        self._push_peers[replica_id] = store
        try:
            self._push_bounded[replica_id] = (
                "timeout" in inspect.signature(store).parameters
            )
        except (TypeError, ValueError):
            self._push_bounded[replica_id] = False

    def remove_push_peer(self, replica_id: str) -> None:
        self._push_peers.pop(replica_id, None)
        self._push_bounded.pop(replica_id, None)

    def _peer_kwargs(self, replica_id: str,
                     deadline: float | None) -> dict[str, float]:
        if not self._peer_bounded.get(replica_id):
            return {}
        if deadline is None:
            return {"timeout": self.fetch_timeout_s}
        return {"timeout": min(self.fetch_timeout_s, deadline)}

    def fetch_chain(
        self, boundaries: list[tuple[int, int, str]],
        deadline: float | None = None,
    ) -> list[tuple[int, int, tuple]]:
        """Fetch the longest advertised contiguous run of chunk-boundary
        entries for ``boundaries`` ([(start, end, key), ...], the
        engine's remaining un-cached chain). Returns [(start, end,
        value), ...], contiguous from the first boundary — possibly
        empty, never raising. ``deadline`` is the request's remaining
        budget in seconds: an already-expired request degrades to a
        compute miss without touching the wire, and a bounded peer's
        transport timeout is clamped to it."""
        if deadline is not None and deadline <= 0:
            return []  # expired: never block admission on a dead request
        if not boundaries or not self._peers:
            return []
        keys = [key for _s, _e, key in boundaries]
        rid, n = self.index.longest_chain(keys, exclude=self.replica_id)
        if rid is None or n == 0:
            return []
        fetch = self._peers.get(rid)
        if fetch is None:
            return []  # advertised by a replica we hold no transport to
        until = self._suppressed_until.get(rid)
        if until is not None and time.monotonic() < until:
            return []  # peer recently failed a fetch: don't stall
            # admission behind its transport timeout again yet
        want = boundaries[:n]
        try:
            chaos.maybe_fail("kv.migrate")
            fetched = fetch(
                [key for _s, _e, key in want],
                **self._peer_kwargs(rid, deadline),
            )
        except Exception as exc:
            # the source died mid-transfer (or the chaos point fired):
            # nothing was committed — a clean degrade to re-prefill,
            # and the peer goes quiet for failure_backoff_s
            self.failed_fetches_total += 1
            self._suppressed_until[rid] = (
                time.monotonic() + self.failure_backoff_s
            )
            if self._logger is not None:
                self._logger.warn(
                    f"KV migration fetch from {rid} failed; "
                    f"re-prefilling: {exc}"
                )
            return []
        self._suppressed_until.pop(rid, None)
        out: list[tuple[int, int, tuple]] = []
        for start, end, key in want:
            value = fetched.get(key)
            if value is None:
                break  # stale advertisement: keep the contiguous prefix
            out.append((start, end, value))
        if out:
            self.migrations_total += 1
            if self._metrics is not None:
                self._metrics.increment_counter("app_kv_migrations_total")
        return out

    def fetch_one(self, key: str,
                  deadline: float | None = None) -> tuple | None:
        """Single-entry fetch (the whole-prompt/monolithic prefill
        path). Same advisory contract as :meth:`fetch_chain`."""
        got = self.fetch_chain([(0, 0, key)], deadline=deadline)
        return got[0][2] if got else None

    # -- disaggregated prefill→decode handoff ----------------------------------
    def fetch_handoff(
        self, boundaries: list[tuple[int, int, str]], source: str,
        deadline: float | None = None,
    ) -> list[tuple[int, int, tuple]]:
        """The prefill→decode KV handoff fetch (the disaggregation
        plane): pull ``boundaries`` from the NAMED
        prefill replica under a two-phase-commit discipline — phase one
        fetches every span into host staging, phase two hands the chain
        to the engine's commit path ONLY when it is complete and
        contiguity-audited (every boundary present, spans abutting,
        covering the request exactly). Anything less returns ``[]`` and
        the decode replica re-prefills: a torn handoff must degrade, not
        commit a partial chain the admission believed complete.

        The ``kv.handoff`` chaos point models the source dying (or the
        transport tearing) mid-handoff; a failed source is suppressed
        for ``failure_backoff_s`` exactly like the advisory tier.
        ``deadline`` follows the :meth:`fetch_chain` contract: expired →
        degrade without touching the wire, bounded peer → clamped
        transport timeout."""
        if deadline is not None and deadline <= 0:
            return []
        if not boundaries:
            return []
        fetch = self._peers.get(source)
        if fetch is None:
            return []  # no transport to the named source: re-prefill
        until = self._suppressed_until.get(source)
        if until is not None and time.monotonic() < until:
            return []
        try:
            chaos.maybe_fail("kv.handoff")
            fetched = fetch(
                [key for _s, _e, key in boundaries],
                **self._peer_kwargs(source, deadline),
            )
        except Exception as exc:
            self.failed_fetches_total += 1
            self._suppressed_until[source] = (
                time.monotonic() + self.failure_backoff_s
            )
            if self._logger is not None:
                self._logger.warn(
                    f"KV handoff fetch from {source} failed; "
                    f"re-prefilling: {exc}"
                )
            return []
        self._suppressed_until.pop(source, None)
        out: list[tuple[int, int, tuple]] = []
        pos = boundaries[0][0]
        for start, end, key in boundaries:
            value = fetched.get(key)
            # the audit: every span present, well-formed, and abutting
            # the previous one — the prefill side evicting a chunk
            # mid-handoff (or a codec tearing a leaf) fails the WHOLE
            # chain, never admits a gap
            if (value is None or len(value) != 3 or start != pos
                    or end <= start):
                self.failed_fetches_total += 1
                return []
            out.append((start, end, value))
            pos = end
        self.handoffs_total += 1
        if self._metrics is not None:
            self._metrics.increment_counter("app_kv_handoffs_total")
        return out

    def fetch_one_handoff(self, key: str, source: str,
                          deadline: float | None = None) -> tuple | None:
        """Monolithic-prompt handoff: the single whole-prompt prefill
        entry from the named source — present and well-formed, or None
        (re-prefill). Same 2PC/backoff contract as :meth:`fetch_handoff`."""
        got = self.fetch_handoff([(0, 1, key)], source, deadline=deadline)
        return got[0][2] if got else None

    # -- reclamation-notice bulk evacuation (push side) -------------------------
    def evacuate_chain(
        self, entries: list[tuple], deadline: float | None = None,
    ) -> tuple[str, int] | None:
        """Push this replica's committed KV entries to ONE surviving
        peer under a reclamation notice (the reclamation plane). ``entries`` is ``[(key, (logits, k, v)),
        ...]`` straight off the local prefix cache; ``deadline`` is the
        notice's REMAINING budget in seconds and threads into every wire
        call — a spent budget degrades to re-prefill on the survivors
        without touching the wire, and a bounded (remote) store's
        transport timeout is clamped to it.

        Two-phase like the handoff fetch: the store commits the batch
        whole or raises (:func:`local_engine_store`), so a source dying
        mid-push — the ``kv.evacuate`` chaos point — leaves the survivor
        clean, never holding a partial set it believes complete. A
        refusing/failed survivor is suppressed for ``failure_backoff_s``
        and the next one is tried; returns ``(replica_id, committed)``
        on success, None when no survivor accepted (degrade: survivors
        re-prefill)."""
        if not entries or not self._push_peers:
            return None
        t0 = time.monotonic()
        for rid in sorted(self._push_peers):
            remaining = (
                None if deadline is None
                else deadline - (time.monotonic() - t0)
            )
            if remaining is not None and remaining <= 0:
                return None  # budget spent: never start a push that
                # cannot finish — a torn commit helps nobody
            until = self._suppressed_until.get(rid)
            if until is not None and time.monotonic() < until:
                continue
            store = self._push_peers[rid]
            kwargs: dict[str, float] = {}
            if self._push_bounded.get(rid):
                kwargs["timeout"] = (
                    self.fetch_timeout_s if remaining is None
                    else min(self.fetch_timeout_s, remaining)
                )
            try:
                chaos.maybe_fail("kv.evacuate")
                n = store(entries, **kwargs)
            except Exception as exc:
                # the push tore (source dying, survivor refusing, chaos
                # fault): the store's all-or-nothing contract means the
                # survivor holds nothing from this batch — try the next
                self.failed_evacuations_total += 1
                self._suppressed_until[rid] = (
                    time.monotonic() + self.failure_backoff_s
                )
                if self._logger is not None:
                    self._logger.warn(
                        f"KV evacuation push to {rid} failed; "
                        f"trying next survivor: {exc}"
                    )
                continue
            self._suppressed_until.pop(rid, None)
            self.evacuations_total += 1
            if self._metrics is not None:
                self._metrics.increment_counter("app_kv_migrations_total")
            return (rid, int(n))
        return None
