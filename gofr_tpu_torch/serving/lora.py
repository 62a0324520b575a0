"""LoRA adapter multiplexing: adapter weights in a device table for
multi-tenant decode (port of ``gofr_tpu/serving/lora.py``).

One base model, many tenants: each request may name a LoRA adapter and the
engine serves rows with DIFFERENT adapters in the same decode block. The
device functions in ``serving/batch.py`` gather each row's adapter slot out
of a fixed device table and apply the low-rank delta inside the dispatch,
so a heterogeneous-adapter batch costs no extra dispatch and no extra host
sync.

Storage is tiered like the KV plane:

- **host pool**: every registered :class:`LoraAdapter` lives as host numpy
  arrays in the :class:`AdapterRegistry`;
- **device table**: a fixed ``[max_active, ...]`` pair of stacked factors
  (``a_table [n, D, r]``, ``b_table [n, r, V]``, f32) on the registry's
  device; slot 0 is the base model (all-zero delta) and never evicts.
  Active adapters are pinned by the rows decoding with them; unpinned
  slots recycle LRU.

Uploads run on a single-worker ``lora-upload`` executor: ``prefetch`` at
submit time schedules the host-to-device copy off the engine thread, and
the admission-time :meth:`acquire` normally finds the adapter resident. An
upload fault is transient: acquire raises :class:`AdapterBusy` and the
engine requeues the request like KV-pool pressure.

Delta math: the adapter is a low-rank token-to-logits bypass. For a row
about to sample from logits produced by forwarding input token ``t``, the
delta is ``emb[t] @ A_i @ B_i`` with ``A_i [D, r]``, ``B_i [r, V]``. It
applies identically at every sampling site (prefill first token, each
block step, ragged fold), so a heterogeneous batch is token-identical to
sequential per-adapter runs.

Table swaps: the reference never mutates a table a dispatch holds; an
upload builds a new array and swaps the reference under the mutex. Here an
in-place write would race a pipelined block still reading a recycled slot,
so an upload copies the table (copy-on-write), writes the slot in the
copy, waits on the worker thread until the copy is on the card, and only
then swaps the reference. Blocks already dispatched keep the old table.

The upload carries the ``lora.upload`` chaos point. With ``metrics=`` (a
Manager with the serving catalog) each completed upload sets the
reference's ``app_lora_adapter_residency``. Left out against the
reference: ``from_config`` (the ``TPU_LORA_MAX_ACTIVE`` knob; the caller
passes ``max_active``).

Lock discipline: the registry mutex is LEAF-ONLY (never held across a
device op or a call out); table swaps are reference assignments under it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import logging
import threading
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch import chaos
from gofr_tpu_torch._device import resolve_device, to_device

__all__ = [
    "LoraAdapter", "AdapterRegistry", "AdapterBusy", "UnknownAdapter",
    "make_adapter",
]

log = logging.getLogger(__name__)


class UnknownAdapter(KeyError):
    """The request named an adapter the registry has never seen: a CLIENT
    error (400 at the transports), never a retriable condition."""


class AdapterBusy(RuntimeError):
    """Transient: no device table slot can be recycled right now (every
    slot is pinned by an active row) or the async upload faulted; the
    engine requeues the request like KV-pool pressure."""

    retriable = True


@dataclasses.dataclass
class LoraAdapter:
    """One registered adapter: host-resident low-rank factors.

    ``a`` is ``[d_model, rank]``, ``b`` is ``[rank, vocab]``: the
    token-to-logits bypass factors (see the module docstring)."""

    adapter_id: str
    a: np.ndarray
    b: np.ndarray

    @property
    def rank(self) -> int:
        return int(self.a.shape[1])


def make_adapter(cfg: Any, adapter_id: str, *, rank: int = 4,
                 seed: int = 0, scale: float = 1.0) -> LoraAdapter:
    """Random-init adapter for tests and benches: factors sized to the
    model config, scaled so the delta shifts the argmax without drowning
    the base logits. The same numpy draw as the reference's, so both
    packages build equal factors from one seed."""
    rng = np.random.default_rng(seed)
    d, v = int(cfg.d_model), int(cfg.vocab_size)
    a = rng.standard_normal((d, rank)).astype(np.float32) / np.sqrt(d)
    b = rng.standard_normal((rank, v)).astype(np.float32) * (scale / np.sqrt(rank))
    return LoraAdapter(adapter_id, a, b)


class AdapterRegistry:
    """Host pool of registered adapters + the fixed device table of the
    active ones. Engine-facing surface:

    - ``prefetch(adapter_id)``: submit time, schedule the async upload
      (off the engine thread) so admission finds the adapter resident;
    - ``acquire(adapter_id) -> int``: admission time (engine thread), pin
      and return the adapter's device slot; raises :class:`AdapterBusy`
      (transient: requeue) or :class:`UnknownAdapter` (client error);
    - ``release(idx)``: retire time, unpin;
    - ``tables() -> (a_table, b_table)``: the current device tables for a
      dispatch. An upload never writes a table a dispatch may hold (see
      the module docstring), so an in-flight block keeps reading the
      table it was dispatched with.

    The tables live on ``device``: the card unless ``device="cpu"``.
    """

    def __init__(self, *, max_active: int = 8, device: str | torch.device | None = None,
                 metrics: Any = None) -> None:
        if max_active < 2:
            raise ValueError("TPU_LORA_MAX_ACTIVE must be >= 2 (slot 0 is base)")
        self.max_active = int(max_active)
        self.device = resolve_device(device)
        self._metrics = metrics
        self._mu = threading.Lock()
        self._adapters: dict[str, LoraAdapter] = {}
        # device residency: adapter_id -> slot, slot -> adapter_id
        self._slot_of: dict[str, int] = {}
        self._id_of: dict[int, str] = {}
        self._pins: dict[int, int] = {}
        self._lru: list[int] = []  # unpinned resident slots, oldest first
        self._uploads: dict[str, concurrent.futures.Future] = {}
        # adapter_id -> slot claimed by a queued upload, so two prefetches
        # can never claim the same slot
        self._upload_slot: dict[str, int] = {}
        self._a_table: torch.Tensor | None = None  # [max_active, D, r_max] f32
        self._b_table: torch.Tensor | None = None  # [max_active, r_max, V] f32
        self._rank_max = 0
        self._exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lora-upload"
        )
        self.upload_faults_total = 0

    # -- host pool -------------------------------------------------------------
    def register(self, adapter: LoraAdapter) -> None:
        """File an adapter in the host pool (host numpy only, no device
        work until a request names it). Re-registering an id replaces the
        weights; its device copy, if any, is dropped so the next acquire
        uploads the new factors."""
        a = np.asarray(adapter.a, np.float32)
        b = np.asarray(adapter.b, np.float32)
        if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
            raise ValueError(
                f"adapter {adapter.adapter_id!r}: a must be [D, r] and "
                f"b [r, V] with matching rank (got {a.shape} / {b.shape})"
            )
        with self._mu:
            # model-dimension mismatches are PERMANENT: reject them here;
            # found at upload time they would look like a transient
            # AdapterBusy and requeue the request forever
            ref = (
                (self._a_table.shape[1], self._b_table.shape[2])
                if self._a_table is not None else next(
                    ((p.a.shape[0], p.b.shape[1])
                     for p in self._adapters.values()), None,
                )
            )
            if ref is not None and (a.shape[0], b.shape[1]) != tuple(ref):
                raise ValueError(
                    f"adapter {adapter.adapter_id!r}: dims "
                    f"(D={a.shape[0]}, V={b.shape[1]}) do not match the "
                    f"registry's model (D={ref[0]}, V={ref[1]})"
                )
            self._adapters[adapter.adapter_id] = LoraAdapter(adapter.adapter_id, a, b)
            self._drop_resident_locked(adapter.adapter_id)

    def deregister(self, adapter_id: str) -> None:
        with self._mu:
            self._adapters.pop(adapter_id, None)
            self._drop_resident_locked(adapter_id)

    def _drop_resident_locked(self, adapter_id: str) -> None:
        slot = self._slot_of.pop(adapter_id, None)
        if slot is not None:
            self._id_of.pop(slot, None)
            if slot in self._lru:
                self._lru.remove(slot)
        self._uploads.pop(adapter_id, None)

    def known(self, adapter_id: str) -> bool:
        with self._mu:
            return adapter_id in self._adapters

    def ids(self) -> list[str]:
        with self._mu:
            return list(self._adapters)

    # -- device table ----------------------------------------------------------
    def _ensure_tables_locked(self, adapter: LoraAdapter) -> None:
        """Allocate (or grow, on a larger-rank registration) the device
        tables. Growing pads into NEW tensors: a table a dispatch holds is
        never written."""
        d, r = adapter.a.shape
        v = adapter.b.shape[1]
        if self._a_table is None:
            self._rank_max = r
            self._a_table = torch.zeros((self.max_active, d, r), dtype=torch.float32,
                                        device=self.device)
            self._b_table = torch.zeros((self.max_active, r, v), dtype=torch.float32,
                                        device=self.device)
        elif r > self._rank_max:
            pad_r = r - self._rank_max
            self._a_table = torch.nn.functional.pad(self._a_table, (0, pad_r))
            self._b_table = torch.nn.functional.pad(self._b_table, (0, 0, 0, pad_r))
            self._rank_max = r

    def _upload(self, adapter_id: str, slot: int) -> None:
        """The lora-upload worker: materialize one adapter into its table
        slot, off the engine thread. A fault here surfaces at acquire as
        :class:`AdapterBusy` and the request requeues; it never decodes
        with a half-written delta (the ``lora.upload`` chaos point makes
        that fault at will)."""
        chaos.maybe_fail("lora.upload")
        with self._mu:
            adapter = self._adapters.get(adapter_id)
            if adapter is None:  # deregistered while queued
                raise UnknownAdapter(adapter_id)
            self._ensure_tables_locked(adapter)
            a_tab, b_tab, r_max = self._a_table, self._b_table, self._rank_max
        r = adapter.rank
        a = np.zeros(tuple(a_tab.shape[1:]), np.float32)
        a[:, :r] = adapter.a
        b = np.zeros(tuple(b_tab.shape[1:]), np.float32)
        b[:r, :] = adapter.b
        # copy-on-write: the OLD tables stay untouched for any in-flight
        # dispatch; the swap below is a reference assignment under the mutex
        new_a = a_tab.clone()
        new_b = b_tab.clone()
        new_a[slot] = to_device(a, self.device)
        new_b[slot] = to_device(b, self.device)
        if self.device.type == "cuda":
            # the copies are queued on the stream; wait for them HERE, on
            # the worker, so a dispatch that reads the swapped-in table
            # never sees a slot that is still being written
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        with self._mu:
            # a concurrent larger-rank registration may have grown the
            # tables while this upload ran: losing that race retries
            if self._a_table is a_tab and self._rank_max == r_max:
                self._a_table, self._b_table = new_a, new_b
                self._id_of[slot] = adapter_id
                self._slot_of[adapter_id] = slot
                if self._pins.get(slot, 0) == 0 and slot not in self._lru:
                    # resident but unpinned from birth (a prefetch whose
                    # request was shed or canceled before admission): the
                    # slot must be LRU-recyclable or it would leak
                    self._lru.append(slot)
                resident = len(self._slot_of)
            else:
                raise AdapterBusy(f"adapter {adapter_id}: table grew mid-upload")
        if self._metrics is not None:
            self._metrics.set_gauge("app_lora_adapter_residency", float(resident))

    def _claim_slot_locked(self, adapter_id: str) -> int:
        """Pick the device slot this adapter will occupy: a never-used slot
        first, else the LRU unpinned resident (its adapter demotes to
        host-only). Raises AdapterBusy when every slot is pinned."""
        used = set(self._id_of) | set(self._upload_slot.values())
        for slot in range(1, self.max_active):
            if slot not in used:
                return slot
        while self._lru:
            slot = self._lru.pop(0)
            if self._pins.get(slot, 0) == 0 and slot in self._id_of:
                evicted = self._id_of.pop(slot)
                self._slot_of.pop(evicted, None)
                return slot
        raise AdapterBusy(
            f"adapter {adapter_id}: all {self.max_active - 1} device slots "
            "pinned by active rows"
        )

    def prefetch(self, adapter_id: str) -> None:
        """Submit-time hint (caller thread, never the engine thread): start
        the async upload so admission finds the adapter resident. Unknown
        ids raise so the transport can 400 before queueing."""
        with self._mu:
            if adapter_id not in self._adapters:
                raise UnknownAdapter(adapter_id)
            if adapter_id in self._slot_of or adapter_id in self._uploads:
                return
            try:
                slot = self._claim_slot_locked(adapter_id)
            except AdapterBusy:
                return  # admission-time acquire retries with pins drained
            self._upload_slot[adapter_id] = slot
            fut = self._exec.submit(self._upload, adapter_id, slot)
            self._uploads[adapter_id] = fut
        # outside the mutex: an upload that already ended runs the callback
        # inline, and the callback takes the mutex
        fut.add_done_callback(lambda f, aid=adapter_id: self._upload_done(aid, f))

    def _upload_done(self, adapter_id: str, fut: Any) -> None:
        with self._mu:
            self._uploads.pop(adapter_id, None)
            self._upload_slot.pop(adapter_id, None)
        exc = fut.exception()
        if exc is not None:
            self.upload_faults_total += 1
            log.warning("lora adapter %s upload failed: %s", adapter_id, exc)

    def acquire(self, adapter_id: str | None, timeout: float = 5.0) -> int:
        """Admission-time pin (engine thread): the adapter's device slot
        (0 for no adapter). Waits BOUNDED for an in-flight upload; a missed
        or faulted upload re-schedules once and raises
        :class:`AdapterBusy` (transient: the engine requeues the request)
        if the adapter still is not resident."""
        if not adapter_id:
            return 0
        with self._mu:
            if adapter_id not in self._adapters:
                raise UnknownAdapter(adapter_id)
            slot = self._slot_of.get(adapter_id)
            if slot is not None:
                self._pin_locked(slot)
                return slot
            fut = self._uploads.get(adapter_id)
        if fut is None:
            self.prefetch(adapter_id)
            with self._mu:
                # the upload may have finished (and its done callback
                # dropped the future) before this re-read
                slot = self._slot_of.get(adapter_id)
                if slot is not None:
                    self._pin_locked(slot)
                    return slot
                fut = self._uploads.get(adapter_id)
            if fut is None:
                # prefetch could not claim a slot (all pinned): transient
                raise AdapterBusy(adapter_id)
        try:
            fut.result(timeout=timeout)
        except (AdapterBusy, UnknownAdapter):
            raise
        except Exception as exc:  # an upload that failed or timed out
            raise AdapterBusy(f"adapter {adapter_id} upload failed") from exc
        with self._mu:
            slot = self._slot_of.get(adapter_id)
            if slot is None:
                raise AdapterBusy(adapter_id)
            self._pin_locked(slot)
            return slot

    def _pin_locked(self, slot: int) -> None:
        self._pins[slot] = self._pins.get(slot, 0) + 1
        if slot in self._lru:
            self._lru.remove(slot)

    def release(self, slot: int) -> None:
        """Unpin one row's claim on a device slot; a slot whose pins drain
        to zero becomes LRU-recyclable (weights stay resident until a new
        adapter needs the slot, so a follow-up request hits warm)."""
        if slot <= 0:
            return
        with self._mu:
            n = self._pins.get(slot, 0) - 1
            if n <= 0:
                self._pins.pop(slot, None)
                if slot in self._id_of and slot not in self._lru:
                    self._lru.append(slot)
            else:
                self._pins[slot] = n

    def tables(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """Current device tables for a dispatch, or None when no adapter
        has ever been uploaded: the None path keeps a base-only engine on
        exactly the code it ran before LoRA."""
        with self._mu:
            if self._a_table is None:
                return None
            return self._a_table, self._b_table

    def slot_factors(self, slot: int) -> tuple[torch.Tensor, torch.Tensor] | None:
        """One slot's (a, b) factor pair out of the device tables, for the
        host-path first-token sampling's single-row delta."""
        tabs = self.tables()
        if tabs is None or slot <= 0:
            return None
        return tabs[0][slot], tabs[1][slot]

    def residency(self) -> dict[str, Any]:
        with self._mu:
            return {
                "registered": len(self._adapters),
                "resident": len(self._slot_of),
                "max_active": self.max_active - 1,
                "pinned_slots": sum(1 for n in self._pins.values() if n > 0),
                "uploads_in_flight": len(self._uploads),
                "upload_faults_total": self.upload_faults_total,
            }

    def flush(self, timeout: float = 5.0) -> None:
        """Settle queued uploads (tests, drain)."""
        with self._mu:
            futs = list(self._uploads.values())
        for fut in futs:
            try:
                fut.result(timeout=timeout)
            except Exception:
                pass

    def close(self) -> None:
        self._exec.shutdown(wait=False)
