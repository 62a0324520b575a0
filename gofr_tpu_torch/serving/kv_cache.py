"""Paged KV cache (port of ``gofr_tpu/serving/kv_cache.py``, bf16 and int8
pools).

A shared page pool ``[L, N_pages+1, Hkv, page, Dh]`` per k/v; the extra
LAST page is the trash page that inactive rows' decode writes are sent to.
With ``kv_dtype="int8"`` the pools hold int8 values and two more pools
``[L, N_pages+1, Hkv, page, 1]`` hold their f32 per-vector absmax scales
(``llama.quantize_kv``): half the bytes per resident token. Sequences own
pages through :class:`~gofr_tpu_torch.serving.block_alloc.BlockAllocator`,
so device memory is committed by resident tokens, not by worst-case slots.

Host side (this class): page accounting, block tables and lengths, whose
numpy mirrors are authoritative. Device side: the prefill scatter
(:func:`_write_pages`, :func:`_write_pages_q`) and, for the chunk-prefix
cache on bf16 pools, the span scatter and gather (``write_span``,
``read_span``); the decode and chunk
appends live in ``llama.decode_step_paged*``/``llama.decode_chunk_paged*``
and the read in ``ops/paged_attention.py``. The pools are updated in place
where the JAX package donates them.

On a mesh (``mesh=``, the tensor-parallel engine) the pools hold this
rank's KV heads (``parallel.sharding.kv_head_slice``) and the page
accounting stays whole: every rank of the group writes and reads the same
pages of its own pools.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch import chaos
from gofr_tpu_torch._device import to_device
from gofr_tpu_torch.models.llama import kv_heads, quantize_kv
from gofr_tpu_torch.serving.block_alloc import BlockAllocator, OutOfBlocks

__all__ = ["PagedKVCache", "OutOfBlocks"]


def _write_pages(
    k_pool: torch.Tensor,  # [L, N, Hkv, page, Dh], written in place
    v_pool: torch.Tensor,
    k_slab: torch.Tensor,  # [L, S_pad, Hkv, Dh] (S_pad = n_pages*page)
    v_slab: torch.Tensor,
    page_ids: torch.Tensor,  # [n_pages] int64, distinct
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a page-aligned slab into the pool pages ``page_ids``."""
    L, S_pad, Hkv, Dh = k_slab.shape
    n_pages = page_ids.shape[0]
    page = S_pad // n_pages
    # [L, n_pages, Hkv, page, Dh]: the pool's layout
    k_pages = k_slab.reshape(L, n_pages, page, Hkv, Dh).transpose(2, 3)
    v_pages = v_slab.reshape(L, n_pages, page, Hkv, Dh).transpose(2, 3)
    k_pool[:, page_ids] = k_pages
    v_pool[:, page_ids] = v_pages
    return k_pool, v_pool


def _write_pages_q(
    k_pool: torch.Tensor,  # [L, N, Hkv, page, Dh] int8, written in place
    v_pool: torch.Tensor,
    ks_pool: torch.Tensor,  # [L, N, Hkv, page, 1] f32, written in place
    vs_pool: torch.Tensor,
    k_slab: torch.Tensor,  # [L, S_pad, Hkv, Dh] full-width prefill slab
    v_slab: torch.Tensor,
    page_ids: torch.Tensor,  # [n_pages] int64, distinct
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """int8 twin of :func:`_write_pages`: the slab quantizes per vector
    (``llama.quantize_kv``) and values and scales scatter alike."""
    kq, ks = quantize_kv(k_slab)  # int8 [L, S, Hkv, Dh], f32 [L, S, Hkv]
    vq, vs = quantize_kv(v_slab)
    _write_pages(k_pool, v_pool, kq, vq, page_ids)
    _write_pages(ks_pool, vs_pool, ks[..., None], vs[..., None], page_ids)
    return k_pool, v_pool, ks_pool, vs_pool


class PagedKVCache:
    """Owns the device page pool and the host page accounting for up to
    ``max_slots`` concurrent sequences."""

    def __init__(
        self,
        cfg: Any,  # LlamaConfig-shaped (n_layers, n_kv_heads, head_dim, dtype)
        *,
        num_pages: int,
        page_size: int = 16,
        max_slots: int = 8,
        max_seq_len: int = 1024,
        device: torch.device,
        dtype: torch.dtype | None = None,
        kv_dtype: str | None = None,  # "int8": quantized pools with scales
        mesh: Any = None,  # tensor parallel: pools of this rank's KV heads
    ) -> None:
        self.cfg = cfg
        self.n_kv_heads = kv_heads(cfg, mesh)
        self.device = device
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.max_pages_per_seq = (max_seq_len + page_size - 1) // page_size
        self.quantized = kv_dtype == "int8"
        self._pool_dtype = dtype or cfg.dtype
        self._closed = False
        self.reset_pools()
        self.allocator = BlockAllocator(num_pages, page_size)
        self.tables = np.zeros((max_slots, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self._slot_seq: list[int | None] = [None] * max_slots

    def reset_pools(self) -> None:
        """(Re)allocate zeroed pools [L, N+1, Hkv, page, Dh]; the last page
        is the trash page. int8 pools come with f32 scale pools
        [L, N+1, Hkv, page, 1]; bf16 pools leave ``ks_pool``/``vs_pool``
        None. The engine's recovery calls it after a device loss: the old
        pools are released BEFORE the new ones are allocated, so a pool
        sized to fill the card is rebuilt without holding two."""
        self.k_pool = self.v_pool = self.ks_pool = self.vs_pool = None
        cfg = self.cfg
        shape = (
            cfg.n_layers, self.num_pages + 1, self.n_kv_heads,
            self.page_size, cfg.head_dim,
        )
        dtype = torch.int8 if self.quantized else self._pool_dtype
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.ks_pool = self.vs_pool = None
        if self.quantized:
            sshape = shape[:-1] + (1,)
            self.ks_pool = torch.zeros(sshape, dtype=torch.float32, device=self.device)
            self.vs_pool = torch.zeros(sshape, dtype=torch.float32, device=self.device)

    def close(self) -> None:
        """A clean stop: refuse new sequences and release the device pools
        (any later device use raises on the host)."""
        self._closed = True
        self.k_pool = self.v_pool = self.ks_pool = self.vs_pool = None

    def leak(self) -> None:  # leakcheck: transfer(quarantine)
        """Quarantine (a warm restart that could not join the engine
        thread): refuse new sequences but leave the pools to that thread,
        never released under it; the engine drops its own reference, so
        the memory goes back once the thread lets go."""
        self._closed = True

    def pools(self) -> tuple:
        """(k_pool, v_pool, ks_pool, vs_pool); the scales are None for bf16."""
        return self.k_pool, self.v_pool, self.ks_pool, self.vs_pool

    # ------------------------------------------------------------- accounting
    def alloc_slot(
        self, slot: int, seq_id: int, prompt_len: int,
        reserve_tokens: int | None = None,
    ) -> None:
        """Reserve pages for a prompt (``reserve_tokens`` >= prompt_len when
        the prefill bucket pads past it). Raises OutOfBlocks without
        touching the slot on failure."""
        if self._closed:
            raise RuntimeError("page pool closed")
        if self._slot_seq[slot] is not None:
            raise KeyError(f"slot {slot} busy")
        chaos.maybe_fail("kv.alloc")
        self.allocator.alloc(seq_id, max(prompt_len, reserve_tokens or 0))
        table = self.allocator.block_table(seq_id)
        self._slot_seq[slot] = seq_id
        self.tables[slot, : len(table)] = table
        self.tables[slot, len(table):] = 0
        self.seq_lens[slot] = prompt_len

    def extend_slot(self, slot: int) -> None:
        """Account one appended token. Raises OutOfBlocks when the pool is
        exhausted: the caller must retire or spill a sequence."""
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            raise KeyError(f"slot {slot} is free")
        new_len = int(self.seq_lens[slot]) + 1
        if new_len > self.allocator.seq_length(seq_id):
            chaos.maybe_fail("kv.alloc")
            self.allocator.extend(seq_id, new_len)
            table = self.allocator.block_table(seq_id)
            self.tables[slot, : len(table)] = table
        self.seq_lens[slot] = new_len

    def try_reserve_chunk(self, slots: list[int], tokens: int) -> bool:
        """Reserve page coverage for up to ``tokens`` further positions on
        every slot, or on none, without advancing the lengths (a
        speculative verify writes up to ``tokens`` positions and commits
        only the accepted prefix, through :meth:`advance_slot`). Targets
        clamp to max_seq_len; chunk positions past the clamp go to the
        trash page through the owned-capacity write guard. Returns False,
        having changed nothing, when the pool cannot cover every slot."""
        targets = []
        needed = 0
        for slot in slots:
            seq_id = self._slot_seq[slot]
            if seq_id is None:
                raise KeyError(f"slot {slot} is free")
            target = min(int(self.seq_lens[slot]) + tokens, self.max_seq_len)
            targets.append((slot, seq_id, target))
            # against the pages OWNED: a reservation that ends mid-page
            # absorbs the chunk's first positions with no new page
            owned = len(self.allocator.block_table(seq_id))
            needed += max(0, self.pages_needed(target) - owned)
        if needed > self.allocator.stats()["free_blocks"]:
            return False
        for slot, seq_id, target in targets:
            if target > self.allocator.seq_length(seq_id):
                self.allocator.extend(seq_id, target)
                table = self.allocator.block_table(seq_id)
                self.tables[slot, : len(table)] = table
        return True

    def try_reserve_slot(self, slot: int, tokens: int) -> bool:
        """Reserve page coverage for up to ``tokens`` positions past the
        slot's committed length (clamped to max_seq_len), or nothing.
        Lengths advance later through :meth:`advance_slot`."""
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            raise KeyError(f"slot {slot} is free")
        target = min(int(self.seq_lens[slot]) + tokens, self.max_seq_len)
        owned = len(self.allocator.block_table(seq_id))
        if self.pages_needed(target) - owned > self.allocator.stats()["free_blocks"]:
            return False
        if target > self.allocator.seq_length(seq_id):
            try:
                chaos.maybe_fail("kv.alloc")
                self.allocator.extend(seq_id, target)
            except OutOfBlocks:  # a raced pool, or the chaos point
                return False
            table = self.allocator.block_table(seq_id)
            self.tables[slot, : len(table)] = table
        return True

    def advance_slot(self, slot: int, n_tokens: int) -> None:
        """Commit ``n_tokens`` positions the device wrote (coverage was
        reserved up front, so this never allocates)."""
        self.seq_lens[slot] = int(self.seq_lens[slot]) + n_tokens

    def owned_capacity(self, slot: int) -> int:
        """Tokens covered by the slot's OWNED pages: the write guard of a
        chunk (positions past it go to the trash page, never through the
        zero-filled table tail into live page 0)."""
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            return 0
        return len(self.allocator.block_table(seq_id)) * self.page_size

    def free_slot(self, slot: int) -> None:
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            return
        self.allocator.free(seq_id)
        self._slot_seq[slot] = None
        self.tables[slot] = 0
        self.seq_lens[slot] = 0

    def pages_needed(self, tokens: int) -> int:
        return (tokens + self.page_size - 1) // self.page_size

    def stats(self) -> dict[str, int]:
        s = self.allocator.stats()
        s["page_size"] = self.page_size
        return s

    # ------------------------------------------------------------- device ops
    def write_prefill(self, slot: int, k_slab: torch.Tensor, v_slab: torch.Tensor) -> None:
        """Scatter a prefilled slab [L, S_bucket, Hkv, Dh] into the slot's
        pages, the slab zero-padded to whole pages (positions past the
        slot's length are masked at every read)."""
        self.write_pages(self.prefill_pages(slot, k_slab.shape[1]), k_slab, v_slab)

    def prefill_pages(self, slot: int, tokens: int) -> np.ndarray:
        """The host half of :meth:`write_prefill`: the ids of the slot's
        pages that a ``tokens``-long slab fills, its reservation grown
        when bucket padding spilled past it."""
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            raise KeyError(f"slot {slot} is free")
        n_pages = self.pages_needed(tokens)
        owned = self.allocator.block_table(seq_id)
        if n_pages > len(owned):
            # bucket padding spilled past the reservation: grow it
            self.allocator.extend(seq_id, n_pages * self.page_size)
            owned = self.allocator.block_table(seq_id)
            self.tables[slot, : len(owned)] = owned
        return np.asarray(owned[:n_pages], np.int64)

    def write_pages(self, page_ids: np.ndarray, k_slab: torch.Tensor, v_slab: torch.Tensor) -> None:
        """The device half of :meth:`write_prefill`: the slab, zero-padded
        to whole pages, scattered into ``page_ids``. A tensor-parallel
        follower runs it with its leader's page ids."""
        S = k_slab.shape[1]
        pad = len(page_ids) * self.page_size - S
        if pad:
            k_slab = torch.nn.functional.pad(k_slab, (0, 0, 0, 0, 0, pad))
            v_slab = torch.nn.functional.pad(v_slab, (0, 0, 0, 0, 0, pad))
        ids = to_device(np.asarray(page_ids, np.int64), self.device)
        if self.quantized:
            _write_pages_q(*self.pools(), k_slab, v_slab, ids)
        else:
            _write_pages(self.k_pool, self.v_pool, k_slab, v_slab, ids)

    def write_span(self, slot: int, start: int, k_slab: torch.Tensor, v_slab: torch.Tensor) -> None:
        """Scatter a cached chunk-prefix slab [L, C, Hkv, Dh] into the pages
        covering tokens [start, start+C): :meth:`write_prefill`'s offset
        twin, for a chunked admission that skips cached chunk prefixes.
        ``start`` must be page-aligned, and the caller reserved the
        coverage first. The slab is zero-padded to whole pages (positions
        past the slot's length are masked at every read). bf16 pools only:
        int8 pools take no cached slabs."""
        if self.quantized:
            raise ValueError("write_span: int8 pools take no cached slabs")
        if start % self.page_size:
            raise ValueError(f"write_span start {start} not page-aligned")
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            raise KeyError(f"slot {slot} is free")
        C = k_slab.shape[1]
        p0 = start // self.page_size
        p1 = self.pages_needed(start + C)
        pad = (p1 - p0) * self.page_size - C
        if pad:
            k_slab = torch.nn.functional.pad(k_slab, (0, 0, 0, 0, 0, pad))
            v_slab = torch.nn.functional.pad(v_slab, (0, 0, 0, 0, 0, pad))
        owned = self.allocator.block_table(seq_id)
        if p1 > len(owned):
            self.allocator.extend(seq_id, p1 * self.page_size)
            owned = self.allocator.block_table(seq_id)
            self.tables[slot, : len(owned)] = owned
        page_ids = to_device(np.asarray(owned[p0:p1], np.int64), self.device)
        _write_pages(self.k_pool, self.v_pool, k_slab, v_slab, page_ids)

    def read_span(self, slot: int, start: int, end: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Gather the slot's resident K/V of tokens [start, end) out of the
        pool into slabs [L, end-start, Hkv, Dh]: the chunk-prefix cache's
        extraction. ``start`` must be page-aligned. The slabs are fresh
        tensors, never views of the pools, so they stay valid when the
        pages are reused. bf16 pools only: int8 pages would dequantize
        here and drift when re-quantized at the next hit."""
        if self.quantized:
            raise ValueError("read_span: int8 pools are not extractable")
        if start % self.page_size:
            raise ValueError(f"read_span start {start} not page-aligned")
        p0 = start // self.page_size
        return self.read_pages(self.tables[slot, p0:self.pages_needed(end)], end - start)

    def read_pages(self, page_ids: np.ndarray, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The device half of :meth:`read_span`: the first ``n`` tokens of
        ``page_ids`` as fresh slabs [L, n, Hkv, Dh]. A tensor-parallel
        follower runs it with its leader's page ids."""
        page_ids = to_device(np.asarray(page_ids, np.int64), self.device)
        out = []
        for pool in (self.k_pool, self.v_pool):
            g = pool[:, page_ids]  # a gather: a fresh [L, n_pages, Hkv, page, Dh]
            L, n_pages, Hkv, page, Dh = g.shape
            out.append(g.transpose(2, 3).reshape(L, n_pages * page, Hkv, Dh)[:, :n].contiguous())
        return out[0], out[1]

    def tables_device(self) -> torch.Tensor:
        """The block tables as a device tensor. The upload is a snapshot:
        the host mirror may change while the copy is still queued."""
        return to_device(self.tables.copy(), self.device)

    def seq_lens_device(self) -> torch.Tensor:
        return to_device(self.seq_lens.copy(), self.device)
