"""Paged KV cache (port of ``gofr_tpu/serving/kv_cache.py``, bf16 pools).

A shared page pool ``[L, N_pages+1, Hkv, page, Dh]`` per k/v; the extra
LAST page is the trash page that inactive rows' decode writes are sent to.
Sequences own pages through :class:`~gofr_tpu_torch.serving.block_alloc.
BlockAllocator`, so device memory is committed by resident tokens, not by
worst-case slots.

Host side (this class): page accounting, block tables and lengths, whose
numpy mirrors are authoritative. Device side: the prefill scatter
(:func:`_write_pages`); the decode append lives in
``llama.decode_step_paged`` and the read in ``ops/paged_attention.py``.
The pools are updated in place where the JAX package donates them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch._device import to_device
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
    ) -> None:
        self.cfg = cfg
        self.device = device
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.max_pages_per_seq = (max_seq_len + page_size - 1) // page_size
        self._pool_dtype = dtype or cfg.dtype
        self.reset_pools()
        self.allocator = BlockAllocator(num_pages, page_size)
        self.tables = np.zeros((max_slots, self.max_pages_per_seq), np.int32)
        self.seq_lens = np.zeros(max_slots, np.int32)
        self._slot_seq: list[int | None] = [None] * max_slots

    def reset_pools(self) -> None:
        """(Re)allocate zeroed pools [L, N+1, Hkv, page, Dh]; the last page
        is the trash page."""
        cfg = self.cfg
        shape = (
            cfg.n_layers, self.num_pages + 1, cfg.n_kv_heads,
            self.page_size, cfg.head_dim,
        )
        self.k_pool = torch.zeros(shape, dtype=self._pool_dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=self._pool_dtype, device=self.device)

    # ------------------------------------------------------------- accounting
    def alloc_slot(
        self, slot: int, seq_id: int, prompt_len: int,
        reserve_tokens: int | None = None,
    ) -> None:
        """Reserve pages for a prompt (``reserve_tokens`` >= prompt_len when
        the prefill bucket pads past it). Raises OutOfBlocks without
        touching the slot on failure."""
        if self._slot_seq[slot] is not None:
            raise KeyError(f"slot {slot} busy")
        self.allocator.alloc(seq_id, max(prompt_len, reserve_tokens or 0))
        table = self.allocator.block_table(seq_id)
        self._slot_seq[slot] = seq_id
        self.tables[slot, : len(table)] = table
        self.tables[slot, len(table):] = 0
        self.seq_lens[slot] = prompt_len

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
                self.allocator.extend(seq_id, target)
            except OutOfBlocks:
                return False
            table = self.allocator.block_table(seq_id)
            self.tables[slot, : len(table)] = table
        return True

    def advance_slot(self, slot: int, n_tokens: int) -> None:
        """Commit ``n_tokens`` positions the device wrote (coverage was
        reserved up front, so this never allocates)."""
        self.seq_lens[slot] = int(self.seq_lens[slot]) + n_tokens

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
        seq_id = self._slot_seq[slot]
        if seq_id is None:
            raise KeyError(f"slot {slot} is free")
        L, S, Hkv, Dh = k_slab.shape
        n_pages = self.pages_needed(S)
        pad = n_pages * self.page_size - S
        if pad:
            k_slab = torch.nn.functional.pad(k_slab, (0, 0, 0, 0, 0, pad))
            v_slab = torch.nn.functional.pad(v_slab, (0, 0, 0, 0, 0, pad))
        owned = self.allocator.block_table(seq_id)
        if n_pages > len(owned):
            # bucket padding spilled past the reservation: grow it
            self.allocator.extend(seq_id, n_pages * self.page_size)
            owned = self.allocator.block_table(seq_id)
            self.tables[slot, : len(owned)] = owned
        page_ids = to_device(np.asarray(owned[:n_pages], np.int64), self.device)
        _write_pages(self.k_pool, self.v_pool, k_slab, v_slab, page_ids)

    def tables_device(self) -> torch.Tensor:
        """The block tables as a device tensor. The upload is a snapshot:
        the host mirror may change while the copy is still queued."""
        return to_device(self.tables.copy(), self.device)

    def seq_lens_device(self) -> torch.Tensor:
        return to_device(self.seq_lens.copy(), self.device)
