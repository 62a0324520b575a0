"""Paged (block-table) decode attention over bf16 page pools (port of
``gofr_tpu/ops/paged_attention.py``, bf16 half; the int8 entry waits).

K/V live in per-layer pools ``[N_pages, Hkv, page, Dh]`` shared by every
sequence; sequence ``b`` owns the pages ``block_tables[b]`` lists.
``paged_decode_attention`` launches the hand-written CUDA kernel in
``csrc/paged_attention.cu`` (one block per sequence and kv head; the file's
header gives its HBM bound on the H100 and how the design meets it) for
CUDA tensors, and runs :func:`paged_decode_attention_ref` for CPU tensors.
It replaces the Pallas TPU kernel ``gofr_tpu/ops/paged_attention.py::
_paged_kernel`` (``quantized=False``).
"""

from __future__ import annotations

import math

import torch

from gofr_tpu_torch import _build

NEG_INF = -1e30


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, H, Dh] one query token per sequence
    k_pool: torch.Tensor,  # [N_pages, Hkv, page, Dh]
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] page ids (unused entries: any)
    seq_lens: torch.Tensor,  # [B] valid token count per sequence
    scale: float | None = None,
) -> torch.Tensor:
    """The kernel's plain version: gather each sequence's pages into
    [B, M*page] K/V, masked f32 softmax. Page ids are clamped into the pool
    (the reference's gather clamps). A sequence with ``seq_len`` 0 gives 0,
    as the kernel's denominator guard does."""
    B, H, Dh = q.shape
    N, Hkv, page, _ = k_pool.shape
    M = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    tables = block_tables.long().clamp(0, N - 1)
    # [B, M, Hkv, page, Dh] -> [B, Hkv, M*page, Dh]
    k = k_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, Hkv, M * page, Dh).float()
    v = v_pool[tables].permute(0, 2, 1, 3, 4).reshape(B, Hkv, M * page, Dh).float()
    qg = q.reshape(B, Hkv, H // Hkv, Dh).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    lens = seq_lens.to(q.device)
    valid = torch.arange(M * page, device=q.device)[None, :] < lens[:, None]  # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v).reshape(B, H, Dh)
    out = torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention through block tables, [B, H, Dh] out in q's dtype.
    Reads only the pages below ``ceil(seq_len/page)`` of each sequence.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which takes contiguous bf16 q/pools with Dh 64 or 128, G = H/Hkv in
    {1, 2, 4, 8} and int32 tables and lengths, and raises on anything else."""
    B, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, scale)
    _check_inputs(q, k_pool, v_pool, block_tables, seq_lens)
    N, Hkv, page, _ = k_pool.shape
    out = torch.empty_like(q)
    status = _build.library("paged_attention").gofr_paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, H, Hkv, Dh, page, N,
        block_tables.shape[1], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches (CPU calls never count)


def _check_inputs(q, k_pool, v_pool, block_tables, seq_lens) -> None:
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} must be [B,H,Dh] and the pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} one layer [N,Hkv,page,Dh]"
        )
    B, H, Dh = q.shape
    N, Hkv, page, Dh_pool = k_pool.shape
    if Dh_pool != Dh or Dh not in (64, 128):
        raise ValueError(f"paged_decode_attention: the kernel takes head dim 64 or 128 (q {Dh}, pool {Dh_pool})")
    if Hkv == 0 or H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"paged_decode_attention: {H} query heads over {Hkv} kv heads is not a group of 1, 2, 4 or 8")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"paged_decode_attention: kernel takes bf16 {name}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be a contiguous, 16-byte aligned tensor on {q.device}")
    for name, t, shape in (("block_tables", block_tables, (B, block_tables.shape[-1])),
                           ("seq_lens", seq_lens, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be contiguous int32 {shape} on {q.device}")
