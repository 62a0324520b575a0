"""Paged (block-table) decode attention over bf16 or int8 page pools (port
of ``gofr_tpu/ops/paged_attention.py``).

K/V live in per-layer pools ``[N_pages, Hkv, page, Dh]`` shared by every
sequence; sequence ``b`` owns the pages ``block_tables[b]`` lists. int8
pools carry per-vector absmax scales ``[N_pages, Hkv, page, 1]`` f32 (one
per token and kv head) and are dequantized where they are read.

``paged_decode_attention`` (bf16 pools) and ``paged_decode_attention_q``
(int8 pools) launch the hand-written CUDA kernels in
``csrc/paged_attention.cu`` for CUDA tensors, and run
:func:`paged_decode_attention_ref` for CPU tensors. They replace the
Pallas TPU kernel ``gofr_tpu/ops/paged_attention.py::_paged_kernel`` with
``quantized=False`` and ``quantized=True``. The kernel is split across
blocks in one launch (flash-decoding): each block takes a span of
``SPLIT_TOKENS`` tokens (whole pages, :func:`split_layout`) of one
sequence and kv head, and the last block of a sequence to finish merges
the spans' f32 partials from a scratch buffer (:func:`scratch_numel`)
in a fixed order. The split count comes from the table's width, which
the host knows, never from ``seq_lens``: a wrapper reads no device value,
so the engine's double-buffered loop never waits on it. The file's
header gives the kernels' HBM bounds on the H100 and the design.

The scratch and the per-(sequence, kv head) arrival counters are kept per
(device, stream) and grown when a launch needs more, so a call allocates
nothing; the counters are zeroed once when allocated, and each launch's
last block resets its own to 0. Launches that share the buffers are thus
ordered by their stream, and a launch on another stream gets its own. A
launch captured into a CUDA graph never uses that cache: a graph replays
the pointers it captured, and the cache may replace its buffers later, so
the capture allocates its own from the graph's memory pool, which the
graph holds for as long as it lives (the counters' zeroing is captured
too, and replays as a memset). The reference's
``INT8_MIN_PAGE`` and its gather fallback for small int8 pages are a
Mosaic tiling rule: the CUDA kernel takes any page size.
"""

from __future__ import annotations

import math

import torch

from gofr_tpu_torch import _build

NEG_INF = -1e30
# tokens per block of the split (whole pages; see split_layout), chosen on
# the card against 128 and 512 (PERF.md); at most the kernel's 256 page ids
SPLIT_TOKENS = 256

# (device, stream) -> (f32 scratch, int32 arrival counters)
_buffers: dict[tuple[torch.device, int], tuple[torch.Tensor, torch.Tensor]] = {}


def split_layout(max_pages: int, page: int) -> tuple[int, int]:
    """(pages per split, number of splits) for a table of ``max_pages``
    columns: each block takes ``SPLIT_TOKENS`` tokens rounded down to whole
    pages (at least one), and the grid has a split for every such span of
    the table, live or not."""
    pps = max(1, SPLIT_TOKENS // page)
    return pps, max(1, -(-max_pages // pps))


def scratch_numel(B: int, Hkv: int, G: int, Dh: int, n_splits: int) -> int:
    """f32 elements of the kernel's partials: (m, l) then acc[Dh] for every
    (sequence, kv head, split, query head of the group)."""
    return B * Hkv * n_splits * G * (Dh + 2)


def _split_buffers(q: torch.Tensor, Hkv: int, page: int, max_pages: int, stream: int):
    """(pages per split, f32 scratch, int32 counters) for one launch on
    ``stream`` (its handle): the (device, stream)'s own buffers, each
    replaced by a larger one (counters zeroed) when the launch needs more;
    under a graph capture, buffers of the graph's own."""
    B, H, Dh = q.shape
    pps, n_splits = split_layout(max_pages, page)
    need = scratch_numel(B, Hkv, H // Hkv, Dh, n_splits)
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        return (pps, torch.empty(need, dtype=torch.float32, device=q.device),
                torch.zeros(B * Hkv, dtype=torch.int32, device=q.device))
    key = (q.device, stream)
    part, counters = _buffers.get(key, (None, None))
    if part is None or part.numel() < need:
        part = torch.empty(need, dtype=torch.float32, device=q.device)
    if counters is None or counters.numel() < B * Hkv:
        counters = torch.zeros(B * Hkv, dtype=torch.int32, device=q.device)
    _buffers[key] = part, counters
    return pps, part, counters


def _gather(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[N, Hkv, page, X] pages of each row -> [B, Hkv, M*page, X]."""
    B, M = tables.shape
    _, Hkv, page, X = pool.shape
    return pool[tables].permute(0, 2, 1, 3, 4).reshape(B, Hkv, M * page, X)


def paged_decode_attention_ref(
    q: torch.Tensor,  # [B, H, Dh] one query token per sequence
    k_pool: torch.Tensor,  # [N_pages, Hkv, page, Dh] (int8 with scales)
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, M] page ids (unused entries: any)
    seq_lens: torch.Tensor,  # [B] valid token count per sequence
    scale: float | None = None,
    *,
    k_scale: torch.Tensor | None = None,  # int8 pools: [N_pages, Hkv, page, 1] f32
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernels' plain version: gather each sequence's pages into
    [B, M*page] K/V (int8 pools dequantize after the gather, in f32, so
    only the owned pages widen), masked f32 softmax. Page ids are clamped
    into the pool (the reference's gather clamps). A sequence with
    ``seq_len`` 0 gives 0, as the kernel's denominator guard does."""
    B, H, Dh = q.shape
    N, Hkv, page, _ = k_pool.shape
    M = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    tables = block_tables.long().clamp(0, N - 1)
    k = _gather(k_pool, tables).float()  # [B, Hkv, M*page, Dh]
    v = _gather(v_pool, tables).float()
    if k_scale is not None:
        k = k * _gather(k_scale, tables)
        v = v * _gather(v_scale, tables)
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
    """Decode attention through block tables over bf16 pools, [B, H, Dh]
    out in q's dtype. Reads only the pages below ``ceil(seq_len/page)`` of
    each sequence. CPU tensors take the plain version; CUDA tensors launch
    the kernel once, split across blocks by ``SPLIT_TOKENS`` spans, with
    no read of a device value on the host. It takes contiguous bf16
    q/pools with Dh 64 or 128, G = H/Hkv in {1, 2, 4, 8} and int32 tables
    and lengths, and raises on anything else."""
    B, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    _refuse_released("paged_decode_attention", k_pool, v_pool)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables, seq_lens, scale)
    _check_inputs(q, k_pool, v_pool, block_tables, seq_lens)
    N, Hkv, page, _ = k_pool.shape
    M = block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pps, part, counters = _split_buffers(q, Hkv, page, M, stream)
    out = torch.empty_like(q)
    status = _build.library("paged_attention").gofr_paged_decode_bf16(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), part.data_ptr(), counters.data_ptr(),
        B, H, Hkv, Dh, page, N, M, pps, float(scale),
        stream,
    )
    _build.check(status, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches (CPU calls never count)


def paged_decode_attention_q(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention through block tables over int8 pools with f32
    per-vector scales, dequantized inside the kernel (the pools are never
    widened in memory); [B, H, Dh] out in q's dtype. CPU tensors take the
    plain version; CUDA tensors launch the kernel as the bf16 entry does
    (one launch, split across blocks), which takes what the bf16 kernel
    takes but int8 pools and contiguous f32 scales ``[N, Hkv, page, 1]``,
    and raises on anything else."""
    B, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    _refuse_released("paged_decode_attention_q", k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, seq_lens, scale, k_scale=k_scale, v_scale=v_scale
        )
    _check_inputs(q, k_pool, v_pool, block_tables, seq_lens, k_scale, v_scale)
    N, Hkv, page, _ = k_pool.shape
    M = block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pps, part, counters = _split_buffers(q, Hkv, page, M, stream)
    out = torch.empty_like(q)
    status = _build.library("paged_attention").gofr_paged_decode_int8(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), B, H, Hkv, Dh, page, N, M, pps, float(scale),
        stream,
    )
    _build.check(status, "paged_decode_attention_q")
    paged_decode_attention_q.launches += 1
    return out


paged_decode_attention_q.launches = 0  # kernel launches (CPU calls never count)


def _refuse_released(what: str, *pools) -> None:
    """A 0-element pool is released storage (the engine poisons its KV
    this way on a device loss): refused on the host, on any device, before
    a kernel could read address 0 and leave the CUDA context in a sticky
    error."""
    if any(t is not None and t.numel() == 0 for t in pools):
        raise ValueError(f"{what}: a 0-element pool is released KV storage; refused before "
                         "any launch")


def _check_inputs(q, k_pool, v_pool, block_tables, seq_lens, k_scale=None, v_scale=None) -> None:
    """Refuse what the kernels do not take; with scales, the int8 kernel's
    inputs."""
    quantized = k_scale is not None
    what = "paged_decode_attention_q" if quantized else "paged_decode_attention"
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"{what}: q {tuple(q.shape)} must be [B,H,Dh] and the pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} one layer [N,Hkv,page,Dh]"
        )
    B, H, Dh = q.shape
    N, Hkv, page, Dh_pool = k_pool.shape
    if Dh_pool != Dh or Dh not in (64, 128):
        raise ValueError(f"{what}: the kernel takes head dim 64 or 128 (q {Dh}, pool {Dh_pool})")
    if Hkv == 0 or H % Hkv or H // Hkv not in (1, 2, 4, 8):
        raise ValueError(f"{what}: {H} query heads over {Hkv} kv heads is not a group of 1, 2, 4 or 8")
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    # (name, tensor, dtype, alignment): rows load as 16-, 8- or 4-byte
    # vectors, scales as one f32 per lane
    tensors = [("q", q, torch.bfloat16, 16), ("k_pool", k_pool, pool_dtype, 16),
               ("v_pool", v_pool, pool_dtype, 16)]
    if quantized:
        if v_scale is None or k_scale.shape != (N, Hkv, page, 1) or v_scale.shape != k_scale.shape:
            raise ValueError(
                f"{what}: scales {tuple(k_scale.shape)}/"
                f"{None if v_scale is None else tuple(v_scale.shape)} must be [N,Hkv,page,1] "
                f"= {(N, Hkv, page, 1)}"
            )
        tensors += [("k_scale", k_scale, torch.float32, 4), ("v_scale", v_scale, torch.float32, 4)]
    for name, t, dtype, align in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{what}: kernel takes {dtype} {name}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be a contiguous, {align}-byte aligned tensor on {q.device}")
    for name, t, shape in (("block_tables", block_tables, (B, block_tables.shape[-1])),
                           ("seq_lens", seq_lens, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous int32 {shape} on {q.device}")
