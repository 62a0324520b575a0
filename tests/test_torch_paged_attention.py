"""Paged decode attention: the port's plain version against the JAX Pallas
kernel (interpret mode) and the JAX gather reference, and the CUDA kernel
against the plain version on a card.

Pools hold shuffled, non-contiguous page ids, tables carry junk past each
sequence's pages, and lengths include 0, 1, a page boundary and ragged
ends. Tolerances: 1e-5 in f32, 1e-2 in bf16 (f32 math on every side; only
the output rounds; on the card, per row max|err| / max|ref| <= 2^-6, two
bf16 steps). For a sequence of length 0 the Pallas kernel and the
port give 0, while the JAX gather reference gives the mean of V (softmax
over all -1e30): those rows are compared with the kernel only.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gofr_tpu_torch.ops import paged_attention as tpaged  # noqa: E402

TOL = {"f32": 1e-5, "bf16": 1e-2}
ROW_TOL = 2.0 ** -6  # card: per-row relative, see the module docstring
DT = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _inputs(seed, seq_lens, H, Hkv, Dh=16, page=8, spare=5):
    rng = np.random.default_rng(seed)
    B = len(seq_lens)
    M = max(1, max(-(-s // page) for s in seq_lens))
    used = sum(-(-s // page) for s in seq_lens)
    N = used + spare
    perm = rng.permutation(N)
    tables = rng.integers(0, N, (B, M)).astype(np.int32)  # junk past the owned pages
    pos = 0
    for b, s in enumerate(seq_lens):
        n = -(-s // page)
        tables[b, :n] = perm[pos:pos + n]
        pos += n
    k_pool = rng.standard_normal((N, Hkv, page, Dh)).astype(np.float32)
    v_pool = rng.standard_normal((N, Hkv, page, Dh)).astype(np.float32)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.array(seq_lens, np.int32)


CASES = [
    ((0, 1, 8, 9, 30), 4, 2),
    ((17, 0, 40), 8, 2),
    ((5, 16, 23), 4, 4),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq_lens,H,Hkv", CASES, ids=["gqa2-edges", "gqa4-empty", "mha"])
def test_plain_version_matches_pallas_kernel_and_reference(jx, dtype, seq_lens, H, Hkv):
    jnp, jpaged = jx
    q, kp, vp, tables, lens = _inputs(len(seq_lens) + H, seq_lens, H, Hkv)
    jdt, tdt = getattr(jnp, DT[dtype][0]), DT[dtype][1]
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(tables), jnp.asarray(lens))
    kernel = np.asarray(jpaged.paged_decode_attention(*jargs, interpret=True).astype(jnp.float32))
    ref = np.asarray(jpaged.paged_decode_attention_ref(*jargs).astype(jnp.float32))
    got = tpaged.paged_decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kp).to(tdt), torch.from_numpy(vp).to(tdt),
        torch.from_numpy(tables), torch.from_numpy(lens),
    )
    assert got.shape == q.shape and got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, kernel, atol=TOL[dtype], rtol=TOL[dtype])
    live = lens > 0
    np.testing.assert_allclose(got[live], ref[live], atol=TOL[dtype], rtol=TOL[dtype])
    assert not got[~live].any()


def test_out_of_pool_page_ids_clamp_like_the_reference(jx):
    jnp, jpaged = jx
    q, kp, vp, tables, lens = _inputs(9, (12,), 4, 2)
    tables[0, 1] = kp.shape[0] + 7  # past the pool: the gather clamps
    jargs = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables), jnp.asarray(lens))
    want = np.asarray(jpaged.paged_decode_attention_ref(*jargs))
    got = tpaged.paged_decode_attention_ref(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_cpu_call_never_counts():
    q, kp, vp, tables, lens = _inputs(3, (9, 4), 4, 2)
    before = tpaged.paged_decode_attention.launches
    tpaged.paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lens)))
    assert tpaged.paged_decode_attention.launches == before


@pytest.mark.parametrize(
    "field,value,err",
    [
        ("q", torch.zeros((2, 4, 64)), TypeError),
        ("tables", torch.zeros((2, 3), dtype=torch.int64), ValueError),
        ("lens", torch.zeros(3, dtype=torch.int32), ValueError),
        ("q", torch.zeros((2, 6, 64), dtype=torch.bfloat16), ValueError),
    ],
    ids=["f32-q", "int64-tables", "lens-shape", "group-3"],
)
def test_kernel_input_checks_refuse(field, value, err):
    args = dict(
        q=torch.zeros((2, 4, 64), dtype=torch.bfloat16),
        kp=torch.zeros((5, 2, 8, 64), dtype=torch.bfloat16),
        vp=torch.zeros((5, 2, 8, 64), dtype=torch.bfloat16),
        tables=torch.zeros((2, 3), dtype=torch.int32),
        lens=torch.zeros(2, dtype=torch.int32),
    )
    args[field] = value
    with pytest.raises(err):
        tpaged._check_inputs(*args.values())


# card cases: (seq_lens, H, Hkv, Dh). Lengths end exactly at a split span
# (256 tokens) and one past it, hold 0, page edges and ragged ends; a lone
# 4000-token row is split across 16 blocks; G = 4 and G = 8 / 2.
SPAN_LENS = (0, 1, 15, 17, 256, 257, 1000, 512, 333, 999)
CARD_CASES = [
    (SPAN_LENS, 32, 8, 128),
    ((4000,), 32, 8, 128),
    (SPAN_LENS, 16, 2, 64),
    (SPAN_LENS, 16, 8, 128),
]
CARD_IDS = ["g4-batch", "g4-lone-4000", "g8-dh64", "g2"]


@pytest.mark.cuda
@pytest.mark.parametrize("page", [16, 32])
@pytest.mark.parametrize("seq_lens,H,Hkv,Dh", CARD_CASES, ids=CARD_IDS)
def test_kernel_matches_plain_version_on_card(cuda_device, seq_lens, H, Hkv, Dh, page):
    q, kp, vp, tables, lens = _inputs(5, seq_lens, H, Hkv, Dh=Dh, page=page)
    dev = [torch.from_numpy(a).to("cuda") for a in (q, kp, vp, tables, lens)]
    for i in range(3):
        dev[i] = dev[i].to(torch.bfloat16)
    got = tpaged.paged_decode_attention(*dev)
    again = tpaged.paged_decode_attention(*dev)  # the counters were reset: same bits
    want = tpaged.paged_decode_attention_ref(*dev)
    torch.cuda.synchronize()
    assert _row_rel_err(got, want) <= ROW_TOL
    assert torch.equal(got, again)
    for b, n in enumerate(seq_lens):
        if n == 0:
            assert not got[b].any()


@pytest.mark.parametrize(
    "max_pages,page,want",
    [(64, 16, (16, 4)), (128, 16, (16, 8)), (1, 32, (8, 1)), (0, 16, (16, 1)),
     (250, 1, (256, 1)), (3, 512, (1, 3))],
    ids=["engine-b8", "bf16-path", "one-page", "empty-table", "page-1-capped", "page-past-span"],
)
def test_split_layout(max_pages, page, want):
    """Whole pages per split, at least one and at most the kernel's list;
    a split for every span of the table, and at least one."""
    assert tpaged.split_layout(max_pages, page) == want


def test_split_span_fits_the_kernels_page_list():
    """However small the page, a split's page ids fit the kernel's shared
    list (one per thread), whose launcher refuses more."""
    import re
    from pathlib import Path

    src = (Path(tpaged.__file__).resolve().parents[1] / "csrc" / "paged_attention.cu").read_text()
    assert re.search(r"constexpr int MAX_PPS = THREADS;", src)
    threads = 32 * int(re.search(r"constexpr int NW = (\d+);", src).group(1))
    assert re.search(r"pps > MAX_PPS", src)
    assert max(tpaged.split_layout(4096, page)[0] for page in (1, 2, 16, 32)) <= threads


def test_split_buffers_shapes_and_counter_reuse():
    """Scratch holds (m, l, acc[Dh]) per (row, kv head, split, group head);
    scratch and counters belong to one (device, stream), are reused while
    large enough (the kernel resets the counters) and replaced by larger
    ones (counters zeroed) when a launch needs more; another stream gets
    its own."""
    stream, other = 0x5EED01, 0x5EED02  # stand-ins for CUDA stream handles
    for key in ((torch.device("cpu"), stream), (torch.device("cpu"), other)):
        tpaged._buffers.pop(key, None)
    q = torch.zeros((8, 32, 128), dtype=torch.bfloat16)
    pps, part, counters = tpaged._split_buffers(q, 8, 16, 128, stream)
    assert pps == 16 and part.dtype == torch.float32
    assert part.numel() == tpaged.scratch_numel(8, 8, 4, 128, 8) == 8 * 8 * 8 * 4 * 130
    assert counters.dtype == torch.int32 and counters.numel() >= 64 and not counters.any()
    _, part_again, again = tpaged._split_buffers(q[:2], 8, 16, 128, stream)
    assert again is counters and part_again is part
    _, part_grown, grown = tpaged._split_buffers(torch.zeros((20, 32, 128), dtype=torch.bfloat16),
                                                 8, 16, 128, stream)
    assert grown.numel() >= 160 and not grown.any()
    assert part_grown.numel() == tpaged.scratch_numel(20, 8, 4, 128, 8)
    _, part_other, counters_other = tpaged._split_buffers(q, 8, 16, 128, other)
    assert part_other is not part_grown and counters_other is not grown


def test_c_entry_points_match_their_ctypes_signatures():
    """Each extern "C" entry of csrc/ takes as many pointers, ints and floats,
    in the same order, as ``_build.SIGNATURES`` declares for ctypes."""
    import ctypes
    import re
    from pathlib import Path

    from gofr_tpu_torch import _build

    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for name, entries in _build.SIGNATURES.items():
        src = (Path(_build.CSRC) / f"{name}.cu").read_text()
        for fn, argtypes in entries:
            params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1).split(",")
            got = "".join("p" if "*" in p else "f" if "float" in p else "i" for p in params)
            assert got == "".join(kinds[a] for a in argtypes), fn


def _row_rel_err(got, want):
    """Largest max|got - ref| / max|ref| over the head dim of one row (one
    head of one sequence); a row whose reference is all zero must be 0."""
    err = (got.float() - want.float()).abs().amax(-1)
    scale = want.float().abs().amax(-1)
    assert not err[scale == 0].any()
    return (err[scale > 0] / scale[scale > 0]).max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported only by the tests that compare with it (the
    card-only tests run where JAX is not installed)."""
    pytest.importorskip("jax")
    return importlib.import_module("jax.numpy"), importlib.import_module("gofr_tpu.ops.paged_attention")
