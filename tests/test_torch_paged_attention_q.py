"""Paged decode attention over int8 pools with f32 per-vector scales: the
port's plain version against the JAX Pallas kernel (interpret mode,
``quantized=True``) and the JAX gather reference with scales, and the CUDA
kernel against the plain version on a card.

The pools are quantized by the JAX package's own ``quantize_kv`` from
seeded normals. Tables hold shuffled page ids with junk past each
sequence's pages; lengths include 0, 1, a page boundary and ragged ends.
Tolerances: 1e-5 in f32, 1e-2 in bf16 (f32 math on every side; only the
output rounds). On the card, per output row max|err| / max|ref| <= 2^-6,
at pages 16 and 32. Rows of length 0 give 0 in the Pallas kernel and the
port, the mean of V in the JAX reference: they are compared with the
kernel only.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gofr_tpu_torch.ops import paged_attention as tpaged  # noqa: E402

TOL = {"f32": 1e-5, "bf16": 1e-2}
ROW_TOL = 2.0 ** -6
DT = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _quantize(x):
    """Per-vector absmax int8 of a numpy array, as ``llama.quantize_kv``:
    (int8 values, f32 scales [..., 1])."""
    absmax = np.abs(x).max(-1, keepdims=True)
    scale = np.maximum(absmax / np.float32(127.0), np.float32(1e-8)).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale


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
    kq, ks = _quantize(rng.standard_normal((N, Hkv, page, Dh)).astype(np.float32) * 3)
    vq, vs = _quantize(rng.standard_normal((N, Hkv, page, Dh)).astype(np.float32))
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    return q, kq, vq, ks, vs, tables, np.array(seq_lens, np.int32)


CASES = [
    ((0, 1, 8, 9, 30), 4, 2),
    ((17, 0, 40), 8, 2),
    ((5, 16, 23), 4, 4),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seq_lens,H,Hkv", CASES, ids=["gqa2-edges", "gqa4-empty", "mha"])
def test_plain_version_matches_pallas_kernel_and_reference(jx, dtype, seq_lens, H, Hkv):
    jnp, jpaged = jx
    q, kq, vq, ks, vs, tables, lens = _inputs(len(seq_lens) + H, seq_lens, H, Hkv)
    jdt, tdt = getattr(jnp, DT[dtype][0]), DT[dtype][1]
    jq = jnp.asarray(q, jdt)
    pools = tuple(jnp.asarray(a) for a in (kq, vq, ks, vs))
    kernel = jpaged.paged_decode_attention_q(jq, *pools, jnp.asarray(tables), jnp.asarray(lens),
                                             interpret=True)
    ref = jpaged.paged_decode_attention_ref(
        jq, pools[0], pools[1], jnp.asarray(tables), jnp.asarray(lens),
        k_scale=pools[2], v_scale=pools[3],
    )
    kernel, ref = (np.asarray(a.astype(jnp.float32)) for a in (kernel, ref))
    got = tpaged.paged_decode_attention_q(
        torch.from_numpy(q).to(tdt), *(torch.from_numpy(a) for a in (kq, vq, ks, vs)),
        torch.from_numpy(tables), torch.from_numpy(lens),
    )
    assert got.shape == q.shape and got.dtype == tdt
    got = got.float().numpy()
    np.testing.assert_allclose(got, kernel, atol=TOL[dtype], rtol=TOL[dtype])
    live = lens > 0
    np.testing.assert_allclose(got[live], ref[live], atol=TOL[dtype], rtol=TOL[dtype])
    assert not got[~live].any()


def test_scales_are_applied_per_token_and_kv_head(jx):
    """Changing one token's K scale moves only the rows that read it."""
    q, kq, vq, ks, vs, tables, lens = _inputs(11, (9, 20), 4, 2)
    args = [torch.from_numpy(a) for a in (q, kq, vq, ks, vs, tables, lens)]
    base = tpaged.paged_decode_attention_q(*args)
    ks2 = ks.copy()
    ks2[tables[1, 0], 1, 3, 0] *= 4.0  # sequence 1, kv head 1, token 3
    args[3] = torch.from_numpy(ks2)
    moved = tpaged.paged_decode_attention_q(*args)
    changed = (moved - base).abs().amax(-1) > 0  # [B, H]
    assert changed.tolist() == [[False] * 4, [False, False, True, True]]


def test_cpu_call_never_counts():
    q, kq, vq, ks, vs, tables, lens = _inputs(3, (9, 4), 4, 2)
    before = tpaged.paged_decode_attention_q.launches
    tpaged.paged_decode_attention_q(*(torch.from_numpy(a) for a in (q, kq, vq, ks, vs, tables, lens)))
    assert tpaged.paged_decode_attention_q.launches == before


@pytest.mark.parametrize(
    "field,value,err",
    [
        ("kp", torch.zeros((5, 2, 8, 64), dtype=torch.bfloat16), TypeError),
        ("ks", torch.zeros((5, 2, 8, 1), dtype=torch.bfloat16), TypeError),
        ("ks", torch.zeros((5, 2, 8), dtype=torch.float32), ValueError),
        ("ks", torch.zeros((5, 2, 8, 2), dtype=torch.float32)[..., :1], ValueError),
        ("q", torch.zeros((2, 4, 32), dtype=torch.bfloat16), ValueError),
        ("tables", torch.zeros((2, 3), dtype=torch.int64), ValueError),
    ],
    ids=["bf16-pool", "bf16-scales", "scale-rank", "strided-scales", "head-dim-32", "int64-tables"],
)
def test_kernel_input_checks_refuse(field, value, err):
    args = dict(
        q=torch.zeros((2, 4, 64), dtype=torch.bfloat16),
        kp=torch.zeros((5, 2, 8, 64), dtype=torch.int8),
        vp=torch.zeros((5, 2, 8, 64), dtype=torch.int8),
        tables=torch.zeros((2, 3), dtype=torch.int32),
        lens=torch.zeros(2, dtype=torch.int32),
        ks=torch.zeros((5, 2, 8, 1), dtype=torch.float32),
        vs=torch.zeros((5, 2, 8, 1), dtype=torch.float32),
    )
    args[field] = value
    with pytest.raises(err):
        tpaged._check_inputs(*args.values())


# card cases: (seq_lens, H, Hkv, Dh), as the bf16 kernel's card test
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
    q, kq, vq, ks, vs, tables, lens = _inputs(5, seq_lens, H, Hkv, Dh=Dh, page=page)
    dev = [torch.from_numpy(a).to("cuda") for a in (q, kq, vq, ks, vs, tables, lens)]
    dev[0] = dev[0].to(torch.bfloat16)
    got = tpaged.paged_decode_attention_q(*dev)
    again = tpaged.paged_decode_attention_q(*dev)  # the counters were reset: same bits
    want = tpaged.paged_decode_attention_ref(*dev[:3], *dev[5:], k_scale=dev[3], v_scale=dev[4])
    torch.cuda.synchronize()
    assert _row_rel_err(got, want) <= ROW_TOL
    assert torch.equal(got, again)
    for b, n in enumerate(seq_lens):
        if n == 0:
            assert not got[b].any()


def test_split_buffers_follow_the_int8_pool_page():
    """The int8 entry splits by the same rule: 32-token pages give 8 pages
    (256 tokens) per split, and the scratch does not depend on the pool
    type."""
    stream = 0x5EED03  # a stand-in for a CUDA stream handle
    tpaged._buffers.pop((torch.device("cpu"), stream), None)
    q = torch.zeros((1, 32, 128), dtype=torch.bfloat16)
    pps, part, _ = tpaged._split_buffers(q, 8, 32, 125, stream)  # a 4000-token row
    assert pps == 8 and tpaged.split_layout(125, 32) == (8, 16)
    assert part.numel() == 1 * 8 * 16 * 4 * 130


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
