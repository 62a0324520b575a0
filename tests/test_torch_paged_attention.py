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


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    q, kp, vp, tables, lens = _inputs(5, (0, 1, 15, 17, 1000, 333, 64, 999), 32, 8, Dh=128, page=16)
    dev = [torch.from_numpy(a).to("cuda") for a in (q, kp, vp, tables, lens)]
    for i in range(3):
        dev[i] = dev[i].to(torch.bfloat16)
    got = tpaged.paged_decode_attention(*dev)
    want = tpaged.paged_decode_attention_ref(*dev)
    torch.cuda.synchronize()
    assert _row_rel_err(got, want) <= ROW_TOL
    assert not got[0].any()


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
