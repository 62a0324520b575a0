"""Flash-prefill attention: the port's plain version against the JAX Pallas
kernel (run in interpret mode, as the JAX package's own tests run it on the
CPU), and the CUDA kernel against the plain version on a card.

Shapes are multiples of the Pallas block (64 here, so several tiles and
the causal skip are exercised). Tolerances: 1e-5 in f32 (same math, other
summation order), 2e-2 in bf16 (the Pallas kernel keeps P in f32 for the
PV product where the plain version rounds it to bf16 first). On the card,
kernel vs plain version per output row: max|err| / max|ref| <= 2^-6, two
bf16 steps of the row's largest value at any row magnitude.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gofr_tpu_torch.ops import flash_attention as tflash  # noqa: E402

TOL = {"f32": 1e-5, "bf16": 2e-2}
ROW_TOL = 2.0 ** -6  # card: per-row relative, see the module docstring
DT = {"f32": ("float32", torch.float32), "bf16": ("bfloat16", torch.bfloat16)}


def _inputs(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize(
    "H,Hkv,kv_len",
    [(4, 2, [128, 77]), (4, 4, [0, 50]), (8, 2, [1, 128])],
    ids=["gqa2-ragged", "mha-empty-row", "gqa4-single-key"],
)
def test_plain_version_matches_pallas_kernel(jx, dtype, H, Hkv, kv_len):
    jnp, jflash = jx
    q, k, v = _inputs(len(kv_len) * H + Hkv, 2, 128, H, Hkv, 16)
    jdt, tdt = getattr(jnp, DT[dtype][0]), DT[dtype][1]
    lens = np.array(kv_len, np.int32)
    want = jflash.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(lens),
        causal=True, block_q=64, block_k=64, interpret=True,
    )
    got = tflash.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        torch.from_numpy(lens), causal=True,
    )
    assert got.shape == q.shape and got.dtype == tdt
    got_np = got.float().numpy()
    np.testing.assert_allclose(got_np, np.asarray(want.astype(jnp.float32)), atol=TOL[dtype], rtol=TOL[dtype])
    for b, n in enumerate(kv_len):
        if n == 0:  # nothing valid: exactly 0, the kernels' denominator guard
            assert not got_np[b].any()


def test_cpu_call_takes_plain_version_and_never_counts():
    q, k, v = _inputs(0, 1, 32, 4, 2, 16)
    before = tflash.flash_attention.launches
    out = tflash.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.tensor([20], dtype=torch.int32))
    ref = tflash.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                     torch.tensor([20], dtype=torch.int32))
    assert torch.equal(out, ref)
    assert tflash.flash_attention.launches == before


@pytest.mark.parametrize(
    "change,err",
    [
        (lambda q, k, v: (q.float(), k, v), TypeError),
        (lambda q, k, v: (q, k.transpose(1, 2).contiguous().transpose(1, 2), v), ValueError),
        (lambda q, k, v: (q[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous()),
         ValueError),
        (lambda q, k, v: (q, k[:, :, :1].contiguous(), v), ValueError),
    ],
    ids=["f32", "non-contiguous", "head-dim-32", "kv-shape"],
)
def test_kernel_input_checks_refuse(change, err):
    """What the kernel does not take is refused before any launch."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    v = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(err):
        tflash._check_inputs(*change(q, k, v), torch.zeros(1, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [32, 128, 200, 1024, 2048])
def test_kernel_matches_plain_version_on_card(cuda_device, S, D, causal):
    """Buckets on and off the 128-row query tile and the 64-key tile; kv_len
    full, odd, off every tile edge, and 0 (that row exactly 0)."""
    gen = torch.Generator(device="cuda").manual_seed(S + D + int(causal))
    B, H, Hkv = 4, (32 if S <= 1024 else 8), (8 if S <= 1024 else 2)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda", dtype=torch.bfloat16)
    kv_len = torch.tensor([S, S - 7, S // 3 + 1, 0], dtype=torch.int32, device="cuda")
    got = tflash.flash_attention(q, k, v, kv_len, causal=causal)
    want = tflash.flash_attention_ref(q, k, v, kv_len, causal=causal)
    torch.cuda.synchronize()
    assert _row_rel_err(got, want) <= ROW_TOL
    assert not got[3].any()


def _row_rel_err(got, want):
    """Largest max|got - ref| / max|ref| over the head dim of one row (one
    query head of one token); a row whose reference is all zero must be 0."""
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
    return importlib.import_module("jax.numpy"), importlib.import_module("gofr_tpu.ops.flash_attention")
