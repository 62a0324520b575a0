"""The port's plain ops (gofr_tpu_torch/ops) against the JAX package's.

Inputs come from numpy with a fixed seed and go to both sides. f32
comparisons hold to 1e-5 (the same math, summed in another order); bf16
ones to 2e-2 (one bf16 rounding of O(1) values is up to 2^-8 relative, and
the two frameworks round at slightly different points).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gofr_tpu_torch.ops import attention as tatt  # noqa: E402
from gofr_tpu_torch.ops import norms as tnorms  # noqa: E402
from gofr_tpu_torch.ops import rope as trope  # noqa: E402
from gofr_tpu_torch.ops import sampling as tsampling  # noqa: E402

# gofr_tpu.ops re-exports functions under some of its module names
jatt = importlib.import_module("gofr_tpu.ops.attention")
jnorms = importlib.import_module("gofr_tpu.ops.norms")
jrope = importlib.import_module("gofr_tpu.ops.rope")
jsampling = importlib.import_module("gofr_tpu.ops.sampling")

F32_TOL = 1e-5
BF16_TOL = 2e-2
DTYPES = {"f32": (np.float32, jnp.float32, torch.float32, F32_TOL),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _both(arr: np.ndarray, dtype: str):
    _, jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.from_numpy(arr).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    jx, tx = _both(x, dtype)
    want = jnorms.rms_norm(jx, jnp.asarray(scale), 1e-5)
    got = tnorms.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=DTYPES[dtype][3], rtol=DTYPES[dtype][3])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_half_rotation(dtype):
    rng = np.random.default_rng(1)
    jsin, jcos = jrope.rope_table(128, 16, 500000.0)
    tsin, tcos = trope.rope_table(128, 16, 500000.0, "cpu")
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 128, (2, 7))
    jx, tx = _both(x, dtype)
    want = jrope.apply_rope(jx, jnp.asarray(pos), jsin, jcos)
    got = trope.apply_rope(tx, torch.from_numpy(pos), tsin, tcos)
    np.testing.assert_allclose(_np(got), _np(want), atol=DTYPES[dtype][3], rtol=DTYPES[dtype][3])
    # half rotation: lane i pairs with lane i + D/2, not with its neighbour
    one = np.zeros((1, 1, 1, 16), np.float32)
    one[..., 0] = 1.0
    rot = trope.apply_rope(torch.from_numpy(one), torch.tensor([[5]]), tsin, tcos)[0, 0, 0]
    assert rot[8].item() == pytest.approx(float(tsin[5, 0]))
    assert rot[1].item() == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 3), (False, 0)])
def test_attention_gqa_masks(dtype, causal, q_offset):
    rng = np.random.default_rng(2)
    B, Sq, Sk, H, Hkv, D = 3, 6, 9, 4, 2, 8
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    kv_len = np.array([9, 4, 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jatt.attention(jq, jk, jv, causal=causal, q_offset=q_offset, kv_len=jnp.asarray(kv_len))
    got = tatt.attention(tq, tk, tv, causal=causal, q_offset=q_offset, kv_len=torch.from_numpy(kv_len))
    assert got.shape == (B, Sq, H, D) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=DTYPES[dtype][3], rtol=DTYPES[dtype][3])


def test_decode_attention():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 1, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 8)).astype(np.float32)
    lens = np.array([10, 3], np.int32)
    want = jatt.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens))
    got = tatt.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k), torch.from_numpy(v),
                                torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)


def _logits(seed=4, B=6, V=50):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


def test_greedy_is_exact_argmax_like_jax():
    logits = _logits()
    want = jsampling.sample_logits(jnp.asarray(logits), jax.random.PRNGKey(0), temperature=0.0)
    got = tsampling.sample_logits(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                                  temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_per_row_params_top_k_one_and_tiny_top_p_are_greedy():
    logits = torch.from_numpy(_logits())
    argmax = logits.argmax(-1)
    temp = torch.tensor([0.0, 0.7, 1.3, 0.7, 2.0, 0.0])
    top_k = torch.tensor([0, 1, 1, 0, 1, 5])
    top_p = torch.tensor([1.0, 1.0, 0.9, 1e-6, 1.0, 0.5])
    got = tsampling.sample_logits(logits, torch.Generator().manual_seed(1),
                                  temperature=temp, top_k=top_k, top_p=top_p)
    assert torch.equal(got, argmax)


def test_sampled_distribution_and_masks():
    """Gumbel-max draws follow softmax(logits / T) over the top-k / top-p
    survivors and never leave them."""
    row = np.array([2.0, 1.5, 1.0, 0.0, -1.0, -3.0], np.float32)
    B = 20000
    logits = torch.from_numpy(np.tile(row, (B, 1)))
    gen = torch.Generator().manual_seed(2)
    draws = tsampling.sample_logits(logits, gen, temperature=0.8).numpy()
    p = np.exp(row / 0.8) / np.exp(row / 0.8).sum()
    freq = np.bincount(draws, minlength=6) / B
    np.testing.assert_allclose(freq, p, atol=0.015)
    topk = tsampling.sample_logits(logits, gen, temperature=1.0, top_k=3).numpy()
    assert set(np.unique(topk)) == {0, 1, 2}
    # nucleus 0.6 at T=1: p = [.45, .27, ...] -> the first two cover it
    nucleus = tsampling.sample_logits(logits, gen, temperature=1.0, top_p=0.6).numpy()
    assert set(np.unique(nucleus)) == {0, 1}


def test_stop_eval_matches_jax():
    nxt = np.array([2, 5, 2, 7], np.int32)
    stop = np.array([2, 2, -1, 7], np.int32)
    budget = np.array([5, 1, 3, 9], np.int32)
    want = jsampling.stop_eval(jnp.asarray(nxt), jnp.asarray(stop), jnp.asarray(budget))
    got = tsampling.stop_eval(torch.from_numpy(nxt), torch.from_numpy(stop), torch.from_numpy(budget))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
