"""int8 paged KV of the port against the JAX package, on the CPU.

- ``quantize_kv`` gives bit-identical int8 values and equal f32 scales
  (f32 first, a true division, half-to-even rounding), including ties at
  .5 and an all-zero vector. The reference is held as its served paths run
  it, under ``jit``: XLA turns ``absmax / 127`` into a product with
  f32(1/127) there, one ulp off the eager division in some scales;
- ``_write_pages_q`` (the prefill scatter into int8 pools) gives identical
  pools and scales;
- 8 steps of ``decode_step_paged_q`` on the tiny f32 model: logits within
  1e-4 (summation order differs), int8 pools identical, scales within
  1e-6 relative, the frozen row's pages untouched; the trash page is left
  out (several frozen writes race there, on either side);
- ``decode_block_paged_q`` gives the reference's packed output.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), params_from_jax(jax.device_get(jparams), device="cpu")


def _quant_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 2, 16)).astype(np.float32) * 2
    x[0, 0, 0] = 0.0  # all-zero vector: scale 1e-8, values 0
    # exact .5 ties after the division: absmax 127 gives scale 1
    x[0, 1, 0] = np.float32(0.5)
    x[0, 1, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_identical(dtype):
    x = _quant_inputs()
    jx = jnp.asarray(x, getattr(jnp, dtype))
    jq, js = jax.jit(jllama.quantize_kv)(jx)
    tq, ts = tllama.quantize_kv(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 1, 0, :4].tolist() == [127, 2, -4, 0]  # half to even
    back = tllama.dequantize_kv(tq, ts, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jllama.dequantize_kv(jq, js, jnp.float32)))


def _pool_kv(pool, table, n_pages):
    """One slot's pages in token order: [L, n*page, Hkv, X]."""
    pages = np.asarray(pool)[:, np.asarray(table[:n_pages])]
    L, n, Hkv, pg, X = pages.shape
    return pages.transpose(0, 1, 3, 2, 4).reshape(L, n * pg, Hkv, X)


def test_write_pages_q_gives_identical_pools(models):
    from gofr_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache
    from gofr_tpu_torch.serving.kv_cache import PagedKVCache

    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(5)
    slab_k = rng.standard_normal((jcfg.n_layers, 12, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    slab_v = rng.standard_normal(slab_k.shape).astype(np.float32) * 0.3
    jc = JPagedKVCache(jcfg, num_pages=8, page_size=8, max_slots=2, max_seq_len=32, kv_dtype="int8")
    tc = PagedKVCache(tcfg, num_pages=8, page_size=8, max_slots=2, max_seq_len=32,
                      device=torch.device("cpu"), kv_dtype="int8")
    assert tc.quantized and tc.k_pool.dtype == torch.int8
    assert tuple(tc.ks_pool.shape) == tuple(jc.ks_pool.shape) == (2, 9, 2, 8, 1)
    for c in (jc, tc):
        c.alloc_slot(1, seq_id=7, prompt_len=10, reserve_tokens=12)
    jc.write_prefill(1, jnp.asarray(slab_k), jnp.asarray(slab_v))
    tc.write_prefill(1, torch.from_numpy(slab_k), torch.from_numpy(slab_v))
    for jp, tp in zip((jc.k_pool, jc.v_pool, jc.ks_pool, jc.vs_pool), tc.pools()):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    got = _pool_kv(tc.ks_pool.numpy(), tc.tables[1], 2)
    np.testing.assert_array_equal(got[:, 12:], np.float32(1e-8))  # page padding: zero vectors


def test_decode_step_paged_q_logits_and_pools_over_8_steps(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    L, Hkv, Dh, page, n_pages = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim, 4, 12
    shape = (L, n_pages + 1, Hkv, page, Dh)  # last page: trash
    kq, ks = jllama.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    vq, vs = jllama.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.5))
    pools = [np.asarray(a) for a in (kq, vq, ks[..., None], vs[..., None])]
    tables = np.array([[3, 7, 1, 0], [5, 2, 9, 11], [4, 6, 8, 10]], np.int32)
    seq = np.array([5, 2, 7], np.int32)  # resident before each row's token
    active = np.array([True, True, False])  # row 2 frozen: writes go to the trash page
    tokens = rng.integers(3, jcfg.vocab_size, 3).astype(np.int32)
    jpools = [jnp.asarray(a) for a in pools]
    tpools = [torch.from_numpy(a.copy()) for a in pools]
    for step in range(8):
        step_len = np.where(active, seq + 1 + step, 1).astype(np.int32)
        want, *jpools = jllama.decode_step_paged_q(
            jcfg, jparams, jnp.asarray(tokens), *jpools, jnp.asarray(tables),
            jnp.asarray(step_len), jnp.asarray(active),
        )
        got, *tpools = tllama.decode_step_paged_q(
            tcfg, tparams, torch.from_numpy(tokens).long(), *tpools, torch.from_numpy(tables),
            torch.from_numpy(step_len), torch.from_numpy(active),
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
        tokens = np.asarray(want).argmax(-1).astype(np.int32)
    live = slice(0, n_pages)  # every page but the trash page
    for j, t in zip(jpools[:2], tpools[:2]):
        np.testing.assert_array_equal(t.numpy()[:, live], np.asarray(j)[:, live])
    for j, t in zip(jpools[2:], tpools[2:]):
        np.testing.assert_allclose(t.numpy()[:, live], np.asarray(j)[:, live], rtol=1e-6, atol=0)
    for t, p in zip(tpools, pools):  # the frozen row never touched its own pages
        np.testing.assert_array_equal(t[:, tables[2]].numpy(), p[:, tables[2]])


def test_decode_block_paged_q_packed_output_matches_reference(models):
    """Greedy rows give the reference's packed [B, N+2] array over int8
    pools: one row spends its budget mid-block, one is inactive."""
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(6)
    B, N, page, n_pages = 3, 4, 8, 10
    shape = (jcfg.n_layers, n_pages + 1, jcfg.n_kv_heads, page, jcfg.head_dim)
    kq, ks = jllama.quantize_kv(jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    pools = [np.asarray(a) for a in (kq, kq, ks[..., None], ks[..., None])]
    tables = np.array([[1, 4, 0], [2, 5, 7], [3, 6, 8]], np.int32)
    host = dict(
        last_token=np.array([40, 41, 42], np.int32), seq_len=np.array([6, 9, 3], np.int32),
        done=np.zeros(B, bool), budget=np.array([10, 2, 10], np.int32),
        stop_tok=np.full(B, -1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
    )
    active = np.array([True, True, False])
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0))
    want = jbatch.decode_block_paged_q(
        jcfg, jparams, *(jnp.asarray(a) for a in pools), jstate, jnp.asarray(tables),
        jnp.asarray(active), N,
    )[0]
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0),
                                      device=torch.device("cpu"))
    got = tbatch.decode_block_paged_q(
        tcfg, tparams, *(torch.from_numpy(a.copy()) for a in pools), tstate,
        torch.from_numpy(tables), torch.from_numpy(active), N,
    )[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(np.asarray(want)[1, N:]) == [1, 2]  # budget spent: done after 2 tokens
