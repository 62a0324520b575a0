"""The port's Llama serving half against the JAX model, on the tiny f32
config with the JAX package's own params carried across by
``params_from_jax``.

Prefill logits and K/V slabs, then 8 steps of ``decode_step_paged``
(logits and both pools, with an inactive row writing the trash page), are
held with allclose at 1e-4 (f32 on both sides; summation order differs and
the error grows over layers and steps).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax, tensor_from_numpy  # noqa: E402

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
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tllama.LlamaConfig.tiny()
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL, rtol=TOL)


def test_params_bridge_keeps_tree_shapes_and_bf16_bits():
    jparams = jax.device_get(jllama.init_params(jllama.LlamaConfig.tiny(dtype=jnp.bfloat16),
                                                jax.random.PRNGKey(2)))
    tparams = params_from_jax(jparams, device="cpu")
    assert tparams.keys() == jparams.keys()
    assert tparams["layers"].keys() == jparams["layers"].keys()
    for name, leaf in jparams["layers"].items():
        assert tuple(tparams["layers"][name].shape) == leaf.shape  # stacked [L, ...]
    emb = tparams["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.view(torch.int16).numpy().view(np.uint16), np.asarray(jparams["embedding"]).view(np.uint16)
    )
    assert tensor_from_numpy(np.arange(3, dtype=np.int32), torch.device("cpu")).dtype == torch.int32


def test_init_params_matches_reference_tree():
    cfg = tllama.LlamaConfig.tiny()
    tparams = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda: jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.PRNGKey(0)))
    flat_t = {k: v for k, v in tparams.items() if k != "layers"} | tparams["layers"]
    flat_j = {k: v for k, v in jshapes.items() if k != "layers"} | jshapes["layers"]
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k


def test_prefill_logits_and_slabs(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(0)
    S = 16
    tokens = rng.integers(3, jcfg.vocab_size, (2, S)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    tokens[1, 9:] = 0  # right padding
    cache = jllama.KVCache.create(jcfg, 2, max_len=S)
    want, cache = jllama.prefill(jcfg, jparams, jnp.asarray(tokens), cache, jnp.asarray(lens))
    got, k_slab, v_slab = tllama._prefill_slabs(tcfg, tparams, torch.from_numpy(tokens).long(),
                                                torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (2, jcfg.vocab_size)
    _close(got, want)
    _close(k_slab, cache.k)
    _close(v_slab, cache.v)


def test_decode_step_paged_logits_and_pools_over_8_steps(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    L, Hkv, Dh, page, n_pages = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim, 4, 12
    shape = (L, n_pages + 1, Hkv, page, Dh)  # last page: trash
    pool_k = rng.standard_normal(shape).astype(np.float32) * 0.5
    pool_v = rng.standard_normal(shape).astype(np.float32) * 0.5
    tables = np.array([[3, 7, 1, 0], [5, 2, 9, 11], [4, 6, 8, 10]], np.int32)
    seq = np.array([5, 2, 7], np.int32)  # resident before each row's token
    active = np.array([True, True, False])  # row 2 frozen: writes go to the trash page
    tokens = rng.integers(3, jcfg.vocab_size, 3).astype(np.int32)
    jk, jv = jnp.asarray(pool_k), jnp.asarray(pool_v)
    tk, tv = torch.from_numpy(pool_k.copy()), torch.from_numpy(pool_v.copy())
    for step in range(8):
        step_len = np.where(active, seq + 1 + step, 1).astype(np.int32)
        want, jk, jv = jllama.decode_step_paged(
            jcfg, jparams, jnp.asarray(tokens), jk, jv, jnp.asarray(tables),
            jnp.asarray(step_len), jnp.asarray(active),
        )
        got, tk, tv = tllama.decode_step_paged(
            tcfg, tparams, torch.from_numpy(tokens).long(), tk, tv, torch.from_numpy(tables),
            torch.from_numpy(step_len), torch.from_numpy(active),
        )
        _close(got, want)
        tokens = np.asarray(want).argmax(-1).astype(np.int32)
    _close(tk, jk)
    _close(tv, jv)
    # the frozen row never touched its own pages
    np.testing.assert_array_equal(tk[:, tables[2]].numpy(), pool_k[:, tables[2]])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["model-dtype", "int8"])
def test_prefill_into_cache_matches_jitted_reference(models, kv_dtype):
    """``llama.prefill(cfg, params, tokens, cache, seq_lens)`` against the
    reference's jitted ``prefill`` over a cache with more rows (3) and
    positions (24) than the prompt batch (2 x 16): logits within 1e-4;
    full-precision K/V within 4e-6 (f32 GEMM summation order: layer 0
    already differs by ~6e-7); int8 values identical, and values and
    scales bit-identical to the jitted ``quantize_kv`` of the port's own
    full-precision K/V; rows past B and positions past S untouched."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    B, S, rows, positions = 2, 16, 3, 24
    tokens = rng.integers(3, jcfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.array([16, 9], np.int32)
    tokens[1, 9:] = 0  # right padding
    jcache = jllama.KVCache.create(jcfg, rows, max_len=positions, kv_dtype=kv_dtype)
    want, jcache = jax.jit(jllama.prefill, static_argnums=0)(
        jcfg, jparams, jnp.asarray(tokens), jcache, jnp.asarray(lens))
    tcache = tllama.KVCache.create(tcfg, rows, max_len=positions, kv_dtype=kv_dtype, device="cpu")
    for t in tcache.tensors():  # what is already there must survive
        if t is not None:
            t.copy_(torch.from_numpy(rng.integers(-50, 50, t.shape)).to(t.dtype))
    before = [None if t is None else t.clone() for t in tcache.tensors()]
    got, out = tllama.prefill(tcfg, tparams, torch.from_numpy(tokens).long(), tcache,
                              torch.from_numpy(lens))
    assert out is tcache and got.shape == (B, jcfg.vocab_size)
    _close(got, want)
    for t, old in zip(tcache.tensors(), before):
        if t is None:
            continue
        assert torch.equal(t[:, B:], old[:, B:]), "a row past B changed"
        assert torch.equal(t[:, :, S:], old[:, :, S:]), "a position past S changed"
    jk, jv = np.asarray(jcache.k)[:, :B, :S], np.asarray(jcache.v)[:, :B, :S]
    if kv_dtype is None:
        for t, w in ((tcache.k, jk), (tcache.v, jv)):
            np.testing.assert_allclose(t[:, :B, :S].numpy(), w, atol=4e-6, rtol=4e-6)
        return
    np.testing.assert_array_equal(tcache.k[:, :B, :S].numpy(), jk)
    np.testing.assert_array_equal(tcache.v[:, :B, :S].numpy(), jv)
    full = tllama.KVCache.create(tcfg, B, max_len=S, device="cpu")
    tllama.prefill(tcfg, tparams, torch.from_numpy(tokens).long(), full, torch.from_numpy(lens))
    jit_quantize = jax.jit(jllama.quantize_kv)
    for x, q, s, js in ((full.k, tcache.k, tcache.ks, jcache.ks), (full.v, tcache.v, tcache.vs, jcache.vs)):
        wq, ws = jit_quantize(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(q[:, :B, :S].numpy(), np.asarray(wq))
        np.testing.assert_array_equal(s[:, :B, :S].numpy().view(np.uint32), np.asarray(ws).view(np.uint32))
        np.testing.assert_allclose(s[:, :B, :S].numpy(), np.asarray(js)[:, :B, :S], rtol=4e-6)
