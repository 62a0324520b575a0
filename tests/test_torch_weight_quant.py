"""Weight-only int8 of the port against the JAX package, on the CPU at the
tiny f32 size.

- ``quantize_weight``: int8 values identical and f32 scales bit-identical
  to the reference as every caller reaches it, jitted (XLA turns
  ``amax / 127`` into a product with f32(1/127)), for a plain and a
  stacked [L, ...] weight in f32 and bf16, with an all-zero output channel
  (the 1e-12 floor) and exact .5 ties;
- ``quantize_params``: the same keys quantized as the reference, the rest
  kept, and a second pass changes nothing;
- ``_mm`` and ``_logits`` over ``{"q", "s"}`` weights within 1e-5
  relative;
- ``init_params(quantize=True)``: shapes and dtypes, and the weights
  ``quantize_params`` makes of the unquantized draw of the same seed;
- ``param_count`` (scales excluded) and ``param_bytes``, equal to the
  reference's over the same tree;
- ``params_from_jax`` carries a quantized tree bit for bit;
- greedy generation with int8 weights gives the reference's tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402

REL = 1e-5


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
    jparams = jllama.quantize_params(jllama.init_params(jcfg, jax.random.PRNGKey(5)))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), params_from_jax(jax.device_get(jparams), device="cpu")


def _weight(shape):
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32) * 0.2
    w[..., 3] = 0.0  # an all-zero output channel: scale 1e-12, values 0
    w[..., :4, 5] = [127.0, 2.5, -3.5, 0.5]  # absmax 127: ties at .5 after the division
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96)], ids=["plain", "stacked"])
def test_quantize_weight_is_bit_identical_to_the_jitted_reference(shape, dtype):
    w = _weight(shape)
    want = jllama.quantize_weight(jnp.asarray(w, getattr(jnp, dtype)), axis=-2)
    got = tllama.quantize_weight(torch.from_numpy(w).to(getattr(torch, dtype)), axis=-2)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert tuple(got["s"].shape) == want["s"].shape == shape[:-2] + shape[-1:]
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert (got["s"][..., 3] == np.float32(1e-12)).all() and not got["q"][..., 3].any()
    assert got["q"][..., :4, 5].reshape(-1, 4)[0].tolist() == [127, 2, -4, 0]  # half to even


def test_quantize_params_keys_and_idempotence():
    jcfg = jllama.LlamaConfig.tiny()
    jraw = jllama.init_params(jcfg, jax.random.PRNGKey(6))
    raw = params_from_jax(jax.device_get(jraw), device="cpu")
    want = jllama.quantize_params(jraw)
    got = tllama.quantize_params(raw)
    assert jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, want)) == \
        jax.tree_util.tree_structure(jax.tree.map(lambda _: 0, got))
    quantized = {k for k, v in got["layers"].items() if isinstance(v, dict)}
    assert quantized == set(tllama._QUANT_KEYS) and isinstance(got["lm_head"], dict)
    for key in ("attn_norm", "mlp_norm"):
        assert got["layers"][key] is raw["layers"][key]
    assert got["embedding"] is raw["embedding"] and got["final_norm"] is raw["final_norm"]
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=str(path))
    again = tllama.quantize_params(got)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(got)):
        assert a is b


def test_mm_and_logits_over_int8_weights(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    jw = {k: v[1] for k, v in jparams["layers"]["w_gate"].items()}
    tw = tllama.layer_params(tparams, 1)["w_gate"]
    assert set(tw) == {"q", "s"} and tw["q"].dtype == torch.int8
    want = jllama._mm(jnp.asarray(x), jw)
    got = tllama._mm(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL, atol=REL)
    want = jllama._logits(jcfg, jparams, jnp.asarray(x))
    got = tllama._logits(tcfg, tparams, torch.from_numpy(x))
    assert got.shape == (2, 5, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL, atol=REL)


def test_init_params_quantize_shapes_dtypes_and_draws():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.bfloat16)
    q = tllama.init_params(cfg, torch.Generator().manual_seed(2), device="cpu", quantize=True)
    raw = tllama.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    L, D, Fd, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    widths = {"wq": (D, D), "wk": (D, 32), "wv": (D, 32), "wo": (D, D), "w_gate": (D, Fd),
              "w_up": (D, Fd), "w_down": (Fd, D)}
    for key, (k_in, n_out) in widths.items():
        leaf = q["layers"][key]
        assert leaf["q"].dtype == torch.int8 and tuple(leaf["q"].shape) == (L, k_in, n_out)
        assert leaf["s"].dtype == torch.float32 and tuple(leaf["s"].shape) == (L, n_out)
    assert tuple(q["lm_head"]["q"].shape) == (D, V) and tuple(q["lm_head"]["s"].shape) == (V,)
    assert q["embedding"].dtype == torch.bfloat16 and q["layers"]["attn_norm"].dtype == torch.float32
    for a, b in zip(jax.tree.leaves(q), jax.tree.leaves(tllama.quantize_params(raw))):
        assert torch.equal(a, b)


def test_param_count_and_bytes_match_reference(models):
    jcfg, jparams, _, tparams = models
    assert tllama.param_count(tparams) == jllama.param_count(jparams)
    assert tllama.param_bytes(tparams) == jllama.param_bytes(jparams)
    raw = jllama.init_params(jcfg, jax.random.PRNGKey(7))
    traw = params_from_jax(jax.device_get(raw), device="cpu")
    assert tllama.param_count(traw) == jllama.param_count(raw) == tllama.param_count(tparams)
    assert tllama.param_bytes(traw) == jllama.param_bytes(raw)
    assert tllama.param_bytes(tparams) < tllama.param_bytes(traw)


def test_params_from_jax_carries_a_quantized_tree(models):
    _, jparams, _, tparams = models
    for (path, j), t in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree.leaves(tparams)):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype, path
        np.testing.assert_array_equal(t.numpy(), j)


def test_greedy_generate_with_int8_weights_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, jcfg.vocab_size, (2, 9)).astype(np.int32)
    lens = np.array([9, 5], np.int32)
    want = jllama.greedy_generate(jcfg, jparams, jnp.asarray(prompt), jnp.asarray(lens), 6)
    got = tllama.greedy_generate(tcfg, tparams, torch.from_numpy(prompt).long(), torch.from_numpy(lens), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
