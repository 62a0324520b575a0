"""The Llama config fields the loaders set (``tie_embeddings``, ``attn_impl``,
the ``llama3_70b`` preset) and the cache-less ``forward`` in
``gofr_tpu_torch/models/llama.py``, beside the JAX package's at
``LlamaConfig.tiny`` (f32, the JAX params carried across): ``forward``'s
logits within 1e-4, untied and tied; a tied head's logits through prefill,
decode and the serving engine; the prefill's ``attn_impl`` choices equal
on the CPU; ``"cp"`` and any other value refused; the 70B preset's
fields."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

ENGINE = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32), kv_page_size=8)
PROMPTS = ["hi", "the quick brown fox jumps", "a prompt longer than the first bucket"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[False, True], ids=["untied", "tied"])
def models(request):
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300, tie_embeddings=request.param)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300, tie_embeddings=request.param)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _tokens(seed: int, B: int = 2, S: int = 12) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 300, (B, S)).astype(np.int32)


@pytest.mark.parametrize("seed,S", [(0, 12), (1, 1), (2, 40)])
def test_forward_matches_reference(models, seed, S):
    jcfg, jparams, tcfg, tparams = models
    tokens = _tokens(seed, S=S)
    want = np.asarray(jllama.forward(jcfg, jparams, jnp.asarray(tokens)))
    got = tllama.forward(tcfg, tparams, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, S, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_tied_params_hold_no_head(models):
    jcfg, jparams, tcfg, tparams = models
    assert ("lm_head" in tparams) is (not tcfg.tie_embeddings) is ("lm_head" in jparams)
    fresh = tllama.init_params(tcfg, device="cpu")
    assert ("lm_head" in fresh) is (not tcfg.tie_embeddings)
    quantized = tllama.quantize_params(tparams)
    assert ("lm_head" in quantized) is ("lm_head" in jllama.quantize_params(jparams))
    if tcfg.tie_embeddings:  # the embedding stays as it is: the head's weight
        assert quantized["embedding"] is tparams["embedding"]


def test_prefill_and_decode_logits_match_reference(models):
    """Prefill's last-token logits and three decode steps' logits (the tied
    head is ``embedding.T`` on every path)."""
    jcfg, jparams, tcfg, tparams = models
    tokens = _tokens(5, S=16)
    lens = np.array([16, 9], np.int32)
    jcache = jllama.KVCache.create(jcfg, 2, max_len=32)
    tcache = tllama.KVCache.create(tcfg, 2, max_len=32, device="cpu")
    jl, jcache = jllama.prefill(jcfg, jparams, jnp.asarray(tokens), jcache, jnp.asarray(lens))
    tl, tcache = tllama.prefill(tcfg, tparams, torch.from_numpy(tokens).long(), tcache,
                                torch.from_numpy(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    cur = lens.copy()
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        cur = cur + 1
        jl, jcache = jllama.decode_step(jcfg, jparams, jnp.asarray(nxt), jcache,
                                        jnp.asarray(cur))
        tl, tcache = tllama.decode_step(tcfg, tparams, torch.from_numpy(nxt).long(), tcache,
                                        torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)


def test_engine_greedy_tokens_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    results = []
    for engine in (JServingEngine(jcfg, jparams, JEngineConfig(**ENGINE, kv_layout="paged"),
                                  JByteTokenizer()),
                   ServingEngine(tcfg, tparams, EngineConfig(**ENGINE, kv_layout="paged"),
                                 ByteTokenizer(), device="cpu")):
        engine.start()
        try:
            futs = [engine.submit(p, max_new_tokens=8) for p in PROMPTS]
            results.append([f.result(timeout=120).token_ids for f in futs])
        finally:
            engine.stop()
    assert results[1] == results[0]


def test_attn_impl_choices_agree_on_the_cpu(models, monkeypatch):
    """"auto" and "flash" both go through the flash wrapper (its plain
    version on the CPU) in every layer: the same prefill logits and slabs."""
    _, _, tcfg, tparams = models
    calls = []
    real = tllama.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tllama, "flash_attention", counted)
    tokens = torch.from_numpy(_tokens(7, S=16)).long()
    lens = torch.tensor([16, 11], dtype=torch.int32)
    out = {}
    for impl in ("auto", "flash"):
        cfg = dataclasses.replace(tcfg, attn_impl=impl)
        before = len(calls)
        out[impl] = tllama._prefill_slabs(cfg, tparams, tokens, lens)
        assert len(calls) - before == cfg.n_layers
    for got, want in zip(out["flash"], out["auto"]):
        assert torch.equal(got, want)
    assert tflash.flash_attention.launches == 0


def test_attn_impl_cp_and_unknown_values_are_refused():
    with pytest.raises(ValueError, match="item 9"):
        tllama.LlamaConfig.tiny(attn_impl="cp")
    for value in ("dense", "ring"):  # no plain-attention prefill beside the kernel
        with pytest.raises(ValueError, match="auto or flash"):
            tllama.LlamaConfig.tiny(attn_impl=value)
    jllama.LlamaConfig.tiny(attn_impl="cp")  # the reference builds one; its prefill refuses it


def test_llama3_70b_preset_matches_reference():
    ref, port = jllama.LlamaConfig.llama3_70b(), tllama.LlamaConfig.llama3_70b()
    assert ({k: v for k, v in dataclasses.asdict(port).items() if k != "dtype"}
            == {k: v for k, v in dataclasses.asdict(ref).items() if k != "dtype"})
    assert (port.d_model, port.n_layers, port.n_heads, port.n_kv_heads, port.d_ff) == \
        (8192, 80, 64, 8, 28672)
    assert port.head_dim == 128 and port.dtype == torch.bfloat16
    assert tllama.LlamaConfig.llama3_70b(max_seq_len=4096).max_seq_len == 4096
