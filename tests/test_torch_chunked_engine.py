"""The port's engine with chunked prefill and int8 KV against the JAX
ServingEngine, on the CPU at the tiny f32 size.

Both engines run the paged layout with 8-token pages, buckets (16, 32) and
16-token chunks, so prompts of at most 16 tokens prefill whole (flash
prefill's plain version) and longer ones, one of them past the largest
bucket, chunk through the unified ragged dispatch. Greedy completions and
finish reasons must be identical for bf16 and int8 pools. Within the port:
the chunked and monolithic routes give equal greedy tokens and the same
first sampled token (both routes seed the first draw with (seed, request
id)), and a pool too tight for two prompts at once requeues a cursor from
chunk 0 and still serves every request, with the tokens a roomy pool gives.
"""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

ENGINE = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32), kv_page_size=8,
              prefill_chunk_tokens=16, kv_layout="paged")
PROMPTS = [
    "hi",  # 3 tokens: monolithic
    "the quick brown fox jumps over",  # 31: chunked (> one chunk)
    "0123456789abcde",  # 16: monolithic (exactly one chunk)
    "a prompt longer than every prefill bucket",  # 42: chunked, > bucket 32
    "GOFR chunks it",  # 15: monolithic
]


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
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


def _port_engine(tcfg, tparams, seed=0, **kw):
    return ServingEngine(
        tcfg, tparams, EngineConfig(**{**ENGINE, **kw}), ByteTokenizer(), seed=seed, device="cpu"
    )


def _run(engine, prompts, **kw):
    engine.start()
    try:
        futs = [engine.submit(p, **kw) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.stop()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunked_greedy_tokens_match_jax_engine(models, kv_dtype):
    jcfg, jparams, tcfg, tparams = models
    jeng = JServingEngine(
        jcfg, jparams, JEngineConfig(**ENGINE, kv_dtype=kv_dtype),
        JByteTokenizer(),
    )
    want = _run(jeng, PROMPTS, max_new_tokens=12)
    port = _port_engine(tcfg, tparams, kv_dtype=kv_dtype)
    assert [port._route_chunked(len(ByteTokenizer().encode(p))) for p in PROMPTS] == [
        False, True, False, True, False]
    got = _run(port, PROMPTS, max_new_tokens=12)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.text, w.text)
        assert g.finish_reason == w.finish_reason
        assert (g.prompt_tokens, g.completion_tokens) == (w.prompt_tokens, w.completion_tokens)


def test_chunked_and_monolithic_routes_agree(models):
    """Greedy tokens are equal on both routes, and a sampled request draws
    the same first token (the ragged dispatch seeds its draw as the
    monolithic prefill does)."""
    _, _, tcfg, tparams = models
    prompts = PROMPTS[:2] + ["x" * 30]
    mono_eng = _port_engine(tcfg, tparams, prefill_chunk_tokens=64)  # chunk >= every bucket
    chunk_eng = _port_engine(tcfg, tparams, prefill_chunk_tokens=8)
    assert not any(mono_eng._route_chunked(n) for n in (3, 31))
    assert chunk_eng._route_chunked(31) and not chunk_eng._route_chunked(8)
    mono = _run(mono_eng, prompts, max_new_tokens=10)
    chunked = _run(chunk_eng, prompts, max_new_tokens=10)
    assert [r.token_ids for r in chunked] == [r.token_ids for r in mono]
    sampled = dict(max_new_tokens=3, temperature=0.9, top_k=20)
    firsts = [
        _run(_port_engine(tcfg, tparams, seed=5, prefill_chunk_tokens=c), ["sample me " * 3],
             **sampled)[0].token_ids[0]
        for c in (64, 8)
    ]
    assert firsts[0] == firsts[1]


def test_tight_pool_requeues_a_cursor_and_finishes_every_request(models):
    """Six 8-token pages for two 31-token prompts: the first cursor takes
    four, the second cannot cover its chunks, requeues from chunk 0 once
    nothing of it is in flight, and is served after the first retires."""
    _, _, tcfg, tparams = models
    prompts = ["the quick brown fox jumps over", "a second prompt that also chunks"]
    engine = _port_engine(tcfg, tparams, max_slots=2, kv_num_pages=6, prefill_chunk_tokens=8)
    requeues = []
    health = engine._cursor_health

    def counting_health(slot, req, cursor):
        if cursor.blocked and cursor.in_flight == 0:
            requeues.append(req.id)
        health(slot, req, cursor)

    engine._cursor_health = counting_health
    tight = _run(engine, prompts, max_new_tokens=6)
    assert requeues, "no cursor was requeued"
    roomy = _run(_port_engine(tcfg, tparams, max_slots=2, prefill_chunk_tokens=8), prompts,
                 max_new_tokens=6)
    for t, r in zip(tight, roomy):
        assert t.finish_reason in ("length", "stop")
        assert t.token_ids == r.token_ids
    assert engine.paged_cache.stats()["free_blocks"] == 6


def test_cursor_slot_stays_frozen_in_a_cold_device_state(models):
    """A device state rebuilt from the host mirrors (first dispatch, or
    after a failure) keeps a mid-prefill row frozen."""
    _, _, tcfg, tparams = models
    from gofr_tpu_torch.serving.engine import _Request

    engine = _port_engine(tcfg, tparams)
    engine._start_cursor(1, _Request(99, list(range(3, 40)), 4, 0.0, 0, 1.0, None, {2}))
    state = engine._make_device_state()
    assert bool(state.done[1]) and int(state.budget[1]) == 0
    engine.stop()


def test_int8_pool_bytes_per_token(models):
    """The tiny model's f32 pools against int8 pools: Dh bytes plus one f32
    scale per token, kv head and k/v, against 4*Dh (2*Dh at bf16)."""
    _, _, tcfg, tparams = models
    sizes = {}
    for kv_dtype in ("bf16", "int8"):
        pc = _port_engine(tcfg, tparams, kv_dtype=kv_dtype).paged_cache
        sizes[kv_dtype] = sum(t.numel() * t.element_size() for t in pc.pools() if t is not None)
    Dh = tcfg.head_dim
    assert sizes["int8"] * 4 * Dh == sizes["bf16"] * (Dh + 4)
