"""The port's ServingEngine on the CPU against the JAX ServingEngine.

Same tiny params (made by the JAX package, carried across). The paged
layout with 8-token pages serves prompts that fit one monolithic bucket on
both sides (the JAX side gets ``prefill_chunk_tokens`` above its largest
bucket so it does not chunk). The dense layout, the reference's default,
serves a mix that prefills whole and in 16-token chunks against a
``max_seq_len`` of 60 that the chunk does not divide (a final chunk's
tail crosses the end), over bf16 and int8 KV and once with weight-only
int8 params. Greedy completions must be identical token for token, with
the same finish reasons. Sampled rows are held to determinism per seed and
to ``top_k=1`` being greedy: the port's draws do not reproduce
jax.random's bits.
"""

import asyncio
import importlib

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
from gofr_tpu_torch.errors import (  # noqa: E402
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
)
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

PROMPTS = [
    "hello paged world",
    "a",
    "the quick brown fox jumps over",
    "GOFR serves tokens",
    "0123456789",
]
ENGINE = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32), kv_page_size=8,
              kv_layout="paged")
DENSE = dict(max_slots=4, max_seq_len=60, prefill_buckets=(16, 32), kv_layout="dense",
             prefill_chunk_tokens=16)
DENSE_PROMPTS = [
    "hi",  # 3 tokens: whole
    "the quick brown fox jumps over",  # 31: two chunks
    "0123456789abcde",  # 16: whole (exactly one chunk)
    "a prompt longer than every prefill bucket",  # 42: three chunks, > bucket 32
    "a prompt whose final chunk runs past the end!",  # 46
    "x" * 51,  # 52 tokens: the fourth chunk at 48 runs past max_seq_len 60
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
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


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


def test_greedy_tokens_match_jax_engine(models):
    jcfg, jparams, tcfg, tparams = models
    jeng = JServingEngine(
        jcfg, jparams,
        JEngineConfig(**ENGINE, prefill_chunk_tokens=64),
        JByteTokenizer(),
    )
    want = _run(jeng, PROMPTS, max_new_tokens=16)
    got = _run(_port_engine(tcfg, tparams), PROMPTS, max_new_tokens=16)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.text, w.text)
        assert g.finish_reason == w.finish_reason
        assert g.prompt_tokens == w.prompt_tokens
        assert g.completion_tokens == w.completion_tokens


@pytest.mark.parametrize("multi_step", [1, 3])
def test_block_size_does_not_change_greedy_tokens(models, multi_step):
    _, _, tcfg, tparams = models
    base = _run(_port_engine(tcfg, tparams), PROMPTS[:3], max_new_tokens=12)
    other = _run(_port_engine(tcfg, tparams, multi_step=multi_step), PROMPTS[:3], max_new_tokens=12)
    assert [r.token_ids for r in other] == [r.token_ids for r in base]


def test_sampled_rows_are_deterministic_per_seed_and_top_k_one_is_greedy(models):
    _, _, tcfg, tparams = models
    kw = dict(max_new_tokens=12, temperature=0.9, top_p=0.95)
    first = _run(_port_engine(tcfg, tparams, seed=7), ["sample this"], **kw)[0]
    again = _run(_port_engine(tcfg, tparams, seed=7), ["sample this"], **kw)[0]
    assert again.token_ids == first.token_ids
    greedy = _run(_port_engine(tcfg, tparams), ["sample this"], max_new_tokens=12)[0]
    top1 = _run(
        _port_engine(tcfg, tparams, seed=3), ["sample this"],
        max_new_tokens=12, temperature=0.9, top_k=1,
    )[0]
    assert top1.token_ids == greedy.token_ids


def test_small_pool_exhaustion_finishes_every_request(models):
    _, _, tcfg, tparams = models
    results = _run(_port_engine(tcfg, tparams, kv_num_pages=6), ["abcdefghij"] * 5, max_new_tokens=12)
    for r in results:
        assert r.finish_reason in ("stop", "length", "kv_exhausted")
        assert r.completion_tokens > 0 or r.finish_reason == "stop"


def test_streaming_and_lifecycle(models):
    _, _, tcfg, tparams = models
    seen = []
    engine = _port_engine(tcfg, tparams)
    engine.start()
    try:
        fut = engine.submit(
            "stream", max_new_tokens=6, stream_cb=lambda tid, piece, done: seen.append((tid, done))
        )
        res = fut.result(timeout=60)
        again = asyncio.run(engine.generate("stream", max_new_tokens=6))
    finally:
        engine.stop()
    assert again.token_ids == res.token_ids
    assert seen[-1] == (-1, True)
    assert [t for t, _ in seen[:-1]] == res.token_ids
    assert res.ttft_s > 0 and res.duration_s >= res.ttft_s
    with pytest.raises(ErrorServiceUnavailable) as err:
        engine.submit("late")
    assert err.value.status_code == 503 and err.value.retry_after == 1.0


def test_refusals(models):
    """A prompt of max_seq_len tokens or more is served from its tail (the
    last max_seq_len - 1 tokens, one position left to generate); past the
    largest bucket it chunks instead. Only a prompt the whole pool can
    never hold is refused, at admission, with a 413 on its future."""
    _, _, tcfg, tparams = models
    engine = _port_engine(tcfg, tparams)
    engine.submit(list(range(3, 67)))  # 64 tokens = max_seq_len: the tail is kept
    with engine._count_lock:
        kept = [r.prompt_ids for r in engine._by_id.values()]
    assert kept == [list(range(4, 67))] and engine._route_chunked(63)
    engine.submit(list(range(3, 66)))  # 63 tokens > largest bucket 32: accepted
    small = _port_engine(tcfg, tparams, kv_num_pages=3)
    small.start()
    try:
        fut = small.submit(list(range(3, 28)))  # 25 tokens, bucket 32: 4 pages
        with pytest.raises(ErrorRequestEntityTooLarge, match="KV pages"):
            fut.result(timeout=60)
    finally:
        small.stop()
    assert small._sched.stats()["busy_slots"] == 0
    with pytest.raises(ValueError, match="kv_dtype"):
        _port_engine(tcfg, tparams, kv_dtype="fp8")
    with pytest.raises(ValueError, match="empty"):
        engine.submit([])
    with pytest.raises(ValueError, match="kv_layout"):
        _port_engine(tcfg, tparams, kv_layout="ragged")
    # a dense slot row holds any prompt that fits max_seq_len: no page check
    assert not _port_engine(tcfg, tparams, kv_layout="dense").submit(list(range(3, 28))).done()
    engine.stop()


@pytest.mark.parametrize("kv_dtype,int8_weights", [("bf16", False), ("int8", False), ("bf16", True)],
                         ids=["bf16", "int8", "int8-weights"])
def test_dense_greedy_tokens_match_jax_engine(models, kv_dtype, int8_weights):
    """The reference's default layout: monolithic and chunked prompts, a
    final chunk crossing max_seq_len, rows frozen mid-prefill beside
    decode rows, bf16 or int8 KV, and once weight-only int8 params (the
    reference's quantized tree carried across, beside the port's own
    ``quantize_params`` of the same weights)."""
    jcfg, jparams, tcfg, tparams = models
    if int8_weights:
        jparams = jllama.quantize_params(jparams)
        tparams = tllama.quantize_params(tparams)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**DENSE, kv_dtype=kv_dtype), JByteTokenizer())
    want = _run(jeng, DENSE_PROMPTS, max_new_tokens=12)
    port = ServingEngine(tcfg, tparams, EngineConfig(**DENSE, kv_dtype=kv_dtype), ByteTokenizer(),
                         device="cpu")
    assert port.paged_cache is None and port.cache.quantized == (kv_dtype == "int8")
    assert port._chunk_tokens == 16 and 60 % 16  # not aligned to any page grid
    assert [port._route_chunked(len(ByteTokenizer().encode(p))) for p in DENSE_PROMPTS] == [
        False, True, False, True, True, True]
    got = _run(port, DENSE_PROMPTS, max_new_tokens=12)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids, (g.text, w.text)
        assert g.finish_reason == w.finish_reason
        assert (g.prompt_tokens, g.completion_tokens) == (w.prompt_tokens, w.completion_tokens)
    assert got[-1].completion_tokens == 60 - 52 and got[-1].finish_reason == "length"


def test_dense_is_the_default_layout(models):
    _, _, tcfg, tparams = models
    assert EngineConfig().kv_layout == JEngineConfig().kv_layout == "dense"
    engine = _port_engine(tcfg, tparams, kv_layout=EngineConfig().kv_layout)
    assert engine.paged_cache is None and tuple(engine.cache.k.shape) == (
        tcfg.n_layers, 4, 64, tcfg.n_kv_heads, tcfg.head_dim)
    engine.stop()


def test_block_allocator_semantics_match_reference():
    from gofr_tpu.native.fallback import OutOfBlocks as JOutOfBlocks
    from gofr_tpu.native.fallback import PyBlockAllocator
    from gofr_tpu_torch.serving.block_alloc import BlockAllocator, OutOfBlocks

    mine, ref = BlockAllocator(6, 4), PyBlockAllocator(6, 4)
    for a in (mine, ref):
        a.alloc(1, 5)
        a.alloc(2, 4)
        a.extend(1, 9)
    assert mine.block_table(1) == ref.block_table(1)
    assert mine.seq_length(1) == ref.seq_length(1) == 9
    with pytest.raises(OutOfBlocks):
        mine.alloc(3, 9)
    with pytest.raises(JOutOfBlocks):
        ref.alloc(3, 9)
    with pytest.raises(OutOfBlocks):
        mine.extend(2, 17)
    with pytest.raises(JOutOfBlocks):
        ref.extend(2, 17)
    assert mine.block_table(2) == ref.block_table(2)  # a refusal changes nothing
    for a in (mine, ref):
        a.free(1)
    assert mine.stats() == ref.stats()


def _slot_kv(pool, table, n_pages, page):
    """One slot's K/V in token order, read through its block table."""
    pages = np.asarray(pool)[:, np.asarray(table[:n_pages])]  # [L, n, Hkv, page, Dh]
    L, n, Hkv, pg, Dh = pages.shape
    return pages.transpose(0, 1, 3, 2, 4).reshape(L, n * pg, Hkv, Dh)


def test_paged_cache_prefill_scatter_matches_reference(models):
    from gofr_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache
    from gofr_tpu_torch.serving.kv_cache import PagedKVCache

    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(5)
    slab_k = rng.standard_normal((jcfg.n_layers, 12, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    slab_v = rng.standard_normal(slab_k.shape).astype(np.float32)
    jc = JPagedKVCache(jcfg, num_pages=8, page_size=8, max_slots=2, max_seq_len=32)
    tc = PagedKVCache(tcfg, num_pages=8, page_size=8, max_slots=2, max_seq_len=32, device=torch.device("cpu"))
    for c in (jc, tc):
        c.alloc_slot(1, seq_id=7, prompt_len=10, reserve_tokens=12)
    jc.write_prefill(1, jnp.asarray(slab_k), jnp.asarray(slab_v))
    tc.write_prefill(1, torch.from_numpy(slab_k), torch.from_numpy(slab_v))
    np.testing.assert_array_equal(tc.seq_lens, jc.seq_lens)
    for jp, tp in ((jc.k_pool, tc.k_pool), (jc.v_pool, tc.v_pool)):
        want = _slot_kv(jp, jc.tables[1], 2, 8)
        got = _slot_kv(tp.numpy(), tc.tables[1], 2, 8)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:, 12:], 0)  # page padding is zeros
    assert tc.try_reserve_slot(1, 20) and len(tc.allocator.block_table(7)) == 4
    with pytest.raises(KeyError):
        tc.try_reserve_slot(0, 1)  # a free slot has nothing to extend
    tc.free_slot(1)
    assert tc.stats()["free_blocks"] == 8


def test_decode_block_packed_output_matches_reference(models):
    """Greedy rows give identical packed [B, N+2] arrays and pools: one row
    spends its budget mid-block, one is inactive (trash-page writes)."""
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(6)
    B, N, page, n_pages = 3, 4, 8, 10
    shape = (jcfg.n_layers, n_pages + 1, jcfg.n_kv_heads, page, jcfg.head_dim)
    pool = rng.standard_normal(shape).astype(np.float32) * 0.5
    tables = np.array([[1, 4, 0], [2, 5, 7], [3, 6, 8]], np.int32)
    host = dict(
        last_token=np.array([40, 41, 42], np.int32), seq_len=np.array([6, 9, 3], np.int32),
        done=np.zeros(B, bool), budget=np.array([10, 2, 10], np.int32),
        stop_tok=np.full(B, -1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
    )
    active = np.array([True, True, False])
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0))
    want, jk, jv, _ = jbatch.decode_block_paged(
        jcfg, jparams, jnp.asarray(pool), jnp.asarray(pool), jstate, jnp.asarray(tables),
        jnp.asarray(active), N,
    )
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0),
                                      device=torch.device("cpu"))
    got, tk, tv, _ = tbatch.decode_block_paged(
        tcfg, tparams, torch.from_numpy(pool.copy()), torch.from_numpy(pool.copy()), tstate,
        torch.from_numpy(tables), torch.from_numpy(active), N,
    )
    assert got.dtype == torch.int32 and got.shape == (B, N + 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-4)
    assert list(np.asarray(want)[1, N:]) == [1, 2]  # budget spent: done after 2 tokens
    assert list(np.asarray(want)[2]) == [-1] * N + [0, 0]  # inactive row


def test_pad_bucket():
    from gofr_tpu_torch.serving.batch import pad_bucket

    assert [pad_bucket(n, (16, 32)) for n in (1, 16, 17, 32, 40)] == [16, 16, 32, 32, 32]


def test_prefill_first_token_matches_dense_argmax(models):
    """The engine's first greedy token is the argmax of a plain prefill."""
    _, _, tcfg, tparams = models
    ids = ByteTokenizer().encode("first token")
    cache = tllama.KVCache.create(tcfg, 1, max_len=16, device="cpu")
    logits, _ = tllama.prefill(
        tcfg, tparams, torch.tensor([ids + [0] * (16 - len(ids))]), cache,
        torch.tensor([len(ids)], dtype=torch.int32),
    )
    res = _run(_port_engine(tcfg, tparams), [ids], max_new_tokens=1)[0]
    assert res.token_ids == [int(np.argmax(logits[0].numpy()))] or res.finish_reason == "stop"
