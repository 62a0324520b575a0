"""The port's KV reuse (the whole-prompt prefix cache, the chunk-prefix cache
and the host spill tier) against the JAX ServingEngine, on the CPU at the
tiny f32 size.

Both engines run 16-token chunks, buckets (16, 32) and 8-token pages with
a 64-entry prefix cache, over the dense and the paged layout with full-
width and int8 KV. One traffic for all four: a short prompt twice (a
whole-prompt hit), a three-chunk prompt twice (a full chain hit on
full-width KV, with zero prefill dispatches), the same prompt extended by
two chunks, then a shared 48-token prefix with distinct one-chunk
suffixes, once alone and then three at once. Greedy tokens and finish
reasons must be identical, both engines must make the same number of
``prefill_compute`` and ragged calls, and both caches must end with the
same keys. Then the pieces bit for bit (``write_span``/``read_span``,
``insert_chunk``), a host-tier hit through the spill tier, and a cached
dense chunk entry that must survive the reuse of its slot.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import batch as jbatch  # noqa: E402
from gofr_tpu.serving.kv_cache import PagedKVCache as JPagedKVCache  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.kv_cache import PagedKVCache  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

ENGINE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), kv_page_size=8,
              prefill_chunk_tokens=16, prefix_cache_entries=64)
LAYOUTS = [("dense", "bf16"), ("dense", "int8"), ("paged", "bf16"), ("paged", "int8")]


def _ids(seed: int, n: int) -> list[int]:
    return np.random.default_rng(seed).integers(3, 300, n).tolist()


SHORT = _ids(1, 11)  # prefills whole
CHUNKED = _ids(2, 40)  # chunks 16 + 16 + 8
EXTENDED = CHUNKED + _ids(3, 30)  # a 70-token prompt sharing CHUNKED's first two chunks
PREFIX = _ids(4, 48)  # three whole chunks
SUFFIXES = [_ids(10 + i, 16) for i in range(4)]  # one chunk each


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


def _port_engine(tcfg, tparams, **kw):
    return ServingEngine(tcfg, tparams, EngineConfig(**{**ENGINE, **kw}), ByteTokenizer(),
                         device="cpu")


def _ragged_name(layout: str, kv_dtype: str) -> str:
    if layout == "dense":
        return "ragged_step"
    return "ragged_step_paged_q" if kv_dtype == "int8" else "ragged_step_paged"


def _serve(engine, batch_mod, ragged: str, monkeypatch) -> tuple[list, dict]:
    """The traffic of the module docstring, with the engine's prefill and
    ragged calls counted."""
    calls = {"prefill_compute": 0, ragged: 0}
    for name in calls:
        real = getattr(batch_mod, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(batch_mod, name, counted)
    engine.start()
    try:
        out = []
        for prompt in (SHORT, SHORT, CHUNKED, CHUNKED, EXTENDED, PREFIX + SUFFIXES[0]):
            out.append(engine.submit(prompt, max_new_tokens=6).result(timeout=120))
        futs = [engine.submit(PREFIX + s, max_new_tokens=6) for s in SUFFIXES[1:]]
        out += [f.result(timeout=120) for f in futs]
        return out, calls
    finally:
        engine.stop()


@pytest.mark.parametrize("layout,kv_dtype", LAYOUTS)
def test_kv_reuse_matches_jax_engine(models, layout, kv_dtype, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    kw = dict(kv_layout=layout, kv_dtype=kv_dtype)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**ENGINE, **kw), JByteTokenizer())
    port = _port_engine(tcfg, tparams, **kw)
    ragged = _ragged_name(layout, kv_dtype)
    want, want_calls = _serve(jeng, jbatch, ragged, monkeypatch)
    got, got_calls = _serve(port, tbatch, ragged, monkeypatch)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert (g.finish_reason, g.prompt_tokens) == (w.finish_reason, w.prompt_tokens)
    assert got_calls == want_calls
    assert sorted(port._prefix_cache.keys()) == sorted(jeng._prefix_cache.keys())
    # each repeat equals its first run
    assert got[1].token_ids == got[0].token_ids and got[3].token_ids == got[2].token_ids
    chunk_keys = [k for k in port._prefix_cache.keys() if k.startswith("chunkpfx:")]
    if kv_dtype == "int8":
        # int8 KV keeps only the whole-prompt cache: every chunk computes
        assert not chunk_keys and got_calls[ragged] == 3 + 3 + 5 + 4 + 3 * 4
    else:
        # the repeat and the shared prefix hit; computed: CHUNKED's three
        # chunks, EXTENDED's last three, PREFIX's three, then one suffix
        # chunk per request
        assert got_calls[ragged] == 3 + 3 + 3 + 1 + 3
        assert len(chunk_keys) == 3 + 3 + 3 + 4
    assert got_calls["prefill_compute"] == 1  # SHORT, once


def _paged_pair(tcfg, jcfg, kv_dtype="bf16"):
    kw = dict(num_pages=12, page_size=8, max_slots=2, max_seq_len=64, kv_dtype=kv_dtype)
    return PagedKVCache(tcfg, device=torch.device("cpu"), **kw), JPagedKVCache(jcfg, **kw)


def test_write_span_and_read_span_match_reference(models):
    jcfg, _, tcfg, _ = models
    mine, ref = _paged_pair(tcfg, jcfg)
    rng = np.random.default_rng(0)
    L, Hkv, Dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim
    for cache in (mine, ref):
        cache.alloc_slot(0, seq_id=1, prompt_len=0, reserve_tokens=5)
        cache.alloc_slot(1, seq_id=2, prompt_len=0, reserve_tokens=30)
    # an 8-token span at 16 past the reservation (the write extends it), a
    # ragged 13-token span at 8, and a span over slot 1's first pages
    for slot, start, n in ((0, 16, 8), (0, 8, 13), (1, 0, 30)):
        k = rng.standard_normal((L, n, Hkv, Dh)).astype(np.float32)
        v = rng.standard_normal((L, n, Hkv, Dh)).astype(np.float32)
        mine.write_span(slot, start, torch.from_numpy(k), torch.from_numpy(v))
        ref.write_span(slot, start, jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_array_equal(mine.tables, ref.tables)
    np.testing.assert_array_equal(mine.k_pool.numpy(), np.asarray(ref.k_pool))
    np.testing.assert_array_equal(mine.v_pool.numpy(), np.asarray(ref.v_pool))
    for slot, start, end in ((0, 8, 21), (0, 16, 24), (1, 0, 30), (1, 8, 9)):
        got, want = mine.read_span(slot, start, end), ref.read_span(slot, start, end)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    k_span, _ = mine.read_span(1, 0, 30)
    k_span.zero_()  # a fresh tensor, never a view of the pool
    np.testing.assert_array_equal(mine.read_span(1, 0, 30)[0].numpy(),
                                  np.asarray(ref.read_span(1, 0, 30)[0]))
    with pytest.raises(ValueError, match="page-aligned"):
        mine.write_span(0, 3, torch.zeros(L, 8, Hkv, Dh), torch.zeros(L, 8, Hkv, Dh))
    with pytest.raises(ValueError, match="page-aligned"):
        mine.read_span(0, 4, 8)
    q8, _ = _paged_pair(tcfg, jcfg, kv_dtype="int8")
    q8.alloc_slot(0, seq_id=1, prompt_len=0, reserve_tokens=8)
    with pytest.raises(ValueError, match="int8"):
        q8.write_span(0, 0, torch.zeros(L, 8, Hkv, Dh), torch.zeros(L, 8, Hkv, Dh))
    with pytest.raises(ValueError, match="int8"):
        q8.read_span(0, 0, 8)


def test_insert_chunk_matches_reference(models):
    _, _, tcfg, _ = models
    rng = np.random.default_rng(1)
    shape = (tcfg.n_layers, 3, 40, tcfg.n_kv_heads, tcfg.head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    slab_shape = (tcfg.n_layers, 16, tcfg.n_kv_heads, tcfg.head_dim)
    ks, vs = (rng.standard_normal(slab_shape).astype(np.float32) for _ in range(2))
    want_k, want_v = jbatch.insert_chunk(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(ks),
                                         jnp.asarray(vs), jnp.int32(2), jnp.int32(16))
    k, v = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    got_k, got_v = tbatch.insert_chunk(k, v, torch.from_numpy(ks), torch.from_numpy(vs), 2, 16)
    assert got_k is k and got_v is v  # in place, where the reference donates
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_spill_tier_serves_a_host_hit(models, layout):
    """A device tier of four entries holds one chunked prompt's chain; a
    second prompt's chain evicts it to the host tier, and the prompt served
    again hits there, with the tokens of its first run."""
    _, _, tcfg, tparams = models
    engine = _port_engine(tcfg, tparams, kv_layout=layout, prefix_cache_entries=4,
                          kv_spill_bytes=1 << 24)
    tiers = []
    lookup = engine._cache_lookup

    def recorded(key):
        value, tier = lookup(key)
        tiers.append(tier)
        return value, tier

    engine._cache_lookup = recorded
    engine.start()
    try:
        prompt = _ids(20, 60)  # four chunks
        first = engine.submit(prompt, max_new_tokens=4).result(timeout=120)
        engine.submit(_ids(21, 60), max_new_tokens=2).result(timeout=120)
        assert engine._prefix_cache.flush(10.0)
        assert engine._prefix_cache.stats()["host"]["entries"] >= 4
        tiers.clear()
        again = engine.submit(prompt, max_new_tokens=4).result(timeout=120)
        assert again.token_ids == first.token_ids
        assert tiers == ["host"] * 4, tiers
    finally:
        engine.stop()
    assert engine._prefix_cache._exec._shutdown  # stop() closed the spill worker


def test_cached_dense_chunk_entry_survives_slot_reuse(models):
    """One slot: a chunked prompt's entries are taken from the slot row,
    then another prompt overwrites that row. The entries must be copies,
    unchanged, and the first prompt served again must give its tokens."""
    _, _, tcfg, tparams = models
    engine = _port_engine(tcfg, tparams, max_slots=1)
    engine.start()
    try:
        first = engine.submit(CHUNKED, max_new_tokens=5).result(timeout=120)
        cache = engine._prefix_cache
        entries = {k: tuple(t.clone() for t in cache.get(k)) for k in cache.keys()}
        assert len(entries) == 3
        engine.submit(_ids(30, 40), max_new_tokens=5).result(timeout=120)  # same slot
        for key, snapshot in entries.items():
            live = cache.get(key)
            assert all(torch.equal(a, b) for a, b in zip(live, snapshot)), key
            assert live[1].untyped_storage().data_ptr() != engine.cache.k.untyped_storage().data_ptr()
        again = engine.submit(CHUNKED, max_new_tokens=5).result(timeout=120)
        assert again.token_ids == first.token_ids
    finally:
        engine.stop()


def test_full_chain_hit_dispatches_no_prefill(models, monkeypatch):
    """A repeated chunked prompt admits straight to decode: zero ragged
    dispatches before its first token, and the pages of its chain are
    claimed at admission and all given back at its end."""
    _, _, tcfg, tparams = models
    engine = _port_engine(tcfg, tparams, kv_layout="paged")
    calls = []
    real = tbatch.ragged_step_paged

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tbatch, "ragged_step_paged", counted)
    engine.start()
    try:
        cold = engine.submit(CHUNKED, max_new_tokens=1).result(timeout=120)
        assert len(calls) == 3
        warm = engine.submit(CHUNKED, max_new_tokens=1).result(timeout=120)
        assert len(calls) == 3 and warm.token_ids == cold.token_ids
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"]
    finally:
        engine.stop()


def test_chunk_cache_keys_are_the_reference_keys(models):
    """The key of every chunk boundary, digest included, is the
    reference's for the same prompt and chunk size."""
    jcfg, jparams, tcfg, tparams = models
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**ENGINE), JByteTokenizer())
    port = _port_engine(tcfg, tparams)
    assert port._chunk_cache_keys(EXTENDED) == jeng._chunk_cache_keys(EXTENDED, None)
    jeng.stop()
    port.stop()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_chunk_entry_logits_are_the_rows_own(models, layout):
    """The ragged dispatch's logits come in chunk-row order, not by slot:
    with slot 0 decoding, a chunked prompt in slot 1 is chunk row 0. Each
    of its entries must hold its own prefix's last-position logits (a
    plain prefill of that prefix, within 1e-5 in f32), and the full-chain
    hit that samples from the last one must give the cold run's tokens."""
    _, _, tcfg, tparams = models
    engine = _port_engine(tcfg, tparams, kv_layout=layout)
    engine.start()
    try:
        busy = engine.submit(SHORT, max_new_tokens=40)
        cold = engine.submit(CHUNKED, max_new_tokens=6).result(timeout=120)
        busy.result(timeout=120)
        cache = engine._prefix_cache
        for start, end, key in engine._chunk_cache_keys(CHUNKED):
            logits = cache.get(key)[0]
            want, _ = tllama.prefill(
                tcfg, tparams, torch.tensor([CHUNKED[:end]]),
                tllama.KVCache.create(tcfg, 1, max_len=end, device="cpu"),
                torch.tensor([end], dtype=torch.int32))
            assert logits.shape == (1, tcfg.vocab_size)
            torch.testing.assert_close(logits, want, atol=1e-5, rtol=0)
        warm = engine.submit(CHUNKED, max_new_tokens=6).result(timeout=120)
        assert warm.token_ids == cold.token_ids
    finally:
        engine.stop()
