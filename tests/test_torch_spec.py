"""The port's speculative decoding against the JAX package, on the CPU at the
tiny f32 size.

- ``batch._accept_and_bonus``: greedy acceptance (the cumulative-product
  argmax match, -1 padding never matching) equal to the reference's on
  seeded logits and drafts, exactly.
- ``verify_and_sample``, ``_paged`` and ``_paged_q`` on all four layouts
  (dense and paged, full-width and int8 KV): the verify forward's logits
  within 1e-4 (absolute, f32 through two layers) of the reference's, and
  the packed tokens and accept counts equal.
- ``llama.speculative_generate``: tokens equal to ``greedy_generate`` and
  to the reference's, with the same number of forwards.
- The engine with ``spec_tokens > 0``: greedy tokens equal to the JAX spec
  engine's and to the port's own non-spec engine's on all four layouts,
  with the same ``spec_stats``; sampled rows take plain steps; a paged row
  runs to the sequence limit; ``try_reserve_chunk`` and ``extend_slot``
  against the reference's; the configuration's validation.
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

LAYOUTS = [("dense", "bf16"), ("dense", "int8"), ("paged", "bf16"), ("paged", "int8")]
LOGITS_ATOL = 1e-4  # f32 logits of the tiny model: summation order only
REPETITIVE = "abcd abcd abcd abcd abcd"  # prompt lookup finds continuations to draft


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


# ------------------------------------------------------------ acceptance
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_and_bonus_matches_reference(seed):
    rng = np.random.default_rng(seed)
    B, T, V = 6, 5, 40
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    chunk = np.full((B, T), -1, np.int32)
    chunk[:, 0] = rng.integers(0, V, B)
    for b in range(B):
        n_drafts = int(rng.integers(0, T))
        chunk[b, 1:1 + n_drafts] = greedy[b, :n_drafts]  # drafts greedy would accept...
        if n_drafts and rng.random() < 0.5:  # ...until one is corrupted
            at = int(rng.integers(1, n_drafts + 1))
            chunk[b, at] = (chunk[b, at] + 1) % V
    zeros = np.zeros(B, np.float32)
    want_out, want_n, _ = jbatch._accept_and_bonus(
        jnp.asarray(chunk), jnp.asarray(logits), jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B, jnp.float32), jax.random.PRNGKey(0),
    )
    out, n = tbatch._accept_and_bonus(
        torch.from_numpy(chunk).long(), torch.from_numpy(logits), torch.zeros(B),
        torch.zeros(B, dtype=torch.long), torch.ones(B), torch.Generator().manual_seed(0),
    )
    np.testing.assert_array_equal(n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert 0 < int(n.sum()) < B * (T - 1)


# ------------------------------------------------------------ verify
B, S, T = 3, 12, 5
SEQ = [12, 9, 5]
N_ACCEPT = [4, 2, 0]  # row 0 drafts the greedy continuation, row 1 two of it, row 2 none


def _prompt_and_chunk(jcfg, jparams):
    rng = np.random.default_rng(7)
    prompt = np.zeros((B, S), np.int32)
    for b, n in enumerate(SEQ):
        prompt[b, :n] = rng.integers(3, 300, n)
    cont = np.asarray(jllama.greedy_generate(jcfg, jparams, jnp.asarray(prompt),
                                             jnp.asarray(SEQ, jnp.int32), T))
    chunk = np.full((B, T), -1, np.int32)
    chunk[:, 0] = cont[:, 0]
    chunk[0, 1:] = cont[0, 1:]
    chunk[1, 1:4] = cont[1, 1:4]
    chunk[1, 3] = (chunk[1, 3] + 1) % 300  # the third draft is wrong
    return prompt, chunk


def _jax_state(jcfg, jparams, layout, kv_dtype, prompt):
    """The reference's cache or pool after prefilling ``prompt``, with page
    coverage for the chunk."""
    if layout == "dense":
        cache = jllama.KVCache.create(jcfg, B, max_len=32, kv_dtype=kv_dtype)
        _, cache = jllama.prefill(jcfg, jparams, jnp.asarray(prompt), cache,
                                  jnp.asarray(SEQ, jnp.int32))
        return cache
    pc = JPagedKVCache(jcfg, num_pages=16, page_size=8, max_slots=B, max_seq_len=32,
                       kv_dtype=kv_dtype)
    for b, n in enumerate(SEQ):
        pc.alloc_slot(b, seq_id=b + 1, prompt_len=n, reserve_tokens=S)
        _, k, v = jbatch.prefill_compute(jcfg, jparams, jnp.asarray(prompt[b:b + 1]),
                                         jnp.asarray([n], jnp.int32))
        pc.write_prefill(b, k, v)
    assert pc.try_reserve_chunk(list(range(B)), T)
    return pc


def _port_state(tcfg, tparams, layout, kv_dtype, prompt):
    if layout == "dense":
        cache = tllama.KVCache.create(tcfg, B, max_len=32, kv_dtype=kv_dtype, device="cpu")
        _, cache = tllama.prefill(tcfg, tparams, torch.from_numpy(prompt).long(), cache,
                                  torch.tensor(SEQ, dtype=torch.int32))
        return cache
    pc = PagedKVCache(tcfg, num_pages=16, page_size=8, max_slots=B, max_seq_len=32,
                      kv_dtype=kv_dtype, device=torch.device("cpu"))
    for b, n in enumerate(SEQ):
        pc.alloc_slot(b, seq_id=b + 1, prompt_len=n, reserve_tokens=S)
        _, k, v = tbatch.prefill_compute(tcfg, tparams, torch.from_numpy(prompt[b:b + 1]).long(),
                                         torch.tensor([n], dtype=torch.int32))
        pc.write_prefill(b, k, v)
    assert pc.try_reserve_chunk(list(range(B)), T)
    return pc


@pytest.mark.parametrize("layout,kv_dtype", LAYOUTS)
def test_verify_and_sample_matches_reference(models, layout, kv_dtype, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    prompt, chunk = _prompt_and_chunk(jcfg, jparams)
    start = np.asarray(SEQ, np.int32)
    samp_j = (jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32))
    samp_t = (torch.zeros(B), torch.zeros(B, dtype=torch.long), torch.ones(B),
              torch.Generator().manual_seed(0))
    active = np.ones(B, bool)

    # the reference: its verify forward's logits (on one state), and its
    # packed verify (on another: the verify donates what it writes)
    st = _jax_state(jcfg, jparams, layout, kv_dtype, prompt)
    st2 = _jax_state(jcfg, jparams, layout, kv_dtype, prompt)
    if layout == "dense":
        want_logits, _ = jllama.decode_chunk(jcfg, jparams, jnp.asarray(chunk), st, jnp.asarray(start))
        want_packed = jbatch.verify_and_sample(jcfg, jparams, st2, jnp.asarray(chunk),
                                               jnp.asarray(start), *samp_j, jax.random.PRNGKey(0))[0]
    else:
        cap = np.array([st.owned_capacity(b) for b in range(B)], np.int32)
        pools = (st.k_pool, st.v_pool) + ((st.ks_pool, st.vs_pool) if st.quantized else ())
        pools2 = (st2.k_pool, st2.v_pool) + ((st2.ks_pool, st2.vs_pool) if st2.quantized else ())
        rest = (jnp.asarray(st.tables), jnp.asarray(start), jnp.asarray(active), jnp.asarray(cap))
        fwd = jllama.decode_chunk_paged_q if st.quantized else jllama.decode_chunk_paged
        verify = jbatch.verify_and_sample_paged_q if st.quantized else jbatch.verify_and_sample_paged
        want_logits = fwd(jcfg, jparams, jnp.asarray(chunk), *pools, rest[0], *rest[1:])[0]
        want_packed = verify(jcfg, jparams, *pools2, rest[0], jnp.asarray(chunk), *rest[1:],
                             *samp_j, jax.random.PRNGKey(0))[0]

    # the port: one verify, its forward's logits recorded as it runs
    seen = []
    name = {"dense": "decode_chunk"}.get(layout) or (
        "decode_chunk_paged_q" if kv_dtype == "int8" else "decode_chunk_paged")
    real = getattr(tllama, name)

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0].clone())
        return out

    monkeypatch.setattr(tllama, name, record)
    ps = _port_state(tcfg, tparams, layout, kv_dtype, prompt)
    chunk_t, start_t = torch.from_numpy(chunk).long(), torch.from_numpy(start)
    if layout == "dense":
        packed = tbatch.verify_and_sample(tcfg, tparams, ps, chunk_t, start_t, *samp_t)[0]
    else:
        cap_t = torch.tensor([ps.owned_capacity(b) for b in range(B)], dtype=torch.int32)
        args = (ps.tables_device(), chunk_t, start_t, torch.from_numpy(active), cap_t, *samp_t)
        if ps.quantized:
            packed = tbatch.verify_and_sample_paged_q(tcfg, tparams, *ps.pools(), *args)[0]
        else:
            packed = tbatch.verify_and_sample_paged(tcfg, tparams, ps.k_pool, ps.v_pool, *args)[0]
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0].numpy(), np.asarray(want_logits), atol=LOGITS_ATOL, rtol=0)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want_packed))
    assert packed.dtype == torch.int32 and packed.shape == (B, T + 1)
    assert packed[:, -1].tolist() == N_ACCEPT


# ------------------------------------------------------- library generation
def test_speculative_generate_matches_greedy_and_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    base = [7, 11, 13, 7, 11, 13, 7, 11, 13, 7, 11]
    prompt = np.zeros((3, 11), np.int32)
    prompt[0] = base
    prompt[1, :9] = rng.integers(3, 300, 9)
    prompt[2] = rng.integers(3, 300, 11)
    lens = np.array([11, 9, 11], np.int32)
    N = 20
    want, want_stats = jllama.speculative_generate(
        jcfg, jparams, jnp.asarray(prompt), jnp.asarray(lens), N, draft_len=4, ngram=2)
    got, stats = tllama.speculative_generate(
        tcfg, tparams, torch.from_numpy(prompt).long(), torch.from_numpy(lens), N,
        draft_len=4, ngram=2)
    greedy = tllama.greedy_generate(tcfg, tparams, torch.from_numpy(prompt).long(),
                                    torch.from_numpy(lens), N)
    assert got.tolist() == greedy.tolist() == np.asarray(want).tolist()
    assert stats == want_stats and stats["tokens"] == 3 * N


def test_prompt_lookup_draft_matches_reference():
    rng = np.random.default_rng(5)
    for _ in range(200):
        ctx = rng.integers(0, 4, int(rng.integers(0, 14))).tolist()
        ngram, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        assert tllama._prompt_lookup_draft(ctx, ngram, k) == jllama._prompt_lookup_draft(ctx, ngram, k)


# ------------------------------------------------------------ the engine
def _engines(models, spec_tokens, layout, kv_dtype, **kw):
    jcfg, jparams, tcfg, tparams = models
    conf = dict(max_slots=2, max_seq_len=128, prefill_buckets=(32,), kv_layout=layout,
                kv_dtype=kv_dtype, kv_page_size=8, spec_tokens=spec_tokens, **kw)
    jeng = JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer(jcfg.vocab_size))
    port = ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(tcfg.vocab_size),
                         device="cpu")
    return jeng, port


def _run(engine, prompts, **kw):
    engine.start()
    try:
        futs = [engine.submit(p, **kw) for p in prompts]
        return [f.result(timeout=120) for f in futs]
    finally:
        engine.stop()


@pytest.mark.parametrize("layout,kv_dtype", LAYOUTS)
def test_spec_engine_matches_jax_and_non_spec(models, layout, kv_dtype):
    jeng, port = _engines(models, 6, layout, kv_dtype)
    want = _run(jeng, [REPETITIVE], max_new_tokens=24)[0]
    got = _run(port, [REPETITIVE], max_new_tokens=24)[0]
    _, plain = _engines(models, 0, layout, kv_dtype)
    base = _run(plain, [REPETITIVE], max_new_tokens=24)[0]
    assert got.token_ids == want.token_ids == base.token_ids
    assert got.finish_reason == want.finish_reason == base.finish_reason
    assert port.spec_stats == jeng.spec_stats
    assert port.spec_stats["accepted"] > 0
    assert port.spec_stats["emitted"] > port.spec_stats["dispatches"]
    assert port._block_steps == 1 and not port._route_chunked(100)
    assert plain.spec_stats["dispatches"] == 0


def test_spec_sampled_rows_take_plain_steps(models):
    """A sampled row gets no drafts: every verify commits one token."""
    _, port = _engines(models, 6, "dense", "bf16")
    res = _run(port, [REPETITIVE], max_new_tokens=12, temperature=0.8)[0]
    stats = port.spec_stats
    assert res.completion_tokens >= 1
    assert stats["accepted"] == 0 and stats["emitted"] == stats["dispatches"]


def test_spec_concurrent_mixed_requests(models):
    """Greedy and sampled rows share verify steps; rows stopping mid-chunk
    discard their tails; greedy rows keep the non-spec engine's tokens."""
    jcfg, jparams, tcfg, tparams = models
    conf = dict(max_slots=4, max_seq_len=128, prefill_buckets=(32,), kv_dtype="int8")
    spec = ServingEngine(tcfg, tparams, EngineConfig(**conf, spec_tokens=4), ByteTokenizer(),
                         device="cpu")
    plain = ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu")
    lens = [(5, 9, 17)[i % 3] for i in range(9)]

    def traffic(engine):
        engine.start()
        try:
            futs = [engine.submit(REPETITIVE, max_new_tokens=n,
                                  temperature=0.0 if i % 2 == 0 else 0.7)
                    for i, n in enumerate(lens)]
            return [f.result(timeout=120) for f in futs]
        finally:
            engine.stop()

    got, base = traffic(spec), traffic(plain)
    for i, (g, b) in enumerate(zip(got, base)):
        assert g.finish_reason in ("stop", "length") and 1 <= g.completion_tokens <= lens[i]
        if i % 2 == 0:
            assert g.token_ids == b.token_ids
    assert all(s is None for s in spec.slots) and spec._sched.stats()["busy_slots"] == 0


def test_spec_paged_request_runs_to_sequence_limit(models):
    """A row that decodes to max_seq_len: the chunk's reservation clamps at
    the limit and its tail positions go to the trash page."""
    _, _, tcfg, tparams = models
    small = tllama.LlamaConfig.tiny(vocab_size=300, max_seq_len=48)
    engine = ServingEngine(small, tparams, EngineConfig(
        max_slots=2, max_seq_len=48, prefill_buckets=(16,), kv_layout="paged", kv_page_size=8,
        spec_tokens=6), ByteTokenizer(), device="cpu")
    plain = ServingEngine(small, tparams, EngineConfig(
        max_slots=2, max_seq_len=48, prefill_buckets=(16,), kv_layout="paged", kv_page_size=8),
        ByteTokenizer(), device="cpu")
    res = _run(engine, [REPETITIVE[:15]], max_new_tokens=100)[0]
    base = _run(plain, [REPETITIVE[:15]], max_new_tokens=100)[0]
    assert res.token_ids == base.token_ids
    assert res.finish_reason in ("stop", "length")
    if res.finish_reason == "length":
        assert res.prompt_tokens + res.completion_tokens == 48
    stats = engine.paged_cache.stats()
    assert stats["free_blocks"] == stats["total_blocks"]


def test_try_reserve_chunk_and_extend_slot_match_reference(models):
    jcfg, _, tcfg, _ = models
    kw = dict(num_pages=10, page_size=4, max_slots=3, max_seq_len=24)
    mine, ref = PagedKVCache(tcfg, device=torch.device("cpu"), **kw), JPagedKVCache(jcfg, **kw)
    rng = np.random.default_rng(11)
    for cache in (mine, ref):
        cache.alloc_slot(0, seq_id=1, prompt_len=5)
        cache.alloc_slot(1, seq_id=2, prompt_len=2, reserve_tokens=7)
        cache.alloc_slot(2, seq_id=3, prompt_len=9)
    for _ in range(40):
        op = rng.choice(["chunk", "chunk1", "advance", "extend"])
        slots = sorted(rng.choice(3, int(rng.integers(1, 4)), replace=False).tolist())
        tokens = int(rng.integers(1, 8))
        if op == "chunk":
            assert mine.try_reserve_chunk(slots, tokens) == ref.try_reserve_chunk(slots, tokens)
        elif op == "chunk1":
            assert mine.try_reserve_chunk(slots[:1], 1) == ref.try_reserve_chunk(slots[:1], 1)
        elif op == "advance":
            slot = slots[0]
            owned = mine.owned_capacity(slot)
            n = min(int(rng.integers(0, 4)), owned - int(mine.seq_lens[slot]))
            mine.advance_slot(slot, max(n, 0))
            ref.advance_slot(slot, max(n, 0))
        else:
            slot = slots[0]
            raised = []
            for cache in (mine, ref):
                try:
                    cache.extend_slot(slot)
                    raised.append(False)
                except Exception as exc:  # the port's and the reference's OutOfBlocks
                    assert type(exc).__name__ == "OutOfBlocks"
                    raised.append(True)
            assert raised[0] == raised[1]
        np.testing.assert_array_equal(mine.tables, ref.tables)
        np.testing.assert_array_equal(mine.seq_lens, ref.seq_lens)
        assert mine.stats() == ref.stats()


@pytest.mark.parametrize("conf,match", [
    (dict(spec_tokens=-1), "must be >= 0"),
    (dict(spec_tokens=4, multi_step=4), "chunking"),
])
def test_spec_config_validation(models, conf, match):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match=match):
        ServingEngine(tcfg, tparams, EngineConfig(max_slots=2, max_seq_len=64, **conf),
                      device="cpu")


def test_multi_step_resolves_as_reference(models):
    _, _, tcfg, tparams = models

    def steps(**conf):
        return ServingEngine(tcfg, tparams, EngineConfig(max_slots=2, max_seq_len=64, **conf),
                             device="cpu")._block_steps

    assert (steps(), steps(spec_tokens=3), steps(spec_tokens=3, multi_step=1),
            steps(multi_step=2)) == (4, 1, 1, 2)


def test_spec_mode_clamps_prompts_to_the_largest_bucket(models):
    """Under spec every prompt prefills whole: one longer than the largest
    bucket keeps its tail within it."""
    _, port = _engines(models, 2, "dense", "bf16")
    res = _run(port, ["x" * 40], max_new_tokens=3)[0]
    assert res.prompt_tokens == 32 and res.completion_tokens >= 1
