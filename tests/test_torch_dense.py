"""The dense slot cache of the port against the JAX package, on the CPU at
the tiny f32 size (the reference's default serving layout).

- ``KVCache.create``: shapes and dtypes of the reference's, bf16 and int8,
  zeroed, with the sink past the end that dropped writes go to;
- 8 steps of ``decode_step`` over bf16 and int8 caches: logits within
  1e-4 (summation order differs), f32 caches within 1e-5, int8 values
  identical and scales within 4e-6 relative (the K/V they quantize come
  from two GEMMs that round differently; ``insert_slot_quantized`` shows
  the quantization itself bit-identical), with a frozen row at
  ``S_max + 1`` (its RoPE position past the table) that leaves its row
  unchanged and raises nothing (its logits are never read: NaN in the
  reference, whose ``jnp.take`` fills past the RoPE table, finite here);
- ``decode_chunk`` with a row whose chunk tail crosses ``S_max`` and a row
  that starts at ``S_max`` (every write dropped), bf16 and int8;
- ``insert_slot``/``insert_slot_quantized``: identical caches;
- ``decode_block``: the packed output identical, with a row that stops
  mid-block and a frozen mid-prefill row whose position 0 is untouched;
- ``ragged_step``: packed output and first tokens identical, last logits
  within 1e-4, the chunk rows' cache as ``decode_step``'s, a final chunk
  crossing ``S_max``;
- ``greedy_generate``, ``decode_step_greedy`` and ``decode_loop_greedy``:
  tokens identical.
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
CACHE_TOL = 1e-5
# an int8 write's scale is its vector's absmax / 127, so it carries the
# relative error of K/V themselves: a few f32 ulps (2^-23 = 1.2e-7 each)
# from GEMMs that sum in another order
SCALE_RTOL = 4e-6
S_MAX = 20  # chunk size 8 does not divide it: a final chunk crosses the end
CPU = torch.device("cpu")


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


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _kv_dtype(quantized):
    return "int8" if quantized else None


def _caches(jcfg, tcfg, B, S, quantized, seed):
    """The same random cache on both sides: (JAX KVCache, port KVCache,
    its arrays)."""
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, S, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    arrays = [k, v]
    if quantized:
        quant = jax.jit(jllama.quantize_kv)
        kq, ks = quant(jnp.asarray(k))
        vq, vs = quant(jnp.asarray(v))
        arrays = [np.asarray(a) for a in (kq, vq, ks, vs)]
    tc = tllama.KVCache.create(tcfg, B, max_len=S, kv_dtype=_kv_dtype(quantized), device=CPU)
    for field, a in zip(tc.tensors(), arrays):
        field.copy_(torch.from_numpy(np.array(a)))
    return jllama.KVCache(*(jnp.asarray(a) for a in arrays)), tc, arrays


def _check_cache(tc, jc, quantized, rows=None):
    """The port's cache against the reference's (``rows`` only, if given)."""
    for i, (t, j) in enumerate(zip([x for x in tc.tensors() if x is not None],
                                   jax.tree_util.tree_leaves(jc))):
        t, j = t.numpy(), np.asarray(j)
        if rows is not None:
            t, j = t[:, rows], j[:, rows]
        if not quantized:
            _close(t, j, CACHE_TOL)
        elif i < 2:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_kv_cache_create_matches_reference(models, quantized):
    jcfg, _, tcfg, _ = models
    jc = jllama.KVCache.create(jcfg, 3, max_len=S_MAX, kv_dtype=_kv_dtype(quantized))
    tc = tllama.KVCache.create(tcfg, 3, max_len=S_MAX, kv_dtype=_kv_dtype(quantized), device=CPU)
    assert tc.quantized == jc.quantized == quantized
    assert tc.max_len == jc.max_len == S_MAX
    leaves = jax.tree_util.tree_leaves(jc)
    mine = [t for t in tc.tensors() if t is not None]
    assert len(mine) == len(leaves) == (4 if quantized else 2)
    for t, j in zip(mine, leaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
        assert t.is_contiguous() and not t.any()
        rows = tllama._cache_rows(t)  # the sink: one more row past the end
        assert rows.shape[0] == 2 * 3 * S_MAX + 1 and rows.shape[1:] == t.shape[3:]
    with pytest.raises(ValueError, match="sink"):
        tllama._cache_rows(torch.zeros(tuple(mine[0].shape)))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_decode_step_logits_and_cache_over_8_steps(models, quantized):
    """S_max is the model's max_seq_len, so the frozen row's length
    S_max + 1 puts its RoPE position past the table on both sides."""
    jcfg, jparams, tcfg, tparams = models
    B, S = 3, jcfg.max_seq_len
    jc, tc, init = _caches(jcfg, tcfg, B, S, quantized, seed=1)
    lens = np.array([5, 60, 0], np.int32)
    tokens = np.array([4, 7, 9], np.int32)
    for step in range(8):
        cache_len = np.where(np.arange(B) < 2, lens + 1 + step, S + 1).astype(np.int32)
        want, jc = jllama.decode_step(jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(cache_len))
        got, tc2 = tllama.decode_step(tcfg, tparams, torch.from_numpy(tokens).long(), tc,
                                      torch.from_numpy(cache_len))
        assert tc2 is tc  # updated in place
        # the frozen row's logits are never read: the reference's RoPE
        # gather fills NaN past the table, the port clamps into it
        assert bool(torch.isfinite(got).all())
        _close(got.numpy()[:2], np.asarray(want)[:2])
        tokens = np.asarray(want).argmax(-1).astype(np.int32)
    _check_cache(tc, jc, quantized)
    for t, a in zip([x for x in tc.tensors() if x is not None], init):
        np.testing.assert_array_equal(t[:, 2].numpy(), a[:, 2])  # the frozen row
        written = t[:, 0, 5:13].numpy()
        assert not np.array_equal(written, a[:, 0, 5:13])  # the live rows' steps landed
    assert tllama._cache_rows(tc.k)[-1].abs().sum() > 0  # the frozen row's writes: the sink


def _chunk_case(jcfg, rng, C=8):
    """3 rows of a cache of S_MAX=20: row 0 a chunk at 2, row 1 a chunk at
    16 whose tail (20..23) crosses the end, row 2 starting at S_MAX, as the
    reference's rows that are not chunking do (every write dropped)."""
    tokens = rng.integers(3, jcfg.vocab_size, (3, C)).astype(np.int32)
    tokens[1, 3:] = -1  # the final ragged chunk's pad
    return tokens, np.array([2, 16, S_MAX], np.int32)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_decode_chunk_crossing_the_end(models, quantized):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    jc, tc, init = _caches(jcfg, tcfg, 3, S_MAX, quantized, seed=3)
    tokens, start = _chunk_case(jcfg, rng)
    want, jc = jllama.decode_chunk(jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(start))
    got, _ = tllama.decode_chunk(tcfg, tparams, torch.from_numpy(tokens).long(), tc,
                                 torch.from_numpy(start))
    assert got.shape == (3, 8, jcfg.vocab_size)
    _close(got.numpy(), want)
    _check_cache(tc, jc, quantized)
    for t, a in zip([x for x in tc.tensors() if x is not None], init):
        np.testing.assert_array_equal(t[:, 2].numpy(), a[:, 2])  # start S_max: nothing landed
        np.testing.assert_array_equal(t[:, 1, :16].numpy(), a[:, 1, :16])
        np.testing.assert_array_equal(t[:, 0, 10:].numpy(), a[:, 0, 10:])


def test_insert_slot_and_quantized_match_reference(models):
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(4)
    slab_k = rng.standard_normal((jcfg.n_layers, 16, jcfg.n_kv_heads, jcfg.head_dim)).astype(np.float32)
    slab_v = rng.standard_normal(slab_k.shape).astype(np.float32) * 0.3
    jc, tc, _ = _caches(jcfg, tcfg, 3, S_MAX, False, seed=5)
    jk, jv = jbatch.insert_slot(jc.k, jc.v, jnp.asarray(slab_k), jnp.asarray(slab_v), jnp.int32(1))
    tk, tv = tbatch.insert_slot(tc.k, tc.v, torch.from_numpy(slab_k), torch.from_numpy(slab_v), 1)
    assert tk is tc.k and tv is tc.v
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    jq, tq, _ = _caches(jcfg, tcfg, 3, S_MAX, True, seed=6)
    jq = jbatch.insert_slot_quantized(jq, jnp.asarray(slab_k), jnp.asarray(slab_v), jnp.int32(2))
    assert tbatch.insert_slot_quantized(tq, torch.from_numpy(slab_k), torch.from_numpy(slab_v), 2) is tq
    for t, j in zip(tq.tensors(), jax.tree_util.tree_leaves(jq)):  # bit for bit, scales too
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _host_state(B, **over):
    state = dict(
        last_token=np.array([40, 41, 42][:B], np.int32), seq_len=np.array([6, 9, 1][:B], np.int32),
        done=np.zeros(B, bool), budget=np.array([10, 2, 10][:B], np.int32),
        stop_tok=np.full(B, -1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
    )
    state.update(over)
    return state


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_decode_block_packed_output_matches_reference(models, quantized):
    """Row 1 spends its budget mid-block; row 2 is frozen mid-prefill (done
    and not active) with live prompt K/V at position 0, which its frozen
    appends at S_max + 1 must never reach."""
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, jparams, tcfg, tparams = models
    B, N = 3, 4
    jc, tc, init = _caches(jcfg, tcfg, B, S_MAX, quantized, seed=7)
    host = _host_state(B, done=np.array([False, False, True]))
    active = np.array([True, True, False])
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0))
    want, jc, _ = jbatch.decode_block(jcfg, jparams, jc, jstate, jnp.asarray(active), N)
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0), device=CPU)
    got, tc2, tstate = tbatch.decode_block(tcfg, tparams, tc, tstate, torch.from_numpy(active), N)
    assert tc2 is tc and got.dtype == torch.int32 and got.shape == (B, N + 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert list(np.asarray(want)[1, N:]) == [1, 2]  # budget spent: done after 2 tokens
    assert list(np.asarray(want)[2]) == [-1] * N + [0, 0]  # the frozen row
    _check_cache(tc, jc, quantized)
    for t, a in zip([x for x in tc.tensors() if x is not None], init):
        np.testing.assert_array_equal(t[:, 2].numpy(), a[:, 2])  # position 0 and all of it
        np.testing.assert_array_equal(t[:, 1, 11:].numpy(), a[:, 1, 11:])  # nothing after its stop
    assert tstate.seq_len.tolist() == [10, 11, 1]


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_ragged_step_matches_reference(models, quantized):
    """One dispatch over 4 rows: 0 decoding, 1 the first 8-token chunk of
    a prompt, 2 a prompt's final 3-token chunk at 16 whose buffer's tail
    crosses S_max=20, 3 idle."""
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(9)
    B, C, steps = 4, 8, 3
    jc, tc, _ = _caches(jcfg, tcfg, B, S_MAX, quantized, seed=10)
    chunk = np.full((B, C), -1, np.int32)
    chunk[1] = rng.integers(3, jcfg.vocab_size, C)
    chunk[2, :3] = rng.integers(3, jcfg.vocab_size, 3)
    start = np.array([S_MAX, 0, 16, S_MAX], np.int32)  # the reference's start for other rows
    finish = np.array([False, False, True, False])
    new_len = np.array([0, 8, 19, 0], np.int32)
    host = _host_state(B, last_token=np.array([40, 0, 0, 0], np.int32),
                       seq_len=np.array([6, 1, 1, 1], np.int32),
                       done=np.array([False, True, True, True]),
                       budget=np.array([10, 0, 0, 0], np.int32))
    fold = dict(budgets=np.array([0, 7, 2, 0], np.int32), stops=np.full(B, -1, np.int32),
                temps=np.zeros(B, np.float32), topks=np.zeros(B, np.int32),
                topps=np.ones(B, np.float32))
    decode_active = np.array([True, False, False, False])
    J, T = jnp.asarray, torch.from_numpy
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0))
    want, jlast, jc, _ = jbatch.ragged_step(
        jcfg, jparams, jc, jstate, J(chunk), J(start), J(finish), J(new_len),
        *(J(a) for a in fold.values()), J(np.array([0, 11, 12, 0], np.int32)),
        jax.random.PRNGKey(1), J(decode_active), steps,
    )
    rows = np.array([1, 2])
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0), device=CPU)
    got, tlast, tc2, tstate = tbatch.ragged_step(
        tcfg, tparams, tc, tstate, T(chunk).long(), T(start), T(rows), T(finish), T(new_len),
        *(T(a) for a in fold.values()), [5, 6], T(decode_active), steps,
    )
    assert tc2 is tc and got.dtype == torch.int32 and got.shape == (B, steps + 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tlast.numpy(), np.asarray(jlast)[rows])
    _check_cache(tc, jc, quantized, rows=[0, 1, 2])
    want = np.asarray(want)
    assert want[2, -1] >= 0 and want[1, -1] == -1  # first token only where the prompt ends
    assert want[0, steps + 1] == steps and (want[1:, :steps] == -1).all()  # only row 0 decodes
    assert int(tstate.seq_len[2]) == 19 and int(tstate.budget[2]) == 2 and not bool(tstate.done[2])


def test_greedy_generate_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(11)
    prompt = rng.integers(3, jcfg.vocab_size, (2, 7)).astype(np.int32)
    lens = np.array([7, 4], np.int32)
    prompt[1, 4:] = 0
    want = jllama.greedy_generate(jcfg, jparams, jnp.asarray(prompt), jnp.asarray(lens), 6)
    got = tllama.greedy_generate(tcfg, tparams, torch.from_numpy(prompt).long(), torch.from_numpy(lens), 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_greedy_and_loop_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    jc, tc, _ = _caches(jcfg, tcfg, 2, S_MAX, False, seed=12)
    tokens = np.array([5, 17], np.int32)
    lens = np.array([3, 9], np.int32)
    jt, jc, jlen = jllama.decode_step_greedy(jcfg, jparams, jnp.asarray(tokens), jc, jnp.asarray(lens))
    tt, tc, tlen = tllama.decode_step_greedy(tcfg, tparams, torch.from_numpy(tokens).long(), tc,
                                             torch.from_numpy(lens))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    jlast, jc, jlen, jtoks = jllama.decode_loop_greedy(jcfg, jparams, jt, jc, jlen, 5)
    tlast, tc, tlen, ttoks = tllama.decode_loop_greedy(tcfg, tparams, tt, tc, tlen, 5)
    assert ttoks.shape == (2, 5)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    _check_cache(tc, jc, False)
