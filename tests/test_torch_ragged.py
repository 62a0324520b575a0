"""Chunked prefill and the unified ragged dispatch of the port against the
JAX package, on the CPU at the tiny f32 size.

- ``attention`` with per-row ``q_offset`` against the reference's, 1e-5;
- ``decode_chunk_paged`` and ``decode_chunk_paged_q``: logits within 1e-4,
  pools within 1e-4 (bf16 layout at f32) or identical int8 values with
  scales within 1e-6 relative; the trash page is left out, since rows sent
  there race on either side;
- the chunk forward over the chunk rows alone gives what the forward over
  every row gives for those rows (the port's ragged dispatch relies on it);
- ``ragged_step_paged`` and ``ragged_step_paged_q``: the packed
  [B, N+3] output is identical, last-position logits within 1e-4, in one
  dispatch that mixes a decode row, a mid-prompt chunk, a prompt's final
  ragged chunk and an idle row;
- the ``StepPlanner`` policy cases of ``tests/test_continuous_batching.py``
  (decode reserved first, whole-chunk grants oldest first, the admission
  quota floor), each held against the reference planner too.
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
PAGE, C, N_PAGES = 4, 8, 12


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
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), params_from_jax(jax.device_get(jparams), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_attention_per_row_q_offset_matches_reference():
    from gofr_tpu.ops.attention import attention as jattention
    from gofr_tpu_torch.ops.attention import attention

    rng = np.random.default_rng(2)
    q = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 20, 2, 16)).astype(np.float32)
    off = np.array([0, 7, 13], np.int32)
    want = jattention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                      q_offset=jnp.asarray(off), kv_len=jnp.asarray(off + 5))
    got = attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                    q_offset=torch.from_numpy(off), kv_len=torch.from_numpy(off + 5))
    _close(got.numpy(), want, 1e-5)
    # an int offset still means one offset for every row
    same = attention(*(torch.from_numpy(a) for a in (q, k, v)), q_offset=7)
    _close(same[1].numpy(), got[1].numpy(), 1e-6)


def _pools(jcfg, rng, quantized):
    shape = (jcfg.n_layers, N_PAGES + 1, jcfg.n_kv_heads, PAGE, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    if not quantized:
        return [k, v]
    kq, ks = jax.jit(jllama.quantize_kv)(jnp.asarray(k))
    vq, vs = jax.jit(jllama.quantize_kv)(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks[..., None], vs[..., None])]


def _chunk_case(jcfg, rng):
    """4 rows: 0 decoding, 1 the first chunk of a 13-token prompt, 2 the
    prompt's final 5-token chunk (the rest of its chunk buffer pads with
    -1), 3 idle. Tables give each row its own pages."""
    tables = np.array([[0, 1, 2, 0], [3, 4, 0, 0], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    chunk = np.full((4, C), -1, np.int32)
    chunk[1] = rng.integers(3, jcfg.vocab_size, C)
    chunk[2, :5] = rng.integers(3, jcfg.vocab_size, 5)
    return dict(
        tables=tables, chunk=chunk,
        start=np.array([0, 0, 8, 0], np.int32),
        active=np.array([False, True, True, False]),
        kvcap=np.array([12, 8, 16, 0], np.int32),
        finish=np.array([False, False, True, False]),
        new_len=np.array([0, 8, 13, 0], np.int32),
    )


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_decode_chunk_paged_logits_and_pools(models, quantized):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(7)
    pools = _pools(jcfg, rng, quantized)
    case = _chunk_case(jcfg, rng)
    jfn = jllama.decode_chunk_paged_q if quantized else jllama.decode_chunk_paged
    tfn = tllama.decode_chunk_paged_q if quantized else tllama.decode_chunk_paged
    tail = [case[k] for k in ("tables", "start", "active", "kvcap")]
    want, *jpools = jfn(jcfg, jparams, jnp.asarray(case["chunk"]), *(jnp.asarray(p) for p in pools),
                        *(jnp.asarray(a) for a in tail))
    got, *tpools = tfn(tcfg, tparams, torch.from_numpy(case["chunk"]).long(),
                       *(torch.from_numpy(p.copy()) for p in pools), *(torch.from_numpy(a) for a in tail))
    assert got.shape == (4, C, jcfg.vocab_size)
    _close(got.numpy(), want)
    _check_pools(tpools, jpools, quantized)
    for t, p in zip(tpools, pools):  # inactive rows wrote nothing but the trash page
        np.testing.assert_array_equal(t.numpy()[:, 1:3], p[:, 1:3])


def _check_pools(tpools, jpools, quantized):
    live = slice(0, N_PAGES)  # every page but the trash page
    for i, (t, j) in enumerate(zip(tpools, jpools)):
        t, j = t.numpy()[:, live], np.asarray(j)[:, live]
        if not quantized:
            _close(t, j)
        elif i < 2:
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_chunk_forward_over_the_chunk_rows_alone_is_the_same(models):
    """What the ragged dispatch does: the chunk rows gathered by index give
    the logits and pool writes the all-row forward gives them."""
    jcfg, _, tcfg, tparams = models
    rng = np.random.default_rng(8)
    pools = _pools(jcfg, rng, True)
    case = _chunk_case(jcfg, rng)
    rows = np.nonzero(case["active"])[0]
    full = [torch.from_numpy(p.copy()) for p in pools]
    sub = [torch.from_numpy(p.copy()) for p in pools]
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    want, *_ = tllama.decode_chunk_paged_q(tcfg, tparams, t["chunk"].long(), *full, t["tables"],
                                           t["start"], t["active"], t["kvcap"])
    r = torch.from_numpy(rows)
    got, *_ = tllama.decode_chunk_paged_q(tcfg, tparams, t["chunk"][r].long(), *sub, t["tables"][r],
                                          t["start"][r], t["active"][r], t["kvcap"][r])
    np.testing.assert_allclose(got.numpy(), want[r].numpy(), atol=1e-6, rtol=1e-6)
    for a, b in zip(full, sub):
        np.testing.assert_array_equal(a[:, :N_PAGES].numpy(), b[:, :N_PAGES].numpy())


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16-layout", "int8"])
def test_ragged_step_packed_output_matches_reference(models, quantized):
    jbatch = importlib.import_module("gofr_tpu.serving.batch")
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(9)
    pools = _pools(jcfg, rng, quantized)
    case = _chunk_case(jcfg, rng)
    B, steps = 4, 3
    host = dict(
        last_token=np.array([40, 0, 0, 0], np.int32), seq_len=np.array([6, 1, 1, 1], np.int32),
        done=np.array([False, True, True, True]), budget=np.array([10, 0, 0, 0], np.int32),
        stop_tok=np.full(B, -1, np.int32), temperature=np.zeros(B, np.float32),
        top_k=np.zeros(B, np.int32), top_p=np.ones(B, np.float32),
    )
    fold = dict(budgets=np.array([0, 7, 2, 0], np.int32), stops=np.full(B, -1, np.int32),
                temps=np.zeros(B, np.float32), topks=np.zeros(B, np.int32),
                topps=np.ones(B, np.float32))
    decode_active = np.array([True, False, False, False])
    rids = np.array([0, 11, 12, 0], np.int32)

    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0))
    jfn = jbatch.ragged_step_paged_q if quantized else jbatch.ragged_step_paged
    J = jnp.asarray
    want, jlast, *jrest = jfn(
        jcfg, jparams, *(J(p) for p in pools), jstate, J(case["tables"]), J(case["chunk"]),
        J(case["start"]), J(case["active"]), J(case["kvcap"]), J(case["finish"]),
        J(case["new_len"]), *(J(a) for a in fold.values()), J(rids), jax.random.PRNGKey(1),
        J(decode_active), steps,
    )
    T = torch.from_numpy
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0),
                                      device=torch.device("cpu"))
    rows = np.nonzero(case["active"])[0]
    tfn = tbatch.ragged_step_paged_q if quantized else tbatch.ragged_step_paged
    got, tlast, *trest = tfn(
        tcfg, tparams, *(T(p.copy()) for p in pools), tstate, T(case["tables"]),
        T(case["chunk"]).long(), T(case["start"]), T(rows), T(case["kvcap"]), T(case["finish"]),
        T(case["new_len"]), *(T(a) for a in fold.values()), [5, 6], T(decode_active), steps,
    )
    assert got.dtype == torch.int32 and got.shape == (B, steps + 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tlast.numpy(), np.asarray(jlast)[rows])
    _check_pools(trest[:-1], jrest[:-1], quantized)
    want = np.asarray(want)
    assert want[2, -1] >= 0 and want[1, -1] == -1  # first token only where the prompt ends
    assert want[0, steps + 1] == steps and (want[1:, :steps] == -1).all()  # only row 0 decodes
    tst = trest[-1]  # the finished row is folded in: its length and budget
    assert int(tst.seq_len[2]) == 13 and int(tst.budget[2]) == 2 and not bool(tst.done[2])
    assert bool(tst.done[1])  # mid-prompt rows stay frozen


def test_ragged_step_without_decode_rows_runs_the_chunks_alone(models):
    """steps=0 (no decode row in the dispatch): the packed array is
    [B, 3] and the chunk rows' result is what a block would give them."""
    from gofr_tpu_torch.serving import batch as tbatch

    jcfg, _, tcfg, tparams = models
    rng = np.random.default_rng(10)
    pools = [torch.from_numpy(p.copy()) for p in _pools(jcfg, rng, True)]
    case = {k: torch.from_numpy(v) for k, v in _chunk_case(jcfg, rng).items()}
    B = 4
    state = tbatch.make_decode_state(
        np.zeros(B, np.int32), np.ones(B, np.int32), np.ones(B, bool), np.zeros(B, np.int32),
        np.full(B, -1, np.int32), np.zeros(B, np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32), torch.Generator().manual_seed(0), device=torch.device("cpu"),
    )
    fold = [torch.tensor(a) for a in ([0, 7, 2, 0], [-1] * 4, [0.0] * 4, [0] * 4, [1.0] * 4)]
    packed, last, *_ = tbatch.ragged_step_paged_q(
        tcfg, tparams, *pools, state, case["tables"], case["chunk"].long(), case["start"],
        torch.tensor([1, 2]), case["kvcap"], case["finish"], case["new_len"], *fold, [5, 6],
        torch.zeros(B, dtype=torch.bool), 0,
    )
    assert packed.shape == (B, 3)
    assert packed[2, 2] == int(last[1].argmax()) and packed[1, 2] == -1
    assert packed[:, 1].tolist() == [0] * B  # no decode tokens


# -- StepPlanner: the reference's policy cases ---------------------------------

def _cursor(mod, slot, total, seq, dispatched=0, blocked=False):
    cur = mod.ChunkCursor(req=None, slot=slot, total=total, seq=seq)
    cur.dispatched = cur.committed = dispatched
    cur.blocked = blocked
    return cur


# (planner kwargs, plan kwargs with cursors as _cursor args, expected fields)
PLANNER_CASES = {
    "decode-reserved-first": (
        dict(chunk_tokens=16, block_steps=4, step_token_budget=48),
        dict(decode_rows=8, cursors=[(0, 100, 0)], free_slots=0, queue_depth=0),
        dict(decode_tokens=32, prefill_budget=16, grants=[(0, 16)])),
    "decode-saturates-budget": (
        dict(chunk_tokens=16, block_steps=4, step_token_budget=48),
        dict(decode_rows=12, cursors=[(0, 100, 0)], free_slots=0, queue_depth=0),
        dict(prefill_budget=0, grants=[])),
    "no-split-below-a-chunk": (
        dict(chunk_tokens=32, block_steps=4, step_token_budget=48),
        dict(decode_rows=8, cursors=[(0, 100, 0)], free_slots=0, queue_depth=0),
        dict(prefill_budget=16, grants=[])),
    "no-split-second-cursor-waits": (
        dict(chunk_tokens=32, block_steps=4, step_token_budget=48),
        dict(decode_rows=0, cursors=[(0, 100, 0), (1, 100, 1)], free_slots=0, queue_depth=0),
        dict(grants=[(0, 32)])),
    "final-tail-fits-leftover": (
        dict(chunk_tokens=32, block_steps=4, step_token_budget=44),
        dict(decode_rows=0, cursors=[(0, 100, 0), (1, 70, 1, 64)], free_slots=0, queue_depth=0),
        dict(grants=[(0, 32), (1, 6)])),
    "auto-one-chunk": (
        dict(chunk_tokens=32, block_steps=4),
        dict(decode_rows=6, cursors=[(0, 100, 1, 32)], free_slots=2, queue_depth=3),
        dict(prefill_budget=32, grants=[(0, 32)])),
    "fifo-oldest-first": (
        dict(chunk_tokens=16, block_steps=4),
        dict(decode_rows=0, cursors=[(3, 64, 2), (2, 64, 1)], free_slots=0, queue_depth=0),
        dict(grants=[(2, 16)])),
    "fifo-wider-budget-in-order": (
        dict(chunk_tokens=16, block_steps=4, step_token_budget=32),
        dict(decode_rows=0, cursors=[(3, 64, 2), (2, 64, 1)], free_slots=0, queue_depth=0),
        dict(grants=[(2, 16), (3, 16)])),
    "skips-blocked-and-finished": (
        dict(chunk_tokens=16, block_steps=4),
        dict(decode_rows=0, cursors=[(0, 64, 1, 0, True), (1, 32, 2, 32), (2, 64, 3)],
             free_slots=0, queue_depth=0),
        dict(grants=[(2, 16)])),
    "admission-floor-zero-budget": (
        dict(chunk_tokens=16, block_steps=4, step_token_budget=8),
        dict(decode_rows=4, cursors=[], free_slots=0, queue_depth=5),
        dict(prefill_budget=0, admit_cap=1)),
    "admission-with-free-slots": (
        dict(chunk_tokens=16, block_steps=4, step_token_budget=8),
        dict(decode_rows=0, cursors=[], free_slots=3, queue_depth=5),
        dict(admit_cap=3)),
    "final-ragged-chunk": (
        dict(chunk_tokens=16, block_steps=4),
        dict(decode_rows=0, cursors=[(0, 37, 1, 32)], free_slots=0, queue_depth=0),
        dict(grants=[(0, 5)])),
}


@pytest.mark.parametrize("case", list(PLANNER_CASES), ids=list(PLANNER_CASES))
def test_step_planner_policy_matches_reference(case):
    from gofr_tpu.serving import stepplan as jplan
    from gofr_tpu_torch.serving import stepplan as tplan

    planner_kw, plan_kw, expected = PLANNER_CASES[case]
    plans = []
    for mod in (tplan, jplan):
        kw = dict(plan_kw, cursors=[_cursor(mod, *c) for c in plan_kw["cursors"]])
        plans.append(mod.StepPlanner(**planner_kw).plan(**kw))
    mine, ref = plans
    fields = ("decode_rows", "decode_tokens", "prefill_budget", "grants", "admit_cap", "budget_left")
    assert {f: getattr(mine, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    for field, value in expected.items():
        assert getattr(mine, field) == value, field
    assert mine.prefill_tokens == sum(n for _, n in mine.grants)
