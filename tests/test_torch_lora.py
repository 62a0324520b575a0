"""LoRA adapter multiplexing of the port (``gofr_tpu_torch/serving/lora.py``
and the LoRA parts of ``serving/batch.py``) against the JAX package, on the
CPU at the tiny f32 size.

- ``make_adapter``: the same factors from one seed;
- ``AdapterRegistry`` against the reference's on seeded op sequences
  (register, prefetch, acquire, release, deregister, a re-register at a
  larger rank): the same slots, residency, ``AdapterBusy`` and
  ``UnknownAdapter`` outcomes and the same device tables; a rank or
  dimension mismatch is rejected at ``register``; an upload fault (a
  patched ``_upload``) is an ``AdapterBusy`` that the next acquire heals;
  an upload never writes the table a dispatch already holds;
- ``_lora_delta`` and ``lora_adjust_logits`` against the JAX functions
  within 1e-5 relative;
- ``decode_block``, ``decode_block_paged``, ``decode_block_paged_q`` and
  the three ragged steps with ``lora=`` on rows of different adapters:
  packed greedy tokens identical to the reference's, last-position logits
  within 1e-4, the adapters' slots folded into the decode state, and the
  tokens different from a base-only run (the delta is not vacuous).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import lora as jlora  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import lora as tlora  # noqa: E402

jbatch = importlib.import_module("gofr_tpu.serving.batch")

TOL = 1e-4
CPU = torch.device("cpu")
S_MAX, PAGE, C, N_PAGES = 20, 4, 8, 12
SCALE = 8.0  # the delta must move greedy tokens (as the reference's tests scale it)


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
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(5))
    return jcfg, jparams, tllama.LlamaConfig.tiny(), params_from_jax(jax.device_get(jparams), device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tables(cfg, ranks=(4, 2), seeds=(1, 2)):
    """Device tables of 3 slots (0 the base), the adapters padded to the
    largest rank: (JAX pair, port pair)."""
    r = max(ranks)
    a = np.zeros((len(ranks) + 1, cfg.d_model, r), np.float32)
    b = np.zeros((len(ranks) + 1, r, cfg.vocab_size), np.float32)
    for i, (rank, seed) in enumerate(zip(ranks, seeds), start=1):
        ad = tlora.make_adapter(cfg, f"t{i}", rank=rank, seed=seed, scale=SCALE)
        a[i, :, :rank], b[i, :rank] = ad.a, ad.b
    return (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a), torch.from_numpy(b))


# -- the registry ----------------------------------------------------------------

def test_make_adapter_draws_the_reference_factors():
    cfg = tllama.LlamaConfig.tiny()
    mine = tlora.make_adapter(cfg, "x", rank=3, seed=9, scale=2.0)
    ref = jlora.make_adapter(jllama.LlamaConfig.tiny(), "x", rank=3, seed=9, scale=2.0)
    np.testing.assert_array_equal(mine.a, ref.a)
    np.testing.assert_array_equal(mine.b, ref.b)
    assert mine.rank == ref.rank == 3


def _outcome(fn):
    try:
        return ("ok", fn())
    except (tlora.AdapterBusy, jlora.AdapterBusy):
        return ("busy",)
    except (tlora.UnknownAdapter, jlora.UnknownAdapter):
        return ("unknown",)


def _ref_acquire(ref, name):
    """The reference's acquire with its race absorbed (ROADMAP Queue C item
    12): an upload that ends before acquire re-reads its future leaves the
    adapter resident yet raises AdapterBusy; a second acquire then pins it,
    as the port's first one does."""
    out = _outcome(lambda: ref.acquire(name, timeout=10.0))
    if out == ("busy",) and name in ref._slot_of:
        out = _outcome(lambda: ref.acquire(name, timeout=10.0))
    return out


def _registries(max_active):
    return (tlora.AdapterRegistry(max_active=max_active, device="cpu"),
            jlora.AdapterRegistry(max_active=max_active))


@pytest.mark.parametrize("seed", range(4))
def test_registry_matches_reference_on_seeded_ops(seed):
    cfg = tllama.LlamaConfig.tiny()
    rng = np.random.default_rng(seed)
    mine, ref = _registries(3 + seed % 2)
    names = [f"ad{i}" for i in range(5)]
    pins: list[int] = []
    seen = set()
    try:
        for name in names[:4]:
            ad = tlora.make_adapter(cfg, name, rank=2, seed=int(rng.integers(100)))
            mine.register(ad)
            ref.register(jlora.LoraAdapter(ad.adapter_id, ad.a, ad.b))
        for step in range(60):
            op = rng.choice(["prefetch", "acquire", "acquire", "acquire", "release",
                             "deregister", "register"])
            name = names[int(rng.integers(len(names)))]
            if op == "prefetch":
                got = [_outcome(lambda r=r: r.prefetch(name)) for r in (mine, ref)]
            elif op == "acquire":
                got = [_outcome(lambda: mine.acquire(name, timeout=10.0)), _ref_acquire(ref, name)]
                if got[0][0] == "ok":
                    pins.append(got[0][1])
            elif op == "release":
                if not pins:
                    continue
                slot = pins.pop(int(rng.integers(len(pins))))
                got = [_outcome(lambda r=r: r.release(slot)) for r in (mine, ref)]
            elif op == "deregister":
                got = [_outcome(lambda r=r: r.deregister(name)) for r in (mine, ref)]
            else:
                # a re-register, at a larger rank from step 30: the tables grow
                rank = 2 if step < 30 else 5
                ad = tlora.make_adapter(cfg, name, rank=rank, seed=step)
                got = [_outcome(lambda: mine.register(ad)),
                       _outcome(lambda: ref.register(jlora.LoraAdapter(ad.adapter_id, ad.a, ad.b)))]
            for r in (mine, ref):
                r.flush()
            assert got[0] == got[1], (step, op, name)
            seen.add(got[0][0])
            assert mine.residency() == ref.residency(), (step, op, name)
            assert mine.known(name) == ref.known(name) and mine.ids() == ref.ids()
        # then four fresh adapters pinned at once, more than the table
        # holds: the last acquires are AdapterBusy on both sides
        for i in range(4):
            ad = tlora.make_adapter(cfg, f"tail{i}", rank=3, seed=200 + i)
            mine.register(ad)
            ref.register(jlora.LoraAdapter(ad.adapter_id, ad.a, ad.b))
            # through _ref_acquire as in the main loop: an upload that ends
            # before the reference re-reads its future is Queue C 12's race
            got = [_outcome(lambda: mine.acquire(f"tail{i}", timeout=10.0)),
                   _ref_acquire(ref, f"tail{i}")]
            assert got[0] == got[1] and mine.residency() == ref.residency()
            seen.add(got[0][0])
        assert {"ok", "busy", "unknown"} <= seen  # the sequence reaches every outcome
        tm, tr = mine.tables(), ref.tables()
        np.testing.assert_array_equal(tm[0].numpy(), np.asarray(tr[0]))
        np.testing.assert_array_equal(tm[1].numpy(), np.asarray(tr[1]))
    finally:
        mine.close()
        ref.close()


def test_registry_slots_pins_and_lru_as_the_reference():
    """The reference's own pin/evict scenario, held step by step."""
    cfg = tllama.LlamaConfig.tiny()
    mine, ref = _registries(3)  # two usable slots (0 is the base)
    try:
        for name, seed in (("a", 1), ("b", 2), ("c", 3)):
            ad = tlora.make_adapter(cfg, name, rank=2, seed=seed)
            mine.register(ad)
            ref.register(jlora.LoraAdapter(ad.adapter_id, ad.a, ad.b))
        assert mine.tables() is None and mine.slot_factors(1) is None  # nothing uploaded yet
        for r in (mine, ref):
            assert r.acquire(None) == 0
        sa, sb = mine.acquire("a"), mine.acquire("b")
        assert (sa, sb) == (ref.acquire("a"), ref.acquire("b")) and 0 < sa != sb > 0
        for r in (mine, ref):
            with pytest.raises((tlora.AdapterBusy, jlora.AdapterBusy)):
                r.acquire("c", timeout=5.0)
            r.release(sa)
        assert mine.acquire("c", timeout=10.0) == ref.acquire("c", timeout=10.0) == sa
        assert mine.residency() == ref.residency()
        assert mine.residency()["resident"] == 2
        a_row, b_row = mine.slot_factors(sa)
        np.testing.assert_array_equal(a_row[:, :2].numpy(), tlora.make_adapter(cfg, "c", rank=2, seed=3).a)
        assert a_row.device == CPU and b_row.dtype == torch.float32
        for r in (mine, ref):
            with pytest.raises((tlora.UnknownAdapter, jlora.UnknownAdapter)):
                r.acquire("never-registered")
            with pytest.raises((tlora.UnknownAdapter, jlora.UnknownAdapter)):
                r.prefetch("never-registered")
    finally:
        mine.close()
        ref.close()


@pytest.mark.parametrize("bad", ["rank", "ndim", "dims"])
def test_register_rejects_a_rank_or_dimension_mismatch(bad):
    cfg = tllama.LlamaConfig.tiny()
    for reg in _registries(3):
        reg.register(tlora.make_adapter(cfg, "good", rank=2, seed=0))
        if bad == "rank":
            a, b = np.zeros((cfg.d_model, 4), np.float32), np.zeros((2, cfg.vocab_size), np.float32)
        elif bad == "ndim":
            a, b = np.zeros((cfg.d_model, 4, 1), np.float32), np.zeros((4, cfg.vocab_size), np.float32)
        else:  # another model's widths
            a, b = np.zeros((cfg.d_model * 2, 4), np.float32), np.zeros((4, cfg.vocab_size), np.float32)
        cls = tlora.LoraAdapter if isinstance(reg, tlora.AdapterRegistry) else jlora.LoraAdapter
        with pytest.raises(ValueError):
            reg.register(cls("bad", a, b))
        assert not reg.known("bad")
        reg.close()
    with pytest.raises(ValueError):
        tlora.AdapterRegistry(max_active=1, device="cpu")


def test_upload_fault_is_transient_and_leaves_no_pin(monkeypatch):
    cfg = tllama.LlamaConfig.tiny()
    reg = tlora.AdapterRegistry(max_active=3, device="cpu")
    reg.register(tlora.make_adapter(cfg, "a", rank=2, seed=1))
    real = reg._upload
    calls = []

    def flaky(adapter_id, slot):
        calls.append(slot)
        if len(calls) == 1:
            raise RuntimeError("injected upload fault")
        return real(adapter_id, slot)

    monkeypatch.setattr(reg, "_upload", flaky)
    try:
        with pytest.raises(tlora.AdapterBusy):
            reg.acquire("a", timeout=10.0)
        reg.flush()
        res = reg.residency()
        assert res["upload_faults_total"] == 1 and res["pinned_slots"] == 0 and res["resident"] == 0
        slot = reg.acquire("a", timeout=10.0)  # re-schedules the upload
        assert slot == 1 and reg.residency()["pinned_slots"] == 1
        reg.release(slot)
        assert reg.residency()["pinned_slots"] == 0 and len(calls) == 2
    finally:
        reg.close()


def test_upload_never_writes_the_table_a_dispatch_holds():
    """Copy-on-write: the tables a dispatch took before an upload (or a
    rank growth) keep their values; the new upload lands in new tensors."""
    cfg = tllama.LlamaConfig.tiny()
    reg = tlora.AdapterRegistry(max_active=3, device="cpu")
    try:
        reg.register(tlora.make_adapter(cfg, "a", rank=2, seed=1))
        reg.register(tlora.make_adapter(cfg, "b", rank=2, seed=2))
        reg.register(tlora.make_adapter(cfg, "c", rank=2, seed=3))
        sa = reg.acquire("a")
        held = reg.tables()
        held_copy = [t.clone() for t in held]
        sb = reg.acquire("b")
        reg.release(sa)
        assert reg.acquire("c") == sa  # recycles a's slot
        reg.register(tlora.make_adapter(cfg, "d", rank=6, seed=4))  # grows the rank
        reg.release(sb)
        reg.acquire("d")
        for t, c in zip(held, held_copy):
            assert torch.equal(t, c)
        now = reg.tables()
        assert now[0] is not held[0] and now[0].shape[2] == 6
    finally:
        reg.close()


# -- the delta ---------------------------------------------------------------------

def test_lora_delta_and_single_row_adjust_match_reference(models):
    jcfg, jparams, tcfg, tparams = models
    (ja, jb), (ta, tb) = _tables(tcfg)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, 5).astype(np.int32)
    adapter = np.array([0, 1, 2, 1, 0], np.int32)
    want = jbatch._lora_delta(jparams["embedding"], ja, jb, jnp.asarray(tokens), jnp.asarray(adapter))
    got = tbatch._lora_delta(tparams["embedding"], ta, tb, torch.from_numpy(tokens),
                             torch.from_numpy(adapter))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5 * float(
        np.abs(np.asarray(want)).max()))
    assert not got[0].any() and not got[4].any()  # slot 0 is the base
    logits = rng.standard_normal((1, jcfg.vocab_size)).astype(np.float32)
    for slot in (1, 2):
        want = jbatch.lora_adjust_logits(jparams["embedding"], ja[slot], jb[slot],
                                         jnp.int32(tokens[1]), jnp.asarray(logits))
        got = tbatch.lora_adjust_logits(tparams["embedding"], ta[slot], tb[slot], int(tokens[1]),
                                        torch.from_numpy(logits))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    base = torch.from_numpy(logits)
    assert tbatch._lora_logits(tparams, None, torch.tensor([1]), torch.tensor([1]), base) is base


# -- blocks and ragged steps with lora= ---------------------------------------------

def _host_state(B):
    return dict(
        last_token=np.array([40, 41, 42, 43][:B], np.int32),
        seq_len=np.array([6, 9, 3, 5][:B], np.int32), done=np.zeros(B, bool),
        budget=np.full(B, 10, np.int32), stop_tok=np.full(B, -1, np.int32),
        temperature=np.zeros(B, np.float32), top_k=np.zeros(B, np.int32),
        top_p=np.ones(B, np.float32),
    )


def _dense_cache(jcfg, tcfg, B, quantized, seed):
    rng = np.random.default_rng(seed)
    shape = (jcfg.n_layers, B, S_MAX, jcfg.n_kv_heads, jcfg.head_dim)
    arrays = [rng.standard_normal(shape).astype(np.float32),
              rng.standard_normal(shape).astype(np.float32) * 0.5]
    if quantized:
        quant = jax.jit(jllama.quantize_kv)
        (kq, ks), (vq, vs) = quant(jnp.asarray(arrays[0])), quant(jnp.asarray(arrays[1]))
        arrays = [np.asarray(a) for a in (kq, vq, ks, vs)]
    tc = tllama.KVCache.create(tcfg, B, max_len=S_MAX, kv_dtype="int8" if quantized else None,
                               device=CPU)
    for field, a in zip(tc.tensors(), arrays):
        field.copy_(torch.from_numpy(np.array(a)))
    return (lambda: jllama.KVCache(*(jnp.asarray(a) for a in arrays))), tc, arrays


def _pools(jcfg, rng, quantized):
    shape = (jcfg.n_layers, N_PAGES + 1, jcfg.n_kv_heads, PAGE, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32) * 0.5
    v = rng.standard_normal(shape).astype(np.float32) * 0.5
    if not quantized:
        return [k, v]
    kq, ks = jax.jit(jllama.quantize_kv)(jnp.asarray(k))
    vq, vs = jax.jit(jllama.quantize_kv)(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks[..., None], vs[..., None])]


TABLES = np.array([[0, 1, 2, 0], [3, 4, 0, 0], [5, 6, 7, 8], [9, 10, 0, 0]], np.int32)
ADAPTERS = np.array([1, 0, 2, 1], np.int32)  # two adapters and a base row in one block
LAYOUTS = ["dense", "dense-int8", "paged", "paged-int8"]


def _block(layout, jcfg, jparams, tcfg, tparams, jlora_tabs, tlora_tabs, seed=7):
    """One decode block of 4 rows (rows 0-2 active with different
    adapters, row 3 idle) on both sides: (JAX packed, port packed, port
    state)."""
    B, N = 4, 4
    host = _host_state(B)
    active = np.array([True, True, True, False])
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0), ADAPTERS)
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0), ADAPTERS,
                                      device=CPU)
    quantized = layout.endswith("int8")
    if layout.startswith("dense"):
        jc, tc, _ = _dense_cache(jcfg, tcfg, B, quantized, seed)
        want, _, _ = jbatch.decode_block(jcfg, jparams, jc(), jstate, jnp.asarray(active), N,
                                         lora=jlora_tabs)
        got, _, tstate = tbatch.decode_block(tcfg, tparams, tc, tstate, torch.from_numpy(active), N,
                                             tlora_tabs)
        return np.asarray(want), got, tstate
    pools = _pools(jcfg, np.random.default_rng(seed), quantized)
    jfn = jbatch.decode_block_paged_q if quantized else jbatch.decode_block_paged
    tfn = tbatch.decode_block_paged_q if quantized else tbatch.decode_block_paged
    want = jfn(jcfg, jparams, *(jnp.asarray(p) for p in pools), jstate, jnp.asarray(TABLES),
               jnp.asarray(active), N, lora=jlora_tabs)[0]
    out = tfn(tcfg, tparams, *(torch.from_numpy(p.copy()) for p in pools), tstate,
              torch.from_numpy(TABLES), torch.from_numpy(active), N, tlora_tabs)
    return np.asarray(want), out[0], out[-1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_blocks_with_lora_match_reference(models, layout):
    jcfg, jparams, tcfg, tparams = models
    jtabs, ttabs = _tables(tcfg)
    want, got, tstate = _block(layout, jcfg, jparams, tcfg, tparams, jtabs, ttabs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tstate.adapter.tolist() == ADAPTERS.tolist()
    base_want, base_got, _ = _block(layout, jcfg, jparams, tcfg, tparams, None, None)
    np.testing.assert_array_equal(base_got.numpy(), base_want)
    # the adapter rows move, the base row does not
    assert (want[0] != base_want[0]).any() and (want[2] != base_want[2]).any()
    np.testing.assert_array_equal(want[1], base_want[1])


def test_block_step_logits_with_lora_match_reference(models):
    """The block tail's adjusted logits themselves, within 1e-4."""
    jcfg, jparams, tcfg, tparams = models
    jtabs, ttabs = _tables(tcfg)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((4, jcfg.vocab_size)).astype(np.float32)
    tokens = np.array([40, 41, 42, 43], np.int32)
    want = jbatch._lora_logits(jparams, jtabs, jnp.asarray(tokens), jnp.asarray(ADAPTERS),
                               jnp.asarray(logits))
    got = tbatch._lora_logits(tparams, ttabs, torch.from_numpy(tokens), torch.from_numpy(ADAPTERS),
                              torch.from_numpy(logits))
    _close(got.numpy(), want)


def _ragged(layout, jcfg, jparams, tcfg, tparams, jtabs, ttabs):
    """One ragged dispatch of 4 rows on both sides: row 0 decoding under
    adapter 1, row 1 the first chunk of a prompt under adapter 2, row 2 a
    prompt's final 5-token chunk under adapter 1 (its first token takes
    the delta of its last prompt token), row 3 idle. Returns (JAX packed,
    JAX last logits of the chunk rows, port packed, port last logits,
    port state, the chunk buffer)."""
    B, steps = 4, 3
    rng = np.random.default_rng(9)
    quantized = layout.endswith("int8")
    chunk = np.full((B, C), -1, np.int32)
    chunk[1] = rng.integers(3, jcfg.vocab_size, C)
    chunk[2, :5] = rng.integers(3, jcfg.vocab_size, 5)
    finish = np.array([False, False, True, False])
    host = dict(_host_state(B), seq_len=np.array([6, 1, 1, 1], np.int32),
                done=np.array([False, True, True, True]), budget=np.array([10, 0, 0, 0], np.int32))
    fold = dict(budgets=np.array([0, 7, 4, 0], np.int32), stops=np.full(B, -1, np.int32),
                temps=np.zeros(B, np.float32), topks=np.zeros(B, np.int32),
                topps=np.ones(B, np.float32))
    adapters = np.array([0, 2, 1, 0], np.int32)  # chunk rows' slots (row 0's is in its state)
    state_adapter = np.array([1, 0, 0, 0], np.int32)
    decode_active = np.array([True, False, False, False])
    rows = np.array([1, 2])
    J, T = jnp.asarray, torch.from_numpy
    jstate = jbatch.make_decode_state(*host.values(), jax.random.PRNGKey(0), state_adapter)
    tstate = tbatch.make_decode_state(*host.values(), torch.Generator().manual_seed(0),
                                      state_adapter, device=CPU)
    rids = np.array([0, 11, 12, 0], np.int32)
    lora_kw = dict(adapters=J(adapters), lora=jtabs) if jtabs is not None else {}
    t_tail = (T(adapters) if ttabs is not None else None, ttabs)
    if layout.startswith("dense"):
        jc, tc, _ = _dense_cache(jcfg, tcfg, B, quantized, seed=10)
        start = np.array([S_MAX, 0, 8, S_MAX], np.int32)
        new_len = np.array([0, 8, 13, 0], np.int32)
        want, jlast, _, _ = jbatch.ragged_step(
            jcfg, jparams, jc(), jstate, J(chunk), J(start), J(finish), J(new_len),
            *(J(a) for a in fold.values()), J(rids), jax.random.PRNGKey(1), J(decode_active),
            steps, **lora_kw)
        got, tlast, _, tstate = tbatch.ragged_step(
            tcfg, tparams, tc, tstate, T(chunk).long(), T(start), T(rows), T(finish), T(new_len),
            *(T(a) for a in fold.values()), [5, 6], T(decode_active), steps, *t_tail)
        return np.asarray(want), np.asarray(jlast)[rows], got, tlast, tstate, chunk
    pools = _pools(jcfg, rng, quantized)
    start = np.array([0, 0, 8, 0], np.int32)
    cactive = np.array([False, True, True, False])
    kvcap = np.array([12, 8, 16, 0], np.int32)
    new_len = np.array([0, 8, 13, 0], np.int32)
    jfn = jbatch.ragged_step_paged_q if quantized else jbatch.ragged_step_paged
    tfn = tbatch.ragged_step_paged_q if quantized else tbatch.ragged_step_paged
    want, jlast, *_ = jfn(
        jcfg, jparams, *(J(p) for p in pools), jstate, J(TABLES), J(chunk), J(start), J(cactive),
        J(kvcap), J(finish), J(new_len), *(J(a) for a in fold.values()), J(rids),
        jax.random.PRNGKey(1), J(decode_active), steps, **lora_kw)
    got, tlast, *trest = tfn(
        tcfg, tparams, *(T(p.copy()) for p in pools), tstate, T(TABLES), T(chunk).long(),
        T(start), T(rows), T(kvcap), T(finish), T(new_len), *(T(a) for a in fold.values()),
        [5, 6], T(decode_active), steps, *t_tail)
    return np.asarray(want), np.asarray(jlast)[rows], got, tlast, trest[-1], chunk


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ragged_steps_with_lora_match_reference(models, layout):
    jcfg, jparams, tcfg, tparams = models
    jtabs, ttabs = _tables(tcfg)
    want, jlast, got, tlast, tstate, chunk = _ragged(layout, jcfg, jparams, tcfg, tparams, jtabs, ttabs)
    np.testing.assert_array_equal(got.numpy(), want)
    _close(tlast.numpy(), jlast)  # base-model logits, for the chunk-prefix cache
    # the finishing row's slot is folded in; the mid-prompt row stays frozen
    assert tstate.adapter.tolist() == [1, 0, 1, 0] and bool(tstate.done[1])
    base = _ragged(layout, jcfg, jparams, tcfg, tparams, None, None)
    np.testing.assert_array_equal(base[2].numpy(), base[0])
    _close(base[3].numpy(), tlast.numpy())  # the cached logits do not depend on the adapter
    assert tstate.adapter.tolist() != base[4].adapter.tolist()
    assert (want[0, :3] != base[0][0, :3]).any()  # the decoding adapter row moves
    # the first token samples from the delta of the last prompt token
    first = tbatch.lora_adjust_logits(tparams["embedding"], ttabs[0][1], ttabs[1][1],
                                      int(chunk[2, 4]), tlast[1:2])
    assert int(got[2, -1]) == int(first.argmax())
