"""The port engine's multi-tenant plane (LoRA adapters, tenant classes and
the preemption ladder) against the JAX ServingEngine, on the CPU at
``LlamaConfig.tiny`` (f32, the JAX package's params carried across).

Each scenario runs on a fresh engine (or a fresh JAX + port pair) of one
configuration (two slots, buckets 16 and 32, 16-token chunks, 8-token
pages, N = 4) over the dense and paged layouts with bf16 and int8 KV
unless it says otherwise. Both packages' registries get the same adapters
(``make_adapter`` draws the same factors from one seed, scaled so that
they move greedy tokens). Checked: a heterogeneous-adapter batch is
token-identical to sequential runs and to the JAX engine, and the
adapters change the output; a chunked adapter row samples its first token
on the device with the delta; prefix-cache keys are adapter-scoped and a
hit serves its adapter's tokens; 400s for an unknown adapter and for an
adapter without a registry, and a ``ValueError`` for a registry in spec
mode; an ``AdapterBusy`` requeue and an upload fault, both healed; the
token-rate 429; deadline classes; class-aware shedding; the preemption
round trip (tokens identical to an uninterrupted run and to the JAX
engine, nothing re-emitted, TTFT kept, a warm chain walk on bf16 KV);
equal classes never preempting; a pending victim under
``decode_sync_every=2``; ``tenant_preempt=False``. Every scenario ends with
no busy slot, no owned page and no adapter pin. Preemption is triggered
from the engine thread (a hook after a block is read), never after a
sleep.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import lora as jlora  # noqa: E402
from gofr_tpu.serving import tenancy as jten  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import lora as tlora  # noqa: E402
from gofr_tpu_torch.serving import tenancy as tten  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32), prefill_chunk_tokens=16,
            kv_page_size=8, max_queue=16)
VARIANTS = {
    "dense-bf16": dict(kv_layout="dense", kv_dtype="bf16"),
    "dense-int8": dict(kv_layout="dense", kv_dtype="int8"),
    "paged-bf16": dict(kv_layout="paged", kv_dtype="bf16"),
    "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
}
ALL = pytest.mark.parametrize("variant", sorted(VARIANTS))
ADAPTERS = {"tenant-a": 1, "tenant-b": 2}  # id -> make_adapter seed
SHORT = list(range(5, 16))  # 11 tokens: prefills whole
LONG = [(7 * i) % 290 + 3 for i in range(40)]  # 40 tokens: chunks 16 + 16 + 8
# the preemption scenario: one slot, 8-token chunks; the batch-class row
# sustains 80 greedy tokens (asserted), the interactive one arrives once it
# has 6 out
STORM = dict(max_slots=1, max_seq_len=256, prefill_buckets=(16, 32), prefill_chunk_tokens=8,
             kv_page_size=8, prefix_cache_entries=16, max_queue=16)
BULK_PROMPT = list(range(2, 20))
GOLD_PROMPT = [8, 9, 10]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
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


def _registries(tcfg, max_active=4):
    """(JAX registry, port registry) holding the same two adapters."""
    jreg, treg = jlora.AdapterRegistry(max_active=max_active), tlora.AdapterRegistry(
        max_active=max_active, device="cpu")
    for name, seed in ADAPTERS.items():
        ad = tlora.make_adapter(tcfg, name, rank=4, seed=seed, scale=8.0)
        treg.register(ad)
        jreg.register(jlora.LoraAdapter(ad.adapter_id, ad.a, ad.b))
    return jreg, treg


def _storm_tenants(mod):
    """gold (interactive) and bulk (batch), with generous deadlines: the
    classes' priorities drive these tests, not the clock."""
    reg = mod.TenantRegistry()
    reg.set_policy(mod.TenantPolicy(name="gold", deadline_class="interactive", deadline_s=60.0))
    reg.set_policy(mod.TenantPolicy(name="bulk", deadline_class="batch", deadline_s=600.0))
    return reg


def _jax_engine(models, conf, **kw):
    jcfg, jparams, _, _ = models
    return JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer(), **kw)


def _port_engine(models, conf, **kw):
    _, _, tcfg, tparams = models
    return ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu", **kw)


def _pair(models, variant, lora=True, **kw):
    """(JAX engine, port engine, port registry) of one configuration, not
    started; each with its own registry of the same adapters."""
    conf = {**BASE, **VARIANTS[variant], **kw}
    if not lora:
        return _jax_engine(models, conf), _port_engine(models, conf), None
    jreg, treg = _registries(models[2])
    return (_jax_engine(models, conf, lora=jreg), _port_engine(models, conf, lora=treg), treg)


def _outcome(fut, timeout=120):
    """(finish reason, token ids) or (status code,)."""
    try:
        r = fut.result(timeout=timeout)
    except (jerrors.HTTPError, terrors.HTTPError) as exc:
        return (exc.status_code,)
    return r.finish_reason, r.token_ids


def _assert_clean(engine, reg=None):
    """No busy slot, no request left, on the paged layout every page free,
    and no adapter pin."""
    t_end = time.monotonic() + 10
    while any(s is not None for s in engine.slots) and time.monotonic() < t_end:
        time.sleep(0.005)
    assert all(s is None for s in engine.slots)
    assert engine._sched.stats()["busy_slots"] == 0
    assert not engine._by_id
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"], stats
    if reg is not None:
        assert reg.residency()["pinned_slots"] == 0, reg.residency()


def _serve(engine, calls):
    """Start the engine, run ``calls(engine)``, stop it; returns its value."""
    engine.start()
    try:
        return calls(engine)
    finally:
        engine.stop()


# ------------------------------------------------------------------ adapters
@ALL
def test_heterogeneous_batch_matches_sequential_and_jax(models, variant):
    """Rows with no adapter, tenant-a and tenant-b in one batch: the same
    greedy tokens as sequential runs and as the JAX engine, and the
    adapters change the output."""
    names = (None, "tenant-a", "tenant-b")

    def batched(engine):
        futs = [engine.submit(SHORT, max_new_tokens=10, adapter_id=a) for a in names]
        return [_outcome(f) for f in futs]

    def sequential(engine):
        return [_outcome(engine.submit(SHORT, max_new_tokens=10, adapter_id=a)) for a in names]

    conf = {**BASE, **VARIANTS[variant], "max_slots": 4}
    jreg, treg = _registries(models[2])
    want = _serve(_jax_engine(models, conf, lora=jreg), batched)
    port = _port_engine(models, conf, lora=treg)
    got = _serve(port, batched)
    port2 = _port_engine(models, conf, lora=treg)
    alone = _serve(port2, sequential)
    assert got == want == alone
    toks = [o[1] for o in got]
    assert toks[1] != toks[0] and toks[2] != toks[0] and toks[1] != toks[2]
    for engine in (port, port2):
        _assert_clean(engine, treg)
    treg.close()


@ALL
def test_chunked_adapter_row_folds_its_first_token_on_the_device(models, variant, monkeypatch):
    """A 40-token prompt under an adapter chunks through the ragged
    dispatch (no monolithic prefill), its first token sampled on the
    device with the delta; the tokens match the JAX engine's and differ
    from the base model's."""
    calls = {"prefill_compute": 0, "ragged": 0}
    ragged = "ragged_step" if variant.startswith("dense") else (
        "ragged_step_paged_q" if variant.endswith("int8") else "ragged_step_paged")
    for name, key in (("prefill_compute", "prefill_compute"), (ragged, "ragged")):
        real = getattr(tbatch, name)

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(tbatch, name, counted)
    jeng, port, treg = _pair(models, variant)

    def run(engine):
        return [_outcome(engine.submit(LONG, max_new_tokens=8, adapter_id=a))
                for a in ("tenant-a", None)]

    want = _serve(jeng, run)
    got = _serve(port, run)
    assert got == want and got[0][1] != got[1][1]
    assert calls == {"prefill_compute": 0, "ragged": 6}  # 3 chunks per prompt
    _assert_clean(port, treg)
    treg.close()


@ALL
def test_prefix_cache_is_adapter_scoped(models, variant):
    """The same prompts under two adapters make two key sets ending in
    their ids; a repeat under one adapter is a hit (a whole-prompt hit,
    and on bf16 KV a full chain hit) that serves that adapter's tokens.
    The keys equal the JAX engine's."""
    jeng, port, treg = _pair(models, variant, prefix_cache_entries=64)

    def run(engine):
        out = []
        for prompt in (SHORT, LONG):
            for a in ("tenant-a", "tenant-b", "tenant-a"):
                out.append(_outcome(engine.submit(prompt, max_new_tokens=6, adapter_id=a)))
        return out

    want = _serve(jeng, run)
    got = _serve(port, run)
    assert got == want
    for first in (0, 3):
        assert got[first + 2] == got[first] and got[first + 1] != got[first]
    keys = sorted(port._prefix_cache.keys())
    assert keys == sorted(jeng._prefix_cache.keys())
    assert {k.rsplit(":", 1)[1] for k in keys} == {"tenant-a", "tenant-b"}
    n_chunk = sum(k.startswith("chunkpfx:") for k in keys)
    assert n_chunk == (0 if variant.endswith("int8") else 6)  # 3 chunks x 2 adapters
    stats = port._prefix_cache.stats()
    # SHORT's repeat, and on bf16 KV LONG's three chunks
    assert stats["hits"] == (1 if variant.endswith("int8") else 4)
    _assert_clean(port, treg)
    treg.close()


def test_refusals(models):
    """An unknown adapter and an adapter on an engine without a registry
    are 400s on both engines; a registry with spec_tokens > 0 is a
    ValueError on both."""
    jeng, port, treg = _pair(models, "dense-bf16")
    bare_j, bare_t, _ = _pair(models, "dense-bf16", lora=False)
    for engine, err in ((jeng, jerrors.ErrorInvalidParam), (port, terrors.ErrorInvalidParam),
                        (bare_j, jerrors.ErrorInvalidParam), (bare_t, terrors.ErrorInvalidParam)):
        name = "tenant-a" if engine in (bare_j, bare_t) else "no-such-adapter"
        with pytest.raises(err) as info:
            engine.submit(SHORT, adapter_id=name)
        assert info.value.status_code == 400
        assert not engine._by_id
        engine.stop()
    assert treg.residency()["resident"] == 0  # a refusal uploads nothing
    jreg, treg2 = _registries(models[2])
    conf = {**BASE, "spec_tokens": 2}
    with pytest.raises(ValueError):
        _jax_engine(models, conf, lora=jreg)
    with pytest.raises(ValueError):
        _port_engine(models, conf, lora=treg2)
    for reg in (treg, treg2, jreg):
        reg.close()


def _counting_acquire(reg, busy):
    """Wrap ``reg.acquire`` on the instance to count AdapterBusy raises."""
    real = reg.acquire

    def acquire(adapter_id, timeout=5.0):
        try:
            return real(adapter_id, timeout=timeout)
        except (tlora.AdapterBusy, jlora.AdapterBusy):
            busy.append(adapter_id)
            raise

    reg.acquire = acquire


def _hold_after_pin(reg, adapter_id, release):
    """Wrap ``reg.acquire`` on the instance: once the engine thread has
    pinned ``adapter_id``, it waits (bounded) for ``release`` before the
    row goes on, so the pin stays held while the test reads it."""
    real = reg.acquire

    def acquire(aid, timeout=5.0):
        slot = real(aid, timeout=timeout)
        if aid == adapter_id:
            release.wait(30)
        return slot

    reg.acquire = acquire


def _submit_behind_pin(engine, reg, release):
    """``tenant-a``'s row first; ``tenant-b``'s only once the registry's
    residency shows ``tenant-a``'s pin (its row admitted), so ``tenant-b``'s
    submit-time prefetch cannot evict ``tenant-a``'s resident adapter before
    admission pins it."""
    first = engine.submit(SHORT, max_new_tokens=12, adapter_id="tenant-a")
    t_end = time.monotonic() + 30
    while reg.residency()["pinned_slots"] < 1 and time.monotonic() < t_end:
        time.sleep(0.001)
    assert reg.residency()["pinned_slots"] == 1
    second = engine.submit(SHORT, max_new_tokens=6, adapter_id="tenant-b")
    release.set()
    return [_outcome(first), _outcome(second)]


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-int8"])
def test_adapter_busy_requeues_until_the_slot_frees(models, variant):
    """One usable table slot (max_active=2): the second adapter's row
    requeues with AdapterBusy while the first row holds the slot, then
    serves; both engines give the same tokens. The second row is submitted
    once the first holds its pin (read through the registry's residency):
    submitted earlier, its prefetch could evict the first adapter while it
    was resident but not yet pinned, and then the first row met the busy
    slot instead, in either engine."""
    conf = {**BASE, **VARIANTS[variant]}
    outs, busies = [], []
    for make, mod in ((_jax_engine, jlora), (_port_engine, tlora)):
        reg = mod.AdapterRegistry(max_active=2, **({"device": "cpu"} if mod is tlora else {}))
        for name, seed in ADAPTERS.items():
            ad = tlora.make_adapter(models[2], name, rank=4, seed=seed, scale=8.0)
            reg.register(mod.LoraAdapter(ad.adapter_id, ad.a, ad.b))
        busy = []
        _counting_acquire(reg, busy)
        release = threading.Event()
        _hold_after_pin(reg, "tenant-a", release)
        engine = make(models, conf, lora=reg)
        outs.append(_serve(engine, lambda e: _submit_behind_pin(e, reg, release)))
        busies.append(busy)
        if mod is tlora:
            _assert_clean(engine, reg)
        reg.close()
    assert outs[0] == outs[1] and all(o[0] == "length" for o in outs[1])
    assert "tenant-b" in busies[1] and "tenant-b" in busies[0]


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-bf16"])
def test_upload_fault_requeues_and_serves(models, variant):
    """The first upload raises (a patched ``_upload``) while admission
    waits on it: the row requeues with AdapterBusy, the next admission
    uploads again and serves the JAX engine's tokens, and no pin is
    left."""
    jeng, port, treg = _pair(models, variant)
    want = _serve(jeng, lambda e: _outcome(e.submit(SHORT, max_new_tokens=6, adapter_id="tenant-b")))
    waiting = threading.Event()
    real_upload, real_acquire = treg._upload, treg.acquire
    uploads, busy = [], []

    def flaky(adapter_id, slot):
        uploads.append(slot)
        if len(uploads) == 1:
            waiting.wait(10.0)  # fail only once admission waits on this upload
            raise RuntimeError("injected upload fault")
        return real_upload(adapter_id, slot)

    def acquire(adapter_id, timeout=5.0):
        waiting.set()
        try:
            return real_acquire(adapter_id, timeout=timeout)
        except tlora.AdapterBusy:
            busy.append(adapter_id)
            raise

    treg._upload, treg.acquire = flaky, acquire
    got = _serve(port, lambda e: _outcome(e.submit(SHORT, max_new_tokens=6, adapter_id="tenant-b")))
    assert got == want and got[0] == "length"
    assert busy == ["tenant-b"] and len(uploads) == 2
    assert treg.residency()["upload_faults_total"] == 1
    _assert_clean(port, treg)
    treg.close()


# ------------------------------------------------------------------- tenants
def _metered(mod):
    """A 30-token burst that refills at half a token a second: however
    long the first request takes, the bucket stays short for the second."""
    reg = mod.TenantRegistry()
    reg.set_policy(mod.TenantPolicy(name="metered", deadline_class="standard", token_rate=0.5,
                                    burst_tokens=30.0))
    return reg


def test_token_rate_budget_is_a_429(models):
    """prompt 3 + max_new 27 drains the 30-token burst; the next request
    of the tenant is a 429 with retry_after >= 0.05; another tenant
    serves. Both engines."""
    for make, mod, err in ((_jax_engine, jten, jerrors.ErrorTooManyRequests),
                           (_port_engine, tten, terrors.ErrorTooManyRequests)):
        tenants = _metered(mod)
        engine = make(models, {**BASE}, tenants=tenants)

        def run(e):
            first = _outcome(e.submit([1, 2, 3], max_new_tokens=27, tenant="metered"))
            with pytest.raises(err) as info:
                e.submit([1, 2, 3], max_new_tokens=27, tenant="metered")
            other = _outcome(e.submit([1, 2, 3], max_new_tokens=2, tenant="other"))
            return first, info.value, other

        first, exc, other = _serve(engine, run)
        assert first[0] == "length" and other[0] == "length"
        assert exc.status_code == 429 and exc.retry_after >= 0.05
        assert tenants.rejections == {"metered": 1}
        if mod is tten:
            _assert_clean(engine)


def test_deadline_class_fills_a_missing_deadline(models):
    """A tenant's class sets the priority and fills a missing deadline
    (a 1 ns class deadline: a 504 before any prefill); a request without a
    tenant is untouched. Both engines, white-box on the queued request."""
    for make, mod, err in ((_jax_engine, jten, jerrors.ErrorDeadlineExceeded),
                           (_port_engine, tten, terrors.ErrorDeadlineExceeded)):
        tenants = mod.TenantRegistry()
        tenants.set_policy(mod.TenantPolicy(name="twitchy", deadline_class="interactive",
                                            deadline_s=1e-9))
        tenants.set_policy(mod.TenantPolicy(name="bulk", deadline_class="batch"))
        engine = make(models, {**BASE}, tenants=tenants)
        futs = {name: engine.submit([1, 2, 3], max_new_tokens=4, tenant=name)
                for name in ("twitchy", "bulk", None)}
        reqs = {name: engine._by_id[f.request_id] for name, f in futs.items()}
        assert reqs[None].deadline is None and reqs[None].priority == 0
        assert reqs["bulk"].priority == 2 and reqs["bulk"].deadline is not None
        assert reqs["twitchy"].priority == 0
        assert 0 < reqs["twitchy"].deadline - reqs["twitchy"].created < 1e-6
        engine.start()
        try:
            with pytest.raises(err):
                futs["twitchy"].result(timeout=60)
            assert _outcome(futs["bulk"])[0] == "length"
            assert _outcome(futs[None])[0] == "length"
        finally:
            engine.stop()
        if mod is tten:
            _assert_clean(engine)


def test_class_aware_shedding_sheds_the_flood_never_interactive(models):
    """A stopped-loop engine with a 1 s cold prior and a 1.5 s threshold:
    batch-class requests shed once four of their class wait, and an
    interactive request behind the flood is admitted (only its own class
    stands before it). The same outcomes on both engines."""
    conf = {**BASE, "shed_cold_prior_s": 1.0, "shed_max_wait_s": 1.5}
    seqs = []
    for make, mod in ((_jax_engine, jten), (_port_engine, tten)):
        engine = make(models, conf, tenants=_storm_tenants(mod))
        seq = []
        for tenant in ["bulk"] * 6 + ["gold", "gold", "bulk"]:
            try:
                engine.submit([1, 2, 3], max_new_tokens=4, tenant=tenant)
                seq.append((tenant, "queued"))
            except (jerrors.HTTPError, terrors.HTTPError) as exc:
                seq.append((tenant, exc.status_code))
        engine.stop()
        seqs.append(seq)
        if mod is tten:
            _assert_clean(engine)
    assert seqs[0] == seqs[1]
    assert seqs[1] == [("bulk", "queued")] * 4 + [("bulk", 429)] * 2 + [
        ("gold", "queued"), ("gold", "queued"), ("bulk", 429)]


def test_from_config_reads_tenant_preempt():
    class Conf:
        def __init__(self, env):
            self.env = env

        def get(self, key):
            return self.env.get(key)

        def get_or_default(self, key, default):
            return self.env.get(key, default)

    for raw, want in ((None, True), ("1", True), ("0", False), ("off", False), ("false", False)):
        env = {} if raw is None else {"TPU_TENANT_PREEMPT": raw}
        assert EngineConfig.from_config(Conf(env)).tenant_preempt is want
        assert JEngineConfig.from_config(Conf(env)).tenant_preempt is want


# ---------------------------------------------------------------- preemption
def _storm(models, variant, *, tenants=True, **over):
    """The port engine of the preemption scenario, not started."""
    conf = {**STORM, **VARIANTS[variant], **over}
    return _port_engine(models, conf, tenants=_storm_tenants(tten) if tenants else None)


def _uninterrupted(models, variant):
    """The batch-class row served alone: (port tokens, JAX tokens)."""
    conf = {**STORM, **VARIANTS[variant]}
    run = lambda e: _outcome(e.submit(BULK_PROMPT, max_new_tokens=80, tenant="bulk"))  # noqa: E731
    port = _serve(_port_engine(models, conf, tenants=_storm_tenants(tten)), run)
    jax_out = _serve(_jax_engine(models, conf, tenants=_storm_tenants(jten)), run)
    assert port[0] == "length" and len(port[1]) == 80, "the greedy chain retired early"
    return port, jax_out


def _drive_storm(engine, second_tenant="gold"):
    """Serve the batch-class row; once a read block leaves it with >= 6
    tokens out, the engine thread itself submits the second request.
    Returns (bulk outcome, second outcome, stream frames, the bulk
    request, its first-token time as it was at the trigger, lookups)."""
    frames, state = [], {}
    real_consume = engine._consume

    def consume(rec):
        real_consume(rec)
        for req in engine.slots:
            if (req is not None and req.id == state.get("bulk_id") and len(req.tokens) >= 6
                    and "second" not in state):
                state["req"], state["ttft_at"] = req, req.first_token_at
                state["second"] = engine.submit(GOLD_PROMPT, max_new_tokens=4,
                                                tenant=second_tenant)

    engine._consume = consume
    lookups = []
    real_lookup = engine._cache_lookup

    def lookup(key):
        value, tier = real_lookup(key)
        if "second" in state:
            lookups.append((key, value is not None))
        return value, tier

    engine._cache_lookup = lookup
    engine.start()
    try:
        fut = engine.submit(BULK_PROMPT, max_new_tokens=80, tenant="bulk",
                            stream_cb=lambda t, s, d: None if d else frames.append(t))
        state["bulk_id"] = fut.request_id
        low = _outcome(fut)
        t_end = time.monotonic() + 60
        while "second" not in state and time.monotonic() < t_end:
            time.sleep(0.005)
        second = _outcome(state["second"])
    finally:
        engine.stop()
    return low, second, frames, state["req"], state["ttft_at"], lookups


@ALL
def test_preempt_resume_round_trip_preserves_tokens(models, variant):
    """The interactive request preempts the batch-class row on the single
    slot; the row resumes (bf16 KV: its chunk spans paged out and walked
    warm; int8 KV: recomputed) and its tokens equal an uninterrupted run's
    and the JAX engine's. Nothing is re-emitted and its TTFT is kept."""
    ctrl, jax_ctrl = _uninterrupted(models, variant)
    engine = _storm(models, variant)
    low, hi, frames, req, ttft_at, lookups = _drive_storm(engine)
    assert hi[0] == "length" and low == ctrl == jax_ctrl
    assert req.preemptions >= 1
    assert frames == low[1]  # every token streamed exactly once
    assert req.first_token_at == ttft_at  # the resume keeps the first token's TTFT
    chunk_hits = sum(hit for key, hit in lookups if key.startswith("chunkpfx:"))
    if variant.endswith("bf16"):
        assert chunk_hits >= 1  # the resume walked the paged-out spans warm
    else:
        assert not any(key.startswith("chunkpfx:") for key, _ in lookups)
    _assert_clean(engine)


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-int8"])
def test_equal_classes_never_preempt_each_other(models, variant):
    engine = _storm(models, variant)
    low, second, _, req, _, _ = _drive_storm(engine, second_tenant="bulk")
    assert low[0] == second[0] == "length" and req.preemptions == 0
    _assert_clean(engine)


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-bf16", "paged-int8"])
def test_pending_victim_is_preempted_only_once_its_blocks_are_read(models, variant):
    """decode_sync_every=2: the victim is marked pending (no further block
    feeds it) and paused only when none of its blocks is in flight; its
    tokens still equal the uninterrupted run's."""
    ctrl, _ = _uninterrupted(models, variant)
    engine = _storm(models, variant, decode_sync_every=2)
    seen = {"pending": 0, "preempted_in_flight": 0}
    real_maybe, real_preempt = engine._maybe_preempt, engine._preempt

    def maybe():
        did = real_maybe()
        seen["pending"] += bool(engine._preempt_pending)
        return did

    def preempt(slot):
        seen["preempted_in_flight"] += engine._row_in_flight(slot, engine.slots[slot])
        return real_preempt(slot)

    engine._maybe_preempt, engine._preempt = maybe, preempt
    low, hi, _, req, _, _ = _drive_storm(engine)
    assert low == ctrl and hi[0] == "length" and req.preemptions >= 1
    assert seen["pending"] >= 1 and seen["preempted_in_flight"] == 0
    _assert_clean(engine)


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-int8"])
def test_tenant_preempt_off_never_preempts(models, variant):
    """With ``tenant_preempt=False`` the interactive request waits for the
    whole batch-class row: it finishes after it, and nothing is paged
    out."""
    engine = _storm(models, variant, tenant_preempt=False)
    finished = []
    real_finish = engine._finish

    def finish(req, reason):
        finished.append(req.tenant)
        return real_finish(req, reason)

    engine._finish = finish
    low, hi, _, req, _, _ = _drive_storm(engine)
    assert low[0] == hi[0] == "length" and req.preemptions == 0
    assert finished == ["bulk", "gold"]
    _assert_clean(engine)
