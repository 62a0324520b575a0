"""The port engine's observability plane against the JAX ServingEngine's, on
the CPU at ``LlamaConfig.tiny(vocab_size=300)`` (f32, the JAX package's
params carried across), over the dense and paged layouts with bf16 and
int8 KV. Each side gets a metrics Manager with the serving series (the
port's from ``register_serving_metrics``, the reference's as its framework
container registers them) and a Tracer over an in-memory exporter; every
request carries the same caller span as ``trace_ctx``.

Two scenarios, each driven from the engine thread (hooks after a block is
read) and from a queue filled before the loop starts, never after a sleep:

- the mix: a chunked prompt, a whole prompt, the same two again (a
  whole-prompt hit, and on bf16 KV a full chunk-chain hit), a request
  whose deadline passes in the queue (504), one canceled in the queue and
  one canceled mid-stream, a metered tenant over its budget (429, no
  timeline), a full queue (429 with a terminal timeline), and a
  ``warm_restart`` before the loop starts that requeues the rest;
- the storm: two batch-class rows fill both slots; once one has 6 tokens
  out, an interactive request arrives and preempts it.

The two engines agree on: span names, their parents and their attributes
(ids and times left out); each timeline's stamps, ``decode_blocks``,
``decode_tokens``, ``prefill_chunks``, ``prefix_tier``, ``finish_reason``
and ``terminal_marks == 1``; counter values, histogram counts by name and
label set, and the set of gauges that were set. ``open_spans()`` is 0
after the drain. On the port, the ``_block_sync`` and ``_first_token``
calls and the tokens are the same with and without the instruments.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import tracing as jtracing  # noqa: E402
from gofr_tpu.tracing import export as jexport  # noqa: E402
from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.metrics import new_metrics_manager as jnew_manager  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import kv_cache as jkv_cache  # noqa: E402
from gofr_tpu.serving import tenancy as jten  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch import tracing  # noqa: E402
from gofr_tpu_torch.metrics import new_metrics_manager  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import engine as tengine_mod  # noqa: E402
from gofr_tpu_torch.serving import register_serving_metrics  # noqa: E402
from gofr_tpu_torch.serving import tenancy as tten  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=2, max_seq_len=128, prefill_buckets=(16, 32), prefill_chunk_tokens=16,
            kv_page_size=8, max_queue=8, prefix_cache_entries=16)
VARIANTS = {
    "dense-bf16": dict(kv_layout="dense", kv_dtype="bf16"),
    "dense-int8": dict(kv_layout="dense", kv_dtype="int8"),
    "paged-bf16": dict(kv_layout="paged", kv_dtype="bf16"),
    "paged-int8": dict(kv_layout="paged", kv_dtype="int8"),
}
ALL = pytest.mark.parametrize("variant", sorted(VARIANTS))
LONG = [(7 * i) % 290 + 3 for i in range(40)]  # chunks of 16 + 16 + 8
SHORT = list(range(5, 16))  # 11 tokens: prefills whole
OTHERS = [[(11 * i + k) % 290 + 3 for i in range(9)] for k in range(4)]
BULK = [list(range(2, 20)), list(range(30, 48))]  # 18 tokens: chunks of 16 + 2
GOLD = [8, 9, 10]
TIME_ATTRS = {"queue.wait_s"}
SIDES = ("jax", "port")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True, scope="module")
def _reference_read_span_settles():
    """Queue C 20: the reference's ``PagedKVCache.read_span`` indexes the
    pools with a view of its host page table, whose upload is
    asynchronous, and the engine rewrites that row right after (a
    preemption frees the slot); under load the gather can read another
    table's pages. Each side's tokens are held elsewhere; here the
    reference's gather is awaited before the call returns, so the
    comparison sees the reference's intended behaviour."""
    real = jkv_cache.PagedKVCache.read_span

    def settled(self, slot, start, end):
        return jax.block_until_ready(real(self, slot, start, end))

    jkv_cache.PagedKVCache.read_span = settled
    yield
    jkv_cache.PagedKVCache.read_span = real


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


@pytest.fixture(scope="module")
def ref_catalog():
    """The reference's registrations, from its framework container."""
    from gofr_tpu.config import MapConfig
    from gofr_tpu.container.container import Container

    container = Container(MapConfig({"LOG_LEVEL": "ERROR"}, use_env=False))
    specs = [(type(i).__name__, i.name, i.description, getattr(i, "buckets", None))
             for i in container.metrics_manager._store.all()]
    container.close()
    return specs


def _ref_manager(specs):
    """A fresh reference Manager with every series the container registers."""
    m = jnew_manager()
    for kind, name, desc, buckets in specs:
        if kind == "Histogram":
            m.new_histogram(name, desc, buckets=buckets)
        elif kind == "Counter":
            m.new_counter(name, desc)
        elif kind == "UpDownCounter":
            m.new_updown_counter(name, desc)
        else:
            m.new_gauge(name, desc)
    return m


def _tenants(mod):
    reg = mod.TenantRegistry()
    reg.set_policy(mod.TenantPolicy(name="gold", deadline_class="interactive", deadline_s=600.0))
    reg.set_policy(mod.TenantPolicy(name="bulk", deadline_class="batch", deadline_s=600.0))
    # every class's deadline is far past the scenario, as gold's and bulk's:
    # the standard class's 10 s default passed in the queue of a JAX engine
    # compiling under a loaded parallel run, failing the request on one side
    reg.set_policy(mod.TenantPolicy(name="metered", deadline_class="standard", deadline_s=600.0,
                                    token_rate=0.5, burst_tokens=20.0))
    return reg


def _engine(models, side, variant, ref_catalog, instruments=True, **over):
    """(engine, manager, tracer, exporter), not started."""
    jcfg, jparams, tcfg, tparams = models
    conf = {**BASE, **VARIANTS[variant], **over}
    if side == "jax":
        mod, tmod, processor = jtracing, jten, jexport.SimpleSpanProcessor
        manager = _ref_manager(ref_catalog) if instruments else None
    else:
        mod, tmod, processor = tracing, tten, tracing.SimpleSpanProcessor
        manager = register_serving_metrics(new_metrics_manager()) if instruments else None
    exporter = mod.InMemoryExporter()
    tracer = mod.Tracer("t", processor(exporter)) if instruments else None
    kw = dict(metrics=manager, tracer=tracer, tenants=_tenants(tmod))
    if side == "jax":
        engine = JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer(), **kw)
    else:
        engine = ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(),
                               device="cpu", **kw)
    return engine, manager, tracer, exporter


def _hook_consume(engine, after):
    """Run ``after(engine)`` on the engine thread after every block read.
    A detok task queued during a read runs once the read is over: the
    reference stamps a block on the timeline after a retire in it queued
    the settlement, which copies the count into the decode span, so on a
    loaded host its span could miss the last block (ROADMAP Queue C 23;
    the port counts the block first)."""
    name = "_consume_block" if isinstance(engine, JServingEngine) else "_consume"
    real, submit = getattr(engine, name), engine._submit_detok
    reading = threading.RLock()

    def consume(rec):
        with reading:
            real(rec)
            after(engine)

    def after_the_read(task):
        def run():
            with reading:
                task()

        return submit(run)

    setattr(engine, name, consume)
    engine._submit_detok = after_the_read


def _outcome(fut, timeout=120):
    try:
        r = fut.result(timeout=timeout)
    except (jerrors.HTTPError, terrors.HTTPError) as exc:
        return (exc.status_code,)
    return r.finish_reason, r.token_ids


def _submit_or_status(engine, *args, **kw):
    try:
        return engine.submit(*args, **kw)
    except (jerrors.HTTPError, terrors.HTTPError) as exc:
        return exc.status_code


def _run_mix(engine, caller):
    """The mix scenario; returns each request's outcome by name."""
    state = {}

    def cancel_short(e):
        for req in e.slots:
            if req is not None and req.id == state["short"] and len(req.tokens) >= 2:
                e.cancel(req.id)

    _hook_consume(engine, cancel_short)
    kw = dict(trace_ctx=caller)
    futs = {
        "long": engine.submit(LONG, max_new_tokens=6, **kw),
        "short": engine.submit(SHORT, max_new_tokens=12, **kw),
        "short_hit": engine.submit(SHORT, max_new_tokens=6, **kw),
        "long_hit": engine.submit(LONG, max_new_tokens=6, **kw),
        "expired": engine.submit(OTHERS[0], max_new_tokens=6, deadline=0.05, **kw),
        "queued_cancel": engine.submit(OTHERS[1], max_new_tokens=6, **kw),
        "metered": engine.submit([1, 2, 3], max_new_tokens=17, tenant="metered", **kw),
    }
    state["short"] = futs["short"].request_id
    over = _submit_or_status(engine, [1, 2, 3], max_new_tokens=17, tenant="metered", **kw)
    futs["fill"] = engine.submit(OTHERS[2], max_new_tokens=5, tenant="gold", **kw)
    full = _submit_or_status(engine, OTHERS[3], max_new_tokens=5, **kw)
    engine.cancel(futs["queued_cancel"].request_id)
    time.sleep(0.1)  # the 504's deadline passes in the queue
    assert engine.warm_restart()  # requeues the queue and starts the loop
    out = {name: _outcome(f) for name, f in futs.items()}
    out["over_budget"], out["queue_full"] = over, full
    assert engine.drain(deadline_s=60)
    return out


def _run_storm(engine, caller):
    """The storm scenario; returns each request's outcome by name."""
    state = {}

    def trigger(e):
        rows = [r for r in e.slots if r is not None and r.tenant == "bulk"]
        if "gold" not in state and len(rows) == 2 and max(len(r.tokens) for r in rows) >= 6:
            state["gold"] = e.submit(GOLD, max_new_tokens=4, tenant="gold", trace_ctx=caller)

    _hook_consume(engine, trigger)
    futs = {f"bulk{i}": engine.submit(p, max_new_tokens=24, tenant="bulk", trace_ctx=caller)
            for i, p in enumerate(BULK)}
    engine.start()  # both rows admitted in the first iteration
    out = {name: _outcome(f) for name, f in futs.items()}
    t_end = time.monotonic() + 60
    while "gold" not in state and time.monotonic() < t_end:
        time.sleep(0.005)
    out["gold"] = _outcome(state["gold"])
    assert engine.drain(deadline_s=60)
    return out


def _spans(exporter, caller) -> dict:
    """Per request id: sorted (name, parent's name, attributes less times)."""
    by_id = {s.span_id: s for s in exporter.spans}
    out: dict = {}
    for s in exporter.spans:
        if s is caller:
            continue
        assert s.trace_id == caller.trace_id, s.name
        parent = "caller" if s.parent_id == caller.span_id else by_id[s.parent_id].name
        attrs = tuple(sorted((k, v) for k, v in s.attributes.items() if k not in TIME_ATTRS))
        out.setdefault(s.attributes["request.id"], []).append((s.name, parent, attrs))
    return {rid: sorted(v) for rid, v in out.items()}


def _timelines(engine) -> dict:
    out = {}
    for tl in engine.timeline.completed():
        out[tl.request_id] = (
            sorted(tl.phases), tl.decode_blocks, tl.decode_tokens,
            [(c["index"], c["start"], c["tokens"], c["prefix_hit"]) for c in tl.prefill_chunks],
            tl.prefix_tier, tl.finish_reason, tl.terminal_marks, tl.tenant,
        )
    assert not engine.timeline.in_flight()
    return out


def _metrics(manager, names) -> dict:
    """Counter values, histogram counts by label set, and the gauges set,
    for every name of the port's catalog."""
    out = {}
    for name in names:
        inst = manager.get(name)
        kind = type(inst).__name__
        with inst._lock:
            series = dict(inst._series)
        if kind == "Histogram":
            out[name] = {k: v[2] for k, v in series.items()}
        elif kind == "Counter":
            out[name] = series
        else:
            out[name] = sorted(series)
    return out


def _observe(models, variant, ref_catalog, run) -> dict:
    """Run one scenario on a JAX and a port engine and return each side's
    record: outcomes, spans, timelines, metrics, open spans after drain."""
    from gofr_tpu_torch.serving.metrics_catalog import SERVING_METRICS

    names = [n for _, n, _, _ in SERVING_METRICS]
    record = {}
    for side in SIDES:
        engine, manager, tracer, exporter = _engine(models, side, variant, ref_catalog)
        caller = tracer.start_span("caller", activate=False)
        try:
            outcomes = run(engine, caller)
        finally:
            engine.stop()
        caller.end()
        emitted = {i.name for i in manager._store.all() if i._series}
        assert emitted <= set(names), emitted - set(names)
        record[side] = {
            "outcomes": outcomes, "spans": _spans(exporter, caller),
            "timelines": _timelines(engine), "metrics": _metrics(manager, names),
            "open_spans": tracer.open_spans(),
        }
    return record


@ALL
def test_mix_matches_the_reference(models, ref_catalog, variant):
    rec = _observe(models, variant, ref_catalog, _run_mix)
    port, ref = rec["port"], rec["jax"]
    for key in ("outcomes", "timelines", "spans", "metrics"):
        assert port[key] == ref[key], key
    assert port["open_spans"] == ref["open_spans"] == 0
    out = port["outcomes"]
    assert out["expired"] == (504,) and out["queued_cancel"] == (503,)
    assert out["short"][0] == "cancel" and out["over_budget"] == 429 and out["queue_full"] == 429
    tls = port["timelines"]
    assert all(t[6] == 1 for t in tls.values())  # exactly one terminal mark each
    reasons = sorted(t[5] for t in tls.values())
    assert reasons.count("shed") == 1 and reasons.count("deadline_exceeded") == 1
    assert reasons.count("cancel") == 1 and reasons.count("unavailable") == 1
    tiers = [t[4] for t in tls.values() if t[4] is not None]
    assert "device" in tiers and "miss" in tiers
    chunked = [t for t in tls.values() if len(t[3]) == 3]
    assert chunked and all([c[2] for c in t[3]] == [16, 16, 8] for t in chunked)
    hits = port["metrics"]["app_kv_prefix_hits_total"]
    assert sum(hits.values()) == len(tiers)
    shed = port["metrics"]["app_requests_shed_total"]
    assert shed == {(): 1.0, (("tenant", "metered"),): 1.0}
    for spans in port["spans"].values():
        assert spans[0][0] == "engine.queue" or any(s[0] == "engine.queue" for s in spans)
        assert all(parent == "engine.queue" for name, parent, _ in spans
                   if name.startswith("serve."))


@ALL
def test_storm_preemption_matches_the_reference(models, ref_catalog, variant):
    rec = _observe(models, variant, ref_catalog, _run_storm)
    port, ref = rec["port"], rec["jax"]
    for key in ("outcomes", "timelines", "spans", "metrics"):
        assert port[key] == ref[key], key
    assert port["open_spans"] == ref["open_spans"] == 0
    assert port["metrics"]["app_tenant_preemptions_total"] == {(("tenant", "bulk"),): 1.0}
    stamps = [t[0] for t in port["timelines"].values()]
    assert sum("preempted:1" in s for s in stamps) == 1
    resumed = [t for t in port["timelines"].values() if "preempted:1" in t[0]]
    # the resume's first token is not a TTFT: one per request that ran
    ttft = port["metrics"]["app_ttft_seconds"]
    assert ttft == {(): 3} and len(resumed) == 1


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-int8"])
def test_instruments_add_no_sync(models, ref_catalog, variant, monkeypatch):
    """The port's mix with and without instruments: the same tokens, the
    same ``_block_sync`` calls and the same ``_first_token`` syncs."""
    counts, outcomes = {}, {}
    for with_instruments in (True, False):
        n = {"block_sync": 0, "first_token": 0}
        real_sync = tengine_mod._block_sync
        real_first = ServingEngine._first_token

        def counting_sync(packed, _real=real_sync, _n=n):
            _n["block_sync"] += 1
            return _real(packed)

        def counting_first(self, *a, _real=real_first, _n=n, **kw):
            _n["first_token"] += 1
            return _real(self, *a, **kw)

        monkeypatch.setattr(tengine_mod, "_block_sync", counting_sync)
        monkeypatch.setattr(ServingEngine, "_first_token", counting_first)
        engine, _, tracer, _ = _engine(models, "port", variant, ref_catalog,
                                       instruments=with_instruments)
        caller = tracer.start_span("caller", activate=False) if tracer else None
        try:
            outcomes[with_instruments] = _run_mix(engine, caller)
        finally:
            engine.stop()
        monkeypatch.undo()
        counts[with_instruments] = n
    assert outcomes[True] == outcomes[False]
    assert counts[True] == counts[False]
    assert counts[True]["block_sync"] > 0 and counts[True]["first_token"] > 0


@ALL
def test_decode_span_counts_the_last_block(models, ref_catalog, variant):
    """The worst order of the race in ROADMAP Queue C 23, made certain:
    every detok task runs inline on the engine thread, so a settlement
    queued by a retire runs inside the block read that retired the row.
    The port counts the block before its commits, so each decode span's
    ``decode.blocks`` is still its timeline's count (the reference's span
    would miss the last block here)."""
    engine, _, tracer, exporter = _engine(models, "port", variant, ref_catalog)

    def inline(task):
        task()
        return True

    engine._submit_detok = inline
    caller = tracer.start_span("caller", activate=False)
    engine.start()
    try:
        futs = [engine.submit(p, max_new_tokens=n, trace_ctx=caller)
                for p, n in ((SHORT, 9), (LONG, 6), (OTHERS[0], 11))]
        results = [f.result(timeout=120) for f in futs]
    finally:
        engine.stop()
    caller.end()
    blocks = {s.attributes["request.id"]: s.attributes["decode.blocks"]
              for s in exporter.spans if s.name == "serve.decode"}
    timelines = {tl.request_id: tl.decode_blocks for tl in engine.timeline.completed()}
    assert set(blocks) == {r.request_id for r in results}
    assert blocks == {rid: timelines[rid] for rid in blocks}
    assert all(n > 0 for n in blocks.values())
