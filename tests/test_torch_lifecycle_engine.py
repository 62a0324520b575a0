"""The port engine's request lifecycle against the JAX ServingEngine, on
the CPU at ``LlamaConfig.tiny`` (f32, the JAX package's params carried
across), over the dense and paged layouts with bf16 and int8 KV.

Each scenario runs on a fresh pair of engines of one configuration (two
slots, buckets 16 and 32, 16-token chunks, 8-token pages, N = 4) and
drives both through the same calls: priority admission, cancel of a
queued, a running and a mid-chunked-prefill request, a queued expiry and
a mid-stream deadline, a failing ``stream_cb``, an over-long prompt, a
prompt the pool can never hold, drain and drain past its deadline, load
shedding, the pipeline depth ``decode_sync_every`` and ``stream()`` left
early. Finish reasons, exception types and status codes must be equal,
greedy tokens identical (a request cut short by a cancel or a deadline
emits a prefix of the same greedy sequence on both), and every scenario
ends with no busy slot and no owned page. Timing is pinned the way the
reference's own tests pin it: cancels and deadline moves happen inside a
token frame or a white-box hook, never after a sleep, and a request that
is canceled mid-decode has a budget of at least 25 blocks.
"""

import asyncio
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
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
PAGED = pytest.mark.parametrize("variant", ["paged-bf16", "paged-int8"])
LONG = 100  # max_new_tokens of a request cut short mid-decode: 25 blocks of 4


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


def _pair(models, variant="dense-bf16", **kw):
    """(JAX engine, port engine) of one configuration, not started."""
    jcfg, jparams, tcfg, tparams = models
    conf = {**BASE, **VARIANTS[variant], **kw}
    return (JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer()),
            ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu"))


def _outcome(fut, timeout=120):
    """(finish reason, token ids, prompt tokens) or (status code,)."""
    try:
        r = fut.result(timeout=timeout)
    except (jerrors.HTTPError, terrors.HTTPError) as exc:
        return (exc.status_code,)
    return r.finish_reason, r.token_ids, r.prompt_tokens


def _assert_clean(engine):
    """No busy slot, no request left and, on the paged layout, every page
    free (the loop releases a slot before it settles the request)."""
    t_end = time.monotonic() + 10
    while any(s is not None for s in engine.slots) and time.monotonic() < t_end:
        time.sleep(0.005)
    assert all(s is None for s in engine.slots)
    assert engine._sched.stats()["busy_slots"] == 0
    assert not engine._by_id
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"], stats


def _prefix_related(a: list, b: list) -> bool:
    n = min(len(a), len(b))
    return a[:n] == b[:n]


# ------------------------------------------------------------------ priority
@ALL
def test_priority_admission_order_and_tokens(models, variant):
    """Two priority-5 requests queued before two priority-0 ones, on two
    slots: the priority-0 pair is admitted first (one prefills whole, one
    chunks), then the priority-5 pair, and every greedy completion is
    identical."""
    prompts = [("low one", 5), ("low two, long enough to chunk: " * 2, 5),
               ("high one, also longer than a chunk", 0), ("hi", 0)]
    outs = []
    for engine in _pair(models, variant):
        order = []
        for name in ("_prefill_into", "_start_cursor"):
            real = getattr(engine, name)
            setattr(engine, name, lambda slot, req, _real=real: (order.append(req.id),
                                                                 _real(slot, req))[1])
        futs = [engine.submit(text, max_new_tokens=10, priority=prio) for text, prio in prompts]
        engine.start()
        try:
            outs.append([_outcome(f) for f in futs])
            _assert_clean(engine)
        finally:
            engine.stop()
        ids = [f.request_id for f in futs]
        assert sorted(order[:2]) == ids[2:] and sorted(order[2:]) == ids[:2], (order, ids)
    assert outs[1] == outs[0]


# -------------------------------------------------------------------- cancel
@ALL
def test_cancel_queued_request(models, variant):
    """A request canceled while queued finishes "cancel" with no token; the
    one beside it is served as before."""
    outs = []
    for engine in _pair(models, variant):
        keep = engine.submit("served", max_new_tokens=6)
        gone = engine.submit("canceled in the queue", max_new_tokens=6)
        engine.cancel(gone.request_id)
        engine.start()
        try:
            outs.append((_outcome(keep), _outcome(gone)))
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[1] == outs[0]
    assert outs[0][1] == ("cancel", [], len("canceled in the queue") + 1)


@ALL
def test_cancel_running_request(models, variant):
    """Canceled from its own 3rd token frame: "cancel" with at least 3 and
    fewer than the budget's tokens, a prefix of the same greedy sequence on
    both engines; a queued request then takes the slot."""
    outs = []
    for engine in _pair(models, variant):
        engine.start()
        try:
            seen = []

            def cb(token_id, piece, done, _seen=seen, _engine=engine):
                if not done:
                    _seen.append(token_id)
                    if len(_seen) == 3:
                        _engine.cancel(fut.request_id)

            fut = engine.submit("cancel me while I run", max_new_tokens=LONG, stream_cb=cb)
            other = engine.submit("holds the other slot", max_new_tokens=LONG)
            after = engine.submit("next in line", max_new_tokens=5)
            outs.append((_outcome(fut), _outcome(after), _outcome(other)))
            _assert_clean(engine)
        finally:
            engine.stop()
    (jr, jafter, jother), (tr, tafter, tother) = outs
    assert jr[0] == tr[0] == "cancel" and (tafter, tother) == (jafter, jother)
    for r in (jr, tr):
        assert 3 <= len(r[1]) < LONG
    assert _prefix_related(jr[1], tr[1])


@ALL
def test_cancel_mid_chunked_prefill(models, variant):
    """A 100-token prompt (seven 16-token chunks) canceled once its first
    chunk has been dispatched: "cancel" with 0 tokens once nothing of it is
    in flight, and its slot and pages are free."""
    outs = []
    for engine in _pair(models, variant):
        health = engine._cursor_health
        canceled = []

        def hook(slot, req, cursor, *rest, _engine=engine, _health=health, _canceled=canceled):
            if cursor.total == 100 and cursor.dispatched > 0 and not _canceled:
                _canceled.append(req.id)
                _engine.cancel(req.id)
            return _health(slot, req, cursor, *rest)

        engine._cursor_health = hook
        engine.start()
        try:
            beside = engine.submit("decoding beside", max_new_tokens=20)
            fut = engine.submit("c" * 99, max_new_tokens=8)
            outs.append((_outcome(fut), _outcome(beside)))
            _assert_clean(engine)
        finally:
            engine.stop()
        assert canceled
    assert outs[1] == outs[0]
    assert outs[0][0] == ("cancel", [], 100)


# ----------------------------------------------------------------- deadlines
@ALL
def test_queued_expiry_is_504_and_never_prefills(models, variant):
    outs = []
    for engine in _pair(models, variant):
        started = []
        for name in ("_prefill_into", "_start_cursor"):
            real = getattr(engine, name)
            setattr(engine, name, lambda slot, req, _real=real: (started.append(req.id),
                                                                 _real(slot, req))[1])
        short = engine.submit("born dead", max_new_tokens=4, deadline=1e-9)
        long_ = engine.submit("x" * 40, max_new_tokens=4, deadline=1e-9)  # would chunk
        engine.start()
        try:
            outs.append((_outcome(short), _outcome(long_), _outcome(engine.submit("alive", max_new_tokens=3))))
            _assert_clean(engine)
        finally:
            engine.stop()
        assert short.request_id not in started and long_.request_id not in started
    assert outs[1] == outs[0]
    assert outs[0][:2] == ((504,), (504,)) and outs[0][2][0] in ("length", "stop")


@ALL
def test_mid_stream_deadline_retires_and_reclaims(models, variant):
    """The deadline moved into the past from the 2nd token frame (the
    reference tests' white-box pattern): "deadline_exceeded" with partial
    greedy tokens, and the slot is reclaimed."""
    outs = []
    for engine in _pair(models, variant):
        engine.start()
        try:
            seen = []

            def cb(token_id, piece, done, _seen=seen, _engine=engine):
                if not done:
                    _seen.append(token_id)
                    if len(_seen) == 2:
                        with _engine._count_lock:
                            req = _engine._by_id[fut.request_id]
                        req.deadline = time.monotonic() - 1.0

            fut = engine.submit("stream me", max_new_tokens=LONG, deadline=60.0, stream_cb=cb)
            outs.append(_outcome(fut))
            _assert_clean(engine)
        finally:
            engine.stop()
    (jr, tr) = outs
    assert jr[0] == tr[0] == "deadline_exceeded"
    assert all(2 <= len(r[1]) < LONG for r in outs) and _prefix_related(jr[1], tr[1])


# ----------------------------------------------------------------- callbacks
@ALL
def test_failing_stream_callback_cancels(models, variant):
    """A stream_cb that raises cancels its request before its budget (the
    reference sets the flag in its detok worker too)."""
    outs = []
    for engine in _pair(models, variant):
        engine.start()

        def cb(token_id, piece, done):
            raise RuntimeError("client went away")

        try:
            outs.append(_outcome(engine.submit("hello world", max_new_tokens=LONG, stream_cb=cb)))
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[0][0] == outs[1][0] == "cancel"
    assert all(1 <= len(r[1]) < LONG for r in outs) and _prefix_related(outs[0][1], outs[1][1])


# ------------------------------------------------------------ prompt lengths
@ALL
@pytest.mark.parametrize("length", [150, 128])
def test_over_long_prompt_is_served_from_its_tail(models, variant, length):
    """A prompt of max_seq_len tokens or more keeps its last 127, chunks,
    and yields one token with "length", as in the reference."""
    outs = []
    ids = [3 + (7 * i) % 290 for i in range(length)]
    for engine in _pair(models, variant):
        engine.start()
        try:
            outs.append(_outcome(engine.submit(ids, max_new_tokens=8)))
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[1] == outs[0]
    assert outs[0][0] == "length" and len(outs[0][1]) == 1 and outs[0][2] == 127


@PAGED
@pytest.mark.parametrize("route", ["monolithic", "chunked"])
def test_never_fit_paged_prompt_is_413(models, variant, route):
    """Three 8-token pages in all: a 20-token prompt (32-token chunks, so
    it prefills whole at bucket 32: 4 pages) and a 40-token one (16-token
    chunks: 5 pages) can never fit; each fails its
    future with a 413 at admission, and the engine serves on."""
    text = "x" * 19 if route == "monolithic" else "y" * 39
    chunk = 32 if route == "monolithic" else 16
    outs = []
    for engine in _pair(models, variant, kv_num_pages=3, prefill_chunk_tokens=chunk):
        engine.start()
        try:
            fut = engine.submit(text, max_new_tokens=4)
            assert engine._route_chunked(20 if route == "monolithic" else 40) == (route == "chunked")
            with pytest.raises((jerrors.ErrorRequestEntityTooLarge,
                                terrors.ErrorRequestEntityTooLarge)) as err:
                fut.result(timeout=120)
            assert err.value.response_headers() == {}
            outs.append(_outcome(engine.submit("ok", max_new_tokens=3)))
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[1] == outs[0] and outs[0][0] in ("length", "stop")


# ------------------------------------------- submit refusals (ROADMAP Queue C 21, 22)
def _ref_outcome(call):
    """How the reference answered: raised at submit (type, status), failed
    its future (type), or served (finish reason, tokens emitted)."""
    try:
        fut = call()
    except jerrors.HTTPError as exc:
        return ("raise", type(exc).__name__, exc.status_code)
    try:
        r = fut.result(timeout=120)
    except Exception as exc:  # noqa: BLE001 - the reference's bare error, recorded
        return ("future", type(exc).__name__)
    return ("result", r.finish_reason, len(r.token_ids))


@pytest.mark.parametrize("variant", ["dense-bf16", "paged-bf16"])
@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("case", ["negative_max_new_tokens", "empty_prompt"])
def test_submit_refusals_are_400_before_an_id(models, variant, backend, case, monkeypatch):
    """A negative ``max_new_tokens`` and an empty token-list prompt: the
    port refuses each at ``submit`` with a 400 naming the parameter,
    before a request id is taken, and leaves no timeline. Beside it the
    reference's outcomes, a deliberate difference: with its native
    scheduler a negative budget is a retriable 503 (a router would retry
    it on every replica), with its Python scheduler the request emits one
    token; an empty prompt fails its future at admission with a bare
    IndexError under either. Neither side leaves a busy slot."""
    import gofr_tpu.native.runtime as jruntime

    if backend == "python":
        monkeypatch.setattr(jruntime, "load_runtime", lambda: None)
    call_kw = ({"prompt": "hello", "max_new_tokens": -1} if case == "negative_max_new_tokens"
               else {"prompt": []})
    jeng, teng = _pair(models, variant)
    outs = {}
    for name, engine in (("jax", jeng), ("port", teng)):
        engine.start()
        try:
            ids = engine._next_id
            if name == "jax":
                outs[name] = _ref_outcome(lambda: engine.submit(**call_kw))
            else:
                with pytest.raises(terrors.ErrorInvalidParam) as err:
                    engine.submit(**call_kw)
                outs[name] = ("raise", type(err.value).__name__, err.value.status_code,
                              err.value.params)
                snap = engine.timeline.snapshot()
                assert snap["in_flight_count"] == snap["completed_count"] == 0
            outs[name + "_ids"] = engine._next_id - ids
            outs[name + "_after"] = _outcome(engine.submit("still serving", max_new_tokens=3))
            _assert_clean(engine)
        finally:
            engine.stop()
    param = "max_new_tokens" if case == "negative_max_new_tokens" else "prompt"
    assert outs["port"] == ("raise", "ErrorInvalidParam", 400, [param])
    assert outs["port_ids"] == 0 and outs["jax_ids"] == 1
    assert outs["port_after"] == outs["jax_after"]
    native = jeng._sched.backend == "native"
    if case == "empty_prompt":
        assert outs["jax"] == ("future", "IndexError")
    elif native:
        assert outs["jax"] == ("raise", "ErrorServiceUnavailable", 503)
    else:
        assert outs["jax"] == ("result", "length", 1)


# --------------------------------------------------------------------- drain
@ALL
def test_drain_lets_work_finish(models, variant):
    outs = []
    for engine in _pair(models, variant):
        engine.start()
        futs = [engine.submit(f"req {i}" * (1 + 5 * (i % 2)), max_new_tokens=6) for i in range(4)]
        assert engine.drain(deadline_s=60) is True
        outs.append([_outcome(f, timeout=1) for f in futs])
        assert all(s is None for s in engine.slots) and engine._sched.stats()["busy_slots"] == 0
        with pytest.raises((jerrors.ErrorServiceUnavailable, terrors.ErrorServiceUnavailable)) as err:
            engine.submit("after drain")
        assert err.value.status_code == 503 and "Retry-After" in err.value.response_headers()
    assert outs[1] == outs[0] and all(o[0] in ("length", "stop") for o in outs[0])


@ALL
def test_drain_past_deadline_fails_the_rest_retriable(models, variant):
    for engine in _pair(models, variant):
        engine.start()
        futs = [engine.submit(f"req {i}", max_new_tokens=LONG) for i in range(6)]
        assert engine.drain(deadline_s=0.0) is False
        for f in futs:
            out = _outcome(f, timeout=30)
            assert out == (503,) or out[0] in ("cancel", "length", "stop"), out
        assert all(s is None for s in engine.slots) and engine._sched.stats()["busy_slots"] == 0
        assert not engine._thread or not engine._thread.is_alive()


# ---------------------------------------------------------------------- shed
@pytest.mark.parametrize("how", ["deadline", "threshold", "queue_full"])
def test_shed_is_429_with_retry_after(models, how):
    """Not started, so submissions stay queued. A request whose deadline
    is shorter than the estimated wait, or any request past
    ``shed_max_wait_s``, is shed; a full queue rejects too."""
    kw = {"shed_max_wait_s": 0.5} if how == "threshold" else {}
    if how == "queue_full":
        kw["max_queue"] = 2
    answers = []
    for engine in _pair(models, **kw):
        engine._shed.observe_request(10.0)
        engine.submit("first", max_new_tokens=2)
        if how == "queue_full":
            engine.submit("second", max_new_tokens=2)
        with pytest.raises((jerrors.ErrorTooManyRequests, terrors.ErrorTooManyRequests)) as err:
            engine.submit("doomed", max_new_tokens=2, deadline=0.01 if how == "deadline" else None)
        exc = err.value
        answers.append((exc.status_code, exc.retry_after, exc.response_headers(), exc.response_fields()))
        if how == "deadline":
            engine.submit("patient", max_new_tokens=2)  # no deadline: not shed
        engine.stop()
    assert answers[1] == answers[0]
    assert answers[0][0] == 429 and answers[0][1] > 0 and "Retry-After" in answers[0][2]


# ----------------------------------------------------------- pipeline depth
@ALL
@pytest.mark.parametrize("depth", [2, 3])
def test_decode_sync_every_matches_jax_engine(models, variant, depth):
    prompts = ["hi", "the quick brown fox jumps over", "a prompt longer than every prefill bucket",
               "0123456789abcde", "x" * 70]
    outs = []
    for engine in _pair(models, variant, decode_sync_every=depth):
        engine.start()
        try:
            futs = [engine.submit(p, max_new_tokens=14) for p in prompts]
            outs.append([_outcome(f) for f in futs])
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[1] == outs[0]


# -------------------------------------------------------------------- stream
@pytest.mark.parametrize("variant", ["dense-bf16", "paged-int8"])
def test_stream_tokens_and_early_exit(models, variant):
    """``stream()`` yields the result's tokens; leaving it after 4 tokens
    cancels the request."""
    outs = []
    for engine in _pair(models, variant):
        engine.start()
        futs = []
        submit = engine.submit

        def spy(*a, _submit=submit, _futs=futs, **kw):
            _futs.append(_submit(*a, **kw))
            return _futs[-1]

        engine.submit = spy

        async def consume(_engine=engine):
            final, whole, early = {}, [], []
            async for token_id, _ in _engine.stream("stream all of me", max_new_tokens=16,
                                                    on_result=lambda r: final.setdefault("r", r)):
                whole.append(token_id)
            agen = _engine.stream("leave me early", max_new_tokens=LONG)
            async for token_id, _ in agen:
                early.append(token_id)
                if len(early) == 4:
                    break
            await agen.aclose()
            return final["r"], whole, early

        try:
            result, whole, early = asyncio.run(consume())
            assert whole == result.token_ids and len(whole) == result.completion_tokens
            left = _outcome(futs[1])
            outs.append((result.token_ids, result.finish_reason, left[0], early))
            _assert_clean(engine)
        finally:
            engine.stop()
    assert outs[1][:3] == outs[0][:3] and outs[0][2] == "cancel"
    assert outs[1][3] == outs[0][3]
