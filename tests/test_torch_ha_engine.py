"""The port engine's HA plane against the JAX ServingEngine, on the CPU at
``LlamaConfig.tiny`` (vocab 300, the JAX package's params carried across),
over the dense and paged layouts.

The engine-level cases of the reference's ``tests/test_ha.py`` (a stale
fence epoch at the engine wire, a duplicate's disconnect that must not
cancel the owner, a duplicate past the replay window attached truncated,
a failed admission after the claim forgetting its key), plus concurrent
keyed duplicates (one admission, one terminal mark), a keyed resume that
is token-identical, and an orphan reaped after its grace. Each scenario
runs on a fresh JAX engine and a fresh port engine of one configuration,
through the same calls; the outcomes, error types and status codes,
greedy tokens and ``dedup_stats`` must be equal on both sides. Timing is
pinned inside token frames and white-box hooks, never by a sleep alone.
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
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16, 32), prefill_chunk_tokens=16,
            kv_page_size=8, max_queue=64)
LAYOUTS = pytest.mark.parametrize("layout", ["dense", "paged"])
PROMPT = "resume me exactly once "  # 24 tokens: two 16-token chunks
TIMEOUT = 120


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


def _pair(models, layout, **kw):
    """(JAX engine, port engine) of one configuration, not started."""
    jcfg, jparams, tcfg, tparams = models
    conf = {**BASE, "kv_layout": layout, **kw}
    return (JServingEngine(jcfg, jparams, JEngineConfig(**conf), JByteTokenizer()),
            ServingEngine(tcfg, tparams, EngineConfig(**conf), ByteTokenizer(), device="cpu"))


def _slow_blocks(engine, seconds, after=None):
    """Each block read takes ``seconds`` longer on the engine thread (the
    reference reads a block in ``_consume_block``), and ``after()`` runs on
    the engine thread once each read is done."""
    name = "_consume_block" if isinstance(engine, JServingEngine) else "_consume"
    real = getattr(engine, name)

    def slowed(rec):
        time.sleep(seconds)
        out = real(rec)
        if after is not None:
            after()
        return out

    setattr(engine, name, slowed)


def _error(exc):
    return type(exc).__name__, exc.status_code


def _assert_clean(engine):
    t_end = time.monotonic() + 10
    while any(s is not None for s in engine.slots) and time.monotonic() < t_end:
        time.sleep(0.005)
    assert all(s is None for s in engine.slots)
    assert engine._sched.stats()["busy_slots"] == 0
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        assert stats["free_blocks"] == stats["total_blocks"], stats


def _run(pair, scenario):
    """The scenario on each engine of the pair (started, then stopped)."""
    outs = []
    for engine in pair:
        engine.start()
        try:
            outs.append(scenario(engine))
        finally:
            engine.stop()
    return outs


# ------------------------------------------------------------------- fencing
@LAYOUTS
def test_stale_epoch_rejected_at_engine_wire(models, layout):
    """After a warm restart a caller with the old epoch is fenced at the
    engine wire: a 409 before any gate, no request id taken, nothing
    admitted, no dedup entry; resume and cancel are fenced the same way,
    and a caller with the new epoch is served."""

    def scenario(engine):
        out = {"first": engine.submit(PROMPT, max_new_tokens=4,
                                      fence_epoch=engine.epoch).result(TIMEOUT).token_ids}
        old = engine.epoch
        assert engine.warm_restart(join_timeout=30.0)
        out["epochs"] = (old, engine.epoch)
        next_id = engine._next_id
        admitted = engine.health_check()["details"]["total_admitted"]
        with pytest.raises((jerrors.ErrorStaleEpoch, terrors.ErrorStaleEpoch)) as ei:
            engine.submit(PROMPT, max_new_tokens=4, fence_epoch=old, idempotency_key="zombie")
        out["submit"] = (_error(ei.value), "refresh membership" in str(ei.value))
        out["ids_taken"] = engine._next_id - next_id
        out["admitted"] = engine.health_check()["details"]["total_admitted"] - admitted
        out["dedup"] = engine.dedup_stats()
        for name, call in (("resume", lambda: engine.resume("zombie", fence_epoch=old)),
                           ("cancel", lambda: engine.cancel(1, fence_epoch=old))):
            with pytest.raises((jerrors.ErrorStaleEpoch, terrors.ErrorStaleEpoch)) as ei:
                call()
            out[name] = _error(ei.value)
        out["fresh"] = engine.submit(PROMPT, max_new_tokens=4,
                                     fence_epoch=engine.epoch).result(TIMEOUT).token_ids
        out["health_dedup"] = engine.health_check()["details"]["dedup"]
        return out

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout == jout
    assert tout["submit"] == (("ErrorStaleEpoch", 409), True)
    assert tout["ids_taken"] == tout["admitted"] == 0
    assert tout["dedup"] == {"live": 0, "terminal": 0, "hits_live": 0, "hits_terminal": 0,
                             "evicted": 0}


# ---------------------------------------------------------- duplicate submits
@LAYOUTS
def test_duplicate_disconnect_does_not_cancel_owner_stream(models, layout):
    """A duplicate keyed attach whose client drops (its transport orphans
    the request with a short grace) leaves the owner's stream running to
    its own terminal: the reaper stands down while the owner's lease
    remains."""

    def scenario(engine):
        frames = []
        rolling = threading.Event()

        def owner_cb(token_id, piece, done):
            frames.append((token_id, done))
            if len(frames) >= 3:
                rolling.set()

        fut = engine.submit(PROMPT, max_new_tokens=80, idempotency_key="dup-disconnect",
                            stream_cb=owner_cb)
        assert rolling.wait(TIMEOUT), "owner stream never started"
        dup = engine.submit(PROMPT, max_new_tokens=80, idempotency_key="dup-disconnect",
                            stream_cb=lambda *a: None)
        same = dup is fut
        engine.orphan(fut.request_id, grace_s=0.02)
        time.sleep(0.2)  # the reaper's window passes while the owner rides
        r = fut.result(TIMEOUT)
        _assert_clean(engine)
        streamed = [t for t, d in frames if not d]
        return {"same_future": same, "reason": r.finish_reason, "tokens": r.token_ids,
                "streamed_all": streamed == r.token_ids, "dedup": engine.dedup_stats()}

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout == jout
    assert tout["same_future"] and tout["streamed_all"] and tout["reason"] == "length"
    assert len(tout["tokens"]) == 80


@LAYOUTS
def test_duplicate_submit_past_replay_window_attaches_truncated(models, layout):
    """A keyed retry of a generation whose emitted frames outran a 4-frame
    replay window still dedups: a truncated live attach with the engine's
    true base seq, the full result through a mirror future, and exactly
    the live suffix past the attach point on its stream."""

    def scenario(engine):
        emitted = threading.Event()
        count = [0]
        attached = threading.Event()

        def owner_cb(token_id, piece, done):
            if not done:
                count[0] += 1
                if count[0] == 8:  # past the 4-frame window: hold the stream here
                    emitted.set()
                    attached.wait(TIMEOUT)

        fut = engine.submit(PROMPT, max_new_tokens=100, idempotency_key="gap-dup",
                            stream_cb=owner_cb)
        assert emitted.wait(TIMEOUT), "owner stream never outran the window"
        dup_frames = []
        fut2 = engine.submit(PROMPT, max_new_tokens=100, idempotency_key="gap-dup",
                             stream_cb=lambda t, p, d: dup_frames.append((t, d)))
        attached.set()
        r, r2 = fut.result(TIMEOUT), fut2.result(TIMEOUT)
        base = getattr(fut2, "stream_base_seq", None)
        t_end = time.monotonic() + 30
        while (not dup_frames or not dup_frames[-1][1]) and time.monotonic() < t_end:
            time.sleep(0.01)
        _assert_clean(engine)
        return {"tokens": r.token_ids, "dup_tokens": r2.token_ids, "mirror": fut2 is not fut,
                "base": base, "done_last": bool(dup_frames) and dup_frames[-1][1],
                "suffix": [t for t, d in dup_frames if not d] == r.token_ids[base:],
                "dedup": engine.dedup_stats()}

    jout, tout = _run(_pair(models, layout, stream_replay_tokens=4), scenario)
    assert tout == jout
    assert tout["mirror"] and tout["base"] == 8 and tout["done_last"] and tout["suffix"]
    assert tout["dup_tokens"] == tout["tokens"] and len(tout["tokens"]) == 100


@LAYOUTS
def test_failed_admission_after_claim_forgets_key(models, layout):
    """A failure inside the claim-to-enqueue window (the flight recorder's
    begin raising) forgets the key: no live entry with a future that never
    resolves, and the next submit of the key runs fresh."""

    class Boom(RuntimeError):
        pass

    def scenario(engine):
        real = engine.timeline.begin

        def boom(*args, **kwargs):
            raise Boom("injected flight-recorder failure")

        engine.timeline.begin = boom
        try:
            with pytest.raises(Boom):
                engine.submit(PROMPT, max_new_tokens=4, idempotency_key="claim-window")
        finally:
            engine.timeline.begin = real
        stats = engine.dedup_stats()
        r = engine.submit(PROMPT, max_new_tokens=4, idempotency_key="claim-window").result(TIMEOUT)
        return {"after_failure": stats, "reason": r.finish_reason, "tokens": r.token_ids,
                "dedup": engine.dedup_stats()}

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout == jout
    assert tout["after_failure"]["live"] == tout["after_failure"]["terminal"] == 0
    assert tout["reason"] == "length" and tout["dedup"]["terminal"] == 1


@LAYOUTS
def test_concurrent_keyed_duplicates_admit_once(models, layout):
    """Eight threads submit one key at once: one admission, one timeline
    with one terminal mark, eight equal results, seven registry hits; a
    ninth submit after the terminal replays it and admits nothing."""
    n = 8

    def scenario(engine):
        admitted = engine._sched.stats()["total_admitted"]
        next_id = engine._next_id
        barrier = threading.Barrier(n)
        results, errors = [None] * n, []

        def submit(i):
            try:
                barrier.wait(TIMEOUT)
                results[i] = engine.submit(PROMPT, max_new_tokens=12, temperature=0.8,
                                           idempotency_key="storm").result(TIMEOUT)
            except BaseException as exc:  # noqa: BLE001 - surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not errors, errors
        tl = engine.timeline.get(results[0].request_id)
        frames = []
        replay = engine.submit(PROMPT, max_new_tokens=12, idempotency_key="storm",
                               stream_cb=lambda t, p, d: frames.append((t, d))).result(TIMEOUT)
        _assert_clean(engine)
        d = engine.dedup_stats()
        # a racer that missed the lookup takes a request id before it loses
        # the claim, as in the reference (the claim follows the gates), and
        # a racer scheduled late may find the terminal: how many of each
        # depends on the threads' timing, so only the bounds are compared
        ids_taken = engine._next_id - next_id
        return {"admissions": engine._sched.stats()["total_admitted"] - admitted,
                "ids_taken_in_bounds": 1 <= ids_taken <= n,
                "same": all(r.token_ids == results[0].token_ids for r in results),
                "one_id": len({r.request_id for r in results}) == 1,
                "terminal_marks": tl.terminal_marks, "reason": results[0].finish_reason,
                "replay": replay.token_ids == results[0].token_ids,
                "replay_frames": [t for t, d in frames if not d] == results[0].token_ids
                and frames[-1] == (-1, True),
                "hits": d["hits_live"] + d["hits_terminal"], "live": d["live"],
                "terminal": d["terminal"]}

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout == jout
    assert tout["admissions"] == tout["terminal_marks"] == tout["terminal"] == 1
    assert tout["ids_taken_in_bounds"] and tout["hits"] == n and tout["live"] == 0
    assert tout["same"] and tout["one_id"] and tout["replay"] and tout["replay_frames"]


# ------------------------------------------------------------ resume, orphan
@LAYOUTS
def test_keyed_resume_is_token_identical(models, layout):
    """A keyed stream dropped at its 10th frame (orphaned with a long
    grace) and resumed with ``last_seq=10`` gets frames 11...N+1 exactly
    once, live, and the owner's first 10 tokens plus the resumed ones are
    the result; a resume after the terminal replays the stored result's
    frames past its ``last_seq``."""

    def scenario(engine):
        owner, at_ten, resumed = [], threading.Event(), threading.Event()

        def owner_cb(token_id, piece, done):
            owner.append((token_id, done))
            if len(owner) == 10:
                at_ten.set()
                resumed.wait(TIMEOUT)  # the stream holds until the resume attached

        fut = engine.submit(PROMPT, max_new_tokens=40, idempotency_key="resume-me",
                            stream_cb=owner_cb)
        assert at_ten.wait(TIMEOUT)
        engine.orphan(fut.request_id, grace_s=30.0)  # the client's transport died
        frames = []
        rfut = engine.resume("resume-me", last_seq=10,
                             stream_cb=lambda s, t, p, d: frames.append((s, t, d)))
        resumed.set()
        r = fut.result(TIMEOUT)
        t_end = time.monotonic() + 30
        while (not frames or not frames[-1][2]) and time.monotonic() < t_end:
            time.sleep(0.01)
        got = [t for t, _ in owner[:10]] + [t for _, t, d in frames if not d]
        late = []
        again = engine.resume("resume-me", last_seq=35,
                              stream_cb=lambda s, t, p, d: late.append((s, t, d)))
        _assert_clean(engine)
        n = len(r.token_ids)
        return {"same_future": rfut is fut, "reason": r.finish_reason, "tokens": r.token_ids,
                "identical": got == r.token_ids,
                "seqs": [s for s, _, _ in frames] == list(range(11, n + 2)),
                "late": late == [(s, r.token_ids[s - 1], False) for s in range(36, n + 1)]
                + [(n + 1, -1, True)],
                "late_result": again.result(TIMEOUT).token_ids == r.token_ids,
                "dedup": engine.dedup_stats()}

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout == jout
    assert tout["same_future"] and tout["identical"] and tout["seqs"]
    assert tout["late"] and tout["late_result"] and len(tout["tokens"]) == 40


@LAYOUTS
def test_resume_past_the_replay_window_or_of_an_unknown_key_is_a_404(models, layout):
    """A live resume whose ``last_seq`` fell behind a 4-frame window is a
    404 (a token-identical suffix is impossible, and nothing generates
    again), as is the resume of a key the replica never saw; the stream
    itself runs on, and after its terminal the same resume replays."""

    def scenario(engine):
        at_eight, go = threading.Event(), threading.Event()

        def owner_cb(token_id, piece, done):
            if not done and token_id >= 0:
                owner.append(token_id)
                if len(owner) == 8:
                    at_eight.set()
                    go.wait(TIMEOUT)

        owner = []
        fut = engine.submit(PROMPT, max_new_tokens=30, idempotency_key="windowed",
                            stream_cb=owner_cb)
        assert at_eight.wait(TIMEOUT)
        out = {}
        try:
            for name, key in (("gap", "windowed"), ("unknown", "never-submitted")):
                with pytest.raises((jerrors.ErrorEntityNotFound,
                                    terrors.ErrorEntityNotFound)) as ei:
                    engine.resume(key, last_seq=2, stream_cb=lambda *a: None)
                out[name] = (_error(ei.value), ei.value.name)
        finally:
            go.set()
        r = fut.result(TIMEOUT)
        frames = []
        engine.resume("windowed", last_seq=2,
                      stream_cb=lambda s, t, p, d: frames.append((s, t, d))).result(TIMEOUT)
        _assert_clean(engine)
        out["tokens"] = r.token_ids
        out["replayed"] = [t for _, t, d in frames if not d] == r.token_ids[2:]
        out["dedup"] = engine.dedup_stats()
        return out

    jout, tout = _run(_pair(models, layout, stream_replay_tokens=4), scenario)
    assert tout == jout
    assert tout["gap"] == (("ErrorEntityNotFound", 404), "replay window")
    assert tout["unknown"] == (("ErrorEntityNotFound", 404), "idempotency_key")
    assert tout["replayed"]


@LAYOUTS
def test_orphan_is_reaped_after_its_grace(models, layout):
    """A keyed stream whose only client vanishes once 3 tokens are out,
    with no resume, is canceled by the reaper after a 50 ms grace: finish
    reason "cancel" with fewer tokens than its budget, its slot and pages
    free and its terminal kept for replay; the same cut on an unkeyed
    request cancels it at once."""

    def scenario(engine):
        out = {}
        for name, key in (("keyed", "orphaned"), ("unkeyed", None)):
            # the client vanishes once 3 tokens are out, seen from the
            # engine thread; 100 tokens then take at least 24 blocks of
            # 20 ms, far past the 50 ms grace
            cut = []

            def after(_cut=cut):
                with engine._count_lock:
                    req = engine._by_id.get(fut.request_id)
                if not _cut and req is not None and len(req.tokens) >= 3:
                    _cut.append(len(req.tokens))
                    engine.orphan(fut.request_id, grace_s=0.05)

            _slow_blocks(engine, 0.02, after)
            fut = engine.submit(PROMPT, max_new_tokens=100, idempotency_key=key,
                                stream_cb=lambda *a: None)
            r = fut.result(TIMEOUT)
            _assert_clean(engine)
            out[name] = (r.finish_reason, bool(cut) and cut[0] <= len(r.token_ids) < 100)
            out[name + "_tokens"] = r.token_ids
            delattr(engine, "_consume_block" if isinstance(engine, JServingEngine)
                    else "_consume")
        out["dedup"] = engine.dedup_stats()
        return out

    jout, tout = _run(_pair(models, layout), scenario)
    assert tout["keyed"] == jout["keyed"] == ("cancel", True)
    assert tout["unkeyed"] == jout["unkeyed"] == ("cancel", True)
    for name in ("keyed_tokens", "unkeyed_tokens"):
        n = min(len(tout[name]), len(jout[name]))
        assert tout[name][:n] == jout[name][:n]  # prefixes of one greedy sequence
    assert tout["dedup"] == jout["dedup"]
