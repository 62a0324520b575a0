"""The port's copies of the request lifecycle's JAX-free modules, held to
the reference on the CPU: the admission scheduler against
``gofr_tpu.native.fallback.PyScheduler``, the shed estimator against
``gofr_tpu.serving.shed.QueueWaitEstimator``, the typed errors against
``gofr_tpu.http.errors`` and ``EngineConfig.from_config`` against the
reference's. Operation sequences and values come from numpy seeds; every
decision, exception type and value must be identical.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.native.fallback import PyScheduler  # noqa: E402
from gofr_tpu.native.fallback import QueueFull as JQueueFull  # noqa: E402
from gofr_tpu.serving.engine import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving.shed import QueueWaitEstimator as JQueueWaitEstimator  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig  # noqa: E402
from gofr_tpu_torch.serving.scheduler import QueueFull, Scheduler  # noqa: E402
from gofr_tpu_torch.serving.shed import QueueWaitEstimator  # noqa: E402


def _outcome(fn, *args, **kw):
    """(value, None) or (None, the exception's kind), the kinds of the two
    implementations mapped onto one name."""
    try:
        return fn(*args, **kw), None
    except (QueueFull, JQueueFull):
        return None, "QueueFull"
    except KeyError:
        return None, "KeyError"


# ------------------------------------------------------------------ scheduler
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("budget", [4096, 300])
def test_scheduler_decisions_match_reference(seed, budget):
    """Seeded random sequences of submit (mixed priorities, prompt lengths
    around the budget, ``front`` requeues), cancel (queued, admitted and
    unknown ids), admit and release (busy and free slots) give identical
    results, exceptions and ``stats()`` after every operation."""
    rng = np.random.default_rng(seed)
    mine, ref = Scheduler(4, 12, budget), PyScheduler(4, 12, budget)
    next_id, admitted_any = 0, False
    for _ in range(300):
        op = rng.choice(["submit", "submit", "cancel", "admit", "release"])
        if op == "submit":
            next_id += 1
            rid = next_id if rng.random() > 0.05 else max(1, next_id - 1)  # a duplicate id now and then
            args = (rid, int(rng.integers(1, 3000)), int(rng.integers(1, 64)),
                    int(rng.integers(0, 4)), bool(rng.random() < 0.2))
        elif op == "cancel":
            args = (int(rng.integers(1, next_id + 3)),)
        elif op == "admit":
            args = (int(rng.integers(1, 5)),)
        else:
            args = (int(rng.integers(0, 4)),)
        got, want = _outcome(getattr(mine, op), *args), _outcome(getattr(ref, op), *args)
        assert got == want, (op, args)
        if op == "admit":
            admitted_any |= bool(want[0][0])
        assert mine.stats() == ref.stats()
        assert mine.pending() == ref.stats()["queue_depth"]
    assert admitted_any


def test_scheduler_budget_gate_and_order():
    """Two 3000-token prompts are not admitted in one round at the default
    budget of 4096; a lower priority class goes first; a front requeue
    heads its class; the lowest free slot is taken; a free slot's release
    raises."""
    for s in (Scheduler(8, 16, 4096), PyScheduler(8, 16, 4096)):
        s.submit(1, 3000, 8)
        s.submit(2, 3000, 8)
        assert s.admit(4) == ([(1, 0)], [])  # 2 waits: 1000 tokens of budget left
        assert s.admit(4) == ([(2, 1)], [])
        s.submit(3, 10, 8, priority=5)
        s.submit(4, 10, 8, priority=0)
        s.submit(5, 10, 8, priority=5, front=True)
        s.cancel(4)
        s.release(0)
        assert s.admit(4) == ([(5, 0), (3, 2)], [4])
        with pytest.raises(KeyError):
            s.release(3)
        assert s.stats()["busy_slots"] == 3 and s.stats()["total_canceled"] == 1


# ------------------------------------------------------------- shed estimator
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("cold_prior", [0.0, 0.75])
def test_estimator_values_bit_identical(seed, cold_prior):
    """The same observation sequences give bit-identical estimates at every
    depth, from the cold start (the TTFT rung and the prior, before any
    completed request) onwards."""
    rng = np.random.default_rng(100 + seed)
    alpha = float(rng.choice([0.25, 0.5, 1.0]))
    mine = QueueWaitEstimator(alpha=alpha, cold_prior_s=cold_prior)
    ref = JQueueWaitEstimator(alpha=alpha, cold_prior_s=cold_prior)
    depths = [0, 1, 3, 8, 17, 250]
    for _ in range(60):
        for d in depths:
            for slots in (1, 8):
                got, want = mine.estimate_wait(d, slots), ref.estimate_wait(d, slots)
                assert np.float64(got).tobytes() == np.float64(want).tobytes()
        assert mine.snapshot() == ref.snapshot()
        kind, seconds = rng.random(), float(rng.exponential(2.0)) - 0.2  # a few negatives
        for e in (mine, ref):
            (e.observe_ttft if kind < 0.5 else e.observe_request)(seconds)


def test_estimator_rejects_bad_settings_as_reference():
    for cls in (QueueWaitEstimator, JQueueWaitEstimator):
        with pytest.raises(ValueError):
            cls(alpha=0.0)
        with pytest.raises(ValueError):
            cls(cold_prior_s=-1.0)


# ---------------------------------------------------------------------- errors
ERROR_CASES = [
    ("ErrorServiceUnavailable", {}),
    ("ErrorServiceUnavailable", {"retry_after": 1.0}),
    ("ErrorServiceUnavailable", {"retry_after": 0.2}),
    ("ErrorTooManyRequests", {}),
    ("ErrorTooManyRequests", {"retry_after": 0.0}),
    ("ErrorTooManyRequests", {"retry_after": 2.3456}),
    ("ErrorTooManyRequests", {"retry_after": 37.0}),
    ("ErrorRequestEntityTooLarge", {}),
    ("ErrorDeadlineExceeded", {}),
]


@pytest.mark.parametrize("name,kw", ERROR_CASES)
@pytest.mark.parametrize("message", ["", "prompt needs 9 KV pages"])
def test_errors_match_reference(name, kw, message):
    mine, ref = getattr(terrors, name)(message, **kw), getattr(jerrors, name)(message, **kw)
    assert isinstance(mine, terrors.HTTPError)
    assert mine.status_code == ref.status_code
    assert mine.retry_after == ref.retry_after
    assert mine.response_headers() == ref.response_headers()
    assert mine.response_fields() == ref.response_fields()
    assert str(mine) == str(ref) and mine.message == ref.message


# --------------------------------------------------------- EngineConfig knobs
class DictConfig:
    """The smallest config object: ``get`` and ``get_or_default`` over a dict
    (an empty string counts as unset, as in the reference's configs)."""

    def __init__(self, values: dict) -> None:
        self.values = values

    def get(self, key: str):
        return self.values.get(key)

    def get_or_default(self, key: str, default: str) -> str:
        val = self.values.get(key)
        return val if val is not None and val != "" else default


KNOBS = {  # knob -> (the port's field, a value to set)
    "TPU_BATCH_MAX_SLOTS": ("max_slots", "12"),
    "TPU_BATCH_MAX_TOKENS": ("max_seq_len", "4096"),
    "TPU_MAX_NEW_TOKENS_DEFAULT": ("max_new_tokens_default", "77"),
    "TPU_BATCH_MAX_QUEUE": ("max_queue", "9"),
    "TPU_BATCH_PREFILL_BUCKETS": ("prefill_buckets", "16, 64,,256"),
    "TPU_BATCH_ADMISSION_PER_STEP": ("admission_per_step", "2"),
    "TPU_BATCH_PREFILL_BUDGET": ("prefill_token_budget", "1000"),
    "TPU_PREFILL_CHUNK_TOKENS": ("prefill_chunk_tokens", "512"),
    "TPU_STEP_TOKEN_BUDGET": ("step_token_budget", "640"),
    "TPU_IDLE_SLEEP_S": ("idle_sleep_s", "0.01"),
    "TPU_KV_LAYOUT": ("kv_layout", "paged"),
    "TPU_KV_PAGE_SIZE": ("kv_page_size", "32"),
    "TPU_KV_NUM_PAGES": ("kv_num_pages", "1024"),
    "TPU_KV_DTYPE": ("kv_dtype", "int8"),
    "TPU_BATCH_MULTI_STEP": ("multi_step", "8"),
    "TPU_DECODE_SYNC_EVERY": ("decode_sync_every", "3"),
    "TPU_SHED_MAX_WAIT_S": ("shed_max_wait_s", "1.5"),
    "TPU_SHED_COLD_PRIOR_S": ("shed_cold_prior_s", "0.25"),
    "TPU_DRAIN_DEADLINE_S": ("drain_deadline_s", "12.5"),
    "TPU_PREFIX_CACHE_ENTRIES": ("prefix_cache_entries", "64"),
    "TPU_PREFIX_CACHE_BYTES": ("prefix_cache_bytes", "1048576"),
    "TPU_KV_SPILL_BYTES": ("kv_spill_bytes", "1073741824"),
    "TPU_SPEC_TOKENS": ("spec_tokens", "4"),
    "TPU_SPEC_NGRAM": ("spec_ngram", "2"),
    "TPU_TENANT_PREEMPT": ("tenant_preempt", "0"),
    "TPU_REQUESTZ_CAPACITY": ("requestz_capacity", "64"),
    "TPU_REPLICA_ROLE": ("role", "decode"),
    "TPU_REPLICA_PREEMPTIBLE": ("preemptible", "1"),
    "TPU_RECLAIM_EVACUATE_FRAC": ("reclaim_evacuate_frac", "0.5"),
    "TPU_STREAM_REPLAY_TOKENS": ("stream_replay_tokens", "64"),
    "TPU_IDEM_CAPACITY": ("idem_capacity", "32"),
    "TPU_STREAM_ORPHAN_GRACE_S": ("stream_orphan_grace_s", "2.5"),
}


def test_every_field_has_a_knob():
    import dataclasses

    fields = {f.name for f in dataclasses.fields(EngineConfig)}
    assert fields == {field for field, _ in KNOBS.values()}
    assert fields <= {f.name for f in dataclasses.fields(JEngineConfig)}
    assert EngineConfig() == EngineConfig.from_config(DictConfig({}))


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("state", ["set", "unset", "empty"])
def test_from_config_matches_reference(knob, state):
    field, value = KNOBS[knob]
    values = {"set": {knob: value}, "unset": {}, "empty": {knob: ""}}[state]
    mine = EngineConfig.from_config(DictConfig(values))
    ref = JEngineConfig.from_config(DictConfig(values))
    assert getattr(mine, field) == getattr(ref, field), (
        getattr(mine, field), getattr(ref, field))
    if state == "set":
        assert getattr(mine, field) != getattr(EngineConfig(), field)
