"""The port's tenant policy (``gofr_tpu_torch/serving/tenancy.py``) and the
step planner's class-aware grant order against the JAX package's.

- ``TenantPolicy``: class defaults and class validation;
- ``TokenBucket``: seeded ``take`` sequences at fixed ``now``, the same
  ``(ok, retry)`` as the reference's, exactly;
- ``TenantRegistry.from_config``: the same policies entry by entry, and
  bad entries raise as the reference's raise;
- ``admit``, ``rejections`` and ``snapshot`` over seeded sequences, with a
  monotonic clock pinned so both registries see the same times;
- ``StepPlanner`` grants over cursors of mixed priority against the
  reference's planner.
"""

import numpy as np
import pytest

from gofr_tpu.serving import stepplan as jplan
from gofr_tpu.serving import tenancy as jten
from gofr_tpu_torch.serving import stepplan as tplan
from gofr_tpu_torch.serving import tenancy as tten


class FakeConfig:
    def __init__(self, env):
        self.env = env

    def get(self, key):
        return self.env.get(key)

    def get_or_default(self, key, default):
        return self.env.get(key, default)


@pytest.mark.parametrize("cls", sorted(tten.DEADLINE_CLASSES))
def test_policy_class_defaults_match_reference(cls):
    mine = tten.TenantPolicy(name="x", deadline_class=cls, token_rate=50.0)
    ref = jten.TenantPolicy(name="x", deadline_class=cls, token_rate=50.0)
    assert (mine.priority, mine.deadline_s, mine.burst_tokens) == (
        ref.priority, ref.deadline_s, ref.burst_tokens)
    assert tten.DEADLINE_CLASSES == jten.DEADLINE_CLASSES
    assert tten.DEFAULT_TENANT == jten.DEFAULT_TENANT


def test_policy_rejects_an_unknown_class():
    for mod in (tten, jten):
        with pytest.raises(ValueError):
            mod.TenantPolicy(name="z", deadline_class="nope")
    explicit = tten.TenantPolicy(name="y", deadline_class="batch", priority=7, deadline_s=3.0)
    assert (explicit.priority, explicit.deadline_s, explicit.burst_tokens) == (7, 3.0, 0.0)


@pytest.mark.parametrize("seed", range(4))
def test_token_bucket_matches_reference_on_seeded_takes(seed):
    rng = np.random.default_rng(seed)
    rate, burst = float(rng.integers(1, 200)), float(rng.integers(1, 400))
    if seed == 3:
        rate = 0.0  # an unmetered-rate bucket answers retry 60s
    mine, ref = tten.TokenBucket(rate, burst), jten.TokenBucket(rate, burst)
    now = 0.0
    outcomes = set()
    for _ in range(60):
        now += float(rng.exponential(0.3))
        n = float(rng.integers(1, int(burst) + 40))
        got, want = mine.take(n, now=now), ref.take(n, now=now)
        assert got == want
        assert mine.level() == ref.level()
        outcomes.add(got[0])
    assert outcomes == {True, False}  # the sequence exercises both answers


def test_from_config_matches_reference_entry_by_entry():
    env = {
        "TPU_TENANT_POLICIES": " gold:interactive; bulk:batch:500 ;;std:standard:12.5",
        "TPU_TENANT_INTERACTIVE_DEADLINE_S": "1.5",
        "TPU_TENANT_BATCH_DEADLINE_S": "90",
    }
    mine = tten.TenantRegistry.from_config(FakeConfig(env))
    ref = jten.TenantRegistry.from_config(FakeConfig(env))
    assert mine.classes == ref.classes
    assert mine.snapshot() == ref.snapshot()
    for name in ("gold", "bulk", "std", "stranger", None, ""):
        a, b = mine.policy(name), ref.policy(name)
        assert (a.name, a.deadline_class, a.priority, a.deadline_s, a.token_rate,
                a.burst_tokens) == (b.name, b.deadline_class, b.priority, b.deadline_s,
                                    b.token_rate, b.burst_tokens)
    assert mine.policy("gold").deadline_s == 1.5 and mine.policy("bulk").deadline_s == 90.0
    assert mine.policy("stranger").deadline_class == "standard"


@pytest.mark.parametrize("spec", ["broken", "a:nope", "a:batch:fast"])
def test_from_config_bad_entries_raise_as_the_reference(spec):
    for mod in (tten, jten):
        with pytest.raises(ValueError):
            mod.TenantRegistry.from_config(FakeConfig({"TPU_TENANT_POLICIES": spec}))


@pytest.mark.parametrize("seed", range(3))
def test_admit_and_snapshot_match_reference(seed, monkeypatch):
    clock = [100.0]
    for mod in (tten, jten):
        monkeypatch.setattr(mod.time, "monotonic", lambda: clock[0])
    env = {"TPU_TENANT_POLICIES": "gold:interactive:40;bulk:batch:300;free:standard"}
    regs = [mod.TenantRegistry.from_config(FakeConfig(env)) for mod in (tten, jten)]
    for reg, mod in zip(regs, (tten, jten)):
        # a metered default: every unknown tenant gets a bucket of its own
        reg.default = mod.TenantPolicy(token_rate=25.0)
    rng = np.random.default_rng(seed)
    names = ["gold", "bulk", "free", None, "stranger-1", "stranger-2"]
    for _ in range(80):
        clock[0] += float(rng.exponential(0.2))
        tenant = names[int(rng.integers(len(names)))]
        tokens = int(rng.integers(1, 120))
        assert regs[0].admit(tenant, tokens) == regs[1].admit(tenant, tokens)
    assert regs[0].rejections == regs[1].rejections and regs[0].rejections
    assert regs[0].snapshot() == regs[1].snapshot()


# (cursors as (slot, total, seq, priority, dispatched, blocked), planner kw, plan kw)
PRIORITY_CASES = {
    "higher-class-first": ([(0, 32, 0, 2), (1, 32, 1, 0)], {}, {}),
    "fifo-within-a-class": ([(0, 32, 3, 1), (1, 32, 1, 1), (2, 32, 2, 1)], {}, {}),
    "wide-budget-class-then-age": (
        [(0, 64, 0, 2), (1, 64, 1, 0), (2, 64, 2, 1), (3, 64, 3, 0)],
        dict(step_token_budget=24), {}),
    "blocked-high-class-skipped": (
        [(0, 32, 0, 0, 0, True), (1, 32, 1, 2), (2, 32, 2, 1)], dict(step_token_budget=8), {}),
    "tail-of-a-low-class-fits": (
        [(0, 64, 0, 0), (1, 70, 1, 2, 64)], dict(step_token_budget=14), {}),
    "decode-reserved-first": (
        [(0, 64, 0, 2), (1, 64, 1, 0)], dict(step_token_budget=20),
        dict(decode_rows=3)),
}


def _cursor(mod, slot, total, seq, priority, dispatched=0, blocked=False):
    cur = mod.ChunkCursor(req=None, slot=slot, total=total, seq=seq, priority=priority)
    cur.dispatched = cur.committed = dispatched
    cur.blocked = blocked
    return cur


@pytest.mark.parametrize("case", list(PRIORITY_CASES), ids=list(PRIORITY_CASES))
def test_planner_grants_walk_priority_then_age_as_the_reference(case):
    cursors, planner_kw, plan_kw = PRIORITY_CASES[case]
    plans = []
    for mod in (tplan, jplan):
        planner = mod.StepPlanner(chunk_tokens=8, block_steps=4, max_admissions=2, **planner_kw)
        kw = dict(dict(decode_rows=0, free_slots=1, queue_depth=0), **plan_kw)
        plans.append(planner.plan(cursors=[_cursor(mod, *c) for c in cursors], **kw))
    mine, ref = plans
    fields = ("decode_rows", "decode_tokens", "prefill_budget", "grants", "admit_cap", "budget_left")
    assert {f: getattr(mine, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    # the first grant goes to the highest class's oldest unblocked cursor
    first = min((c for c in cursors if not (len(c) > 5 and c[5])), key=lambda c: (c[3], c[2]))
    assert mine.grants[0][0] == first[0]
