"""The port's prefix index and KV migrator (``gofr_tpu_torch/serving/
prefix_index.py``) against the reference's (``gofr_tpu/serving/
prefix_index.py``): the index and the migrator's backoff on seeded
sequences, step by step; the wire codec byte for byte on f32, bf16 and
int8 leaves, each side decoding the other's payload; the peer fetcher's
peeks; the two-phase handoff and the all-or-nothing evacuation store."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from gofr_tpu.serving import prefix_index as jpi  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as tpi  # noqa: E402
from gofr_tpu_torch.serving.kv_spill import TieredPrefixCache  # noqa: E402

KEYS = [f"c{i}" for i in range(6)]
REPLICAS = ["A", "B", "C"]


# -- the index -------------------------------------------------------------------
def _index_trace(mod, seed: int, steps: int = 150) -> list:
    rng = np.random.default_rng(seed)
    idx = mod.PrefixIndex()
    seqs = {r: 0 for r in REPLICAS}
    out = []
    for _ in range(steps):
        op = rng.choice(["observe", "observe", "stale", "locate", "chain", "drop", "none"])
        rid = REPLICAS[int(rng.integers(len(REPLICAS)))]
        if op in ("observe", "stale"):
            if op == "observe":
                seqs[rid] += int(rng.integers(1, 3))
            seq = seqs[rid] - (int(rng.integers(0, 2)) if op == "stale" else 0)
            n = int(rng.integers(0, len(KEYS) + 1))
            rows = [[k, "device" if rng.random() < 0.6 else "host"] for k in KEYS[:n]]
            if rng.random() < 0.2:
                rows.append("garbage")  # a malformed row is dropped
            res = idx.observe(rid, seq, rows)
        elif op == "none":
            res = idx.observe(rid, seqs[rid] + 1, None)
        elif op == "locate":
            key = KEYS[int(rng.integers(len(KEYS)))]
            res = idx.locate(key, exclude=rid if rng.random() < 0.3 else None)
        elif op == "chain":
            start = int(rng.integers(0, 2))
            res = idx.longest_chain(KEYS[start:], exclude=rid if rng.random() < 0.3 else None)
        else:
            idx.drop_replica(rid)
            res = None
        out.append((str(op), rid, res, idx.snapshot()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_index_matches_reference_on_seeded_sequences(seed):
    ref, port = _index_trace(jpi, seed), _index_trace(tpi, seed)
    assert port == ref
    assert any(r[0] == "stale" and r[2] is False for r in ref)  # the seq guard fired


# -- the migrator's backoff --------------------------------------------------------
def _migrator_trace(mod, seed: int, monkeypatch, steps: int = 80) -> list:
    """A migrator over three peers, each of which fails, goes stale (drops
    keys) or serves per a seeded plan, under a fake monotonic clock; every
    fetch's result and the counters after it."""
    rng = np.random.default_rng(seed)
    clock = [1000.0]
    # the module's own clock only: other threads keep the real one
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: clock[0]))
    idx = mod.PrefixIndex()
    for i, rid in enumerate(REPLICAS):
        idx.observe(rid, 1, [[k, "device"] for k in KEYS[:3 + i]])
    mig = mod.KVMigrator("self", idx, failure_backoff_s=5.0)
    plan: dict[str, str] = {}

    def peer(rid):
        def fetch(keys):
            mode = plan.get(rid, "ok")
            if mode == "fail":
                raise ConnectionError(f"{rid} down")
            held = keys[:-1] if mode == "stale" else keys
            return {k: (f"{rid}:{k}", 0, 0) for k in held}
        return fetch

    for rid in REPLICAS:
        mig.add_peer(rid, peer(rid))
    out = []
    for _ in range(steps):
        clock[0] += float(rng.choice([0.5, 1.0, 3.0]))
        for rid in REPLICAS:
            plan[rid] = str(rng.choice(["ok", "ok", "fail", "stale"]))
        op = rng.choice(["chain", "chain", "one", "handoff", "handoff_one", "expired"])
        start = int(rng.integers(0, 3))
        bounds = [(16 * i, 16 * (i + 1), k) for i, k in enumerate(KEYS)][start:]
        src = REPLICAS[int(rng.integers(len(REPLICAS)))]
        if op == "chain":
            res = mig.fetch_chain(bounds)
        elif op == "one":
            res = mig.fetch_one(bounds[0][2])
        elif op == "handoff":
            res = mig.fetch_handoff(bounds[:3], src)
        elif op == "handoff_one":
            res = mig.fetch_one_handoff(bounds[0][2], src)
        else:
            res = mig.fetch_chain(bounds, deadline=0.0)
        out.append((str(op), res, mig.migrations_total, mig.handoffs_total,
                    mig.failed_fetches_total, sorted(mig._suppressed_until.items())))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_migrator_backoff_matches_reference(seed, monkeypatch):
    ref = _migrator_trace(jpi, seed, monkeypatch)
    port = _migrator_trace(tpi, seed, monkeypatch)
    assert port == ref
    assert ref[-1][4] > 0 and ref[-1][2] > 0  # both failures and migrations happened


def test_migrator_backs_off_a_failing_peer():
    idx = tpi.PrefixIndex()
    idx.observe("A", 1, [["c0", "device"]])
    mig = tpi.KVMigrator("B", idx, failure_backoff_s=30.0)
    calls = []

    def failing(keys):
        calls.append(list(keys))
        raise ConnectionError("peer down")

    mig.add_peer("A", failing)
    assert mig.fetch_chain([(0, 16, "c0")]) == []
    assert mig.fetch_chain([(0, 16, "c0")]) == []  # suppressed: no second call
    assert len(calls) == 1 and mig.failed_fetches_total == 1
    mig._suppressed_until["A"] = 0.0
    mig.add_peer("A", lambda keys: {})
    mig.fetch_chain([(0, 16, "c0")])
    assert "A" not in mig._suppressed_until


def test_bounded_peer_gets_the_deadline_as_its_timeout():
    """A fetcher that takes ``timeout`` (a remote transport) gets the
    request's remaining deadline, capped at ``fetch_timeout_s``; the
    reference does the same."""
    for mod in (jpi, tpi):
        idx = mod.PrefixIndex()
        idx.observe("A", 1, [["c0", "device"]])
        mig = mod.KVMigrator("B", idx, fetch_timeout_s=2.0)
        seen = []
        mig.add_peer("A", lambda keys, timeout: seen.append(timeout) or {})
        mig.fetch_chain([(0, 16, "c0")], deadline=0.5)
        mig.fetch_chain([(0, 16, "c0")])
        assert seen == [0.5, 2.0], mod.__name__


# -- the wire codec ------------------------------------------------------------------
def _leaves(seed: int):
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((1, 40)).astype(np.float32)
    bf16 = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    i8 = rng.integers(-128, 128, (2, 5, 2, 4)).astype(np.int8)
    jax_value = (jnp.asarray(f32), jnp.asarray(bf16, jnp.bfloat16), jnp.asarray(i8))
    torch_value = (torch.from_numpy(f32), torch.from_numpy(bf16).to(torch.bfloat16),
                   torch.from_numpy(i8))
    return jax_value, torch_value


@pytest.mark.parametrize("seed", range(3))
def test_encode_entry_is_byte_identical_to_the_reference(seed):
    jax_value, torch_value = _leaves(seed)
    ref = jpi.encode_entry(jax_value)
    port = tpi.encode_entry(torch_value)
    assert port == ref
    assert [leaf["dtype"] for leaf in port["leaves"]] == ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("seed", range(3))
def test_each_side_decodes_the_others_payload(seed):
    jax_value, torch_value = _leaves(seed)
    from_ref = tpi.decode_entry(jpi.encode_entry(jax_value))
    from_port = jpi.decode_entry(tpi.encode_entry(torch_value))
    for got, want in zip(from_ref, torch_value):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape and torch.equal(got, want)
    for got, want in zip(from_port, jax_value):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert from_port[1].dtype == np.dtype(ml_dtypes.bfloat16)
    # the port's payload round trips through itself, on the CPU, with no card
    again = tpi.decode_entry(tpi.encode_entry(from_ref))
    assert all(torch.equal(a, b) for a, b in zip(again, from_ref))


# -- the peer fetcher and the evacuation store ------------------------------------------
def test_peer_reads_are_non_mutating_peeks():
    """Serving a peer's fetch neither promotes a host-tier entry into the
    owner's device tier nor pops its only host copy."""
    cache = TieredPrefixCache(max_entries=1, spill_bytes=1 << 20, device="cpu")
    try:
        cache.put("old", (torch.full((4,), 1.0),))
        cache.put("new", (torch.full((4,), 2.0),))  # evicts "old" to the host tier
        assert cache.flush(5.0)
        assert cache.stats()["host"]["entries"] == 1
        fetch = tpi.local_engine_fetcher(types.SimpleNamespace(_prefix_cache=cache))
        got = fetch(["old", "new", "absent"])
        assert set(got) == {"old", "new"}
        assert cache.stats()["host"]["entries"] == 1
        assert cache._device.keys() == ["new"]
        assert cache.advertised(8) == [("new", "device"), ("old", "host")]
        assert cache.advertised(1) == [("new", "device")]
    finally:
        cache.close()


class _Cache:
    def __init__(self, fail_at=None):
        self.entries, self.fail_at = {}, fail_at

    def put(self, key, value):
        if key == self.fail_at:
            raise RuntimeError("device full")
        self.entries[key] = value

    def evict(self, key):
        self.entries.pop(key, None)


@pytest.mark.parametrize("case", ["ok", "torn", "malformed", "draining", "no-cache"])
def test_local_engine_store_commits_whole_or_nothing(case):
    """The survivor's store: a torn or malformed batch leaves nothing, a
    draining target refuses; the same outcome as the reference's."""
    outcomes = []
    for mod in (jpi, tpi):
        cache = None if case == "no-cache" else _Cache(fail_at="k2" if case == "torn" else None)
        engine = types.SimpleNamespace(_prefix_cache=cache, _running=True,
                                       draining=case == "draining", _reclaiming=False)
        entries = [(f"k{i}", (i, i, i)) for i in range(4)]
        if case == "malformed":
            entries.append(("bad", (1, 2)))
        try:
            outcomes.append(("ok", mod.local_engine_store(engine)(entries),
                             sorted(cache.entries)))
        except Exception as exc:  # noqa: BLE001 - compared across the two
            outcomes.append((type(exc).__name__, sorted(cache.entries) if cache else None))
    assert outcomes[0] == outcomes[1], outcomes


def test_evacuate_chain_tries_the_next_survivor():
    for mod in (jpi, tpi):
        mig = mod.KVMigrator("doomed", mod.PrefixIndex())
        got = {}

        def refusing(entries):
            raise RuntimeError("draining")

        mig.add_push_peer("a", refusing)
        mig.add_push_peer("b", lambda entries: got.setdefault("b", len(entries)))
        assert mig.evacuate_chain([("k", (1, 2, 3))]) == ("b", 1)
        assert mig.failed_evacuations_total == 1 and mig.evacuations_total == 1
        assert "a" in mig._suppressed_until and mig.evacuate_chain([], deadline=1.0) is None
