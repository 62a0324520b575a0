"""The port's prefix caches (``gofr_tpu_torch/serving/prefix_cache.py`` and
``kv_spill.py``) against the JAX package's classes.

The same seeded sequences of put/get/evict/clear (and, on the tiered cache,
get_with_tier/peek with a flush after every operation) go to a reference cache
holding numpy arrays and a port cache holding tensors of the same shapes
and values. After every operation both must hold the same keys in the same
LRU order, report equal ``stats()`` (byte totals included) and return
equal values: exact equality, since nothing is computed. Then the spill
round trip, the host tier's byte bound and a dropped spill, as the
reference's own tests run them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from gofr_tpu.serving.kv_spill import HostSpillTier as JHostSpillTier  # noqa: E402
from gofr_tpu.serving.kv_spill import TieredPrefixCache as JTieredPrefixCache  # noqa: E402
from gofr_tpu.serving.prefix_cache import PrefixCache as JPrefixCache  # noqa: E402
from gofr_tpu_torch.serving.kv_spill import HostSpillTier, TieredPrefixCache  # noqa: E402
from gofr_tpu_torch.serving.prefix_cache import PrefixCache, _value_bytes  # noqa: E402


def _value(rng: np.random.Generator) -> tuple:
    """A (logits, k_slab, v_slab)-shaped entry of random size, as numpy."""
    n = int(rng.integers(1, 6))
    return (rng.standard_normal((1, 8)).astype(np.float32),
            rng.standard_normal((2, n, 2, 4)).astype(np.float32),
            rng.standard_normal((2, n, 2, 4)).astype(np.float32))


def _as_torch(value: tuple) -> tuple:
    return tuple(torch.from_numpy(a.copy()) for a in value)


def _same_value(mine, ref) -> bool:
    if mine is None or ref is None:
        return mine is None and ref is None
    return all(np.array_equal(np.asarray(m), np.asarray(r)) for m, r in zip(mine, ref))


def _ops(seed: int, n: int = 120):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(9)]
    for _ in range(n):
        op = rng.choice(["put", "put", "get", "get", "evict", "peek", "clear"],
                        p=[0.3, 0.1, 0.25, 0.15, 0.1, 0.08, 0.02])
        yield str(op), str(rng.choice(keys)), _value(rng)


def test_value_bytes_counts_tensors():
    value = (torch.zeros((1, 300)), torch.zeros((2, 5, 2, 4), dtype=torch.bfloat16),
             np.zeros(7, np.float64))
    assert _value_bytes(value) == 300 * 4 + 80 * 2 + 7 * 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_matches_reference(seed):
    ref = JPrefixCache(max_entries=4, max_bytes=1500)
    mine = PrefixCache(max_entries=4, max_bytes=1500)
    evicted_ref, evicted_mine = [], []
    ref.on_evict = lambda k, v: evicted_ref.append(k)
    mine.on_evict = lambda k, v: evicted_mine.append(k)
    for op, key, value in _ops(seed):
        if op in ("put", "peek"):
            ref.put(key, value)
            mine.put(key, _as_torch(value))
        elif op == "get":
            assert _same_value(mine.get(key), ref.get(key))
        elif op == "evict":
            ref.evict(key)
            mine.evict(key)
        else:
            ref.clear()
            mine.clear()
        assert mine.keys() == ref.keys()
        assert mine.stats() == ref.stats()
    assert evicted_mine == evicted_ref and evicted_ref


def test_prefix_cache_rejects_an_entry_past_its_byte_bound():
    cache = PrefixCache(max_entries=8, max_bytes=1000)
    cache.put("small", (torch.zeros(100),))
    cache.put("huge", (torch.zeros(1000),))  # 4000 B: never fits, flushes nothing
    assert cache.keys() == ["small"] and cache.stats()["bytes"] == 400


@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_cache_matches_reference(seed):
    kw = dict(max_entries=3, max_bytes=1200, spill_bytes=2000)
    ref = JTieredPrefixCache(**kw)
    mine = TieredPrefixCache(**kw, device="cpu")
    try:
        for op, key, value in _ops(seed):
            if op == "put":
                ref.put(key, value)
                mine.put(key, _as_torch(value))
            elif op == "get":
                (got, tier), (want, want_tier) = mine.get_with_tier(key), ref.get_with_tier(key)
                assert tier == want_tier and _same_value(got, want)
                if got is not None:
                    assert all(isinstance(t, torch.Tensor) for t in got)
            elif op == "peek":
                assert _same_value(mine.peek(key), ref.peek(key))
            elif op == "evict":
                ref.evict(key)
                mine.evict(key)
            else:
                ref.clear()
                mine.clear()
            # a put or a promotion may have queued a spill
            assert ref.flush(5.0) and mine.flush(5.0)
            assert mine.keys() == ref.keys()
            assert mine.stats() == ref.stats()
        assert mine.stats()["spilled_total"] > 0 and mine.stats()["host"]["hits"] > 0
    finally:
        ref.close()
        mine.close()


def test_host_tier_reuse_score_orders_eviction_as_reference():
    scores = {"a": 5.0, "b": 0.0, "c": 1.0, "d": 0.0, "e": 0.0}
    ref = JHostSpillTier(400, score=lambda k: scores[k])
    mine = HostSpillTier(400, score=lambda k: scores[k])
    for key, n in [("a", 25), ("b", 25), ("c", 25), ("d", 25), ("e", 50)]:
        ref.put(key, (np.zeros(n, np.float32),))
        mine.put(key, (torch.zeros(n),))
        assert mine.keys() == ref.keys()
    assert mine.stats() == ref.stats()
    assert mine.keys() == ["a", "c", "e"]  # the least reused went first


def test_spill_round_trip_serves_a_host_hit():
    """Mirrors the reference's round trip: five entries through a device
    tier of two, the rest spilled, a host hit byte-identical and promoted
    back to the device tier."""
    cache = TieredPrefixCache(max_entries=2, spill_bytes=1 << 24, device="cpu")
    originals = {}
    for i in range(5):
        value = (torch.full((1, 8), float(i)), torch.full((2, 4, 2, 2), i + 0.5,
                 dtype=torch.bfloat16), torch.full((2, 4, 2, 2), i + 0.25))
        originals[f"k{i}"] = value
        cache.put(f"k{i}", value)
    assert cache.flush(5.0)
    stats = cache.stats()
    assert (stats["entries"], stats["host"]["entries"], stats["spilled_total"]) == (2, 3, 3)
    value, tier = cache.get_with_tier("k0")
    assert tier == "host"
    for got, want in zip(value, originals["k0"]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert cache.get_with_tier("k0")[1] == "device"
    assert cache.get("missing") is None
    cache.close()


def test_spill_tier_byte_bound_evicts_lru():
    cache = TieredPrefixCache(max_entries=1, spill_bytes=3000, device="cpu")
    for i in range(4):
        cache.put(f"k{i}", (torch.zeros(256),))  # 1 KiB each
    assert cache.flush(5.0)
    host = cache.stats()["host"]
    assert host["entries"] == 2 and host["bytes"] <= 3000
    assert cache._host.keys() == ["k1", "k2"]
    cache.close()


def test_a_spill_whose_host_copy_raises_is_dropped():
    """A value the worker cannot copy to the host (a meta tensor has no
    data) is dropped: counted, never filed, and a later lookup misses."""
    cache = TieredPrefixCache(max_entries=1, spill_bytes=1 << 20, device="cpu")
    cache.put("a", (torch.empty(4, device="meta"),))
    cache.put("b", (torch.zeros(4),))  # evicts "a": its spill raises
    assert cache.flush(5.0)
    stats = cache.stats()
    assert stats["host"]["entries"] == 0 and stats["spill_dropped_total"] == 1
    assert cache.get_with_tier("a") == (None, "miss")
    cache.close()


def test_spill_backlog_refuses_offers_past_max_pending():
    cache = TieredPrefixCache(max_entries=1, spill_bytes=1 << 20, device="cpu")
    cache._pending = cache.MAX_PENDING  # a full backlog
    cache._offer("k", (torch.zeros(4),))
    assert cache.stats()["spill_dropped_total"] == 1
    cache._pending = 0
    cache.close()


def test_host_copy_is_fresh_and_the_reupload_lands_on_the_cache_device():
    from gofr_tpu_torch.serving.kv_spill import _to_device, _to_host

    src = (torch.arange(6.0).reshape(2, 3)[:, 1:],)  # a non-contiguous view
    host = _to_host(src)
    src[0].zero_()
    assert host[0].tolist() == [[1.0, 2.0], [4.0, 5.0]]
    back = _to_device(host, torch.device("cpu"))
    assert back[0].device.type == "cpu" and torch.equal(back[0], host[0])
