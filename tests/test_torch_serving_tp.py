"""The port's tensor-parallel ServingEngine against the JAX package's
engine over tp-sharded params (``tests/test_serving_tp.py``), case by case.

Two gloo worlds on the CPU, module-scoped and each run once
(``torch_serving_tp_cases.tp_world``): 8 ranks on the reference test's
mesh (fsdp=2 x tp=4) and 4 ranks on tp=4 (the card's layout). Rank 0 runs
``ServingEngine(..., mesh=)``; every other rank runs ``serve_follower``.
The JAX side runs here on the 8-device CPU mesh of ``conftest.py`` while
the worlds run: the unsharded engine for every config, and the sharded
one where the reference's own probe finds the partitioner sound. Tolerance: exact
greedy tokens at tiny f32, as the reference test asks of its sharded
engine.
"""

from __future__ import annotations

import concurrent.futures

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_serving_tp_cases as cases
from gofr_tpu.models import llama as jllama
from gofr_tpu.parallel.sharding import llama_sharding_rules as jrules
from gofr_tpu.parallel.sharding import shard_params as jshard_params
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer
from gofr_tpu.serving import EngineConfig as JEngineConfig
from gofr_tpu.serving import ServingEngine as JServingEngine
from gofr_tpu_torch.parallel import world
from test_serving_tp import _spmd_rope_partitioner_broken

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")

VOCAB = 320  # dims divisible by tp=4 and fsdp=2, as in the reference test
BASE = dict(max_slots=4, max_seq_len=64, prefill_buckets=(16, 32))
PAGED = dict(BASE, kv_layout="paged", kv_page_size=8)
ENGINES = {  # the reference test's engines and prompts
    "dense": (BASE, [("hello tp", 6), ("b", 6), ("a longer prompt than the others", 6)]),
    "paged": (PAGED, [("paged tp", 6)]),
    "paged_int8": (dict(PAGED, kv_dtype="int8"), [("tp int8 paged", 6)]),
}
CHUNKED_PROMPTS = [("hi", 6), ("the quick brown fox jumps over", 6),
                   ("a prompt longer than every prefill bucket", 6)]
CHUNKED = {  # prompts past a 16-token chunk and past the largest bucket: the ragged dispatch
    "dense_chunked": (dict(BASE, max_seq_len=60, prefill_chunk_tokens=16), CHUNKED_PROMPTS),
    "paged_int8_chunked": (dict(PAGED, prefill_chunk_tokens=16, kv_dtype="int8"),
                           CHUNKED_PROMPTS),
}
WORLDS = {"fsdp=2,tp=4": 8, "tp=4": 4}


@pytest.fixture(scope="module")
def ref():
    cfg = jllama.LlamaConfig.tiny(vocab_size=VOCAB)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("fsdp", "tp"))
    return cfg, params, jshard_params(params, mesh, jrules())


def _jax_tokens(cfg, params, conf: dict, prompts: list) -> list:
    engine = JServingEngine(cfg, params, JEngineConfig(**conf), JByteTokenizer())
    engine.start()
    try:
        return [engine.submit(p, max_new_tokens=n, temperature=0.0).result(timeout=120).token_ids
                for p, n in prompts]
    finally:
        engine.stop()


@pytest.fixture(scope="module")
def world_futures(ref):
    """Both worlds started at once, off this thread, by mesh spec."""
    _, params, _ = ref
    params_np = jax.tree.map(np.asarray, jax.device_get(params))
    pool = concurrent.futures.ThreadPoolExecutor(len(WORLDS))
    futures = {}
    for spec, n in WORLDS.items():
        engines = ENGINES if spec == "fsdp=2,tp=4" else {**ENGINES, **CHUNKED}
        inp = {"mesh": spec, "vocab": VOCAB, "params": params_np,
               "engines": [(name, conf, prompts) for name, (conf, prompts) in engines.items()],
               "http": BASE if spec == "fsdp=2,tp=4" else None,
               "refusals": spec == "tp=4", "fail": PAGED if spec == "tp=4" else None,
               "ring": spec == "tp=4"}
        futures[spec] = pool.submit(world.run_spmd, cases.tp_world, n, args=(inp,),
                                    backend="gloo", device="cpu", timeout_s=300)
    yield futures
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def jax_tokens(ref, world_futures):
    """Greedy tokens of the JAX engines: unsharded for every config, sharded
    for the reference test's three where its probe passes."""
    cfg, params, sharded = ref
    out = {"unsharded": {}, "sharded": {}}
    for name, (conf, prompts) in {**ENGINES, **CHUNKED}.items():
        out["unsharded"][name] = _jax_tokens(cfg, params, conf, prompts)
    # the reference's int8 check: the first token of the unsharded bf16 engine
    out["bf16_of_int8_prompt"] = _jax_tokens(cfg, params, BASE, ENGINES["paged_int8"][1])
    out["exact_spmd"] = not _spmd_rope_partitioner_broken()
    if out["exact_spmd"]:
        for name, (conf, prompts) in ENGINES.items():
            out["sharded"][name] = _jax_tokens(cfg, sharded, conf, prompts)
    return out


@pytest.fixture(scope="module")
def worlds(world_futures, jax_tokens):
    """Both worlds' results by mesh spec, rank by rank (the JAX side ran
    meanwhile)."""
    return {spec: fut.result() for spec, fut in world_futures.items()}


@pytest.mark.parametrize("spec", WORLDS)
def test_sharded_params_actually_sharded(worlds, spec):
    """Column-parallel wq: heads split 4-way, d_model split over fsdp."""
    cfg = jllama.LlamaConfig.tiny(vocab_size=VOCAB)
    fsdp = 2 if spec.startswith("fsdp") else 1
    for r in worlds[spec]:
        assert r["wq"] == (cfg.n_layers, cfg.d_model // fsdp, cfg.d_model // 4)


@pytest.mark.parametrize("spec", WORLDS)
def test_init_params_on_a_mesh_keeps_the_ranks_slices(worlds, spec):
    """``init_params(mesh=)`` draws as one card does and keeps each rank's
    slices: equal to ``shard_params`` of the whole draw on every rank."""
    assert all(r["init_slices_equal"] for r in worlds[spec])


def _assert_matches(worlds, jax_tokens, spec: str, name: str) -> None:
    got = worlds[spec][0]["engines"][name]
    assert got["tokens"] == jax_tokens["unsharded"][name]
    if jax_tokens["exact_spmd"] and name in jax_tokens["sharded"]:
        assert got["tokens"] == jax_tokens["sharded"][name]
    assert got["again"] == got["tokens"][:1]  # deterministic on the same engine


@pytest.mark.parametrize("spec", WORLDS)
def test_tp_engine_matches_unsharded(worlds, jax_tokens, spec):
    _assert_matches(worlds, jax_tokens, spec, "dense")


@pytest.mark.parametrize("spec", WORLDS)
def test_tp_engine_paged_layout(worlds, jax_tokens, spec):
    """Paged KV (each rank's pools hold its KV heads) on tp-sharded weights."""
    _assert_matches(worlds, jax_tokens, spec, "paged")


@pytest.mark.parametrize("spec", WORLDS)
def test_tp_engine_paged_int8(worlds, jax_tokens, spec):
    """tp x paged x int8 pools: the JAX unsharded int8 engine's tokens, the
    first equal to the bf16 engine's (the reference's check), and the same
    again on the same engine."""
    _assert_matches(worlds, jax_tokens, spec, "paged_int8")
    got = worlds[spec][0]["engines"]["paged_int8"]["tokens"]
    assert got[0][0] == jax_tokens["bf16_of_int8_prompt"][0][0] and len(got[0]) == 6


@pytest.mark.parametrize("name", CHUNKED)
def test_tp_engine_ragged_chunked_prefill(worlds, jax_tokens, name):
    """Prompts past the chunk and past every bucket prefill in chunks
    through the ragged dispatch on the mesh, dense and paged int8."""
    got = worlds["tp=4"][0]["engines"][name]
    assert got["tokens"] == jax_tokens["unsharded"][name]
    assert got["again"] == got["tokens"][:1]


@pytest.mark.parametrize("spec", WORLDS)
def test_every_ranks_packed_outputs_are_bit_equal(worlds, spec):
    """Every follower's running hash of its packed blocks is the leader's,
    over the same number of blocks, for every engine."""
    ranks = worlds[spec]
    for name, lead in ranks[0]["engines"].items():
        blocks, digest = lead["digest"]
        assert blocks > 0 and lead["health"]["blocks"] == blocks
        assert lead["health"]["ranks"] == len(ranks) and not lead["health"]["lost"]
        assert all(tuple(r["engines"][name]) == (blocks, digest) for r in ranks[1:]), name


def test_tp_engine_http_grpc_load(worlds):
    """The reference test's load on the 8-rank tp engine behind an App: 8
    HTTP and 4 gRPC requests, TTFT read back from the engine's histogram."""
    ranks = worlds["fsdp=2,tp=4"]
    load = ranks[0]["http"]
    assert len(load["http"]) == 8 and len(load["grpc"]) == 4
    for status, completion, ttft_ms in load["http"]:
        assert status in (200, 201) and completion >= 1 and ttft_ms > 0
    assert set(load["grpc"]) <= {"length", "stop"}
    assert load["ttft_count"] == 12 and 0 < load["ttft_p50"] < 120
    assert load["tpot_count"] >= 1
    assert all(r["http"][0] > 0 for r in ranks[1:])  # every follower ran the blocks


def test_follower_that_raises_fails_the_request(worlds):
    """Rank 1's decode raises: its follower aborts the group, the leader's
    request fails with a 503 well inside the group's timeout instead of
    hanging, later submits are refused, and every rank returned."""
    fail = [r["fail"] for r in worlds["tp=4"]]
    lead = fail[0]
    assert lead["error"].startswith("TPGroupError") and lead["seconds"] < 60
    assert lead["after"].startswith("ErrorServiceUnavailable") and lead["status"] == "DOWN"
    assert "injected follower fault" in fail[1]["raised"]
    assert all(f["raised"] for f in fail[2:])


def test_host_ring_sums_and_gathers_exactly(worlds):
    """The tp group's all-reduce and all-gather through shared memory
    (``parallel/hostring.py``): small, within a slot, and in
    slot-sized pieces, f32 and bf16, each equal bit for bit to gloo's
    gather summed in rank order, and the same bits on every rank."""
    ranks = worlds["tp=4"]
    cases = ranks[0]["ring"]
    assert len(cases) == 8 and all(ok for ok, _ in cases.values())
    for r in ranks[1:]:
        assert {k: h for k, (_, h) in r["ring"].items()} == {k: h for k, (_, h) in cases.items()}


@pytest.mark.parametrize("feature", ["spec", "lora", "prefix_cache", "prefix_cache=", "kv_spill",
                                     "kv_migrator", "int8 params"])
def test_features_outside_the_slice_are_refused(worlds, feature):
    msg = worlds["tp=4"][0]["refusals"][feature]
    assert "tensor-parallel engine (mesh=) does not serve" in msg
    assert "Queue A item 13" in msg


def test_kv_head_placement():
    """The KV storage splits on its head axis over tp; with fewer KV heads
    than tp ranks each rank keeps the one its query heads read."""
    import types

    from gofr_tpu_torch.parallel.sharding import kv_head_slice

    def mesh(tp: int, i: int):
        return types.SimpleNamespace(shape={"tp": tp}, index=lambda axis: i)

    assert [kv_head_slice(32, 8, mesh(4, i)) for i in range(4)] == [(0, 2), (2, 2), (4, 2), (6, 2)]
    assert [kv_head_slice(4, 2, mesh(4, i)) for i in range(4)] == [(0, 1), (0, 1), (1, 1), (1, 1)]
    assert kv_head_slice(4, 2, mesh(1, 0)) == (0, 2)
    with pytest.raises(ValueError, match="neither split"):
        kv_head_slice(12, 3, mesh(2, 0))
