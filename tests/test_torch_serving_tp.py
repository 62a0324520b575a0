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
engine; the prefix cache's stats, ``spec_stats`` and the int8 weights'
slices exactly equal too.

LoRA (``lora=``) is held to the reference's unsharded engine with the
reference's ``AdapterRegistry`` and the same adapters (``make_adapter``'s
numpy draw): exact greedy tokens. KV migration between the tp engine and
a one-card port engine on rank 0 (the P/D handoff both ways, a chain
over ``fetch_chain``, the reclaim evacuation both ways, a torn handoff)
is held to the reference's unified engine's tokens; the entries that
crossed, gathered whole, to the reference's prefill replica's entries
within rtol 1e-5 (and atol 1e-5 of the largest magnitude: the tp
forward sums its row-parallel products in another order); and each
follower's slabs of an entry that came in to its heads of the sender's
entry, bit for bit.

The weight-only int8 engines serve ``quantize_params(local, mesh=)`` of
each rank's slices and are held to the reference's unsharded
``quantize_params(params)`` engine; the slices themselves are held bit for
bit to the addressable shards of the reference's only route to int8 on a
mesh, ``quantize_params(shard_params(...))`` (the other order raises).
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
from gofr_tpu.serving import lora as jlora
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
INT8 = {  # weight-only int8 params on the reference test's three configs
    "int8_dense": (BASE, ENGINES["dense"][1], {"params": "int8"}),
    "int8_paged": (PAGED, ENGINES["paged"][1], {"params": "int8"}),
    "int8_paged_int8": (dict(PAGED, kv_dtype="int8"), ENGINES["paged_int8"][1], {"params": "int8"}),
}
REPEAT = [("hello tp hello tp", 6), ("hello tp hello tp", 6), ("abcabcabcabc", 6)]
EVICTING = [("abc", 6), ("abc", 6), ("xyz", 6), ("abc", 6)]
PREFIX = {  # each prompt alone, in order, through the prefix cache; the whole prefills each ran
    "prefix_dense": (dict(BASE, prefix_cache_entries=4), REPEAT, [1, 0, 1]),
    "prefix_paged": (dict(PAGED, prefix_cache_entries=4), REPEAT, [1, 0, 1]),
    # 12000 bytes hold one 16-token entry (9472 bytes at the whole KV's size), not two
    "prefix_evict": (dict(BASE, prefix_cache_entries=4, prefix_cache_bytes=12000), EVICTING,
                     [1, 0, 1, 1]),
    # two 16-token chunks through the ragged dispatch, cached at their
    # boundaries: the second admission restores both and dispatches none
    "prefix_chunked": (dict(PAGED, prefill_chunk_tokens=16, prefix_cache_entries=8),
                       [("the quick brown fox jumps over", 6)] * 2, [0, 0]),
}
FOX = "the quick brown fox jumps over"
SPILL = {  # a device tier of one entry; the host-tier hits and the whole prefills each ran
    "spill": (dict(BASE, prefix_cache_entries=1, kv_spill_bytes=1 << 20),
              [("abc", 6), ("xyz", 6), ("abc", 6)], 1, [1, 1, 0]),  # abc spills, then hits
    # a chain of two 16-token chunk entries: both spill (the second behind
    # "xyz"), then one walk re-uploads both, and the second's re-upload
    # spills the first before the restore reads it
    "spill_chain": (dict(PAGED, prefill_chunk_tokens=16, prefix_cache_entries=1,
                         kv_spill_bytes=1 << 20),
                    [(FOX, 6), ("xyz", 6), (FOX, 6)], 2, [0, 1, 0]),
}
SPEC_PROMPTS = [("aaaaaaaa", 24), ("hello tp", 6)]  # the first settles into a loop the drafts hit
SPEC = {
    "spec_dense": (dict(BASE, spec_tokens=2), SPEC_PROMPTS),
    "spec_paged": (dict(PAGED, spec_tokens=2), SPEC_PROMPTS),
}
RESTART = (dict(BASE, prefix_cache_entries=4), [("hello tp", 6), ("b", 6), ("hello tp", 6)])
FEATURES = {**{k: (c, p, {"kind": "prefix"}) for k, (c, p, _) in PREFIX.items()},
            **{k: (c, p, {"kind": "spill"}) for k, (c, p, _, _) in SPILL.items()},
            **{k: (c, p, {"kind": "spec"}) for k, (c, p) in SPEC.items()}}
WORLDS = {"fsdp=2,tp=4": 8, "tp=4": 4}
ADAPTERS = {"a": (1, 4), "b": (2, 4), "c": (3, 6)}  # id -> (make_adapter seed, rank)
LORA = {  # each prompt: text, tokens, adapter id (None: the base model)
    "lora_dense": (BASE, [("hello tp", 6, "a"), ("hello tp", 6, None),
                          ("a longer prompt than the others", 6, "b")], {"batch": True}),
    # one table slot: each adapter uploads into it between dispatches, the
    # rank-6 one grows the tables; then a warm restart and the same again
    "lora_swap": (PAGED, [("hello tp", 6, "a"), ("hello tp", 6, "c"), ("hello tp", 6, "a")],
                  {"max_active": 2, "restart": True}),
    "lora_chunked": (dict(PAGED, prefill_chunk_tokens=16),
                     [(FOX, 6, "a"), ("a prompt longer than every prefill bucket", 6, "b")], {}),
}
HANDOFF = "the disaggregated system prompt xy"  # three 16-token chunks
MIG = dict(PAGED, prefill_chunk_tokens=16, prefix_cache_entries=64)
MIG_INT8 = dict(PAGED, kv_dtype="int8", prefix_cache_entries=64)  # whole-prompt entries only
MIGRATION = {  # name -> (config, arc, prompts)
    "tp_to_one": (MIG, "tp_to_one", [(HANDOFF, 5), ("short sys", 4)]),
    "tp_to_one_int8": (MIG_INT8, "tp_to_one", [("short sys", 4)]),
    "one_to_tp": (MIG, "one_to_tp", [(HANDOFF, 5), ("short sys", 4)]),
    "one_to_tp_int8": (MIG_INT8, "one_to_tp", [("short sys", 4)]),
    "chain": (dict(BASE, prefill_chunk_tokens=16, prefix_cache_entries=64), "chain",
              [(HANDOFF, 5)]),
    "evacuate": (MIG, "evacuate", [(HANDOFF, 5), ("short sys", 4)]),
    "evacuate_in": (MIG, "evacuate_in", [(HANDOFF, 5)]),
    "torn": (MIG, "torn", [(HANDOFF, 5)]),
}
WIDE_LORA = ("lora_dense",)  # also in the 8-rank world
WIDE_MIGRATION = ("tp_to_one", "one_to_tp_int8")


def _jax_mesh(spec: str) -> Mesh:
    fsdp = 2 if spec.startswith("fsdp") else 1
    return Mesh(np.array(jax.devices()[:4 * fsdp]).reshape(fsdp, 4), ("fsdp", "tp"))


@pytest.fixture(scope="module")
def ref():
    cfg = jllama.LlamaConfig.tiny(vocab_size=VOCAB)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jshard_params(params, _jax_mesh("fsdp=2,tp=4"), jrules())


def _jax_run(cfg, params, conf: dict, prompts: list, kind: str) -> dict:
    """The reference engine's run of a feature engine: each prompt alone,
    in order (``spill`` settles the spill worker after each); its tokens,
    prefix cache stats and ``spec_stats``."""
    engine = JServingEngine(cfg, params, JEngineConfig(**conf), JByteTokenizer())
    engine.start()
    try:
        tokens = []
        for p, n in prompts:
            tokens.append(engine.submit(p, max_new_tokens=n, temperature=0.0)
                          .result(timeout=120).token_ids)
            if kind == "spill":
                engine._prefix_cache.flush()
        details = engine.health_check()["details"]
    finally:
        engine.stop()
    return {"tokens": tokens, "prefix_cache": details.get("prefix_cache"),
            "spec_stats": dict(engine.spec_stats)}


def _jax_tokens(cfg, params, conf: dict, prompts: list) -> list:
    engine = JServingEngine(cfg, params, JEngineConfig(**conf), JByteTokenizer())
    engine.start()
    try:
        return [engine.submit(p, max_new_tokens=n, temperature=0.0).result(timeout=120).token_ids
                for p, n in prompts]
    finally:
        engine.stop()


def _jax_lora_tokens(cfg, params, conf: dict, prompts: list, max_active: int) -> list:
    """The reference engine with the reference's registry of the same
    adapters: each prompt alone, greedy."""
    reg = jlora.AdapterRegistry(max_active=max_active)
    for aid, (seed, rank) in ADAPTERS.items():
        ad = jlora.make_adapter(cfg, aid, rank=rank, seed=seed, scale=8.0)
        reg.register(ad)
    engine = JServingEngine(cfg, params, JEngineConfig(**conf), JByteTokenizer(), lora=reg)
    engine.start()
    try:
        return [engine.submit(p, max_new_tokens=n, temperature=0.0, adapter_id=aid)
                .result(timeout=120).token_ids for p, n, aid in prompts]
    finally:
        engine.stop()
        reg.close()


def _jax_entries(cfg, params, conf: dict, prompts: list) -> dict:
    """The reference prefill replica's cache entries after each prompt's
    ``prefill_only``: {key: (logits, k, v)} as numpy."""
    engine = JServingEngine(cfg, params, JEngineConfig(**conf, role="prefill"), JByteTokenizer())
    engine.start()
    try:
        for p, _ in prompts:
            assert engine.submit(p, max_new_tokens=1, temperature=0.0, prefill_only=True).result(
                timeout=120).finish_reason == "handoff"
        cache = engine._prefix_cache
        return {key: tuple(np.asarray(leaf, np.float32) for leaf in cache.get(key))
                for key in cache.keys()}
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
        wide = spec == "fsdp=2,tp=4"
        engines = {**ENGINES, **INT8} if wide else {**ENGINES, **CHUNKED, **INT8, **FEATURES}
        lora = {k: v for k, v in LORA.items() if not wide or k in WIDE_LORA}
        migration = {k: v for k, v in MIGRATION.items() if not wide or k in WIDE_MIGRATION}
        inp = {"mesh": spec, "vocab": VOCAB, "params": params_np,
               "engines": [(name, *entry) for name, entry in engines.items()],
               "adapters": ADAPTERS, "delta_rows": not wide,
               "lora": [(name, *entry) for name, entry in lora.items()],
               "migration": [(name, *entry) for name, entry in migration.items()],
               "http": BASE if wide else None,
               "refusals": not wide, "fail": None if wide else PAGED, "ring": not wide,
               "restart": None if wide else RESTART, "restart_lost": BASE if wide else None}
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
    int8 = jllama.quantize_params(params)
    for name, (conf, prompts, _) in INT8.items():
        out["unsharded"][name] = _jax_tokens(cfg, int8, conf, prompts)
    out["features"] = {name: _jax_run(cfg, params, conf, prompts, opt["kind"])
                       for name, (conf, prompts, opt) in FEATURES.items()}
    out["restart"] = _jax_tokens(cfg, params, *RESTART)
    out["lora"] = {name: _jax_lora_tokens(cfg, params, conf, prompts, opt.get("max_active", 4))
                   for name, (conf, prompts, opt) in LORA.items()}
    out["migration"] = {name: _jax_tokens(cfg, params, conf, prompts)
                        for name, (conf, _, prompts) in MIGRATION.items()}
    out["entries"] = {name: _jax_entries(cfg, params, conf, prompts)
                      for name, (conf, _, prompts) in MIGRATION.items()}
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


@pytest.mark.parametrize("spec", WORLDS)
def test_init_params_quantized_on_a_mesh_keeps_the_ranks_slices(worlds, spec):
    """``init_params(quantize=True, mesh=)`` quantizes each leaf whole and
    keeps each rank's ``q`` and ``s``: equal to ``shard_params`` of the
    one-card ``quantize_params`` on every rank."""
    assert all(r["init_int8_slices_equal"] for r in worlds[spec])


@pytest.mark.parametrize("spec", WORLDS)
def test_int8_slices_equal_the_reference_shards(worlds, ref, spec):
    """Each rank's ``quantize_params(local, mesh=)`` slices, bit for bit, are
    the addressable shards of the reference's ``quantize_params(
    shard_params(...))`` on the device at the rank's mesh coordinates: q by
    its weight's placement, s on the output axis, and a row-parallel
    scale from the absmax of the whole contraction axis."""
    cfg, params, _ = ref
    mesh = _jax_mesh(spec)
    qtree = jllama.quantize_params(jshard_params(params, mesh, jrules()))
    leaves = {f"layers/{k}/{part}": v[part] for k, v in qtree["layers"].items()
              if isinstance(v, dict) for part in ("q", "s")}
    leaves.update({f"lm_head/{part}": qtree["lm_head"][part] for part in ("q", "s")})
    assert np.asarray(qtree["layers"]["wo"]["s"]).shape == (cfg.n_layers, cfg.d_model)
    for r in worlds[spec]:
        device = mesh.devices[r["coordinate"]["fsdp"], r["coordinate"]["tp"]]
        assert set(r["int8_slices"]) == set(leaves)
        for path, leaf in leaves.items():
            shard = next(s for s in leaf.addressable_shards if s.device == device)
            got, want = r["int8_slices"][path], np.asarray(shard.data)
            assert got.shape == want.shape and got.dtype == want.dtype, path
            assert got.tobytes() == want.tobytes(), (r["rank"], path)


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


@pytest.mark.parametrize("spec", WORLDS)
@pytest.mark.parametrize("name", INT8)
def test_tp_engine_int8_params(worlds, jax_tokens, spec, name):
    """Weight-only int8 params on the mesh: the reference's unsharded
    ``quantize_params(params)`` engine's greedy tokens, and the same again."""
    _assert_matches(worlds, jax_tokens, spec, name)


def _follower_keys(worlds, name: str) -> None:
    """Every follower's store holds on the card the keys the leader's
    device tier holds, and in host memory at least its host tier's."""
    ranks = worlds["tp=4"]
    lead = ranks[0]["engines"][name]
    stats = lead["prefix_cache"]
    for r in ranks[1:]:
        held = set(r["engines"][name]["card"]) | set(r["engines"][name]["host"])
        assert set(lead["keys"]) <= held
        assert len(r["engines"][name]["card"]) == stats["entries"]


@pytest.mark.parametrize("name", PREFIX)
def test_tp_prefix_cache(worlds, jax_tokens, name):
    """The prefix cache on the mesh: the reference's tokens and its stats
    (entries, hits, misses, bytes at the whole KV's size; with a budget of
    one entry, its evictions), no prefill on a whole-prompt hit, and the
    leader's keys in every follower's store."""
    got = worlds["tp=4"][0]["engines"][name]
    want = jax_tokens["features"][name]
    assert got["tokens"] == want["tokens"]
    for key in ("entries", "hits", "misses", "bytes"):
        assert got["prefix_cache"][key] == want["prefix_cache"][key], key
    assert got["prefix_cache"]["hits"] >= 1
    assert got["prefills"] == PREFIX[name][2]
    _follower_keys(worlds, name)


@pytest.mark.parametrize("name", SPILL)
def test_tp_spill_tier(worlds, jax_tokens, name):
    """The host spill tier on the mesh: the reference's tokens, device and
    host hits; the followers spilled and re-uploaded their own slabs (a
    chunk chain: each restores the slabs of the walk's hits, though the
    walk spilled the first before the restore)."""
    got = worlds["tp=4"][0]["engines"][name]
    want = jax_tokens["features"][name]
    host_hits, prefills = SPILL[name][2:]
    assert got["tokens"] == want["tokens"]
    for key in ("entries", "hits", "misses", "bytes"):
        assert got["prefix_cache"][key] == want["prefix_cache"][key], key
    assert got["prefix_cache"]["host"]["hits"] == want["prefix_cache"]["host"]["hits"] == host_hits
    assert got["prefills"] == prefills
    _follower_keys(worlds, name)


@pytest.mark.parametrize("name", SPEC)
def test_tp_speculative_decoding(worlds, jax_tokens, name):
    """Speculative decoding on the mesh (the verify through
    ``dispatch_verify`` on every rank): the reference's greedy tokens and
    ``spec_stats``, with drafts accepted."""
    got = worlds["tp=4"][0]["engines"][name]
    want = jax_tokens["features"][name]
    assert got["tokens"] == want["tokens"]
    assert got["spec_stats"] == want["spec_stats"]
    assert got["spec_stats"]["accepted"] > 0


def test_tp_warm_restart(worlds, jax_tokens):
    """``warm_restart`` of the tp engine with two requests queued behind a
    held loop: it joins, every rank rebuilds, both complete with the
    reference's tokens, the epoch is bumped, the rank hashes are equal and
    the rebuilt prefix store holds the leader's keys."""
    ranks = worlds["tp=4"]
    lead = ranks[0]["restart"]
    assert lead["restarted"] and lead["status"] == "UP"
    assert lead["epoch"][1] == lead["epoch"][0] + 1
    assert lead["tokens"] == jax_tokens["restart"]
    assert all(r["restart"]["digest"] == tuple(lead["digest"]) for r in ranks[1:])
    assert lead["keys"] and all(set(lead["keys"]) <= set(r["restart"]["card"]) for r in ranks[1:])


def test_tp_warm_restart_that_cannot_join_ends_the_group(worlds):
    """A restart whose loop thread stays hung: ``TPGroupError``, health
    DOWN with the group lost, the queued request failed retriable, and
    every follower raised instead of waiting out its timeout."""
    ranks = worlds["fsdp=2,tp=4"]
    lead = ranks[0]["restart_lost"]
    assert lead["error"].startswith("TPGroupError")
    assert lead["queued"].startswith("ErrorServiceUnavailable")
    assert lead["status"] == "DOWN" and lead["lost"]
    assert all(r["restart_lost"]["raised"] for r in ranks[1:])


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
        assert all(tuple(r["engines"][name]["digest"]) == (blocks, digest)
                   for r in ranks[1:]), name


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


@pytest.mark.parametrize("feature", ["pp"])
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


def test_kv_head_slices_take_each_head_once():
    """``kv_head_slices`` lists each tp index's ``kv_head_slice``; where
    ranks keep copies of a head (fewer KV heads than ranks) the gather of
    an entry takes each head once, in head order."""
    import types

    from gofr_tpu_torch.parallel.sharding import kv_head_slice, kv_head_slices

    for n_heads, n_kv, tp in ((32, 8, 4), (4, 2, 4), (8, 1, 4), (8, 8, 2)):
        places = kv_head_slices(n_heads, n_kv, tp)
        assert places == [kv_head_slice(n_heads, n_kv, types.SimpleNamespace(
            shape={"tp": tp}, index=lambda axis, i=i: i)) for i in range(tp)]
        covered = sorted({h for first, n in places for h in range(first, first + n)})
        assert covered == list(range(n_kv))


def test_tp_lora_delta_reads_the_whole_row(worlds):
    """Token ids in every rank's vocabulary shard (a rank holds 80 of the
    320 rows): on every rank the forward's lookup the delta taps is the
    whole table's row of each id, bit for bit, and so is the delta it gives
    and the ``embed`` command's row of the last id."""
    for r in worlds["tp=4"]:
        got = r["delta_rows"]
        assert got["local_rows"] == VOCAB // 4
        assert got["rows_equal"] and got["delta_equal"] and got["embed_row_equal"], r["rank"]
        assert got["delta_nonzero"]


def _lora(worlds, spec: str, name: str) -> dict:
    ranks = worlds[spec]
    got = ranks[0]["lora"][name]
    assert all(tuple(r["lora"][name]["digest"]) == tuple(got["digest"]) for r in ranks[1:])
    assert got["digest"][0] > 0 and not got["health"]["lost"] and got["pinned"] == 0
    return got


@pytest.mark.parametrize("spec,name", [(s, n) for s in WORLDS for n in LORA
                                       if s == "tp=4" or n in WIDE_LORA])
def test_tp_lora_matches_the_reference(worlds, jax_tokens, spec, name):
    """The tp engine with an ``AdapterRegistry``: the reference engine's
    greedy tokens with the reference's registry of the same adapters, each
    prompt alone, on the dense and paged layouts and chunked; the rank
    hashes equal (each follower mirrors the leader's tables)."""
    got = _lora(worlds, spec, name)
    assert got["tokens"] == jax_tokens["lora"][name]


def test_tp_lora_mixed_batch(worlds, jax_tokens):
    """Two adapters and a base row at once: the tokens of each alone, and
    the adapter row apart from its base twin (the delta is applied)."""
    got = _lora(worlds, "tp=4", "lora_dense")
    assert got["together"] == got["tokens"] == jax_tokens["lora"]["lora_dense"]
    assert got["tokens"][0] != got["tokens"][1]


def test_tp_lora_upload_between_dispatches(worlds, jax_tokens):
    """One table slot: each adapter uploads into it between two dispatches
    (the rank-6 one growing the tables), and every follower replays each
    change before the dispatch that reads it: the reference's tokens, the
    second adapter's apart from the first's."""
    got = _lora(worlds, "tp=4", "lora_swap")
    assert got["tokens"] == jax_tokens["lora"]["lora_swap"]
    assert got["tokens"][0] == got["tokens"][2] != got["tokens"][1]


def test_tp_lora_warm_restart(worlds, jax_tokens):
    """``warm_restart`` with a registry: every follower drops its tables
    and takes the leader's whole again; the same tokens after."""
    got = _lora(worlds, "tp=4", "lora_swap")
    assert got["restarted"] and got["after"] == jax_tokens["lora"]["lora_swap"]


def _migration(worlds, spec: str, name: str) -> tuple[dict, list]:
    ranks = worlds[spec]
    got = ranks[0]["migration"][name]
    followers = [r["migration"][name] for r in ranks[1:]]
    assert all(tuple(f["digest"]) == tuple(got["digest"]) for f in followers)
    return got, followers


def _close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, leaves in got.items():
        for g, w in zip(leaves, want[key]):
            assert g.shape == w.shape, key
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))


def _received_whole(got: dict, followers: list, jax_tokens, name: str) -> None:
    """The entries that crossed are the reference's within the stated
    tolerance; where the tp engine received them, each follower's slabs of
    each are its heads of the sender's entry, bit for bit."""
    assert set(got["sent"]) <= set(got["received"])
    _close({k: got["received"][k] for k in got["sent"]}, jax_tokens["entries"][name])
    if "expected" in got:
        for f, r in zip(followers, range(1, 1 + len(followers))):
            tp_index = r % 4  # the tp axis is the mesh's last: rank % tp
            assert f["imported"] == {k: v[tp_index] for k, v in got["expected"].items()}


@pytest.mark.parametrize("spec,name", [(s, n) for s in WORLDS for n in ("tp_to_one",
                                                                       "tp_to_one_int8")
                                       if s == "tp=4" or n in WIDE_MIGRATION])
def test_tp_handoff_to_one_card(worlds, jax_tokens, spec, name):
    """The tp engine as the prefill replica: ``prefill_only`` retires with
    ``handoff``, the one-card decode replica serves with ``handoff_from``
    and no prefill compute, the reference's tokens; what it fetched is the
    tp engine's entries gathered whole (bf16 and int8 pools)."""
    got, followers = _migration(worlds, spec, name)
    assert got["tokens"] == jax_tokens["migration"][name]
    assert set(got["finish"]) == {"handoff"} and got["handoffs"] == len(got["tokens"])
    assert all(c == {"prefill": 0, "ragged": 0} for c in got["counts"])
    _received_whole(got, followers, jax_tokens, name)


@pytest.mark.parametrize("spec,name", [(s, n) for s in WORLDS for n in ("one_to_tp",
                                                                       "one_to_tp_int8")
                                       if s == "tp=4" or n in WIDE_MIGRATION])
def test_tp_handoff_from_one_card(worlds, jax_tokens, spec, name):
    """The tp engine as the decode replica: ``handoff_from`` admits with
    zero prefill compute on every rank, the reference's tokens, and each
    rank keeps its own heads of each entry (bf16 and int8 pools)."""
    got, followers = _migration(worlds, spec, name)
    assert got["tokens"] == jax_tokens["migration"][name]
    assert got["handoffs"] == len(got["tokens"])
    none = {"prefill": 0, "ragged": 0}
    assert all(c == none for c in got["counts"])
    assert all(f["counts"] == none for f in followers)
    _received_whole(got, followers, jax_tokens, name)


def test_tp_fetch_chain(worlds, jax_tokens):
    """A chunk chain the one-card engine advertises, fetched by the tp
    engine over ``fetch_chain`` (dense layout): the whole prompt admits from
    it with no prefill dispatch on any rank, the reference's tokens."""
    got, followers = _migration(worlds, "tp=4", "chain")
    assert got["tokens"] == got["first"] == jax_tokens["migration"]["chain"]
    assert got["migrations"] == 1
    assert got["counts"] == [{"prefill": 0, "ragged": 0}]
    assert all(f["counts"] == {"prefill": 0, "ragged": 0} for f in followers)
    _received_whole(got, followers, jax_tokens, "chain")


@pytest.mark.parametrize("name", ["evacuate", "evacuate_in"])
def test_tp_reclaim_evacuation(worlds, jax_tokens, name):
    """``begin_reclaim`` pushes the whole cache, committed, from the tp
    engine to a one-card survivor (``evacuate``) or from a one-card engine
    onto the tp engine (``evacuate_in``); the survivor then serves the
    prompts with no prefill dispatch on any of its ranks, the reference's
    tokens."""
    got, followers = _migration(worlds, "tp=4", name)
    ev = got["evacuation"]
    assert ev["outcome"] == "committed" and ev["committed"] == ev["entries"] == len(got["src_keys"])
    assert got["dst_keys"] == got["src_keys"]
    assert got["tokens"] == got["first"] == jax_tokens["migration"][name]
    assert got["counts"] == [{"prefill": 0, "ragged": 0}]
    if name == "evacuate_in":
        assert all(f["counts"] == {"prefill": 0, "ragged": 0} for f in followers)
        assert all(set(f["card"]) == set(got["keys"]) for f in followers)
    _received_whole(got, followers, jax_tokens, name)


def test_tp_torn_handoff_leaves_no_partial_chain(worlds, jax_tokens):
    """The source loses a chain's middle entry mid-handoff: the handoff
    fails whole (no handoff counted), no rank took any entry of it, the tp
    engine computes the prompt and serves the reference's tokens, and every
    follower holds exactly the leader's keys."""
    got, followers = _migration(worlds, "tp=4", "torn")
    assert got["tokens"] == jax_tokens["migration"]["torn"] and got["handoffs"] == 0
    assert got["counts"][0]["ragged"] > 0
    for f in followers:
        assert f["imported"] == {} and f["counts"]["ragged"] > 0
        assert set(f["card"]) == set(got["keys"])
