"""Rank functions of the tensor-parallel engine's tests
(``test_torch_serving_tp.py``, ``test_torch_checkpoint.py``,
``test_torch_hf_import.py``).

Each function runs on every rank of one gloo world on the CPU
(``gofr_tpu_torch.parallel.world.run_spmd``): rank 0 builds the
tensor-parallel ``ServingEngine(..., mesh=)`` and serves, every other rank
runs ``serve_follower`` for each engine in the same order. Inputs come as
numpy (the JAX package's tiny params, made in the test process) and the
results go back as plain values. The module imports torch and the port
only, never JAX, so a spawned rank never loads it.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading
import time
import urllib.request
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.parallel import build_mesh, llama_sharding_rules, shard_params
from gofr_tpu_torch.parallel.sharding import kv_head_slices
from gofr_tpu_torch.serving import batch as batch_ops
from gofr_tpu_torch.serving import prefix_index
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine
from gofr_tpu_torch.serving.lora import AdapterRegistry, make_adapter
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer
from gofr_tpu_torch.serving.tp_group import (TPGroupError, embedding_row, serve_follower,
                                              slab_digest)

TIMEOUT_S = 120


def _local(inp: dict, mesh: Any) -> dict:
    return params_from_jax(shard_params(inp["params"], mesh, llama_sharding_rules()),
                           device="cpu")


def _digest(result: Any) -> tuple[int, str]:
    return result.blocks, result.digest


def _serve(engine: ServingEngine, prompts: list) -> list[list[int]]:
    """Each prompt alone, greedy, as the reference test submits them."""
    return [engine.submit(p, max_new_tokens=n, temperature=0.0).result(timeout=TIMEOUT_S)
            .token_ids for p, n in prompts]


def tp_world(dev: torch.device, inp: dict) -> dict:
    """The engines of ``test_torch_serving_tp.py`` on one mesh, in order:
    each of ``inp["engines"]`` serves its prompts (an optional fourth
    entry: ``"int8"`` params, ``"kind"`` ``prefix``, ``spill`` or ``spec``),
    then the LoRA engines (``inp["lora"]``, after the delta's row check of
    ``inp["delta_rows"]``) and the migration arcs (``inp["migration"]``),
    then (``inp["http"]``) the HTTP + gRPC load, the refusals
    (``inp["refusals"]``), a warm restart with queued requests
    (``inp["restart"]``), and last a follower that raises (``inp["fail"]``)
    or a restart that cannot join (``inp["restart_lost"]``), after which
    no rank has a process group."""
    torch.set_num_threads(1)
    mesh = build_mesh(inp["mesh"])
    cfg = llama.LlamaConfig.tiny(vocab_size=inp["vocab"])
    local = _local(inp, mesh)
    rank = dist.get_rank()
    lead = rank == 0
    out: dict = {"rank": rank, "wq": tuple(local["layers"]["wq"].shape), "engines": {}}
    if inp.get("ring"):
        out["ring"] = _ring_checks(mesh)
    # init_params(mesh=) draws the weights leaf by leaf and keeps this
    # rank's slices: the slices of the one-card draw
    whole = llama.init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    mine = llama.init_params(cfg, torch.Generator().manual_seed(7), device="cpu", mesh=mesh)
    want = shard_params(whole, mesh, llama_sharding_rules())
    out["init_slices_equal"] = _tree_equal(mine, want)
    # weight-only int8: quantized on the ranks' slices (the row-parallel
    # absmax reduced over tp), and drawn quantized whole on a mesh
    int8 = llama.quantize_params(local, mesh=mesh)
    out["int8_slices"] = _int8_leaves(int8)
    out["coordinate"] = dict(mesh.coordinate)
    mine = llama.init_params(cfg, torch.Generator().manual_seed(7), device="cpu", mesh=mesh,
                             quantize=True)
    want = shard_params(llama.quantize_params(whole), mesh, llama_sharding_rules())
    out["init_int8_slices_equal"] = _tree_equal(mine, want)
    trees = {"bf16": local, "int8": int8}
    for name, conf, prompts, *opts in inp["engines"]:
        opt = opts[0] if opts else {}
        params = trees[opt.get("params", "bf16")]
        if not lead:
            res = serve_follower(cfg, params, mesh=mesh, device="cpu")
            out["engines"][name] = {"digest": _digest(res), "card": res.prefix_card,
                                    "host": res.prefix_host}
            continue
        engine = ServingEngine(cfg, params, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                               device="cpu")
        out["engines"][name] = _serve_engine(engine, prompts, opt.get("kind"))
    if inp.get("delta_rows"):
        out["delta_rows"] = _delta_rows(cfg, local, mesh, inp)
    for name, conf, prompts, opt in inp.get("lora", ()):
        out.setdefault("lora", {})[name] = _lora_case(cfg, local, mesh, conf, prompts, opt,
                                                      inp["adapters"])
    for name, conf, kind, prompts in inp.get("migration", ()):
        whole = params_from_jax(inp["params"], device="cpu") if lead else None
        out.setdefault("migration", {})[name] = _migration_case(cfg, whole, local, mesh, conf,
                                                                kind, prompts)
    if inp.get("http"):
        out["http"] = (_http_load(cfg, local, mesh, inp["http"]) if lead
                       else _digest(serve_follower(cfg, local, mesh=mesh, device="cpu")))
    if inp.get("refusals"):
        pp_mesh = build_mesh("pp=2,tp=2")  # collective: every rank builds it
        if lead:
            out["refusals"] = _refusals(cfg, local, mesh, pp_mesh)
    if inp.get("restart"):
        out["restart"] = _restart(cfg, local, mesh, *inp["restart"])
    if inp.get("fail"):
        out["fail"] = _fail(cfg, local, mesh, inp["fail"])
    if inp.get("restart_lost"):
        out["restart_lost"] = _restart_lost(cfg, local, mesh, inp["restart_lost"])
    return out


class _Gate:
    """Holds the engine loop before its admission while ``closed``: it
    lets go when the loop is stopped (``until_stopped``), or only once
    opened. ``waiting`` is set once the loop waits at it."""

    def __init__(self, engine: ServingEngine, until_stopped: bool) -> None:
        self.engine, self.until_stopped = engine, until_stopped
        self.closed = threading.Event()
        self.waiting = threading.Event()
        real = engine._admit

        def admit(plan):
            while self.closed.is_set() and not (self.until_stopped and not engine._running):
                self.waiting.set()
                time.sleep(0.005)
            return real(plan) if engine._running else False

        engine._admit = admit


def _restart(cfg: Any, local: dict, mesh: Any, conf: dict, prompts: list) -> dict:
    """``warm_restart`` of the tp engine with two requests queued behind a
    held loop: the first prompt served before, the others queued; the
    restart joins the loop, rebuilds every rank's state and serves them."""
    if dist.get_rank() != 0:
        res = serve_follower(cfg, local, mesh=mesh, device="cpu")
        return {"digest": _digest(res), "card": res.prefix_card}
    engine = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                           device="cpu")
    gate = _Gate(engine, until_stopped=True)
    engine.start()
    try:
        before = _serve(engine, prompts[:1])
        gate.closed.set()
        gate.waiting.wait(timeout=TIMEOUT_S)
        futures = [engine.submit(p, max_new_tokens=n, temperature=0.0) for p, n in prompts[1:]]
        epoch = engine.epoch
        restarted = engine.warm_restart(join_timeout=TIMEOUT_S)
        gate.closed.clear()
        queued = [f.result(timeout=TIMEOUT_S).token_ids for f in futures]
        status = engine.health_check()["status"]
    finally:
        engine.stop()
    return {"tokens": before + queued, "restarted": restarted, "epoch": (epoch, engine.epoch),
            "status": status, "digest": engine.tp_digest(),
            "keys": sorted(engine._prefix_cache.keys())}


def _restart_lost(cfg: Any, local: dict, mesh: Any, conf: dict) -> dict:
    """A warm restart whose loop thread stays hung past ``join_timeout``:
    the group ends (``TPGroupError``, health DOWN, the queued request fails
    retriable) and every follower raises; no rank keeps a process group."""
    if dist.get_rank() != 0:
        try:
            serve_follower(cfg, local, mesh=mesh, device="cpu")
            return {"raised": ""}
        except TPGroupError as exc:
            return {"raised": str(exc)}
    engine = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                           device="cpu")
    gate = _Gate(engine, until_stopped=False)
    engine.start()
    try:
        gate.closed.set()
        gate.waiting.wait(timeout=TIMEOUT_S)
        fut = engine.submit("queued behind a hang", max_new_tokens=4, temperature=0.0)
        try:
            engine.warm_restart(join_timeout=0.5)
            error = ""
        except Exception as exc:  # noqa: BLE001 - the test reads what the caller gets
            error = f"{type(exc).__name__}: {exc}"
        try:
            fut.result(timeout=TIMEOUT_S)
            queued = ""
        except Exception as exc:  # noqa: BLE001
            queued = f"{type(exc).__name__}: {exc}"
        health = engine.health_check()
    finally:
        gate.closed.clear()
        engine.stop()
    return {"error": error, "queued": queued, "status": health["status"],
            "lost": health["details"]["tensor_parallel"]["lost"]}


def _tree_equal(got: dict, want: dict) -> bool:
    """Every leaf of two params trees (int8 leaves' ``q`` and ``s``) equal."""
    if isinstance(want, dict):
        return set(got) == set(want) and all(_tree_equal(got[k], want[k]) for k in want)
    return torch.equal(got, want)


def _int8_leaves(params: dict) -> dict:
    """Each weight-only int8 leaf's ``q`` and ``s`` slices as numpy, by path."""
    out = {}
    leaves = [(f"layers/{k}", v) for k, v in params["layers"].items()]
    for path, w in [*leaves, ("lm_head", params.get("lm_head"))]:
        if isinstance(w, dict):
            out[f"{path}/q"], out[f"{path}/s"] = w["q"].numpy(), w["s"].numpy()
    return out


def _serve_engine(engine: ServingEngine, prompts: list, kind: str | None) -> dict:
    """One leader engine's run (:func:`tp_world`): each prompt alone, then
    the first again, or by ``kind``: ``prefix`` and ``spec`` serve the
    prompts alone in order, ``spill`` settles the spill worker after each.
    Returns the tokens, the packed-block hash, the group's health and the
    prefix cache's stats and keys, ``spec_stats`` and the prefill
    dispatches of each prompt."""
    prefills: list[int] = []
    real = batch_ops.prefill_compute

    def counted(*args, **kw):
        prefills[-1] += 1
        return real(*args, **kw)

    batch_ops.prefill_compute = counted
    engine.start()
    try:
        tokens = []
        for p, n in prompts:
            prefills.append(0)
            tokens.append(_serve(engine, [(p, n)])[0])
            if kind == "spill":
                engine._prefix_cache.flush()
        again = _serve(engine, prompts[:1]) if kind is None else None
    finally:
        batch_ops.prefill_compute = real
        engine.stop()
    out = {"tokens": tokens, "again": again, "digest": engine.tp_digest(),
           "health": engine.health_check()["details"]["tensor_parallel"],
           "spec_stats": dict(engine.spec_stats), "prefills": prefills}
    cache = engine._prefix_cache
    if cache is not None:
        out["prefix_cache"] = engine.health_check()["details"]["prefix_cache"]
        out["keys"] = sorted(cache.keys())
    return out


def _ring_checks(mesh: Any) -> dict:
    """The host ring's all-reduce and all-gather on the tp group (small,
    within a slot, past a slot; f32 and bf16) against gloo's gather of the
    same tensors summed in rank order: equal bit for bit. Returns, by case,
    (equal, a hash of the result) for the test to compare across ranks."""
    import hashlib

    from gofr_tpu_torch.parallel import hostring

    group, n = mesh.group("tp"), mesh.shape["tp"]
    ring = hostring.ring_for(group)
    assert ring is not None
    gen = torch.Generator().manual_seed(100 + dist.get_rank())
    out = {}
    for shape in ((3,), (8, 4096), (1, 300, 1000), (2, 1024, 1100)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen).to(dtype)
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x, group=group)  # gloo itself: the ring is not involved
            want = parts[0].clone()
            for p in parts[1:]:
                want += p
            got = ring.all_reduce(x)
            gathered = ring.all_gather(x, 0)
            key = f"{shape} {dtype}"
            out[key] = (torch.equal(got, want) and torch.equal(gathered, torch.cat(parts)),
                        hashlib.blake2b(got.view(torch.uint8).numpy().tobytes()).hexdigest())
    return out


def _http_load(cfg: Any, local: dict, mesh: Any, conf: dict) -> dict:
    """The reference test's load: 8 concurrent ``/generate`` calls and 4
    gRPC ``Generate`` calls of 5 tokens on the tp engine behind an App."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.grpcx import InferenceClient, InferenceService
    from gofr_tpu_torch.serving.handlers import register_generation_routes
    from gofr_tpu_torch.testutil import new_server_configs

    ports = new_server_configs(set_env=False)
    app = App(MapConfig({"HTTP_PORT": str(ports.http_port), "GRPC_PORT": str(ports.grpc_port),
                         "METRICS_PORT": str(ports.metrics_port), "HTTP_HOST": "127.0.0.1",
                         "APP_NAME": "tp-serving-test", "LOG_LEVEL": "FATAL"}, use_env=False))
    engine = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                           device="cpu", metrics=app.container.metrics_manager)
    register_generation_routes(app, engine)
    app.register_grpc_service(InferenceService(engine))
    thread = threading.Thread(target=app.run, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{ports.http_port}"
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            urllib.request.urlopen(base + "/.well-known/alive", timeout=1)
            break
        except OSError:
            time.sleep(0.05)

    def http_gen(i: int) -> dict:
        body = json.dumps({"prompt": f"load {i}", "max_tokens": 5, "temperature": 0.0}).encode()
        req = urllib.request.Request(base + "/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT_S) as resp:
            return {"status": resp.status, **json.loads(resp.read())["data"]}

    async def grpc_gen() -> list:
        client = InferenceClient(f"127.0.0.1:{ports.grpc_port}")
        try:
            return await asyncio.gather(*[client.generate(f"grpc {i}", max_tokens=5)
                                          for i in range(4)])
        finally:
            await client.close()

    try:
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            futures = [pool.submit(http_gen, i) for i in range(8)]
            grpc_results = asyncio.run(grpc_gen())
            http_results = [f.result(timeout=TIMEOUT_S) for f in futures]
        ttft = app.container.metrics_manager.get("app_ttft_seconds")
        _, ttft_count = ttft.snapshot()
        _, tpot_count = app.container.metrics_manager.get("app_tpot_seconds").snapshot()
        return {"http": [(r["status"], r["usage"]["completion_tokens"], r["usage"]["ttft_ms"])
                         for r in http_results],
                "grpc": [r["finish_reason"] for r in grpc_results],
                "ttft_count": ttft_count, "ttft_p50": ttft.percentile(0.5),
                "tpot_count": tpot_count}
    finally:
        app.stop()
        thread.join(timeout=15)
        engine.stop()


def _refusals(cfg: Any, local: dict, mesh: Any, pp_mesh: Any) -> dict:
    """Each feature outside the tensor-parallel engine refused by name at
    construction (no follower is involved: nothing reaches the group)."""
    base = dict(max_slots=2, max_seq_len=32, prefill_buckets=(16,))
    cases = {
        "pp": ({}, {}, pp_mesh),
    }
    out = {}
    for name, (conf, kw, on) in cases.items():
        try:
            ServingEngine(cfg, local, EngineConfig(**base, **conf), ByteTokenizer(), mesh=on,
                          device="cpu", **kw)
            out[name] = ""
        except NotImplementedError as exc:
            out[name] = str(exc)
    return out


def _fail(cfg: Any, local: dict, mesh: Any, conf: dict) -> dict:
    """Rank 1's decode block raises: its follower aborts, the leader's
    request fails within the group's timeout, every rank returns."""
    rank = dist.get_rank()
    if rank != 0:
        real = batch_ops.decode_block_paged
        if rank == 1:
            def boom(*args, **kw):
                raise RuntimeError("injected follower fault")

            batch_ops.decode_block_paged = boom
        try:
            serve_follower(cfg, local, mesh=mesh, device="cpu")
            return {"raised": ""}
        except TPGroupError as exc:
            return {"raised": str(exc)}
        finally:
            batch_ops.decode_block_paged = real
    engine = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                           device="cpu")
    engine.start()
    t0 = time.monotonic()
    try:
        fut = engine.submit("a follower fails", max_new_tokens=6, temperature=0.0)
        try:
            fut.result(timeout=TIMEOUT_S)
            error = ""
        except Exception as exc:  # noqa: BLE001 - the test reads what the caller gets
            error = f"{type(exc).__name__}: {exc}"
        seconds = time.monotonic() - t0
        try:
            engine.submit("after the loss", max_new_tokens=2)
            after = ""
        except Exception as exc:  # noqa: BLE001
            after = f"{type(exc).__name__}: {exc}"
        status = engine.health_check()["status"]
    finally:
        engine.stop()
    return {"error": error, "seconds": seconds, "after": after, "status": status}


def loader_world(dev: torch.device, inp: dict) -> dict:
    """``from_checkpoint`` or ``from_hf`` (``inp["loader"]``) with
    ``llama_sharding_rules()``'s placement on a tp mesh: rank 0 gets the
    engine and serves the prompts, every other rank serves as its follower
    and gets None."""
    torch.set_num_threads(1)
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = build_mesh(inp["mesh"])
    cfg = llama.LlamaConfig.tiny(**inp.get("cfg", {}))
    with FakeTensorMode():
        abstract = llama.init_params(cfg, device="cpu")
    sharding = llama_sharding_rules().tree_shardings(mesh, abstract)
    conf = EngineConfig(**inp["engine"])
    if inp["loader"] == "checkpoint":
        engine = ServingEngine.from_checkpoint(cfg, inp["path"], sharding=sharding,
                                               engine_config=conf, tokenizer=ByteTokenizer(),
                                               device="cpu")
    else:
        engine = ServingEngine.from_hf(inp["path"], dtype=torch.float32, sharding=sharding,
                                       engine_config=conf, device="cpu")
    if dist.get_rank() != 0:
        return {"engine": engine}
    engine.start()
    try:
        return {"tokens": _serve(engine, inp["prompts"]),
                "wq": tuple(engine.params["layers"]["wq"].shape)}
    finally:
        engine.stop()


# ------------------------------------------------------------------ LoRA
def _registry(cfg: Any, adapters: dict, max_active: int) -> AdapterRegistry:
    """A registry of ``adapters`` ({id: (seed, rank)}), drawn as the
    reference's ``make_adapter`` draws them."""
    reg = AdapterRegistry(max_active=max_active, device="cpu")
    for aid, (seed, rank) in adapters.items():
        reg.register(make_adapter(cfg, aid, rank=rank, seed=seed, scale=8.0))
    return reg


def _delta_rows(cfg: Any, local: dict, mesh: Any, inp: dict) -> dict:
    """The delta's row of ids in every rank's vocabulary shard: the row the
    forward's lookup taps equals the whole table's, bit for bit, on every
    rank, and so does the delta it gives (``_lora_delta_rows`` against
    ``_lora_delta`` over the whole table); this rank's own rows of the
    table do not hold most of those ids."""
    whole = torch.from_numpy(np.asarray(inp["params"]["embedding"]))
    vocab = cfg.vocab_size
    tokens = torch.tensor([0, vocab // 4 + 1, vocab // 2 + 3, vocab - 1])
    with llama.tap_embedding() as rows:
        llama._embed(cfg, local, tokens, mesh)
    reg = _registry(cfg, {"a": (1, 4)}, 2)
    try:
        reg.acquire("a")
        a_tab, b_tab = reg.tables()
    finally:
        reg.close()
    adapter = torch.tensor([1, 1, 0, 1], dtype=torch.int32)
    got = batch_ops._lora_delta_rows(rows[0], a_tab, b_tab, adapter)
    want = batch_ops._lora_delta(whole, a_tab, b_tab, tokens, adapter)
    one = embedding_row(cfg, local, vocab - 1, mesh, torch.device("cpu"))
    return {"rows_equal": torch.equal(rows[0], whole[tokens]),
            "delta_equal": torch.equal(got, want), "delta_nonzero": bool(got[3].any()),
            "embed_row_equal": torch.equal(one, whole[vocab - 1]),
            "local_rows": int(local["embedding"].shape[0])}


def _lora_case(cfg: Any, local: dict, mesh: Any, conf: dict, prompts: list, opt: dict,
               adapters: dict) -> dict:
    """One tp engine with an ``AdapterRegistry`` (``opt``: ``max_active``,
    ``batch`` to submit every prompt at once after, ``restart`` for a
    ``warm_restart`` and the prompts again): each prompt (text, tokens,
    adapter id or None) alone, greedy. A follower's result is its hash."""
    if dist.get_rank() != 0:
        return {"digest": _digest(serve_follower(cfg, local, mesh=mesh, device="cpu"))}
    reg = _registry(cfg, adapters, opt.get("max_active", 4))
    engine = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                           device="cpu", lora=reg)
    engine.start()

    def serve(batch: list) -> list:
        futures = [engine.submit(p, max_new_tokens=n, temperature=0.0, adapter_id=aid)
                   for p, n, aid in batch]
        return [f.result(timeout=TIMEOUT_S).token_ids for f in futures]

    try:
        out = {"tokens": [serve([item])[0] for item in prompts]}
        if opt.get("batch"):
            out["together"] = serve(prompts)
        if opt.get("restart"):
            out["restarted"] = engine.warm_restart(join_timeout=TIMEOUT_S)
            out["after"] = [serve([item])[0] for item in prompts]
    finally:
        engine.stop()
        reg.close()
    out.update(digest=engine.tp_digest(), pinned=reg.residency()["pinned_slots"],
               health=engine.health_check()["details"]["tensor_parallel"])
    return out


# ------------------------------------------------------------- migration
class _Count:
    """Prefill computes and ragged dispatches through ``serving.batch``
    while open, on this rank (the leader's engines and a follower alike)."""

    def __init__(self) -> None:
        self.n = {"prefill": 0, "ragged": 0}
        self._real = {"prefill": batch_ops.prefill_compute, "ragged": batch_ops.dispatch_ragged}

        def counted(name: str) -> Any:
            def call(*args, **kw):
                self.n[name] += 1
                return self._real[name](*args, **kw)
            return call

        batch_ops.prefill_compute = counted("prefill")
        batch_ops.dispatch_ragged = counted("ragged")

    def close(self) -> dict:
        batch_ops.prefill_compute = self._real["prefill"]
        batch_ops.dispatch_ragged = self._real["ragged"]
        return dict(self.n)


def _entries(engine: ServingEngine, keys: list) -> dict:
    """An engine's whole entries of ``keys`` as numpy (logits, k, v)."""
    return {key: tuple(t.float().numpy() for t in value)
            for key, value in engine.export_kv(keys).items()}


def _one_card(cfg: Any, whole: dict, conf: dict, **kw: Any) -> ServingEngine:
    return ServingEngine(cfg, whole, EngineConfig(**conf), ByteTokenizer(), device="cpu", **kw)


def _migration_case(cfg: Any, whole: dict | None, local: dict, mesh: Any, conf: dict,
                    kind: str, prompts: list) -> dict:
    """One migration arc between the tp engine and a one-card engine on
    rank 0 over the whole params (each prompt: text, tokens):

    - ``tp_to_one``: the tp engine (role prefill) takes each prompt with
      ``prefill_only``, the one-card engine (role decode) serves it with
      ``handoff_from``; its entries are the tp engine's, gathered whole;
    - ``one_to_tp``: the same the other way; each follower reports a hash
      of its slabs of each entry that came in (its heads of the source's);
    - ``chain``: the one-card engine serves, the tp engine serves the same
      prompts again, fetching the advertised chain (``fetch_chain``);
    - ``evacuate``: the tp engine serves, then ``begin_reclaim`` pushes its
      cache to the one-card survivor, which serves the prompts again;
    - ``evacuate_in``: the one-card engine serves and evacuates onto the tp
      engine, which serves them again;
    - ``torn``: as ``one_to_tp``, but the fetch loses a chain's middle key:
      the handoff fails whole and the tp engine computes.

    Every rank reports its prefill computes and ragged dispatches while the
    receiving side served."""
    count_on = kind in ("one_to_tp", "chain", "evacuate_in", "torn")  # the tp side receives
    if dist.get_rank() != 0:
        counter = _Count() if count_on else None
        try:
            res = serve_follower(cfg, local, mesh=mesh, device="cpu")
        finally:
            counts = counter.close() if counter is not None else None
        return {"digest": _digest(res), "imported": res.imported, "card": res.prefix_card,
                "counts": counts}
    index = prefix_index.PrefixIndex()
    serve_kw = dict(temperature=0.0)
    out: dict = {}
    if kind == "tp_to_one":
        src = ServingEngine(cfg, local, EngineConfig(**conf, role="prefill"), ByteTokenizer(),
                            mesh=mesh, device="cpu")
        mig = prefix_index.KVMigrator("B", index)
        dst = _one_card(cfg, whole, dict(conf, role="decode"), kv_migrator=mig)
        mig.add_peer("A", prefix_index.local_engine_fetcher(src))
        tp_engine = src
    elif kind in ("one_to_tp", "torn"):
        src = _one_card(cfg, whole, dict(conf, role="prefill"))
        mig = prefix_index.KVMigrator("B", index)
        dst = ServingEngine(cfg, local, EngineConfig(**conf, role="decode"), ByteTokenizer(),
                            mesh=mesh, device="cpu", kv_migrator=mig)
        fetch = prefix_index.local_engine_fetcher(src)
        if kind == "torn":
            def fetch_torn(keys: list) -> dict:  # the source lost a middle chunk mid-handoff
                got = fetch(keys)
                chunks = sorted((k for k in got if k.startswith("chunkpfx:")),
                                key=lambda k: int(k.split(":")[2]))
                if len(chunks) >= 3:
                    got.pop(chunks[1])
                return got
            mig.add_peer("A", fetch_torn)
        else:
            mig.add_peer("A", fetch)
        tp_engine = dst
    elif kind == "chain":
        src = _one_card(cfg, whole, conf)
        mig = prefix_index.KVMigrator("B", index)
        dst = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                            device="cpu", kv_migrator=mig)
        mig.add_peer("A", prefix_index.local_engine_fetcher(src))
        tp_engine = dst
    elif kind == "evacuate":
        mig = prefix_index.KVMigrator("A", index)
        src = ServingEngine(cfg, local, EngineConfig(**conf, preemptible=True), ByteTokenizer(),
                            mesh=mesh, device="cpu", kv_migrator=mig)
        dst = _one_card(cfg, whole, conf)
        mig.add_push_peer("S", prefix_index.local_engine_store(dst))
        tp_engine = src
    else:  # evacuate_in
        mig = prefix_index.KVMigrator("A", index)
        src = _one_card(cfg, whole, dict(conf, preemptible=True), kv_migrator=mig)
        dst = ServingEngine(cfg, local, EngineConfig(**conf), ByteTokenizer(), mesh=mesh,
                            device="cpu")
        mig.add_push_peer("S", prefix_index.local_engine_store(dst))
        tp_engine = dst
    src.start()
    dst.start()
    counter = None
    try:
        if kind in ("tp_to_one", "one_to_tp", "torn"):
            tokens, finish = [], []
            for p, n in prompts:
                r = src.submit(p, max_new_tokens=1, prefill_only=True, **serve_kw).result(
                    timeout=TIMEOUT_S)
                finish.append(r.finish_reason)
                counter = _Count()
                tokens.append(dst.submit(p, max_new_tokens=n, handoff_from="A", **serve_kw)
                              .result(timeout=TIMEOUT_S).token_ids)
                out.setdefault("counts", []).append(counter.close())
                counter = None
            out.update(tokens=tokens, finish=finish, handoffs=mig.handoffs_total)
            sent = src.export_kv(sorted(src._prefix_cache.keys()))
        elif kind == "chain":
            out["first"] = _serve(src, prompts)
            index.observe("A", 1, src.prefix_advertisement(256))
            counter = _Count()
            out["tokens"] = _serve(dst, prompts)
            out["counts"] = [counter.close()]
            counter = None
            out["migrations"] = mig.migrations_total
            sent = src.export_kv(sorted(src._prefix_cache.keys()))
        else:
            out["first"] = _serve(src, prompts)
            src_keys = sorted(src._prefix_cache.keys())
            sent = src.export_kv(src_keys)
            summary = src.begin_reclaim(60.0)
            out["evacuation"] = summary["evacuation"]
            out["src_keys"], out["dst_keys"] = src_keys, sorted(dst._prefix_cache.keys())
            counter = _Count()
            out["tokens"] = _serve(dst, prompts)
            out["counts"] = [counter.close()]
            counter = None
        # the entries the receiving side holds, whole, and the sender's
        out["keys"] = sorted(dst._prefix_cache.keys())
        out["received"] = _entries(dst, out["keys"])
        out["sent"] = {key: tuple(t.float().numpy() for t in value)
                       for key, value in sent.items()}
        if tp_engine is dst:
            # what each follower should hold of each entry that came in: its
            # heads of the sender's entry, by tp index
            places = kv_head_slices(cfg.n_heads, cfg.n_kv_heads, mesh.shape["tp"])
            out["expected"] = {
                key: [slab_digest(k[:, :, f:f + c], v[:, :, f:f + c]) for f, c in places]
                for key, (_, k, v) in sent.items()}
    finally:
        if counter is not None:
            counter.close()
        src.stop()
        dst.stop()
    out["digest"] = tp_engine.tp_digest()
    return out
