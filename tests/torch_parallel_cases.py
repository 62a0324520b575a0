"""Rank functions of the port's parallel tests (``test_torch_parallel.py``,
``test_torch_context_parallel.py``, ``test_torch_pipeline.py``,
``test_torch_moe_ep.py``).

Each function runs on every rank of one gloo world of 8 ranks on the CPU
(``gofr_tpu_torch.parallel.world.run_spmd``), takes the test's inputs as
numpy arrays (made from seeds by the JAX package in the test process) and
returns this rank's results as numpy, which the test holds to the JAX
package on its 8-device CPU mesh. Rank r of the world sits where device r
sits on the reference's mesh of the same spec. The functions live apart
from the test files so that a spawned rank imports torch and the port
only, never JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.models import llama
from gofr_tpu_torch.models.convert import params_from_jax
from gofr_tpu_torch.parallel import build_mesh, llama_sharding_rules, named_sharding, shard_params
from gofr_tpu_torch.parallel.mesh import require_axis
from gofr_tpu_torch.parallel.sharding import map_with_path


def to_numpy(tree: Any) -> Any:
    return map_with_path(lambda _p, t: t.detach().numpy() if isinstance(t, torch.Tensor) else t,
                         tree)


def error_of(fn) -> str:
    """The message of the ValueError ``fn`` raises ('' when it returns)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _tokens(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


def _train(cfg, mesh, rules, params_np, tokens, steps: int) -> dict:
    from gofr_tpu_torch.models import train

    params = params_from_jax(shard_params(params_np, mesh, rules), device="cpu")
    init, compile_for = train.sharded_train_step(cfg, mesh, rules)
    opt = init(params)
    step = compile_for(params, opt, tokens)
    losses = []
    for _ in range(steps):
        params, opt, loss = step(params, opt, tokens)
        losses.append(float(loss))
    return {"losses": losses, "params": to_numpy(params)}


def parallel_world(dev: torch.device, inp: dict) -> dict:
    """Meshes, rules, the tensor-parallel forward, the sharded restores and
    sharded_train_step (``test_torch_parallel.py``)."""
    torch.manual_seed(0)
    out: dict = {}
    specs = ("dp=2,tp=4", "tp=4,dp=2", "fsdp=2,tp=2,dp=2", "tp=2,dp=4")
    meshes = {spec: build_mesh(spec) for spec in specs}
    out["mesh"] = {spec: (dict(m.shape), m.devices.shape, m.coordinate)
                   for spec, m in meshes.items()}
    mesh = meshes["dp=2,tp=4"]
    out["require_axis"] = (require_axis(mesh, "tp"), error_of(lambda: require_axis(mesh, "model")))

    cfg = llama.LlamaConfig.tiny()
    full = params_from_jax(inp["params"], device="cpu")
    out["shards"] = to_numpy(shard_params(full, meshes["tp=4,dp=2"], llama_sharding_rules()))

    out["forward"] = {}
    for case, spec, key, tied in inp["forward_cases"]:
        m = meshes[spec]
        tcfg = llama.LlamaConfig.tiny(tie_embeddings=tied)
        tree = inp["params_tied"] if tied else inp["params"]
        local = params_from_jax(shard_params(tree, m, llama_sharding_rules()), device="cpu")
        out["forward"][case] = llama.forward(tcfg, local, _tokens(inp[key]), mesh=m).numpy()

    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.models.hf_import import load_llama_from_hf

    m = meshes["tp=2,dp=4"]
    rules = llama_sharding_rules()
    mgr = CheckpointManager(inp["ckpt"])
    out["restore"] = {
        "rules": to_numpy(mgr.restore(full, sharding=rules.tree_shardings(m, full), device="cpu")),
        "replicated": to_numpy(mgr.restore(full, sharding=named_sharding(m), device="cpu")),
    }
    out["hf"] = {
        "rules": to_numpy(load_llama_from_hf(inp["hf"], dtype=torch.float32, device="cpu",
                                             sharding=rules.tree_shardings(m, full))[1]),
        "replicated": to_numpy(load_llama_from_hf(inp["hf"], dtype=torch.float32, device="cpu",
                                                  sharding=named_sharding(m))[1]),
    }

    out["train"] = {}
    for spec in ("tp=2,dp=4", "fsdp=2,tp=2,dp=2"):
        out["train"][spec] = _train(cfg, meshes[spec], llama_sharding_rules(), inp["params"],
                                    _tokens(inp["train_tokens"]), 3)
    return out


def context_parallel_world(dev: torch.device, inp: dict) -> dict:
    """Ring and Ulysses attention and the cp forward on sp=4,dp=2
    (``test_torch_context_parallel.py``)."""
    from gofr_tpu_torch.parallel import cp_context, ring_attention, ulysses_attention

    mesh = build_mesh("sp=4,dp=2")
    out: dict = {"ring": {}, "ulysses": {}}
    for name, (q, k, v) in inp["qkv"].items():
        q, k, v = (torch.as_tensor(a) for a in (q, k, v))
        out["ring"][name] = ring_attention(q, k, v, mesh, axis="sp").numpy()
        out["ulysses"][name] = ulysses_attention(q, k, v, mesh, axis="sp").numpy()
    q, k, v = (torch.as_tensor(a) for a in inp["qkv_s30"])
    out["indivisible"] = error_of(lambda: ring_attention(q, k, v, mesh))

    q, k, v = (torch.as_tensor(a).requires_grad_(True) for a in inp["qkv"]["mha"])
    y = ring_attention(q, k, v, mesh)
    (y * torch.as_tensor(inp["cotangent"])).sum().backward()
    out["ring_grads"] = [t.grad.numpy() for t in (q, k, v)]

    out["cp_forward"] = {}
    cfg = llama.LlamaConfig.tiny(attn_impl="cp", n_heads=4, n_kv_heads=4)
    params = params_from_jax(inp["cp_params"], device="cpu")
    for impl in ("ring", "ulysses"):
        with cp_context(mesh, axis="sp", impl=impl):
            out["cp_forward"][impl] = llama.forward(cfg, params, _tokens(inp["cp_tokens"])).numpy()
    return out


def pipeline_world(dev: torch.device, inp: dict) -> dict:
    """The GPipe schedule, pp_forward, its gradients and the pipelined
    training step (``test_torch_pipeline.py``)."""
    from gofr_tpu_torch.models import train
    from gofr_tpu_torch.parallel.pipeline import pipeline_apply, pp_forward

    pp_mesh = build_mesh("pp=4,dp=2")
    out: dict = {}
    stage = pp_mesh.index("pp")
    stage_params = torch.arange(4.0)[:, None][stage:stage + 1]
    out["identity_chain"] = pipeline_apply(lambda p, x: x + p[0], stage_params,
                                           torch.ones(8, 2, 3), pp_mesh).numpy()

    cfg = llama.LlamaConfig.tiny(n_layers=4)
    rules = llama_sharding_rules(pp=True)
    params = params_from_jax(shard_params(inp["params"], pp_mesh, rules), device="cpu")
    out["pp_forward"] = pp_forward(cfg, params, _tokens(inp["tokens"]), pp_mesh).numpy()

    bad = llama.LlamaConfig.tiny(n_layers=3)
    out["bad_split"] = error_of(lambda: pp_forward(bad, params, _tokens(inp["tokens"][:4]), pp_mesh))

    for leaf in map_with_path(lambda _p, t: t, params["layers"]).values():
        leaf.requires_grad_(True)
    for name in ("embedding", "final_norm", "lm_head"):
        params[name].requires_grad_(True)
    tokens = _tokens(inp["grad_tokens"])
    logits = pp_forward(cfg, params, tokens, pp_mesh)
    train.next_token_nll(logits, tokens).backward()
    train._grad_sync(pp_mesh, rules)(params)
    out["pp_grads"] = map_with_path(lambda _p, t: t.grad.numpy(), params)

    mixed = build_mesh("pp=2,tp=2,dp=2")
    out["pp_train"] = _train(cfg, mixed, rules, inp["params"], _tokens(inp["train_tokens"]), 3)
    return out


def moe_ep_world(dev: torch.device, inp: dict) -> dict:
    """The expert-parallel FFN, the MoE forward on a mesh, its gradients and
    the MoE training step on ep=4,dp=2 (``test_torch_moe_ep.py``)."""
    from gofr_tpu_torch.models import moe, train
    from gofr_tpu_torch.ops import moe as moe_ops

    mesh = build_mesh("ep=4,dp=2")
    out: dict = {}
    wr, wg, wu, wd = (torch.as_tensor(a) for a in inp["weights"])
    x = torch.as_tensor(inp["x"])
    out["full_capacity"] = moe_ops.moe_ffn_ep(x, wr, wg, wu, wd, mesh, top_k=2, capacity=8).numpy()
    e = mesh.index("ep")
    local = [w[e:e + 1] for w in (wg, wu, wd)]
    out["local_experts"] = moe_ops.moe_ffn_ep(x, wr, *local, mesh, top_k=2, capacity=8).numpy()
    y, f, p = moe_ops.moe_ffn_ep(torch.as_tensor(inp["x_drop"]), *(torch.as_tensor(a) for a in
                                 inp["weights_drop"]), mesh, top_k=2, capacity=1,
                                 return_stats=True)
    out["capacity_1"] = (y.numpy(), f.numpy(), p.numpy())
    w6 = [torch.as_tensor(a) for a in inp["weights_e6"]]
    out["bad_divisibility"] = error_of(lambda: moe_ops.moe_ffn_ep(x, *w6, mesh))

    cfg = moe.MoeConfig.tiny(capacity_factor=8.0)
    params = params_from_jax(inp["params"], device="cpu")
    tokens = _tokens(inp["tokens"])
    logits, (f, p) = moe.forward(cfg, params, tokens, mesh=mesh, return_aux=True)
    out["forward"] = (logits.numpy(), f.numpy(), p.numpy())
    sharded = shard_params(params, mesh, moe.moe_sharding_rules())
    out["forward_sharded"] = moe.forward(cfg, sharded, tokens, mesh=mesh).numpy()

    gcfg = moe.MoeConfig.tiny(capacity_factor=4.0)
    for leaf in map_with_path(lambda _p, t: t, params["layers"]).values():
        leaf.requires_grad_(True)
    logits, _ = moe._forward(gcfg, params, tokens, mesh)
    train.next_token_nll(logits, tokens).backward()
    out["grads"] = {k: params["layers"][k].grad.numpy() for k in ("w_gate", "w_router", "wq")}

    init, step = train.make_moe_train_step(gcfg, mesh)
    fresh = params_from_jax(inp["params"], device="cpu")
    fresh, _, loss = step(fresh, init(fresh), tokens)
    out["train"] = {"loss": float(loss), "params": to_numpy(fresh)}
    return out


def raising_rank(dev: torch.device) -> None:
    """Rank 1 raises; rank 0 waits for it in a barrier that never ends."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hanging_rank(dev: torch.device) -> None:
    import time

    time.sleep(3600)


def rank_and_size(dev: torch.device) -> tuple[int, int]:
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()
