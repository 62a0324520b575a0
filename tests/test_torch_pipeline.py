"""The port's GPipe pipeline over the pp axis against the JAX package
(``tests/test_pipeline.py``): the schedule, ``pp_forward``, its gradients
through the ppermute ring, and the pipelined ``sharded_train_step`` with
tp and dp inside.

One gloo world of 8 ranks on the CPU runs every case once
(``torch_parallel_cases.pipeline_world``) at the reference's meshes
(pp=4,dp=2; pp=2,tp=2,dp=2); the JAX side runs here on the 8-device CPU
mesh. Tolerances: the reference's (5e-4 for the forward, 2e-4 for the
gradients), rtol=atol=2e-4 for the training step's losses and params.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_cases as cases
from conftest import requires_modern_shard_map
from gofr_tpu.models import llama
from gofr_tpu.models.train import sharded_train_step
from gofr_tpu.parallel import build_mesh
from gofr_tpu.parallel.mesh import MeshSpec
from gofr_tpu.parallel.pipeline import pipeline_apply, pp_forward
from gofr_tpu.parallel.sharding import llama_sharding_rules, shard_params
from gofr_tpu_torch.parallel import world

# the reference's pipeline programs need the modern SPMD partitioner
pytestmark = requires_modern_shard_map

TOL = 2e-4


@pytest.fixture(scope="module")
def pp_mesh():
    return build_mesh(MeshSpec(pp=4, dp=2))


@pytest.fixture(scope="module")
def mixed_mesh():
    return build_mesh(MeshSpec(pp=2, tp=2, dp=2))


@pytest.fixture(scope="module")
def world8():
    cfg = llama.LlamaConfig.tiny(n_layers=4, n_heads=4, n_kv_heads=2, attn_impl="dense")
    inp = {
        "params": jax.tree.map(np.asarray, llama.init_params(cfg, jax.random.PRNGKey(0))),
        "tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, cfg.vocab_size)),
        "grad_tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                                     cfg.vocab_size)),
        "train_tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0,
                                                      cfg.vocab_size)),
    }
    results = world.run_spmd(cases.pipeline_world, 8, args=(inp,), backend="gloo",
                             device="cpu", timeout_s=240)
    return cfg, inp, results


def _stage_slice(full, rank: int, jmesh, spec):
    device = jmesh.devices.flat[rank]
    from jax.sharding import NamedSharding

    return np.asarray(full)[NamedSharding(jmesh, spec).devices_indices_map(full.shape)[device]]


def test_pipeline_apply_identity_chain(world8, pp_mesh):
    """Each stage adds its stage param; result = x + sum(all stages)."""
    _, _, results = world8
    x_mb = jnp.ones((8, 2, 3))
    ref = pipeline_apply(lambda p, x: x + p[0], jnp.arange(4.0)[:, None], x_mb, pp_mesh)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(x_mb) + 6.0)
    for res in results:
        np.testing.assert_allclose(res["identity_chain"], np.asarray(ref))


def test_pp_forward_matches_dense(world8, pp_mesh):
    cfg, inp, results = world8
    tokens = jnp.asarray(inp["tokens"])
    ref = llama.forward(cfg, inp["params"], tokens)
    out = jax.jit(lambda p, t: pp_forward(cfg, p, t, pp_mesh))(inp["params"], tokens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-4)
    for res in results:
        np.testing.assert_allclose(res["pp_forward"], np.asarray(ref), atol=5e-4)


def test_pp_forward_rejects_bad_layer_split(world8, pp_mesh):
    _, inp, results = world8
    cfg = llama.LlamaConfig.tiny(n_layers=3)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as ref:
        pp_forward(cfg, params, jnp.ones((4, 8), jnp.int32), pp_mesh)
    for res in results:
        assert res["bad_split"] == str(ref.value)


def test_pp_train_step_decreases_loss(world8, mixed_mesh):
    """Three steps of pp+tp+dp training on one repeated batch reduce the
    loss, with the reference's losses and each rank's updated slices."""
    cfg, inp, results = world8
    rules = llama_sharding_rules(pp=True)
    params = shard_params(inp["params"], mixed_mesh, rules)
    tokens = jnp.asarray(inp["train_tokens"])
    init_opt, compile_for = sharded_train_step(cfg, mixed_mesh, rules)
    opt_state = init_opt(params)
    step = compile_for(params, opt_state, tokens)
    losses = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    final = jax.device_get(params)
    specs = rules.tree_specs(final)
    for rank, res in enumerate(results):
        got = res["pp_train"]
        np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=TOL)
        assert got["losses"][-1] < got["losses"][0]
        for path, want in jax.tree_util.tree_flatten_with_path(final)[0]:
            keys = [k.key for k in path]
            leaf, spec = got["params"], specs
            for k in keys:
                leaf, spec = leaf[k], spec[k]
            np.testing.assert_allclose(leaf, _stage_slice(want, rank, mixed_mesh, spec),
                                       rtol=TOL, atol=TOL, err_msg=f"rank {rank} {keys}")


def test_pp_grads_match_dense(world8, pp_mesh):
    """Gradients through the ppermute ring equal single-device grads: each
    rank's stage slices, reduced over dp."""
    cfg, inp, results = world8
    tokens = jnp.asarray(inp["grad_tokens"])

    def dense_loss(p):
        logits = llama.forward(cfg, p, tokens)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))

    def pp_loss(p):
        logits = pp_forward(cfg, p, tokens, pp_mesh)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))

    g_ref = jax.device_get(jax.grad(dense_loss)(inp["params"]))
    g_pp = jax.jit(jax.grad(pp_loss))(inp["params"])
    for a, b in zip(jax.tree.leaves(g_ref), jax.tree.leaves(g_pp)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=2e-4)
    specs = llama_sharding_rules(pp=True).tree_specs(g_ref)
    for rank, res in enumerate(results):
        for path, want in jax.tree_util.tree_flatten_with_path(g_ref)[0]:
            keys = [k.key for k in path]
            leaf, spec = res["pp_grads"], specs
            for k in keys:
                leaf, spec = leaf[k], spec[k]
            np.testing.assert_allclose(leaf, _stage_slice(want, rank, pp_mesh, spec),
                                       atol=2e-4, err_msg=f"rank {rank} {keys}")
