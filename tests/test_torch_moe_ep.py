"""The port's expert-parallel MoE against the JAX package
(``tests/test_moe.py``'s EP tests): ``moe_ffn_ep`` with full capacity
and with drops, its divisibility errors, ``moe.forward(mesh=)`` with its
aux statistics, gradients through the all_to_all dispatch, and one
``make_moe_train_step`` step.

One gloo world of 8 ranks on the CPU runs every case once
(``torch_parallel_cases.moe_ep_world``) on ep=4,dp=2, the reference's
mesh; the JAX side runs here on the 8-device CPU mesh. Tolerances: the
reference's (1e-5 for the FFN, 5e-4 for the model), 2e-4 for gradients
and the step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_cases as cases
from conftest import requires_modern_shard_map
from gofr_tpu.models import moe
from gofr_tpu.models.train import make_moe_train_step
from gofr_tpu.ops import moe as moe_ops
from gofr_tpu.parallel import build_mesh
from gofr_tpu.parallel.mesh import MeshSpec
from gofr_tpu_torch.parallel import world

# the reference's expert-parallel programs need the modern shard_map
pytestmark = requires_modern_shard_map

TOL = 2e-4


def _weights(key, D=16, F=32, E=4):
    ks = jax.random.split(key, 4)
    wr = jax.random.normal(ks[0], (D, E)) * 0.5
    wg = jax.random.normal(ks[1], (E, D, F)) / np.sqrt(D)
    wu = jax.random.normal(ks[2], (E, D, F)) / np.sqrt(D)
    wd = jax.random.normal(ks[3], (E, F, D)) / np.sqrt(F)
    return wr, wg, wu, wd


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def ep_mesh():
    return build_mesh(MeshSpec(ep=4, dp=2))


@pytest.fixture(scope="module")
def world8():
    cfg = moe.MoeConfig.tiny(capacity_factor=8.0)
    inp = {
        "weights": _np(_weights(jax.random.PRNGKey(0))),
        "x": np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16))),
        "weights_drop": _np(_weights(jax.random.PRNGKey(2))),
        "x_drop": np.asarray(jax.random.normal(jax.random.PRNGKey(3), (32, 16))),
        "weights_e6": _np(_weights(jax.random.PRNGKey(4), E=6)),
        "params": _np(moe.init_params(cfg, jax.random.PRNGKey(0))),
        "tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, cfg.vocab_size)),
    }
    results = world.run_spmd(cases.moe_ep_world, 8, args=(inp,), backend="gloo", device="cpu",
                             timeout_s=240)
    return inp, results


def test_ep_matches_reference_with_full_capacity(world8, ep_mesh):
    """Capacity ≥ tokens-per-group ⇒ no drops ⇒ exact match with dense;
    all E experts in or this rank's E/n give the same."""
    inp, results = world8
    wr, wg, wu, wd = (jnp.asarray(w) for w in inp["weights"])
    x = jnp.asarray(inp["x"])
    ref = moe_ops.moe_ffn_reference(x, wr, wg, wu, wd, top_k=2)
    out = moe_ops.moe_ffn_ep(x, wr, wg, wu, wd, ep_mesh, top_k=2, capacity=8)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)
    for res in results:
        np.testing.assert_allclose(res["full_capacity"], np.asarray(ref), atol=1e-5)
        np.testing.assert_allclose(res["local_experts"], np.asarray(ref), atol=1e-5)


def test_ep_capacity_drops_are_graceful(world8, ep_mesh):
    """Capacity 1 drops tokens: the output stays finite and is the
    reference's EP output with the same drops, stats and all."""
    inp, results = world8
    wr, wg, wu, wd = (jnp.asarray(w) for w in inp["weights_drop"])
    x = jnp.asarray(inp["x_drop"])
    out, f, p = moe_ops.moe_ffn_ep(x, wr, wg, wu, wd, ep_mesh, top_k=2, capacity=1,
                                   return_stats=True)
    assert np.all(np.isfinite(np.asarray(out)))
    for res in results:
        y, tf, tp = res["capacity_1"]
        assert np.all(np.isfinite(y))
        np.testing.assert_allclose(y, np.asarray(out), atol=1e-5)
        np.testing.assert_allclose(tf, np.asarray(f), atol=1e-6)
        np.testing.assert_allclose(tp, np.asarray(p), atol=1e-6)


def test_ep_rejects_bad_divisibility(world8, ep_mesh):
    inp, results = world8
    wr, wg, wu, wd = (jnp.asarray(w) for w in inp["weights_e6"])
    with pytest.raises(ValueError) as ref:
        moe_ops.moe_ffn_ep(jnp.asarray(inp["x"]), wr, wg, wu, wd, ep_mesh)  # 6 experts vs ep=4
    for res in results:
        assert res["bad_divisibility"] == str(ref.value)


def test_moe_forward_ep_matches_dense(world8, ep_mesh):
    """``forward(mesh=)`` from the full tree and from ``moe_sharding_rules``'
    slices against the dense forward; the aux stats against the
    reference's EP forward."""
    inp, results = world8
    cfg = moe.MoeConfig.tiny(capacity_factor=8.0)  # high capacity: no drops
    tokens = jnp.asarray(inp["tokens"])
    ref = moe.forward(cfg, inp["params"], tokens, mesh=None)
    out, (f, p) = moe.forward(cfg, inp["params"], tokens, mesh=ep_mesh, return_aux=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-4)
    for res in results:
        logits, tf, tp = res["forward"]
        np.testing.assert_allclose(logits, np.asarray(ref), atol=5e-4)
        np.testing.assert_allclose(res["forward_sharded"], np.asarray(ref), atol=5e-4)
        np.testing.assert_allclose(tf, np.asarray(f), atol=1e-6)
        np.testing.assert_allclose(tp, np.asarray(p), atol=1e-5)


def test_moe_grads_flow_through_ep(world8, ep_mesh):
    """Gradients through the all_to_all dispatch: finite, non-zero for the
    experts, and the reference's own gradients through its EP program."""
    inp, results = world8
    cfg = moe.MoeConfig.tiny(capacity_factor=4.0)
    tokens = jnp.asarray(inp["tokens"])

    def loss(p):
        logits, _ = moe._forward_jit(cfg, p, tokens, ep_mesh)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))

    val, grads = jax.value_and_grad(loss)(inp["params"])
    assert np.isfinite(float(val))
    g = grads["layers"]["w_gate"]
    assert np.all(np.isfinite(np.asarray(g))) and float(jnp.abs(g).sum()) > 0
    for res in results:
        for key in ("w_gate", "w_router", "wq"):
            got = res["grads"][key]
            assert np.all(np.isfinite(got))
            np.testing.assert_allclose(got, np.asarray(grads["layers"][key]), atol=TOL)
        assert np.abs(res["grads"]["w_gate"]).sum() > 0


def test_moe_train_step_matches_reference(world8, ep_mesh):
    """One ``make_moe_train_step`` step (CE plus the aux loss, experts over
    ep): the loss and the updated params against the reference's."""
    inp, results = world8
    cfg = moe.MoeConfig.tiny(capacity_factor=4.0)
    init, step = make_moe_train_step(cfg, ep_mesh)
    params, _, loss = jax.jit(step)(inp["params"], init(inp["params"]), jnp.asarray(inp["tokens"]))
    for res in results:
        np.testing.assert_allclose(res["train"]["loss"], float(loss), rtol=TOL, atol=TOL)
        jax.tree.map(lambda got, want: np.testing.assert_allclose(got, np.asarray(want),
                                                                  rtol=TOL, atol=TOL),
                     res["train"]["params"], _np(params))
