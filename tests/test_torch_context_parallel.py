"""The port's ring and Ulysses attention and the context-parallel Llama
forward against the JAX package (``tests/test_context_parallel.py``).

One gloo world of 8 ranks on the CPU runs every case once
(``torch_parallel_cases.context_parallel_world``) on sp=4,dp=2, the
reference's mesh; the JAX side runs here on the 8-device CPU mesh. The
reference's tolerances: 2e-5 for attention, 5e-4 for the model.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_cases as cases
from gofr_tpu.models import llama as jllama
from gofr_tpu.ops.attention import attention as jattention
from gofr_tpu.parallel import build_mesh, cp_context, ring_attention, ulysses_attention
from gofr_tpu.parallel.mesh import MeshSpec
from gofr_tpu_torch.parallel import world

QKV = {  # name: (key, heads, kv heads) as the reference's tests draw them
    "mha": (0, 4, 2),
    "mqa": (1, 8, 1),
    "ulysses": (2, 4, 2),
    "partial_repeat": (5, 8, 2),
}


def _qkv(key, B=2, S=32, H=4, Hkv=2, D=16):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(key), 3)
    q = jax.random.normal(kq, (B, S, H, D), jnp.float32)
    k = jax.random.normal(kk, (B, S, Hkv, D), jnp.float32)
    v = jax.random.normal(kv, (B, S, Hkv, D), jnp.float32)
    return q, k, v


@pytest.fixture(scope="module")
def sp_mesh():
    return build_mesh(MeshSpec(sp=4, dp=2))


@pytest.fixture(scope="module")
def world8():
    qkv = {name: tuple(np.asarray(t) for t in _qkv(key, H=H, Hkv=Hkv))
           for name, (key, H, Hkv) in QKV.items()}
    cfg = jllama.LlamaConfig.tiny(attn_impl="dense", n_heads=4, n_kv_heads=4)
    inp = {
        "qkv": qkv,
        "qkv_s30": tuple(np.asarray(t) for t in _qkv(3, S=30)),
        "cotangent": np.random.default_rng(0).standard_normal((2, 32, 4, 16)).astype(np.float32),
        "cp_params": jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(0))),
        "cp_tokens": np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0,
                                                   cfg.vocab_size)),
    }
    results = world.run_spmd(cases.context_parallel_world, 8, args=(inp,), backend="gloo",
                             device="cpu", timeout_s=240)
    return inp, results


def _hold(results, key, name, ref, atol):
    for rank, res in enumerate(results):
        np.testing.assert_allclose(res[key][name], np.asarray(ref), atol=atol,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("impl,name", [("ring", "mha"), ("ring", "mqa"), ("ulysses", "ulysses"),
                                       ("ulysses", "partial_repeat")])
def test_cp_attention_matches_dense(world8, sp_mesh, impl, name):
    """ring (Hkv=2; Hkv=1, MQA: the head-group broadcast) and Ulysses
    (Hkv=2; H=8 over n=4, KV repeated only to lcm=4) against dense causal
    attention and against the reference's own ring/Ulysses."""
    inp, results = world8
    q, k, v = (jnp.asarray(t) for t in inp["qkv"][name])
    ref = jattention(q, k, v, causal=True)
    fn = ring_attention if impl == "ring" else ulysses_attention
    np.testing.assert_allclose(np.asarray(fn(q, k, v, sp_mesh, axis="sp")), np.asarray(ref),
                               atol=2e-5)
    _hold(results, impl, name, ref, 2e-5)


def test_ring_rejects_indivisible_seq(world8, sp_mesh):
    inp, results = world8
    q, k, v = (jnp.asarray(t) for t in inp["qkv_s30"])
    with pytest.raises(ValueError) as ref:
        ring_attention(q, k, v, sp_mesh)
    for res in results:
        assert res["indivisible"] == str(ref.value)


def test_ring_inside_jit(world8, sp_mesh):
    """The ring composes under the reference's jit and grad; the port's
    backward through the ppermute ring (the inverse permutation) gives the
    same gradients."""
    inp, results = world8
    q, k, v = (jnp.asarray(t) for t in inp["qkv"]["mha"])
    w = jnp.asarray(inp["cotangent"])

    @jax.jit
    def f(q, k, v):
        return ring_attention(q, k, v, sp_mesh)

    np.testing.assert_allclose(np.asarray(f(q, k, v)),
                               np.asarray(jattention(q, k, v, causal=True)), atol=2e-5)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w), argnums=(0, 1, 2)))(q, k, v)
    dense = jax.grad(lambda q, k, v: jnp.sum(jattention(q, k, v, causal=True) * w),
                     argnums=(0, 1, 2))(q, k, v)
    for got, want in zip(grads, dense):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)
    for rank, res in enumerate(results):
        for got, want in zip(res["ring_grads"], grads):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, err_msg=f"rank {rank}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_llama_cp_forward_matches_dense(world8, sp_mesh, impl):
    """Full model: attn_impl='cp' forward under cp_context equals the
    single-device dense forward, each rank keeping its sequence shard
    through the layers."""
    inp, results = world8
    cfg_dense = jllama.LlamaConfig.tiny(attn_impl="dense", n_heads=4, n_kv_heads=4)
    cfg_cp = jllama.LlamaConfig.tiny(attn_impl="cp", n_heads=4, n_kv_heads=4)
    tokens = jnp.asarray(inp["cp_tokens"])
    ref = jllama.forward(cfg_dense, inp["cp_params"], tokens)
    with cp_context(sp_mesh, axis="sp", impl=impl):
        out = jllama.forward(cfg_cp, inp["cp_params"], tokens)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=5e-4)
    _hold(results, "cp_forward", impl, ref, 5e-4)
