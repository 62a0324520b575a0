"""The port's MoE without a mesh (``gofr_tpu_torch/ops/moe.py``,
``models/moe.py``) beside the JAX package's on the same numpy inputs at
``MoeConfig.tiny()``: ``router_topk`` (the same experts; gates and probs
within 1e-6), ``switch_aux_stats`` (exact), ``_dispatch_combine`` with and
without capacity drops (exact one-hots, combine within 1e-6),
``expert_ffn`` and ``moe_ffn_reference`` within 1e-5, ``capacity_for``,
``forward``'s logits (1e-5) and per-layer stats (1e-6; bf16 logits within
2e-2 relative L2), both load-balance losses (1e-6 relative), the MoE tree
through ``params_from_jax``, a mesh refused, and gradients that reach
the router and exactly the experts that received a token."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import moe as jmoe  # noqa: E402
from gofr_tpu.ops import moe as jops  # noqa: E402
from gofr_tpu_torch.models import moe as tmoe  # noqa: E402
from gofr_tpu_torch.models import train  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops import moe as tops  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("T,D,E,k", [(16, 32, 4, 2), (7, 8, 8, 1), (33, 16, 8, 2)])
def test_router_topk_and_aux_stats_match(T, D, E, k):
    rng = _rng(T + D + E)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    ji, jp, jprobs = jops.router_topk(jnp.asarray(x), jnp.asarray(w), k)
    ti, tp, tprobs = tops.router_topk(_t(x), _t(w), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    jf, jpp = jops.switch_aux_stats(ji, jprobs)
    tf, tpp = tops.switch_aux_stats(ti, tprobs)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tpp.numpy(), np.asarray(jpp), rtol=1e-6, atol=1e-7)


def test_router_promotes_bf16_activations_against_the_f32_router():
    rng = _rng(4)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    ji, jp, jprobs = jops.router_topk(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 2)
    ti, tp, tprobs = tops.router_topk(_t(x).to(torch.bfloat16), _t(w), 2)
    assert tprobs.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,E,k,cap", [(16, 4, 2, 8), (16, 4, 2, 3), (9, 8, 1, 1), (12, 3, 2, 20)],
                         ids=["roomy", "drops", "cap-1", "past-all"])
def test_dispatch_combine_match(T, E, k, cap):
    rng = _rng(T * E + cap)
    probs = rng.random((T, E)).astype(np.float32)
    top_i = np.argsort(-probs, axis=-1)[:, :k].astype(np.int32)
    top_p = np.take_along_axis(probs, top_i, -1)
    top_p = (top_p / top_p.sum(-1, keepdims=True)).astype(np.float32)
    jd, jc = jops._dispatch_combine(jnp.asarray(top_i), jnp.asarray(top_p), E, cap)
    td, tc = tops._dispatch_combine(_t(top_i).long(), _t(top_p), E, cap)
    assert td.shape == (T, E, cap) == tc.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("args", [(16, 4, 2, 1.25), (1, 8, 2, 1.0), (1000, 8, 2, 1.25),
                                  (5, 64, 1, 0.5)])
def test_capacity_for_matches(args):
    assert tops.capacity_for(*args) == jops.capacity_for(*args)


def _expert_weights(rng, E, D, Fd):
    return [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
            for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]


def test_expert_ffn_matches():
    rng = _rng(5)
    h = rng.standard_normal((4, 6, 16)).astype(np.float32)
    ws = _expert_weights(rng, 4, 16, 24)
    want = jops.expert_ffn(jnp.asarray(h), *map(jnp.asarray, ws))
    got = tops.expert_ffn(_t(h), *map(_t, ws))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_moe_ffn_reference_matches(k):
    rng = _rng(6 + k)
    T, D, E, Fd = 10, 16, 4, 24
    x = rng.standard_normal((T, D)).astype(np.float32)
    wr = (rng.standard_normal((D, E)) / 4).astype(np.float32)
    ws = _expert_weights(rng, E, D, Fd)
    jy, jf, jp = jops.moe_ffn_reference(jnp.asarray(x), jnp.asarray(wr), *map(jnp.asarray, ws),
                                        top_k=k, return_stats=True)
    ty, tf, tp = tops.moe_ffn_reference(_t(x), _t(wr), *map(_t, ws), top_k=k,
                                        return_stats=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    plain = tops.moe_ffn_reference(_t(x), _t(wr), *map(_t, ws), top_k=k)
    assert torch.equal(plain, ty)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jmoe.MoeConfig.tiny()
    jparams = jmoe.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = _rng(8).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, jparams, tmoe.MoeConfig.tiny(), params_from_jax(jax.device_get(jparams),
                                                                 device="cpu"), tokens


def test_params_from_jax_and_init_params_hold_the_moe_tree(tiny):
    jcfg, jparams, tcfg, tparams, _ = tiny
    mine = tmoe.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))[0]
    for path, arr in flat:
        keys = [p.key for p in path]
        node_t, node_m = tparams, mine
        for key in keys:
            node_t, node_m = node_t[key], node_m[key]
        assert tuple(node_t.shape) == tuple(node_m.shape) == arr.shape
        assert str(node_t.dtype) == str(node_m.dtype) == f"torch.{arr.dtype}"
        np.testing.assert_array_equal(node_t.numpy(), np.asarray(arr))
    assert mine["layers"]["w_router"].dtype == torch.float32


def test_forward_and_aux_stats_match(tiny):
    jcfg, jparams, tcfg, tparams, tokens = tiny
    jl, (jf, jp) = jmoe.forward(jcfg, jparams, jnp.asarray(tokens), return_aux=True)
    tl, (tf, tp) = tmoe.forward(tcfg, tparams, _t(tokens), return_aux=True)
    assert tl.dtype == torch.float32 and tf.shape == (jcfg.n_layers, jcfg.n_experts)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    # token fractions: the jitted mean may differ from count/T by an ulp
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    assert torch.equal(tmoe.forward(tcfg, tparams, _t(tokens)), tl)
    want = float(jmoe.load_balance_loss_from_stats(jcfg, jf, jp))
    np.testing.assert_allclose(float(tmoe.load_balance_loss_from_stats(tcfg, tf, tp)), want,
                               rtol=1e-6)
    np.testing.assert_allclose(float(tmoe.load_balance_loss(tcfg, tparams, _t(tokens))),
                               float(jmoe.load_balance_loss(jcfg, jparams, jnp.asarray(tokens))),
                               rtol=1e-6)


def test_bf16_forward_matches(tiny):
    jcfg = jmoe.MoeConfig.tiny(dtype=jnp.bfloat16)
    jparams = jmoe.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tmoe.MoeConfig.tiny(dtype=torch.bfloat16)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    tokens = tiny[4]
    want = np.asarray(jmoe.forward(jcfg, jparams, jnp.asarray(tokens)))
    got = tmoe.forward(tcfg, tparams, _t(tokens)).numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 2e-2


def test_a_mesh_is_refused(tiny):
    """A mesh whose axes other than ep and dp split (the attention would
    need tensor parallelism) is refused; on a one-rank mesh the expert-
    parallel path gives the mesh=None result (many ranks:
    ``test_torch_moe_ep.py``)."""
    import types

    from gofr_tpu_torch.parallel import build_mesh

    _, _, tcfg, tparams, tokens = tiny
    tp2 = types.SimpleNamespace(shape={"dp": 1, "fsdp": 1, "pp": 1, "sp": 1, "ep": 2, "tp": 2})
    with pytest.raises(ValueError, match="tensor-parallel attention"):
        tmoe.forward(tcfg, tparams, _t(tokens), mesh=tp2)
    with pytest.raises(ValueError, match="tensor-parallel attention"):
        tmoe.load_balance_loss(tcfg, tparams, _t(tokens), mesh=tp2)
    mesh = build_mesh()
    cfg = tmoe.MoeConfig.tiny(capacity_factor=8.0)  # no drops: the dense FFN's result
    want, (wf, wp) = tmoe.forward(cfg, tparams, _t(tokens), return_aux=True)
    got, (gf, gp) = tmoe.forward(cfg, tparams, _t(tokens), mesh=mesh, return_aux=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gf, wf)
    torch.testing.assert_close(gp, wp)
    assert float(tmoe.load_balance_loss(cfg, tparams, _t(tokens), mesh=mesh)) == \
        pytest.approx(float(tmoe.load_balance_loss(cfg, tparams, _t(tokens))))


def test_gradients_reach_the_router_and_exactly_the_routed_experts(tiny):
    """CE plus the coefficient times the aux loss, backward: every weight
    gets a finite gradient; each layer's experts that some token's top-k
    chose get a non-zero one, the others exactly zero (their gate weight
    is 0)."""
    _, _, tcfg, tparams, tokens = tiny
    params = {k: ({kk: vv.clone().requires_grad_(True) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.clone().requires_grad_(True))
              for k, v in tparams.items()}
    tok = _t(tokens)
    logits, (f, p) = tmoe.forward(tcfg, params, tok, return_aux=True)
    loss = train.next_token_nll(logits, tok) + tcfg.aux_loss_coef * \
        tmoe.load_balance_loss_from_stats(tcfg, f, p)
    loss.backward()
    layers = params["layers"]
    for name, w in layers.items():
        assert w.grad is not None and torch.isfinite(w.grad).all(), name
    assert layers["w_router"].grad.abs().sum() > 0
    # which experts each layer routed to: replay the routing layer by layer
    x = params["embedding"][tok].detach()
    from gofr_tpu_torch.ops.rope import rope_table

    B, S = tok.shape
    positions = torch.arange(S)[None, :].expand(B, S)
    sin, cos = rope_table(tcfg.max_seq_len, tcfg.head_dim, tcfg.rope_theta, "cpu")
    with torch.no_grad():
        for layer in range(tcfg.n_layers):
            lp = {k: v[layer].detach() for k, v in layers.items()}
            xin = tmoe.rms_norm(_attn_out(tcfg, x, lp, sin, cos, positions), lp["mlp_norm"],
                                tcfg.norm_eps)
            top_i, _, _ = tops.router_topk(xin.reshape(B * S, -1), lp["w_router"], tcfg.top_k)
            routed = set(top_i.flatten().tolist())
            for e in range(tcfg.n_experts):
                for name in ("w_gate", "w_up", "w_down"):
                    got = float(layers[name].grad[layer, e].abs().sum())
                    assert (got > 0) == (e in routed), (name, layer, e, routed)
            x = tmoe._layer(tcfg, x, lp, sin, cos, positions)[0]


def _attn_out(cfg, h, lp, sin, cos, positions):
    """The residual stream after a layer's attention (its MoE block's input
    before the norm)."""
    from gofr_tpu_torch.ops.attention import attention
    from gofr_tpu_torch.ops.rope import apply_rope

    B, S, _ = h.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = tmoe.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = apply_rope((x @ lp["wq"]).reshape(B, S, H, Dh), positions, sin, cos)
    k = apply_rope((x @ lp["wk"]).reshape(B, S, Hkv, Dh), positions, sin, cos)
    v = (x @ lp["wv"]).reshape(B, S, Hkv, Dh)
    return h + attention(q, k, v, causal=True).reshape(B, S, H * Dh) @ lp["wo"]
