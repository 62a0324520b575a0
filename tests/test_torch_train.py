"""The port's training step (``gofr_tpu_torch/models/train.py``) beside the
JAX package's ``models/train.py`` on the same numpy inputs:
``next_token_nll`` and ``cross_entropy_loss`` within 1e-6 relative (f32),
one and three AdamW steps against ``optax.adamw`` at ``LlamaConfig.tiny()``
f32 (loss rtol 1e-5, params atol 1e-5: a thirtieth of the 3e-4 step, since
Adam moves an element whose gradient is near zero by up to the learning
rate on a rounding; one step at lr 1e-2 within the same thirtieth), the
optimizer's settings, and the
f32-out logits GEMM's backward (``ops/matmul.py``) against autograd of the
f32 product: exact in f32, rel L2 <= 1e-2 in bf16 (the gradient is rounded
to bf16 before the GEMM)."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.models import train as jtrain  # noqa: E402
from gofr_tpu_torch import tree as tree_util  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models import train  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops import matmul  # noqa: E402

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B,S,V", [(2, 9, 17), (1, 33, 256), (3, 2, 5)])
def test_next_token_nll_matches_reference(B, S, V):
    rng = np.random.default_rng(B * S + V)
    logits = (rng.standard_normal((B, S, V)) * 4).astype(np.float32)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    want = float(jtrain.next_token_nll(jnp.asarray(logits), jnp.asarray(tokens)))
    got = train.next_token_nll(torch.from_numpy(logits), torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    # distinct norm scales, so a misplaced norm shows in the gradients
    rng = np.random.default_rng(1)
    jparams = jax.tree.map(lambda x: x, jparams)
    for key in ("attn_norm", "mlp_norm"):
        shape = jparams["layers"][key].shape
        jparams["layers"][key] = jnp.asarray(1 + 0.1 * rng.standard_normal(shape), jnp.float32)
    jparams["final_norm"] = jnp.asarray(
        1 + 0.1 * rng.standard_normal(jparams["final_norm"].shape), jnp.float32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tokens


def _port_params(jparams):
    return params_from_jax(jax.device_get(jparams), device="cpu")


def test_cross_entropy_loss_matches_reference(tiny):
    jcfg, jparams, tcfg, tokens = tiny
    want = float(jtrain.cross_entropy_loss(jcfg, jparams, jnp.asarray(tokens)))
    got = train.cross_entropy_loss(tcfg, _port_params(jparams), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


@pytest.mark.parametrize("steps", [1, 3])
def test_adamw_steps_match_optax(tiny, steps):
    jcfg, jparams, tcfg, tokens = tiny
    jinit, jstep = jtrain.make_train_step(jcfg)
    jstep = jax.jit(jstep)
    jp, js = jparams, jinit(jparams)
    jlosses = []
    for _ in range(steps):
        jp, js, loss = jstep(jp, js, jnp.asarray(tokens))
        jlosses.append(float(loss))

    init_opt, step = train.make_train_step(tcfg)
    tp = _port_params(jparams)
    ts = init_opt(tp)
    tlosses = []
    for _ in range(steps):
        tp, ts, loss = step(tp, ts, torch.from_numpy(tokens))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert int(ts["step"]) == steps
    want = jax.device_get(jp)
    for (path, got) in zip(*_paths(tp)):
        ref = _at(want, path)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=PARAM_ATOL, rtol=0,
                                   err_msg="/".join(path))
    # the moments follow optax's mu and nu, leaf for leaf
    mu, nu = js[0].mu, js[0].nu
    for (path, got) in zip(*_paths(ts["exp_avg"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(_at(mu, path)), atol=1e-6, rtol=1e-4)
    for (path, got) in zip(*_paths(ts["exp_avg_sq"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(_at(nu, path)), atol=1e-9, rtol=1e-4)
    # params come back as plain tensors, no grad kept
    assert all(not t.requires_grad and t.grad is None for t in tree_util.leaves(tp))


def _paths(tree, prefix=()):
    paths, leaves = [], []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            p, lv = _paths(v, prefix + (k,))
            paths += p
            leaves += lv
        else:
            paths.append(prefix + (k,))
            leaves.append(v)
    return paths, leaves


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_adamw_settings_are_optaxs_defaults():
    assert train.adamw() == {"lr": 3e-4, "betas": (0.9, 0.999), "eps": 1e-8,
                             "weight_decay": 1e-4}
    # optax's adamw signature carries the same defaults
    import inspect

    sig = inspect.signature(optax.adamw).parameters
    assert (sig["b1"].default, sig["b2"].default, sig["eps"].default,
            sig["weight_decay"].default) == (0.9, 0.999, 1e-8, 1e-4)


def test_step_with_other_settings_matches_optax(tiny):
    """``train.adamw(lr, ...)`` against ``optax.adamw(lr, ...)`` with a
    learning rate and decay far from the defaults: one step."""
    jcfg, jparams, tcfg, tokens = tiny
    jinit, jstep = jtrain.make_train_step(jcfg, optax.adamw(1e-2, weight_decay=0.1))
    jp, _, jloss = jax.jit(jstep)(jparams, jinit(jparams), jnp.asarray(tokens))
    init_opt, step = train.make_train_step(tcfg, train.adamw(1e-2, weight_decay=0.1))
    tp = _port_params(jparams)
    tp, _, tloss = step(tp, init_opt(tp), torch.from_numpy(tokens))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    want = jax.device_get(jp)
    for (path, got) in zip(*_paths(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(_at(want, path)),
                                   atol=PARAM_ATOL * 1e-2 / 3e-4, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 1e-2)])
def test_matmul_f32_backward_matches_autograd_of_the_f32_product(dtype, tol):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 64, generator=g).to(dtype)
    w = torch.randn(64, 48, generator=g).to(dtype)
    up = torch.randn(10, 48, generator=g)
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    ya = xa.reshape(-1, 64).float() @ wa.float()
    (ya * up).sum().backward()
    yb = matmul.matmul_f32(x, w).reshape(-1, 48)
    assert yb.dtype == torch.float32
    torch.testing.assert_close(yb, ya, rtol=0, atol=0)
    # the card's backward (its forward is the card's f32-out GEMM), given
    # what autograd would hand it: the saved operands and the upstream grad
    ctx = SimpleNamespace(saved_tensors=(x.reshape(-1, 64), w), needs_input_grad=(True, True))
    dx, dw = matmul._MatmulF32.backward(ctx, up)
    for got, want in ((dx.reshape(x.shape), xa.grad), (dw, wa.grad)):
        assert got.dtype == want.dtype == dtype
        rel = (got.float() - want.float()).norm() / want.float().norm()
        assert float(rel) <= tol


def test_matmul_f32_keeps_the_plain_path_without_grad():
    """On the CPU ``matmul_f32`` stays the plain f32 product (it has a
    derivative there); a bf16 call returns f32."""
    x = torch.randn(3, 8).to(torch.bfloat16).requires_grad_(True)
    w = torch.randn(8, 4).to(torch.bfloat16)
    y = matmul.matmul_f32(x, w)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    y.sum().backward()
    assert x.grad.dtype == torch.bfloat16
