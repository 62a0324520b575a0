"""The port's BERT encoder and /embed (``gofr_tpu_torch/models/bert.py``,
``ops/norms.py``'s ``layer_norm``, ``serving/handlers.py``'s
``register_embedding_routes``) beside the JAX package's: ``layer_norm``
within 1e-6, ``encode``/``embed`` within 1e-5 at ``BertConfig.tiny`` (f32,
the JAX params carried across), a row's embedding the same alone and
padded inside a batch, /embed over real sockets on each package's ``App``
with the same texts (embeddings within 1e-5, ``dim`` and usage equal), the
400 for a body with no input, the ``engine`` field, and the refused native
PJRT embedder."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.models import bert as jbert  # noqa: E402
from gofr_tpu.ops.norms import layer_norm as jlayer_norm  # noqa: E402
from gofr_tpu.serving import handlers as r_handlers  # noqa: E402
from gofr_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving.tokenizer import pad_batch as jpad_batch  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import bert as tbert  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops.norms import layer_norm  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer, pad_batch  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402
from gofr_tpu_torch.testutil.params import perturb_norms_and_biases  # noqa: E402

TEXTS = ["hi", "the quick brown fox jumps over the lazy dog", "caffè 東京 🚀", "x" * 70]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    """BERT tiny at vocab 300 (the byte tokenizer's ids fit), JAX params and
    their port copy. The init's unit norm scales and zero biases are given
    distinct values first, so a misplaced bias or norm shows."""
    jcfg = jbert.BertConfig.tiny(vocab_size=300)
    tcfg = tbert.BertConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jbert.init_params(jcfg, jax.random.PRNGKey(0))),
                              device="cpu")
    perturb_norms_and_biases(tparams, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("shape,eps", [((3, 5, 32), 1e-12), ((2, 7), 1e-5), ((4, 1, 1, 64), 1e-6)])
def test_layer_norm_matches_reference(shape, eps):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), eps))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_params_from_jax_holds_the_bert_tree(models):
    _, jparams, _, _ = models
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))[0]
    assert len(flat) == len(tparams["layers"]) + len(tparams) - 1
    for path, leaf in flat:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def _batch(seed: int, B: int = 3, S: int = 16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, 300, (B, S)).astype(np.int32)
    lens = np.array([S, 5, 1][:B], np.int32)
    tokens[np.arange(S)[None, :] >= lens[:, None]] = 0
    return tokens, lens


@pytest.mark.parametrize("seed", [0, 1])
def test_encode_and_embed_match_reference(models, seed):
    jcfg, jparams, tcfg, tparams = models
    tokens, lens = _batch(seed)
    want_h = np.asarray(jbert.encode(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lens)))
    want_e = np.asarray(jbert.embed(jcfg, jparams, jnp.asarray(tokens), jnp.asarray(lens)))
    t_tokens, t_lens = torch.from_numpy(tokens), torch.from_numpy(lens)
    got_h = tbert.encode(tcfg, tparams, t_tokens, t_lens).numpy()
    got_e = tbert.embed(tcfg, tparams, t_tokens, t_lens).numpy()
    # past a row's length the hidden states are padding: held where valid
    valid = np.arange(tokens.shape[1])[None, :] < lens[:, None]
    np.testing.assert_allclose(got_h[valid], want_h[valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_e, want_e, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got_e, axis=-1), 1.0, atol=1e-6)


def test_embedding_is_the_same_alone_and_padded_in_a_batch(models):
    _, _, tcfg, tparams = models
    tok = ByteTokenizer()
    arr, lens = pad_batch(tok, TEXTS, tcfg.max_seq_len)
    batch = tbert.embed(tcfg, tparams, torch.from_numpy(arr), torch.tensor(lens)).numpy()
    for i, text in enumerate(TEXTS):
        a1, l1 = pad_batch(tok, [text], tcfg.max_seq_len)
        assert a1.shape[1] <= arr.shape[1]
        alone = tbert.embed(tcfg, tparams, torch.from_numpy(a1), torch.tensor(l1)).numpy()[0]
        np.testing.assert_allclose(alone, batch[i], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("texts,max_len", [(TEXTS, 64), (["", "a"], 64), (["abc" * 40], 16),
                                           ([], 32)])
def test_pad_batch_matches_reference(texts, max_len):
    arr, lens = pad_batch(ByteTokenizer(), texts, max_len)
    want_arr, want_lens = jpad_batch(JByteTokenizer(), texts, max_len)
    assert arr.dtype == want_arr.dtype == np.int32 and lens == want_lens
    np.testing.assert_array_equal(arr, want_arr)


def _conf(side: str, **values) -> dict:
    return {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
            "HTTP_HOST": "127.0.0.1", "APP_NAME": f"embed-{side}", "LOG_LEVEL": "FATAL",
            **values}


def _app(side: str, models):
    jcfg, jparams, tcfg, tparams = models
    if side == "ref":
        app = gofr_tpu.App(RMapConfig(_conf(side), use_env=False))
        r_handlers.register_embedding_routes(app, jcfg, jparams, JByteTokenizer())
    else:
        app = TApp(TMapConfig(_conf(side), use_env=False))
        t_handlers.register_embedding_routes(app, tcfg, tparams, ByteTokenizer())
    return app


@pytest.fixture(scope="module")
def served(models):
    apps = {side: _app(side, models) for side in ("ref", "port")}
    threads = {side: start_app(app) for side, app in apps.items()}
    yield apps
    for side, app in apps.items():
        stop_app(app, threads[side])


def _post(app, payload) -> tuple[int, dict]:
    status, _, data = fetch(f"http://127.0.0.1:{app.http_port}/embed", "POST",
                            json.dumps(payload).encode(), {"Content-Type": "application/json"},
                            timeout=120)
    return status, json.loads(data)


@pytest.mark.parametrize("payload", [{"input": TEXTS}, {"texts": TEXTS[1]}, {"input": "hi"}],
                         ids=["input-list", "texts-string", "input-string"])
def test_embed_route_matches_reference(served, payload):
    (r_status, r_body), (t_status, t_body) = (_post(served[s], payload) for s in ("ref", "port"))
    assert r_status == t_status == 201
    ref, port = r_body["data"], t_body["data"]
    assert ref["engine"] == "jax" and port["engine"] == "torch"
    assert port["dim"] == ref["dim"] == 32 and port["usage"] == ref["usage"]
    np.testing.assert_allclose(np.array(port["embeddings"]), np.array(ref["embeddings"]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("payload", [{}, {"input": []}, {"input": ""}, {"other": "x"}])
def test_embed_without_input_is_a_400_on_both(served, payload):
    (r_status, r_body), (t_status, t_body) = (_post(served[s], payload) for s in ("ref", "port"))
    assert r_status == t_status == 400
    assert "input" in json.dumps(t_body) and "input" in json.dumps(r_body)


def test_native_pjrt_embedder_is_refused_at_registration(models):
    _, _, tcfg, tparams = models
    cases = [({}, {"native_embedder": object()}), ({"TPU_NATIVE_PJRT": "1"}, {})]
    for values, kw in cases:
        app = TApp(TMapConfig(_conf("port", **values), use_env=False))
        with pytest.raises(NotImplementedError, match="PJRT.*item 7"):
            t_handlers.register_embedding_routes(app, tcfg, tparams, ByteTokenizer(), **kw)
        assert not any(r.pattern == "/embed" for r in app.router.routes)
        app.container.close()
    app = TApp(TMapConfig(_conf("port", TPU_NATIVE_PJRT="0"), use_env=False))
    t_handlers.register_embedding_routes(app, tcfg, tparams, ByteTokenizer())
    assert any(r.pattern == "/embed" for r in app.router.routes)
    app.container.close()
