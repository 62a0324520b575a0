"""``/embed`` with token ids past BERT's vocabulary (ROADMAP Queue C 36),
beside the JAX package's route, at the default ``BertConfig.tiny()``
(vocab 128): a tokenizer that declares a larger vocabulary is refused at
registration; with a ``ByteTokenizer`` that declares 128 (its byte ids
still run to 258), ids that fit give equal 201s on both sides, and ids
past the vocabulary give the reference's 201 (its gather clamps them)
and the port's 400, which never reaches the model."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gofr_tpu  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.models import bert as jbert  # noqa: E402
from gofr_tpu.serving import handlers as r_handlers  # noqa: E402
from gofr_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import bert as tbert  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402

EMB_TOL = 1e-5  # f32 embeddings, both packages


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _conf(side: str) -> dict:
    return {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
            "HTTP_HOST": "127.0.0.1", "APP_NAME": f"vocab-{side}", "LOG_LEVEL": "FATAL"}


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jbert.BertConfig.tiny(), tbert.BertConfig.tiny()
    assert jcfg.vocab_size == tcfg.vocab_size == 128
    tparams = params_from_jax(jax.device_get(jbert.init_params(jcfg, jax.random.PRNGKey(0))),
                              device="cpu")
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, jparams, tcfg, tparams


def test_a_tokenizer_larger_than_the_vocabulary_is_refused_at_registration(models):
    _, _, tcfg, tparams = models
    app = TApp(TMapConfig(_conf("port"), use_env=False))
    try:
        with pytest.raises(ValueError, match="259 exceeds the model's 128"):
            t_handlers.register_embedding_routes(app, tcfg, tparams, ByteTokenizer())
        assert not any(r.pattern == "/embed" for r in app.router.routes)
        t_handlers.register_embedding_routes(app, tcfg, tparams, ByteTokenizer(128))
        assert any(r.pattern == "/embed" for r in app.router.routes)
    finally:
        app.container.close()


@pytest.fixture(scope="module")
def served(models):
    jcfg, jparams, tcfg, tparams = models
    ref = gofr_tpu.App(RMapConfig(_conf("ref"), use_env=False))
    r_handlers.register_embedding_routes(ref, jcfg, jparams, JByteTokenizer(128))
    port = TApp(TMapConfig(_conf("port"), use_env=False))
    t_handlers.register_embedding_routes(port, tcfg, tparams, ByteTokenizer(128))
    apps = {"ref": ref, "port": port}
    threads = {side: start_app(app) for side, app in apps.items()}
    yield apps
    for side, app in apps.items():
        stop_app(app, threads[side])


def _post(app, payload) -> tuple[int, dict]:
    status, _, data = fetch(f"http://127.0.0.1:{app.http_port}/embed", "POST",
                            json.dumps(payload).encode(), {"Content-Type": "application/json"},
                            timeout=120)
    return status, json.loads(data)


@pytest.mark.parametrize("payload", [{"input": "abc"}, {"input": ["abc", "hello"]}],
                         ids=["one", "two"])
def test_ids_inside_the_vocabulary_give_equal_201s(served, payload):
    (r_status, r_body), (t_status, t_body) = (_post(served[s], payload) for s in ("ref", "port"))
    assert r_status == t_status == 201
    assert r_body["data"]["usage"] == t_body["data"]["usage"]
    np.testing.assert_allclose(np.array(t_body["data"]["embeddings"]),
                               np.array(r_body["data"]["embeddings"]), rtol=EMB_TOL, atol=EMB_TOL)


@pytest.mark.parametrize("payload", [{"input": "a}b"}, {"input": "héllo"},
                                     {"input": ["abc", "a}b"]}],
                         ids=["brace", "accent", "one-of-two"])
def test_ids_past_the_vocabulary_are_a_400_on_the_port(served, payload, monkeypatch):
    calls = []
    monkeypatch.setattr(tbert, "embed", lambda *a, **k: calls.append(a))
    (r_status, _), (t_status, t_body) = (_post(served[s], payload) for s in ("ref", "port"))
    assert r_status == 201  # the reference's gather clamps the ids
    assert t_status == 400 and "input" in json.dumps(t_body)
    assert calls == []  # refused on the host, before the model
