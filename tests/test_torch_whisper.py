"""The port's ASR path (``gofr_tpu_torch/ops/audio.py``,
``models/whisper.py``, ``serving/asr.py``) beside the JAX package's, at
``WhisperConfig.tiny`` (f32, the JAX params carried across): the mel
filterbank equal, the log-mel frontend within 1e-4, ``encode_audio``
within 1e-5, ``decode_text_step``'s logits within 1e-4 and its cache
writes over several steps, ``transcribe`` token for token, and the
``ASRWorker`` behind each package's subscription manager and in-memory
broker: the same ``token_ids`` and text, each reply on the job's topic
(or the worker's default), the empty-audio error."""

import asyncio
import base64
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import gofr_tpu.subscriber as rsub  # noqa: E402
import gofr_tpu_torch.subscriber as tsub  # noqa: E402
from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.container.container import Container as RContainer  # noqa: E402
from gofr_tpu.datasource.pubsub import InMemoryBroker as RBroker  # noqa: E402
from gofr_tpu.models import whisper as jwhisper  # noqa: E402
from gofr_tpu.ops import audio as jaudio  # noqa: E402
from gofr_tpu.serving.asr import ASRWorker as RASRWorker  # noqa: E402
from gofr_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.container.container import Container as TContainer  # noqa: E402
from gofr_tpu_torch.models import whisper as twhisper  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops import audio as taudio  # noqa: E402
from gofr_tpu_torch.pubsub import InMemoryBroker as TBroker  # noqa: E402
from gofr_tpu_torch.serving.asr import ASRWorker  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil.params import perturb_norms_and_biases  # noqa: E402


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
    """Whisper tiny, JAX params and their port copy. The init's unit norm
    scales and zero biases are given distinct values first, so a misplaced
    bias or norm shows."""
    jcfg = jwhisper.WhisperConfig.tiny(vocab_size=300)
    tcfg = twhisper.WhisperConfig.tiny(vocab_size=300)
    tparams = params_from_jax(
        jax.device_get(jwhisper.init_params(jcfg, jax.random.PRNGKey(0))), device="cpu")
    perturb_norms_and_biases(tparams, torch.Generator().manual_seed(0))
    jparams = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tparams)
    return jcfg, jparams, tcfg, tparams


def _mel(seed: int, B: int = 2, T: int = 16, n_mels: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, T, n_mels)).astype(np.float32)


@pytest.mark.parametrize("n_mels,n_fft", [(8, 64), (80, 400), (128, 400)])
def test_mel_filterbank_is_the_reference(n_mels, n_fft):
    np.testing.assert_array_equal(taudio.mel_filterbank(n_mels, n_fft),
                                  jaudio.mel_filterbank(n_mels, n_fft))


@pytest.mark.parametrize("n,n_fft,hop,n_mels", [(1600, 64, 32, 8), (8000, 400, 160, 80),
                                                (48, 64, 32, 8), (400, 400, 160, 128)])
def test_log_mel_matches_reference(n, n_fft, hop, n_mels):
    audio = np.random.default_rng(n).uniform(-1, 1, (2, n)).astype(np.float32)
    audio[1] *= 0.01  # a quiet row: its dynamic-range clamp is its own
    want = np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(audio), n_fft=n_fft, hop=hop,
                                                 n_mels=n_mels))
    got = taudio.log_mel_spectrogram(torch.from_numpy(audio), n_fft=n_fft, hop=hop,
                                     n_mels=n_mels)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_params_from_jax_holds_the_whisper_tree(models):
    _, jparams, _, _ = models
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(jparams))[0]:
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


@pytest.mark.parametrize("T", [16, 15, 32])
def test_encode_audio_matches_reference(models, T):
    jcfg, jparams, tcfg, tparams = models
    mel = _mel(T, T=T)
    want = np.asarray(jwhisper.encode_audio(jcfg, jparams, jnp.asarray(mel)))
    got = twhisper.encode_audio(tcfg, tparams, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, (T + 1) // 2, tcfg.d_model)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_decode_text_step_matches_reference(models):
    jcfg, jparams, tcfg, tparams = models
    mel = _mel(3)
    j_enc = jwhisper.encode_audio(jcfg, jparams, jnp.asarray(mel))
    t_enc = twhisper.encode_audio(tcfg, tparams, torch.from_numpy(mel))
    j_cache = jwhisper.DecCache.create(jcfg, 2)
    t_cache = twhisper.DecCache.create(tcfg, 2, "cpu")
    rng = np.random.default_rng(4)
    for step in range(5):
        tokens = rng.integers(0, 300, 2).astype(np.int32)
        pos = np.array([step, step + (step > 1)], np.int32)  # rows at their own positions
        j_logits, j_cache = jwhisper.decode_text_step(jcfg, jparams, j_enc, jnp.asarray(tokens),
                                                      j_cache, jnp.asarray(pos))
        t_logits, t_cache = twhisper.decode_text_step(tcfg, tparams, t_enc,
                                                      torch.from_numpy(tokens).long(), t_cache,
                                                      torch.from_numpy(pos).long())
        assert t_logits.dtype == torch.float32 and tuple(t_logits.shape) == (2, 300)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_cache.v.numpy(), np.asarray(j_cache.v), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed,max_tokens", [(5, 6), (6, None), (7, 1)])
def test_transcribe_matches_reference(models, seed, max_tokens):
    jcfg, jparams, tcfg, tparams = models
    mel = _mel(seed, B=3)
    want = jwhisper.transcribe(jcfg, jparams, jnp.asarray(mel), max_tokens=max_tokens)
    got = twhisper.transcribe(tcfg, tparams, torch.from_numpy(mel), max_tokens=max_tokens)
    assert got == want


def test_transcribe_stops_at_eot(models):
    """With the EOT id the model's first argmax, the loop ends after one
    step and the row is empty, on both sides."""
    import dataclasses

    jcfg, jparams, tcfg, tparams = models
    mel = _mel(8, B=1)
    first = twhisper.transcribe(tcfg, tparams, torch.from_numpy(mel), max_tokens=1)
    assert len(first[0]) == 1
    eot = first[0][0]

    jcfg2, tcfg2 = dataclasses.replace(jcfg, eot_id=eot), dataclasses.replace(tcfg, eot_id=eot)
    want = jwhisper.transcribe(jcfg2, jparams, jnp.asarray(mel), max_tokens=8)
    got = twhisper.transcribe(tcfg2, tparams, torch.from_numpy(mel), max_tokens=8)
    assert got == want == [[]]


# ------------------------------------------------ the worker behind a subscriber
AUDIO = np.sin(np.linspace(0, 100, 800)).astype(np.float32)
JOBS = [
    {"id": "list", "audio": AUDIO.tolist(), "reply_topic": "asr-results", "max_tokens": 6},
    {"id": "b64", "audio_b64": base64.b64encode((AUDIO[::2] * 0.5).tobytes()).decode(),
     "reply_topic": "other-results"},
    {"id": "default-topic", "audio": (AUDIO[:300] * 0.2).tolist(), "max_tokens": 3},
    {"id": "empty", "audio": [], "reply_topic": "asr-results"},
]


def _worker_replies(side: str, models) -> dict:
    jcfg, jparams, tcfg, tparams = models
    if side == "ref":
        container = RContainer(RMapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
        broker, sub = RBroker(poll_timeout=0.02), rsub
        worker = RASRWorker(jcfg, jparams, JByteTokenizer(), reply_topic="asr-default",
                            n_fft=64, hop=32)
    else:
        container = TContainer(TMapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
        broker, sub = TBroker(poll_timeout=0.02), tsub
        worker = ASRWorker(tcfg, tparams, ByteTokenizer(), reply_topic="asr-default",
                           n_fft=64, hop=32)
    container.register_datasource("pubsub", broker)
    manager = sub.SubscriptionManager(container)
    manager.register("asr-jobs", worker.handler)
    replies: dict = {}

    async def scenario():
        for job in JOBS:
            broker.publish("asr-jobs", json.dumps(job).encode())
        await manager.start()
        try:
            deadline = time.monotonic() + 60
            while len(replies) < len(JOBS) and time.monotonic() < deadline:
                for topic in ("asr-results", "other-results", "asr-default"):
                    msg = broker.subscribe(topic)
                    if msg is not None:
                        msg.commit()
                        reply = json.loads(msg.value)
                        replies[reply["id"]] = (topic, reply)
                await asyncio.sleep(0.01)
        finally:
            await manager.stop()

    asyncio.run(scenario())
    container.close()
    return replies


def test_asr_worker_through_each_subscriber_matches_reference(models):
    ref, port = (_worker_replies(side, models) for side in ("ref", "port"))
    assert set(port) == set(ref) == {job["id"] for job in JOBS}
    assert port == ref
    assert port["list"][0] == "asr-results" and port["b64"][0] == "other-results"
    assert port["default-topic"][0] == "asr-default"
    assert port["empty"] == ("asr-results", {"id": "empty", "error": "empty audio"})
    assert 0 < len(port["list"][1]["token_ids"]) <= 6
    assert len(port["default-topic"][1]["token_ids"]) <= 3


def test_asr_worker_transcribes_as_transcribe_does(models):
    """A job's ids are ``transcribe`` of the worker's mel of its audio."""
    _, _, tcfg, tparams = models
    worker = ASRWorker(tcfg, tparams, n_fft=64, hop=32)
    result = worker.transcribe_job({"id": 1, "audio": AUDIO.tolist(), "max_tokens": 5})
    mel = taudio.log_mel_spectrogram(torch.from_numpy(AUDIO[None]), n_fft=64, hop=32,
                                     n_mels=tcfg.n_mels)
    assert result == {"id": 1, "token_ids": twhisper.transcribe(tcfg, tparams, mel, 5)[0],
                      "text": None}
    assert worker.transcribe_job({"id": 2}) == {"id": 2, "error": "empty audio"}
