"""The port's binary ``/kv/fetch`` body (ROADMAP Queue C 27):
``encode_entries_binary``/``decode_entries_binary`` round trips bit for bit
(bf16 as its 16-bit words, f32, int8, empty slabs), malformed bodies raise
``ValueError``; over real sockets a port app answers the binary body to
``HTTPReplica.fetch_kv`` (bit for bit the engine's cache entries) and the
JSON body to a request that does not ask for it, the JAX package's
``HTTPReplica`` included; a server answering a malformed binary body is a
clean compute miss in the migrator; the fence epoch still answers 409."""

import http.server
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import router as r_router  # noqa: E402
from gofr_tpu_torch.app import App as TApp  # noqa: E402
from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import handlers as t_handlers  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as t_pi  # noqa: E402
from gofr_tpu_torch.serving import router as t_router  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app  # noqa: E402

TIMEOUT = 120
BASE = dict(max_slots=4, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16, prefix_cache_entries=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _entry(seed: int, n: int = 5) -> tuple:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, 300, generator=g),
            torch.randn(2, n, 2, 16, generator=g).to(torch.bfloat16),
            torch.randint(-127, 128, (2, n, 2, 16), generator=g, dtype=torch.int8))


def _bits_equal(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.device.type == "cpu"
        and torch.equal(x.view(torch.uint8) if x.numel() else x,
                        y.view(torch.uint8) if y.numel() else y)
        for x, y in zip(a, b))


@pytest.mark.parametrize("entries", [
    {"prefill:a": _entry(0)},
    {"chunk:1": _entry(1, 16), "chunk:2": _entry(2, 3), "prefill:b": _entry(3)},
    {"empty": (torch.zeros(0, 4), torch.zeros(2, 0, 2, 16, dtype=torch.bfloat16))},
    {},
], ids=["one", "three", "empty-slabs", "none"])
def test_binary_body_round_trips_bit_for_bit(entries):
    body = t_pi.encode_entries_binary(entries)
    got = t_pi.decode_entries_binary(body)
    assert list(got) == list(entries)
    assert all(_bits_equal(got[k], v) for k, v in entries.items())
    # no base64: the body is the slabs' bytes plus a short header
    raw = sum(t.numel() * t.element_size() for v in entries.values() for t in v)
    assert raw <= len(body) < raw + 256 + 160 * sum(len(v) for v in entries.values())


def test_binary_body_holds_nan_and_signed_zero_bits():
    x = torch.tensor([float("nan"), -0.0, float("inf"), 1e-40]).to(torch.bfloat16)
    got = t_pi.decode_entries_binary(t_pi.encode_entries_binary({"k": (x, x.float())}))["k"]
    assert torch.equal(got[0].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got[1].view(torch.int32), x.float().view(torch.int32))


def _malformed() -> dict[str, bytes]:
    good = t_pi.encode_entries_binary({"k": _entry(4)})
    n = int.from_bytes(good[:8], "little")
    head = json.loads(good[8:8 + n])

    def with_head(h: dict, payload: bytes = good[8 + n:]) -> bytes:
        raw = json.dumps(h).encode()
        return len(raw).to_bytes(8, "little") + raw + payload

    leaf = head["entries"]["k"][1]
    return {
        "short": b"\x01\x02",
        "header-past-body": (1 << 40).to_bytes(8, "little") + b"{}",
        "not-json": (4).to_bytes(8, "little") + b"\xff\xfe{[",
        "no-entries": with_head({"other": 1}),
        "truncated-slab": good[:-7],
        "leaf-past-body": with_head({"entries": {"k": [dict(leaf, offset=len(good))]}}),
        "wrong-nbytes": with_head({"entries": {"k": [dict(leaf, nbytes=leaf["nbytes"] - 2)]}}),
        "unknown-dtype": with_head({"entries": {"k": [dict(leaf, dtype="complex64")]}}),
        "negative-shape": with_head({"entries": {"k": [dict(leaf, shape=[-2, 5, 2, 16])]}}),
        "leaf-not-a-map": with_head({"entries": {"k": [7]}}),
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_malformed_binary_body_raises_value_error(name):
    with pytest.raises(ValueError):
        t_pi.decode_entries_binary(_malformed()[name])


@pytest.fixture(scope="module")
def served():
    """A started port app over a tiny engine that has served two prompts
    (whole-prompt and chunk entries in its prefix cache)."""
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    tparams = params_from_jax(jax.device_get(jllama.init_params(jcfg, jax.random.PRNGKey(0))),
                              device="cpu")
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "HTTP_HOST": "127.0.0.1", "APP_NAME": "kv-wire", "LOG_LEVEL": "FATAL",
              "SHUTDOWN_GRACE_PERIOD": "5"}
    app = TApp(TMapConfig(values, use_env=False))
    engine = ServingEngine(tcfg, tparams, EngineConfig(**BASE), ByteTokenizer(), device="cpu")
    t_handlers.register_generation_routes(app, engine)
    thread = start_app(app)
    for prompt in ("wire prefix over sockets " * 2, "short one"):
        engine.submit(prompt, max_new_tokens=3, temperature=0.0).result(timeout=TIMEOUT)
    yield dict(app=app, engine=engine, tcfg=tcfg, tparams=tparams,
               url=f"http://127.0.0.1:{app.http_port}")
    if thread.is_alive():
        stop_app(app, thread)


def _keys(engine) -> list[str]:
    return sorted(k for k, _ in engine.prefix_advertisement())


def _cached(engine, key: str) -> tuple:
    cache = engine._prefix_cache
    return tuple(t.cpu() for t in (getattr(cache, "peek", None) or cache.get)(key))


def test_fetch_kv_takes_the_binary_body_bit_for_bit(served, monkeypatch):
    engine = served["engine"]
    keys = _keys(engine)
    assert any(k.startswith("prefill:") for k in keys) and any(
        not k.startswith("prefill:") for k in keys)
    calls = []
    real = t_pi.decode_entries_binary
    monkeypatch.setattr(t_router, "decode_entries_binary",
                        lambda body: calls.append(len(body)) or real(body))
    rep = t_router.HTTPReplica("a", served["url"])
    try:
        got = rep.fetch_kv(keys + ["absent"])
    finally:
        rep.close()
    assert len(calls) == 1 and sorted(got) == keys
    for key in keys:
        assert _bits_equal(got[key], _cached(engine, key))


def test_a_request_without_the_binary_accept_gets_the_json_body(served):
    engine = served["engine"]
    keys = _keys(engine)
    status, headers, data = fetch(f"{served['url']}/kv/fetch", "POST",
                                  json.dumps({"keys": keys}).encode(),
                                  {"Content-Type": "application/json"}, timeout=TIMEOUT)
    assert status == 201
    entries = json.loads(data)["data"]["entries"]
    assert sorted(entries) == keys
    for key in keys:
        assert _bits_equal(t_pi.decode_entry(entries[key]),
                           _cached(engine, key))
    # the JAX package's client reads the port's JSON body as it reads its own
    rep = r_router.HTTPReplica("a", served["url"])
    try:
        ref = rep.fetch_kv(keys)
    finally:
        rep.close()
    assert sorted(ref) == keys
    for key in keys:
        want = _cached(engine, key)
        for arr, t in zip(ref[key], want):
            assert tuple(np.asarray(arr).shape) == tuple(t.shape)
            if t.dtype == torch.bfloat16:
                assert np.array_equal(np.asarray(arr).view(np.uint16),
                                      t.view(torch.int16).numpy().view(np.uint16))
            else:
                assert np.array_equal(np.asarray(arr), t.numpy())


def test_a_malformed_binary_body_is_a_clean_compute_miss():
    class Bad(http.server.BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            body = (1 << 40).to_bytes(8, "little") + b"garbage"
            self.send_response(200)
            self.send_header("Content-Type", t_pi.KV_WIRE_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", get_free_port()), Bad)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rep = t_router.HTTPReplica("bad", f"http://127.0.0.1:{srv.server_port}")
        index = t_pi.PrefixIndex()
        index.observe("bad", 1, [["k", "device"]])
        migrator = t_pi.KVMigrator("c", index)
        migrator.add_peer("bad", rep.fetch_kv)
        t0 = time.monotonic()
        value = migrator.fetch_one("k")
        assert value is None and migrator.failed_fetches_total == 1
        assert migrator.migrations_total == 0 and time.monotonic() - t0 < 2.0
        rep.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_the_fence_epoch_still_answers_409_to_a_binary_fetch(served):
    """A fetch stamped with an epoch the replica has left is refused at the
    wire (409, so ``fetch_kv`` raises) before any cache is read, binary
    Accept or not; the current epoch fetches."""
    engine = served["engine"]
    keys = _keys(engine)
    stale = engine.epoch - 1 if engine.epoch > 1 else engine.epoch + 7
    rep = t_router.HTTPReplica("a", served["url"])
    try:
        with pytest.raises(ConnectionError, match="409"):
            rep.fetch_kv(keys, fence_epoch=stale)
        assert sorted(rep.fetch_kv(keys, fence_epoch=engine.epoch)) == keys
    finally:
        rep.close()
    status, _, _ = fetch(f"{served['url']}/kv/fetch", "POST",
                         json.dumps({"keys": keys, "fence_epoch": stale}).encode(),
                         {"Content-Type": "application/json",
                          "Accept": t_pi.KV_WIRE_CONTENT_TYPE}, timeout=TIMEOUT)
    assert status == 409
