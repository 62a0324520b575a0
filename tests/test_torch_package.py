"""Rules of the port's package: it imports no JAX and nothing of the JAX
package, its entry points run on the card unless asked for the CPU (and
raise without one), and CPU calls never count as kernel launches."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from gofr_tpu_torch import _build  # noqa: E402
from gofr_tpu_torch.models import llama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402
from gofr_tpu_torch.ops.paged_attention import (  # noqa: E402
    paged_decode_attention,
    paged_decode_attention_q,
)
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "gofr_tpu", "websockets", "optax", "orbax")
# not on the card's machine: no port module imports one when it is imported
# (``HFTokenizer`` imports ``transformers`` when one is built)
FORBIDDEN_AT_IMPORT = ("regex", "transformers", "tokenizers", "safetensors", "sentencepiece")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_files() -> list[Path]:
    return sorted((ROOT / "gofr_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


def _imported_at_import(path: Path) -> set[str]:
    """Modules a file imports when it is imported: every import statement
    outside a function body."""
    names: set[str] = set()

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                names.update(alias.name for alias in child.names)
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                names.add(child.module)
            walk(child)

    walk(ast.parse(path.read_text(), str(path)))
    return names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    late = {n for n in _imported_at_import(path) if n.split(".")[0] in FORBIDDEN_AT_IMPORT}
    assert not late, f"{path.relative_to(ROOT)} imports {sorted(late)} when it is imported"


def test_every_kernel_source_is_bound():
    sources = {p.stem for p in (ROOT / "gofr_tpu_torch" / "csrc").glob("*.cu")}
    assert sources == set(_build.SIGNATURES)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_a_card(no_card):
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg)
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.KVCache.create(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": torch.zeros(2).numpy()})


def test_rope_table_has_no_host_default(no_card):
    """``rope_table`` resolves its device as every entry point does: with
    no device on a host without a card it raises; the CPU is asked for,
    and the table stays cached per device."""
    from gofr_tpu_torch.ops.rope import rope_table

    rope_table.cache_clear()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rope_table(64, 16)
    sin, cos = rope_table(64, 16, 10000.0, "cpu")
    assert sin.device.type == cos.device.type == "cpu" and sin.shape == (64, 8)
    assert rope_table(64, 16, 10000.0, "cpu")[0] is sin


def test_multi_tenant_modules_are_checked_and_refuse_without_a_card(no_card):
    """The LoRA and tenancy modules are among the files the import rule
    holds, and the adapter registry's tables go to the card unless asked
    for the CPU."""
    from gofr_tpu_torch.serving.lora import AdapterRegistry

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"gofr_tpu_torch/serving/lora.py", "gofr_tpu_torch/serving/tenancy.py"} <= files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdapterRegistry(max_active=2)
    reg = AdapterRegistry(max_active=2, device="cpu")
    assert reg.device == torch.device("cpu")
    reg.close()


def test_ha_and_migration_modules_are_checked_and_keep_the_device_policy(no_card):
    """The dedup and prefix-index modules are among the files the import
    rule holds. Neither takes a device: the registry, the replay ring, the
    index, the migrator and the wire codec are host-side and work without
    a card (a decoded entry is a host tensor the engine uploads), while
    the engine that holds a migrator, and the spill tier its advertisement
    reads, still refuse without one."""
    from gofr_tpu_torch.serving import dedup, prefix_index
    from gofr_tpu_torch.serving.kv_spill import TieredPrefixCache

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"gofr_tpu_torch/serving/dedup.py", "gofr_tpu_torch/serving/prefix_index.py"} <= files
    reg = dedup.DedupRegistry(4)
    assert reg.claim("k")[0] and dedup.ReplayStream(4).wrap(None) is not None
    mig = prefix_index.KVMigrator("B", prefix_index.PrefixIndex())
    value = (torch.zeros(1, 4), torch.ones(2, 3, dtype=torch.bfloat16), torch.zeros(2, dtype=torch.int8))
    decoded = prefix_index.decode_entry(prefix_index.encode_entry(value))
    assert all(t.device.type == "cpu" and torch.equal(t, v) for t, v in zip(decoded, value))
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, kv_migrator=mig)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredPrefixCache(4)
    engine = ServingEngine(cfg, params, EngineConfig(prefix_cache_entries=4), device="cpu",
                           kv_migrator=mig)
    assert engine.prefix_advertisement() == [] and engine.dedup_stats()["live"] == 0


def test_fleet_modules_are_checked_and_the_pool_factory_keeps_the_device_policy(no_card):
    """The pubsub, membership, router, autoscaler and stub-replica modules
    are among the files the import rule holds. They are host-side and work
    without a card; the pool driver's engine factory builds its engines on
    the card unless given the CPU, and raises without one."""
    from gofr_tpu_torch.pubsub import InMemoryBroker
    from gofr_tpu_torch.serving import Router, RouterConfig, engine_factory, release_replica

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"gofr_tpu_torch/pubsub/memory.py", "gofr_tpu_torch/pubsub/message.py",
            "gofr_tpu_torch/serving/membership.py", "gofr_tpu_torch/serving/router.py",
            "gofr_tpu_torch/serving/autoscaler.py", "gofr_tpu_torch/testutil/replica.py"} <= files
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    conf = EngineConfig(max_slots=1, max_seq_len=32, prefill_buckets=(16,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_factory(cfg, params, conf)("unified", "r1")
    broker = InMemoryBroker()
    handle = engine_factory(cfg, params, conf, publisher=broker, device="cpu")("decode", "r1",
                                                                              preemptible=True)
    try:
        assert handle.engine.device.type == "cpu" and handle.role == "decode"
        assert handle.engine.preemptible and handle.announcer is not None
        assert broker.backlog("replica.heartbeat") >= 1  # announced at start
        router = Router(RouterConfig())
        router.add_replica(handle)
        assert router.membership.is_preemptible("r1")
        router.stop()
    finally:
        engine = handle.engine
        release_replica(handle)
    assert handle.engine is None and handle.announcer is None
    assert not engine._running


APP_MODULES = (
    "gofr_tpu_torch/app.py", "gofr_tpu_torch/context.py", "gofr_tpu_torch/handler.py",
    "gofr_tpu_torch/serve.py", "gofr_tpu_torch/config/config.py",
    "gofr_tpu_torch/logging/level.py", "gofr_tpu_torch/logging/logger.py",
    "gofr_tpu_torch/http/errors.py", "gofr_tpu_torch/http/request.py",
    "gofr_tpu_torch/http/responder.py", "gofr_tpu_torch/http/router.py",
    "gofr_tpu_torch/http/server.py", "gofr_tpu_torch/http/dispatch.py",
    "gofr_tpu_torch/http/response/__init__.py", "gofr_tpu_torch/http/middleware/core.py",
    "gofr_tpu_torch/container/container.py", "gofr_tpu_torch/container/health.py",
    "gofr_tpu_torch/metrics/server.py", "gofr_tpu_torch/service/client.py",
    "gofr_tpu_torch/service/options.py", "gofr_tpu_torch/serving/handlers.py",
    "gofr_tpu_torch/serving/remote.py", "gofr_tpu_torch/testutil/ports.py",
    "gofr_tpu_torch/testutil/apps.py",
)


def test_app_modules_are_checked_and_import_no_jax():
    """The app plane's modules are among the files the import rule holds,
    and importing every module of the package in a fresh interpreter loads
    nothing of JAX or of the JAX package."""
    import subprocess
    import sys

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(APP_MODULES) <= files
    modules = sorted(str(p.relative_to(ROOT).with_suffix("")).replace("/", ".")
                     .removesuffix(".__init__")
                     for p in _port_files() if p.name != "chip_smoke.py")
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + FORBIDDEN_AT_IMPORT!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


SURFACE_MODULES = (
    "gofr_tpu_torch/websocket.py", "gofr_tpu_torch/cron.py", "gofr_tpu_torch/subscriber.py",
    "gofr_tpu_torch/telemetry.py", "gofr_tpu_torch/pubsub/delivery.py",
    "gofr_tpu_torch/http/middleware/auth.py", "gofr_tpu_torch/http/middleware/jwt.py",
    "gofr_tpu_torch/http/swagger.py", "gofr_tpu_torch/logging/remote.py",
    "gofr_tpu_torch/cli/__init__.py", "gofr_tpu_torch/cli/cmd.py",
    "gofr_tpu_torch/cli/terminal.py",
)


def test_surface_modules_are_checked_and_keep_the_device_policy(no_card):
    """The app surface's modules (WebSocket, cron, subscribers, auth and
    JWT, swagger, the remote pollers, telemetry, CMD mode) are among the
    files the import rule holds, the swagger asset is the package's own
    copy, and an ``App`` with every surface registered builds without a
    card (the surface is host code) while the engine behind it still
    refuses one."""
    from gofr_tpu_torch.app import App, new_cmd
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serving.handlers import register_generation_ws

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(SURFACE_MODULES) <= files
    assert (ROOT / "gofr_tpu_torch" / "http" / "static" / "swagger_ui.html").is_file()
    app = App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL",
                         "PUBSUB_BACKEND": "MEMORY"}, use_env=False))
    app.enable_api_key_auth("k")
    app.websocket("/ws", lambda ctx: None)
    app.subscribe("t", lambda ctx: None)
    app.add_cron_job("* * * * *", "j", lambda ctx: None)
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        register_generation_ws(app, ServingEngine(cfg, llama.init_params(cfg, device="cpu")))
    app.container.close()
    cmd = new_cmd(MapConfig({"LOG_LEVEL": "FATAL"}, use_env=False))
    assert cmd.is_cmd and not cmd.router.routes  # no default routes in CMD mode
    cmd.container.close()


MODEL_MODULES = (
    "gofr_tpu_torch/ops/audio.py", "gofr_tpu_torch/ops/matmul.py",
    "gofr_tpu_torch/models/bert.py", "gofr_tpu_torch/models/whisper.py",
    "gofr_tpu_torch/models/hf_import.py", "gofr_tpu_torch/models/whisper_import.py",
    "gofr_tpu_torch/serving/asr.py",
    "gofr_tpu_torch/serving/tokenizer.py", "gofr_tpu_torch/tokenizer/__init__.py",
    "gofr_tpu_torch/tokenizer/bpe.py", "gofr_tpu_torch/tokenizer/spm.py",
    "gofr_tpu_torch/testutil/assets.py",
)


def test_model_family_modules_are_checked_and_keep_the_device_policy(no_card, tmp_path):
    """The BERT, Whisper, loader and tokenizer modules are among the files
    the import rules hold. Their entry points build on the card unless
    asked for the CPU and raise without one: BERT's and Whisper's params,
    Whisper's decoder cache, both loaders and ``ServingEngine.from_hf``.
    Tokenizers are host code and build without a card."""
    import json

    from gofr_tpu_torch.models import bert, hf_import, whisper, whisper_import
    from gofr_tpu_torch.testutil.assets import bpe_spec
    from gofr_tpu_torch.tokenizer import BPETokenizer

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(MODEL_MODULES) <= files
    bcfg, wcfg = bert.BertConfig.tiny(), whisper.WhisperConfig.tiny()
    for call in (lambda: bert.init_params(bcfg), lambda: whisper.init_params(wcfg),
                 lambda: whisper.DecCache.create(wcfg, 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert bert.init_params(bcfg, device="cpu")["embedding"].device.type == "cpu"
    assert whisper.DecCache.create(wcfg, 1, "cpu").k.device.type == "cpu"
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 8, "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
        "intermediate_size": 8, "num_mel_bins": 8, "d_model": 8, "encoder_layers": 1,
        "decoder_layers": 1, "encoder_attention_heads": 2, "encoder_ffn_dim": 8}))
    for call in (lambda: hf_import.load_llama_from_hf(str(tmp_path)),
                 lambda: whisper_import.load_whisper_from_hf(str(tmp_path)),
                 lambda: ServingEngine.from_hf(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(FileNotFoundError):  # with the CPU asked for: no weights there
        hf_import.load_llama_from_hf(str(tmp_path), device="cpu")
    tok = BPETokenizer.from_spec(bpe_spec([("a", "b")]))
    assert tok.decode(tok.encode("abc")) == "abc"


PLANE_MODULES = (
    "gofr_tpu_torch/tree.py", "gofr_tpu_torch/checkpoint/__init__.py",
    "gofr_tpu_torch/checkpoint/manager.py", "gofr_tpu_torch/models/train.py",
    "gofr_tpu_torch/ops/moe.py", "gofr_tpu_torch/models/moe.py",
    "gofr_tpu_torch/datasource/__init__.py", "gofr_tpu_torch/datasource/tpu/__init__.py",
    "gofr_tpu_torch/datasource/tpu/client.py",
)


def test_model_plane_and_datasource_modules_are_checked_and_keep_the_device_policy(
        no_card, tmp_path):
    """The checkpoint, training, MoE and device-datasource modules are among
    the files the import rules hold. Their entry points place tensors on the
    card unless asked for the CPU and raise without one: MoE params, a
    checkpoint restore, ``from_checkpoint`` and the datasource's connect;
    a save and the tree utilities are host code."""
    from gofr_tpu_torch.checkpoint import CheckpointManager
    from gofr_tpu_torch.datasource.tpu import TPUClient
    from gofr_tpu_torch.models import moe

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(PLANE_MODULES) <= files
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe.init_params(moe.MoeConfig.tiny())
    assert moe.init_params(moe.MoeConfig.tiny(), device="cpu")["lm_head"].device.type == "cpu"
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_checkpoint(cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPUClient().connect()
    engine = ServingEngine.from_checkpoint(cfg, str(tmp_path), device="cpu")
    assert engine.device.type == "cpu"
    assert all(torch.equal(a, b) for a, b in zip(
        [params["embedding"], params["layers"]["wq"]],
        [engine.params["embedding"], engine.params["layers"]["wq"]]))


def test_serve_entry_point_refuses_without_a_card(no_card):
    """``build_app`` builds its engine on the card unless the config asks
    for the CPU, and raises without one."""
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.serve import build_app

    values = {"SERVE_MODEL": "tiny", "HTTP_PORT": "0", "METRICS_PORT": "0",
              "TPU_BATCH_MAX_TOKENS": "64", "LOG_LEVEL": "FATAL"}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_app(MapConfig(values, use_env=False))
    with pytest.raises(ValueError, match="SERVE_MODEL"):
        build_app(MapConfig({**values, "SERVE_MODEL": "gpt"}, use_env=False))
    app = build_app(MapConfig({**values, "SERVE_DEVICE": "cpu"}, use_env=False))
    try:
        engine = app.container.serving
        assert engine.device.type == "cpu" and engine.model_cfg.d_model == 64
        assert {r.pattern for r in app.router.routes} >= {
            "/generate", "/generate/stream", "/generate/cancel", "/v1/models", "/requestz",
            "/requestz/{request_id}", "/kv/fetch", "/.well-known/health", "/.well-known/alive"}
    finally:
        app.container.close()


def test_cpu_engine_run_launches_no_kernel():
    """bf16 and int8 engines on either layout, a monolithic and a chunked
    prompt each: the plain versions run on the CPU and no counter moves."""
    flash_attention.launches = paged_decode_attention.launches = 0
    paged_decode_attention_q.launches = 0
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    for layout, kv_dtype in [(la, kv) for la in ("paged", "dense") for kv in ("bf16", "int8")]:
        engine = ServingEngine(cfg, params,
                               EngineConfig(max_slots=2, max_seq_len=32, prefill_buckets=(16,),
                                            kv_page_size=8, prefill_chunk_tokens=8,
                                            kv_dtype=kv_dtype, kv_layout=layout), device="cpu")
        engine.start()
        try:
            results = [f.result(timeout=60) for f in
                       [engine.submit(p, max_new_tokens=5) for p in ("hi", "a chunked prompt")]]
        finally:
            engine.stop()
        for res in results:
            assert res.completion_tokens > 0 or res.finish_reason == "stop"
    assert flash_attention.launches == 0
    assert paged_decode_attention.launches == 0
    assert paged_decode_attention_q.launches == 0


def test_build_needs_nvcc_and_imports_without_it(monkeypatch, tmp_path):
    """Importing the port never builds; building without nvcc says so."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("flash_attention")
    assert not (tmp_path / "build").exists()


class _Done:
    """A finished nvcc process with the given output."""

    def __init__(self, out: str, returncode: int = 0):
        self.out, self.returncode = out, returncode

    def communicate(self):
        return self.out, None


_PTXAS = """ptxas info    : Compiling entry function '_ZN51_GLOBAL__N_{k}' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N_{k}
    {stack} bytes stack frame, {st} bytes spill stores, {ld} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, {smem} bytes smem
"""


def test_chip_smoke_reads_each_path_instance_from_ptxas():
    """The card run's build phase reports registers, spills and static
    shared memory of each main-path kernel instantiation, and fails when
    ptxas says it serialized wgmma."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    flash = "".join(_PTXAS.format(k=f"16flash_fwd_kernelILi{d}EEEv14CUtensorMap", stack=0, st=0, ld=0,
                                  regs=r, smem=48) for d, r in ((128, 160), (64, 130)))
    paged = "".join(_PTXAS.format(k=f"19paged_decode_kernelILi128ELi{g}E{t}EEvPKt", stack=s, st=s,
                                  ld=2 * s, regs=r, smem=17668) for g, t, r, s in
                    ((4, "t", 153, 0), (4, "a", 243, 0), (8, "a", 255, 472)))
    report = cs.ptxas_report({"flash_attention": _Done(flash), "paged_attention": _Done(paged)})
    assert report["flash D=128"] == dict(stack=0, spill_stores=0, spill_loads=0, registers=160,
                                         static_smem=48)
    assert report["paged bf16 Dh=128 G=4"]["registers"] == 153
    assert report["paged int8 Dh=128 G=4"] == dict(stack=0, spill_stores=0, spill_loads=0, registers=243,
                                                   static_smem=17668)
    serialized = flash + ("ptxas info    : (C7520) Potential Performance Loss: wgmma.mma_async "
                          "instructions are serialized due to ...\n")
    with pytest.raises(RuntimeError, match="serialized"):
        cs.ptxas_report({"flash_attention": _Done(serialized)})
    with pytest.raises(RuntimeError, match="nvcc"):
        cs.ptxas_report({"flash_attention": _Done("error", returncode=1)})


def test_chip_smoke_labels_profiler_kernels_apart():
    """The dispatch profile sums kernel time by a short label; PyTorch's
    elementwise kernels share one template head, so the label keeps the
    operation inside them apart."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    copy = ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
            "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda(signed char)#1}>")
    mul = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
           "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor"
           "<float> > >(at::TensorIteratorBase&, ...)::{lambda(int)#1}>(int, ...)")
    assert cs.kernel_label(copy) == "at::native::unrolled_elementwise_kernel direct_copy_kernel_cuda"
    assert cs.kernel_label(mul) == "at::native::elementwise_kernel MulFunctor"
    assert cs.kernel_label("nvjet_tst_192x8_64x8_4x1_v_bz_NNT") == "nvjet_tst_192x8_64x8_4x1_v_bz_NNT"


SQL_MODULES = (
    "gofr_tpu_torch/datasource/sql/__init__.py", "gofr_tpu_torch/datasource/sql/query_builder.py",
    "gofr_tpu_torch/datasource/sql/sqlite.py", "gofr_tpu_torch/datasource/sql/pool.py",
    "gofr_tpu_torch/datasource/sql/base.py", "gofr_tpu_torch/datasource/sql/pg_wire.py",
    "gofr_tpu_torch/datasource/sql/postgres.py", "gofr_tpu_torch/datasource/sql/mysql_wire.py",
    "gofr_tpu_torch/datasource/sql/mysql.py", "gofr_tpu_torch/container/datasources.py",
    "gofr_tpu_torch/migration/__init__.py", "gofr_tpu_torch/migration/migration.py",
    "gofr_tpu_torch/crud.py", "gofr_tpu_torch/testutil/postgres_server.py",
    "gofr_tpu_torch/testutil/mysql_server.py", "gofr_tpu_torch/testutil/mock_container.py",
)


def test_sql_modules_are_checked_and_wire_without_a_card(no_card, tmp_path):
    """The SQL, migration, CRUD and fake-server modules are among the files
    the import rules hold, and the examples too. They are host code: an
    ``App`` with ``DB_DIALECT=sqlite`` migrates and wires ``ctx.sql``
    without a card, the container keeps the reference's datasource slots
    (``redis``, ``kv_store``, ``file`` and ``cache`` empty), a dark wire
    database is DOWN health rather than a crash, and a device datasource
    that a migration would use still refuses without a card."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.container import container as container_mod
    from gofr_tpu_torch.container.datasources import wire_provider
    from gofr_tpu_torch.datasource.tpu import TPUClient
    from gofr_tpu_torch.migration import Migrate
    from gofr_tpu_torch.testutil import new_mock_container

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(SQL_MODULES) <= files
    for example in ("using-migrations", "using-rest-handlers"):
        path = ROOT / "examples_torch" / example / "main.py"
        bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    assert container_mod.wire_provider is wire_provider  # its old import still resolves
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"}
    app = App(MapConfig({**base, "DB_DIALECT": "sqlite", "DB_NAME": str(tmp_path / "a.db")},
                        use_env=False))
    app.migrate({1: Migrate(up=lambda ds: ds.sql.exec("CREATE TABLE t (v INTEGER)"))})
    c = app.container
    assert (c.redis, c.kv_store, c.file, c.cache) == (None, None, None, None)
    assert [n for n, _ in c.datasource_pairs()] == ["tpu", "sql", "redis", "pubsub", "kv_store",
                                                    "file", "cache"]
    assert c.health()["details"]["sql"]["status"] == "UP"
    c.close()
    dark = App(MapConfig({**base, "DB_DIALECT": "postgres", "DB_HOST": "127.0.0.1",
                          "DB_PORT": "1"}, use_env=False))
    assert dark.container.sql is not None
    assert dark.container.health()["details"]["sql"]["status"] == "DOWN"
    dark.container.close()
    mock, mocks = new_mock_container()
    from gofr_tpu_torch.datasource.redis import InMemoryRedis

    assert isinstance(mocks.redis, InMemoryRedis) and mock.redis is mocks.redis
    from gofr_tpu_torch.datasource.kv import InMemoryKVStore

    assert isinstance(mocks.kv_store, InMemoryKVStore) and mock.kv_store is mocks.kv_store
    assert mock.sql is mocks.sql
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPUClient().connect()


PUBSUB_MODULES = (
    "gofr_tpu_torch/pubsub/__init__.py", "gofr_tpu_torch/pubsub/kafka_wire.py",
    "gofr_tpu_torch/pubsub/kafka.py", "gofr_tpu_torch/pubsub/nats.py",
    "gofr_tpu_torch/pubsub/mqtt.py", "gofr_tpu_torch/pubsub/amqp_wire.py",
    "gofr_tpu_torch/pubsub/eventhub.py", "gofr_tpu_torch/testutil/kafka_broker.py",
    "gofr_tpu_torch/testutil/nats_broker.py", "gofr_tpu_torch/testutil/mqtt_broker.py",
    "gofr_tpu_torch/testutil/eventhub_server.py",
)


def test_pubsub_modules_are_checked_and_connect_without_a_card(no_card):
    """The networked brokers' drivers, codecs and fakes are among the files
    the import rules hold. They are host code: each ``PUBSUB_BACKEND`` builds
    the port's own client from the reference's config keys, and an ``App``
    connects it to the port's fake without a card (health UP); a dark broker
    at boot is DOWN health rather than a crash."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.pubsub import InMemoryBroker, KafkaClient
    from gofr_tpu_torch.pubsub.eventhub import EventHubClient
    from gofr_tpu_torch.pubsub.mqtt import MQTTClient
    from gofr_tpu_torch.pubsub.nats import NatsClient
    from gofr_tpu_torch.testutil import (MiniEventHubServer, MiniKafkaBroker, MiniMQTTBroker,
                                         MiniNatsBroker)

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(PUBSUB_MODULES) <= files
    kafka, nats = MiniKafkaBroker(), MiniNatsBroker()
    mqtt, eventhub = MiniMQTTBroker().start(), MiniEventHubServer().start()
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"}
    backends = {
        "MEMORY": ({}, InMemoryBroker),
        "KAFKA": ({"PUBSUB_BROKER": kafka.address, "CONSUMER_ID": "g",
                   "PUBSUB_OFFSET": "latest"}, KafkaClient),
        "NATS": ({"NATS_SERVER": nats.address, "CONSUMER_ID": "g"}, NatsClient),
        "MQTT": ({"MQTT_HOST": "127.0.0.1", "MQTT_PORT": str(mqtt.port), "MQTT_CLIENT_ID": "c",
                  "MQTT_QOS": "1", "MQTT_KEEPALIVE": "20"}, MQTTClient),
        "EVENTHUB": ({"EVENTHUB_HOST": "127.0.0.1", "EVENTHUB_PORT": str(eventhub.port),
                      "EVENTHUB_NAME": "hub", "EVENTHUB_PARTITIONS": "3"}, EventHubClient),
    }
    try:
        for backend, (conf, cls) in backends.items():
            app = App(MapConfig({**base, "PUBSUB_BACKEND": backend.lower(), **conf},
                                use_env=False))
            client = app.container.pubsub
            assert type(client) is cls, backend
            assert app.container.health()["details"]["pubsub"]["status"] == "UP", backend
            app.container.close()
        kafka_client = App(MapConfig({**base, "PUBSUB_BACKEND": "KAFKA",
                                      **backends["KAFKA"][0]}, use_env=False)).container.pubsub
        assert (kafka_client.consumer_group, kafka_client.auto_offset_reset) == ("g", "latest")
        kafka_client.close()
    finally:
        kafka.close(), nats.close(), mqtt.stop(), eventhub.close()
    for backend, conf in (("KAFKA", {"PUBSUB_BROKER": "127.0.0.1:1"}),
                          ("NATS", {"NATS_SERVER": "127.0.0.1:1"}),
                          ("EVENTHUB", {"EVENTHUB_HOST": "127.0.0.1", "EVENTHUB_PORT": "1"})):
        dark = App(MapConfig({**base, "PUBSUB_BACKEND": backend, **conf}, use_env=False))
        assert dark.container.health()["details"]["pubsub"]["status"] == "DOWN", backend
        dark.container.close()


@pytest.mark.parametrize("backend,message", [
    ("GOOGLE", "not ported: the Google Pub/Sub driver speaks gRPC"),
    ("RABBIT", "unknown PUBSUB_BACKEND 'RABBIT'"),
])
def test_build_pubsub_refuses_google_and_unknown_backends(backend, message):
    """``GOOGLE`` is refused at ``App`` construction, its driver needing gRPC
    (ROADMAP Queue C 49); any other unknown value raises the reference's
    ``ValueError``. Unset is no broker, as on the reference."""
    from gofr_tpu.config import MapConfig as RMapConfig
    from gofr_tpu.datasource.pubsub import build_pubsub as rbuild
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.pubsub import build_pubsub

    conf = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL",
            "PUBSUB_BACKEND": backend}
    with pytest.raises(ValueError, match=message):
        App(MapConfig(conf, use_env=False))
    with pytest.raises(ValueError, match=message):
        build_pubsub(MapConfig({"PUBSUB_BACKEND": backend}, use_env=False))
    if backend != "GOOGLE":
        with pytest.raises(ValueError, match=message):
            rbuild(RMapConfig({"PUBSUB_BACKEND": backend}, use_env=False))
    assert build_pubsub(MapConfig({}, use_env=False)) is None
    assert rbuild(RMapConfig({}, use_env=False)) is None


@pytest.mark.parametrize("side", ["ref", "port"])
def test_mock_pubsub_nack_requeues(side):
    """The mock container's pubsub: a published message is captured and
    delivered, a nack with requeue puts it back at the head, a commit-less
    second subscribe then gets it again, and a drained topic gives None;
    the same observables on both packages' mocks."""
    if side == "ref":
        from gofr_tpu.testutil import new_mock_container as make
    else:
        from gofr_tpu_torch.testutil import new_mock_container as make

    _, mocks = make()
    pubsub = mocks.pubsub
    pubsub.publish("t", b"x", {"k": "v"})
    pubsub.publish("t", b"y")
    first = pubsub.subscribe("t")
    first.nack(True)
    again = pubsub.subscribe("t")
    again.commit()
    second = pubsub.subscribe("t")
    second.nack(False)
    got = {"published": pubsub.published, "first": (first.topic, first.value, first.metadata),
           "again": (again.value, again.metadata), "second": second.value,
           "drained": pubsub.subscribe("t")}
    assert got == {"published": [("t", b"x", {"k": "v"}), ("t", b"y", {})],
                   "first": ("t", b"x", {"k": "v"}), "again": (b"x", {"k": "v"}),
                   "second": b"y", "drained": None}


FILE_MODULES = (
    "gofr_tpu_torch/datasource/redis/__init__.py", "gofr_tpu_torch/datasource/redis/client.py",
    "gofr_tpu_torch/datasource/redis/memory.py", "gofr_tpu_torch/datasource/file/__init__.py",
    "gofr_tpu_torch/datasource/file/local.py", "gofr_tpu_torch/datasource/file/row_reader.py",
    "gofr_tpu_torch/datasource/file/observability.py",
    "gofr_tpu_torch/datasource/file/object_store.py", "gofr_tpu_torch/datasource/file/gcs.py",
    "gofr_tpu_torch/datasource/file/s3.py", "gofr_tpu_torch/datasource/file/ftp.py",
    "gofr_tpu_torch/datasource/file/ssh_transport.py", "gofr_tpu_torch/datasource/file/sftp.py",
    "gofr_tpu_torch/testutil/object_store_server.py", "gofr_tpu_torch/testutil/ftp_server.py",
    "gofr_tpu_torch/testutil/sftp_server.py", "gofr_tpu_torch/testutil/redis_server.py",
)


def test_redis_and_file_modules_are_checked_and_connect_without_a_card(no_card, tmp_path):
    """The Redis and file datasources, their servers and the file-jobs
    example are among the files the import rules hold. They are host code:
    an ``App`` takes each as its ``redis`` or ``file`` datasource and shows it
    UP in health without a card, and a Redis that is down at boot is DOWN
    health rather than a crash."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.file import FTPFileSystem, LocalFileSystem
    from gofr_tpu_torch.datasource.redis import RedisClient
    from gofr_tpu_torch.testutil import MiniFTPServer, MiniRedisServer

    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(FILE_MODULES) <= files
    path = ROOT / "examples_torch" / "using-file-jobs" / "main.py"
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    redis, ftp = MiniRedisServer(), MiniFTPServer(str(tmp_path / "ftp"))
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"}
    try:
        for fs in (LocalFileSystem(str(tmp_path)), FTPFileSystem(host="127.0.0.1", port=ftp.port,
                                                                 user="gofr", password="secret")):
            app = App(MapConfig(base, use_env=False))
            app.add_datasource("redis", RedisClient(host="127.0.0.1", port=redis.port))
            app.add_datasource("file", fs)
            details = app.container.health()["details"]
            assert details["redis"]["status"] == details["file"]["status"] == "UP", details
            app.container.close()
        redis.close()
        dark = App(MapConfig(base, use_env=False))
        dark.add_datasource("redis", RedisClient(host="127.0.0.1", port=redis.port, timeout=0.5))
        assert dark.container.health()["details"]["redis"]["status"] == "DOWN"
        dark.container.close()
    finally:
        redis.close()
        ftp.close()


STORE_MODULES = (
    "gofr_tpu_torch/datasource/kv/__init__.py", "gofr_tpu_torch/datasource/kv/store.py",
    "gofr_tpu_torch/datasource/kv/dynamodb.py", "gofr_tpu_torch/testutil/dynamodb_server.py",
    "gofr_tpu_torch/datasource/document/__init__.py", "gofr_tpu_torch/datasource/document/bson.py",
    "gofr_tpu_torch/datasource/document/embedded.py",
    "gofr_tpu_torch/datasource/document/mongo.py", "gofr_tpu_torch/testutil/mongo_server.py",
    "gofr_tpu_torch/datasource/widecolumn/__init__.py",
    "gofr_tpu_torch/datasource/widecolumn/cql_wire.py",
    "gofr_tpu_torch/datasource/widecolumn/cassandra.py",
    "gofr_tpu_torch/testutil/cassandra_server.py", "gofr_tpu_torch/datasource/search/__init__.py",
    "gofr_tpu_torch/datasource/search/solr.py", "gofr_tpu_torch/testutil/solr_server.py",
    "gofr_tpu_torch/datasource/timeseries/__init__.py",
)


def test_store_modules_are_checked_and_connect_without_a_card(no_card):
    """The KV, document, wide-column, search and time-series datasources,
    their four fakes and the datastores example are among the files the
    import rules hold. They are host code: an ``App`` takes each wire client
    on its fake, and each embedded store, and shows it UP in health without a
    card; ``ctx.kv_store`` and ``ctx.datasource(...)`` reach them; a
    DynamoDB that is down at boot is DOWN health rather than a crash."""
    import importlib.util

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.context import Context
    from gofr_tpu_torch.datasource.document import new_document_store
    from gofr_tpu_torch.datasource.kv import DynamoDBKVStore
    from gofr_tpu_torch.datasource.search import EmbeddedSearch
    from gofr_tpu_torch.datasource.search.solr import SolrClient
    from gofr_tpu_torch.datasource.timeseries import EmbeddedTimeSeries
    from gofr_tpu_torch.datasource.widecolumn import new_widecolumn_store
    from gofr_tpu_torch.testutil import (MiniCassandraServer, MiniDynamoDBServer,
                                         MiniMongoServer, MiniSolrServer)

    assert len(STORE_MODULES) == 17
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(STORE_MODULES) <= files
    path = ROOT / "examples_torch" / "using-datastores" / "main.py"
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    spec = importlib.util.spec_from_file_location("using_datastores", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dyn, mongo, cas, solr = (MiniDynamoDBServer().start(), MiniMongoServer().start(),
                             MiniCassandraServer().start(), MiniSolrServer())
    base = {"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"}
    try:
        wire = {"MONGO_HOST": "127.0.0.1", "MONGO_PORT": str(mongo.port),
                "CASSANDRA_HOST": "127.0.0.1", "CASSANDRA_PORT": str(cas.port)}
        for values in (wire, {}):
            app = App(MapConfig({**base, **values}, use_env=False))
            conf = app.container.config
            app.add_datasource("kv_store", DynamoDBKVStore(
                "kv", endpoint=dyn.endpoint, access_key=dyn.access_key,
                secret_key=dyn.secret_key))
            app.add_datasource("document", new_document_store(conf))
            app.add_datasource("widecolumn", new_widecolumn_store(conf))
            app.add_datasource("search", example.SolrIndex(SolrClient(solr.url))
                               if values else EmbeddedSearch())
            app.add_datasource("timeseries", EmbeddedTimeSeries())
            details = app.container.health()["details"]
            for family in ("kv_store", "document", "widecolumn", "search", "timeseries"):
                assert details[family]["status"] == "UP", (family, details[family])
            ctx = Context(None, app.container)
            assert ctx.kv_store is app.container.kv_store
            assert ctx.datasource("document").health_check()["details"]["backend"] == (
                "mongo-wire" if values else "embedded-document")
            app.container.close()
        mongo.close()
        dark = App(MapConfig(base, use_env=False))
        dark.add_datasource("kv_store", DynamoDBKVStore("kv", endpoint="http://127.0.0.1:1",
                                                        timeout=0.5))
        assert dark.container.health()["details"]["kv_store"]["status"] == "DOWN"
        dark.container.close()
    finally:
        for server in (dyn, mongo, cas, solr):
            server.close()


ANALYTICS_MODULES = (
    "gofr_tpu_torch/datasource/columnar/__init__.py", "gofr_tpu_torch/datasource/graph/__init__.py",
    "gofr_tpu_torch/datasource/compat.py", "gofr_tpu_torch/testutil/clickhouse_server.py",
    "gofr_tpu_torch/testutil/capture.py", "gofr_tpu_torch/version.py",
    "gofr_tpu_torch/analysis/__init__.py", "gofr_tpu_torch/analysis/__main__.py",
    "gofr_tpu_torch/analysis/core.py", "gofr_tpu_torch/analysis/rules.py",
    "gofr_tpu_torch/analysis/baseline_io.py", "gofr_tpu_torch/analysis/sarif.py",
    "gofr_tpu_torch/analysis/audit.py", "gofr_tpu_torch/analysis/ffi.py",
    "gofr_tpu_torch/analysis/lockorder.py", "gofr_tpu_torch/analysis/lockcheck.py",
)


def test_analytics_modules_are_checked_and_wire_without_a_card(no_card):
    """The columnar, graph and facade datasources, the ClickHouse fake, the
    analyzer and the analytics example and tool are among the files the
    import rules hold. They are host code: an ``App`` takes the ClickHouse
    client on its fake, the graph and the facades, and shows them UP in
    health without a card; the analyzer's modules import no torch of their
    own (it lints a tree, it runs nothing of it) and nothing of JAX or the
    JAX package at run time; the example's routes register on an App
    whose engine is never built here."""
    import importlib.util
    import subprocess
    import sys

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.datasource.columnar import ClickHouseClient
    from gofr_tpu_torch.datasource.compat import CouchbaseFacade, OracleFacade
    from gofr_tpu_torch.datasource.document import EmbeddedDocumentStore
    from gofr_tpu_torch.datasource.graph import EmbeddedGraph
    from gofr_tpu_torch.datasource.sql.sqlite import SQLite
    from gofr_tpu_torch.testutil import MiniClickHouseServer, capture

    assert len(ANALYTICS_MODULES) == 16
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert set(ANALYTICS_MODULES) <= files
    for rel in ("examples_torch/using-analytics/main.py", "tools_torch/analytics_phase.py"):
        bad = {n for n in _imported(ROOT / rel) if n.split(".")[0] in FORBIDDEN}
        assert not bad, f"{rel} imports {sorted(bad)}"
    for rel in ANALYTICS_MODULES:
        if "/analysis/" in rel:
            assert not {n for n in _imported(ROOT / rel) if n.split(".")[0] == "torch"}, rel
    code = ("import sys, gofr_tpu_torch.analysis.__main__, gofr_tpu_torch.analysis.lockcheck; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'gofr_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    spec = importlib.util.spec_from_file_location(
        "using_analytics", ROOT / "examples_torch" / "using-analytics" / "main.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    fake = MiniClickHouseServer()
    try:
        app = App(MapConfig({"HTTP_PORT": "0", "METRICS_PORT": "0", "LOG_LEVEL": "FATAL"},
                            use_env=False))
        app.add_datasource("columnar", ClickHouseClient(fake.url))
        app.add_datasource("graph", EmbeddedGraph())
        app.add_datasource("oracle", OracleFacade(SQLite(":memory:")))
        app.add_datasource("couchbase", CouchbaseFacade(EmbeddedDocumentStore()))
        example.register(app, engine=None)
        details = app.container.health()["details"]
        for name in ("columnar", "graph", "oracle", "couchbase"):
            assert details[name]["status"] == "UP", (name, details[name])
        assert [r[0] for r in fake.rows(
            "SELECT name FROM sqlite_master WHERE type = 'table' ORDER BY name")] == [
            "job_events", "usage"]
        app.container.close()
    finally:
        fake.close()
    assert capture.stdout_output_for_func(lambda: print("hi")) == "hi\n"
