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
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "gofr_tpu")


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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


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
            f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


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
