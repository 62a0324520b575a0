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
