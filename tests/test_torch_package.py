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
        params_from_jax({"w": torch.zeros(2).numpy()})


def test_cpu_engine_run_launches_no_kernel():
    """bf16 and int8 engines, a monolithic and a chunked prompt each: the
    plain versions run on the CPU and no counter moves."""
    flash_attention.launches = paged_decode_attention.launches = 0
    paged_decode_attention_q.launches = 0
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, device="cpu")
    for kv_dtype in ("bf16", "int8"):
        engine = ServingEngine(cfg, params,
                               EngineConfig(max_slots=2, max_seq_len=32, prefill_buckets=(16,),
                                            kv_page_size=8, prefill_chunk_tokens=8,
                                            kv_dtype=kv_dtype), device="cpu")
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
