"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded through ``ctypes``. The
library lands in ``gofr_tpu_torch/_build/`` (ignored by git) under a name
that carries the hash of its source and flags, so an edited source
rebuilds on first use and an unchanged one loads at once. Nothing here
runs at import: the CPU tests import every module of the port on machines
that have no ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all,
so the build costs as long as the slowest file, not the sum; the first
``library()`` call runs it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

# C signatures of the entry points each library exports: (name, argtypes).
# Every pointer and the stream are c_void_p; each entry returns the
# cudaError_t of its launch as an int.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES: dict[str, list[tuple[str, list]]] = {
    "flash_attention": [
        # q, k, v, kv_len, out, B, Sq, Sk, H, Hkv, D, scale, causal, stream
        ("gofr_flash_attention_bf16",
         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]),
    ],
    "paged_attention": [
        # q, k_pool, v_pool, block_tables, seq_lens, out, part (f32
        # scratch), counters (int32, zero between launches),
        # B, H, Hkv, Dh, page, n_pool_pages, max_pages, pages_per_split,
        # scale, stream
        ("gofr_paged_decode_bf16",
         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
        # q, k_pool, v_pool (int8), k_scale, v_scale (f32), block_tables,
        # seq_lens, out, part, counters, B, H, Hkv, Dh, page, n_pool_pages,
        # max_pages, pages_per_split, scale, stream
        ("gofr_paged_decode_int8",
         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P]),
    ],
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels build from source on the machine with the card"
        )
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is current."""
    so = _target(name)
    if so.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file


def _open(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_target(name)))
    for fn, argtypes in SIGNATURES[name]:
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def build_all() -> None:
    """Compile every kernel source in parallel (one nvcc each) and load them."""
    with _lock:
        names = [n for n in SIGNATURES if n not in _loaded]
        jobs = {n: _start(n) for n in names}
        errors = []
        for n, job in jobs.items():  # wait for every nvcc, even after a failure
            if job is not None:
                try:
                    _finish(n, job)
                except RuntimeError as exc:
                    errors.append(exc)
        if errors:
            raise errors[0]
        for n in names:
            _loaded[n] = _open(n)


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``; the first call builds
    and loads every kernel (``build_all``)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = _loaded[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise on a failed launch: a kernel the CUDA runtime refused never ran,
    and a later synchronize would not report it."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
