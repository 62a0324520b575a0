"""Weights through the port's file systems (ROADMAP Queue C 51).

The JAX package's loaders read ``fs.open(path, "rb")``, but of its file
systems only the object store's ``open`` takes a mode: its local, FTP and
SFTP ``open(name)`` raise ``TypeError`` under the loaders. The port's file
systems all take ``open(name, mode)`` and have ``exists``, so its loaders
read through each. Here tiny HF-layout checkpoints (a Llama at
``LlamaConfig.tiny`` widths and a Whisper at ``WhisperConfig.tiny``, written
with ``chip_smoke.py``'s own HF writers, with a byte-level BPE tokenizer)
are copied into each port file system (local, local behind
``ObservedFileSystem``, S3 and GCS on the port's ``FakeObjectStore``, FTP on
its ``MiniFTPServer``, SFTP on its ``MiniSFTPServer``) and loaded back:

- ``config_from_hf``/``load_llama_from_hf`` and ``load_whisper_from_hf``
  through each give the configs field for field and the params bit for bit
  of the JAX package's load from the plain path;
- ``ServingEngine.from_hf(path, fs=...)`` gives the same tokenizer and the
  same greedy tokens as ``from_hf`` of the plain path;
- the same calls through the JAX package's ``LocalFileSystem`` raise its
  ``TypeError``."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cryptography")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from gofr_tpu.datasource.file.local import LocalFileSystem as RLocalFileSystem  # noqa: E402
from gofr_tpu.models import hf_import as r_hf  # noqa: E402
from gofr_tpu.models import whisper_import as r_wi  # noqa: E402
from gofr_tpu_torch.datasource.file import (  # noqa: E402
    FTPFileSystem, GCSProvider, LocalFileSystem, ObjectFileSystem, ObservedFileSystem,
    S3Provider, SFTPFileSystem)
from gofr_tpu_torch.models import hf_import as t_hf  # noqa: E402
from gofr_tpu_torch.models import llama, whisper  # noqa: E402
from gofr_tpu_torch.models import whisper_import as t_wi  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.testutil import FakeObjectStore, MiniFTPServer, MiniSFTPServer  # noqa: E402
from gofr_tpu_torch.testutil.assets import bpe_spec, write_bpe_asset  # noqa: E402
from gofr_tpu_torch.testutil.params import perturb_norms_and_biases  # noqa: E402

BACKENDS = ["local", "observed", "s3", "gcs", "ftp", "sftp"]
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n")]
TEXTS = ["the quick brown fox", "in the end"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Plain-path checkpoint directories: ``llama`` (with a tokenizer
    asset) and ``whisper``."""
    root = tmp_path_factory.mktemp("weights")
    gen = torch.Generator().manual_seed(5)
    lcfg = llama.LlamaConfig.tiny(vocab_size=300, max_seq_len=64)
    lparams = llama.init_params(lcfg, gen, device="cpu")
    perturb_norms_and_biases(lparams, gen)
    chip_smoke.write_hf_checkpoint(torch, str(root / "llama"),
                                   *chip_smoke.llama_hf(torch, lcfg, lparams))
    write_bpe_asset(str(root / "llama"), bpe_spec(MERGES),
                    {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"})
    wcfg = whisper.WhisperConfig.tiny()
    wparams = whisper.init_params(wcfg, gen, device="cpu")
    perturb_norms_and_biases(wparams, gen)
    chip_smoke.write_hf_checkpoint(torch, str(root / "whisper"),
                                   *chip_smoke.whisper_hf(torch, wcfg, wparams))
    return {"llama": str(root / "llama"), "whisper": str(root / "whisper")}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {"object": FakeObjectStore(),
           "ftp": MiniFTPServer(str(tmp_path_factory.mktemp("ftp-root"))),
           "sftp": MiniSFTPServer(str(tmp_path_factory.mktemp("sftp-root")))}
    yield out
    for s in out.values():
        s.close()


def _fs(kind: str, servers, tmp_path):
    if kind == "local":
        return LocalFileSystem(str(tmp_path))
    if kind == "observed":
        return ObservedFileSystem(LocalFileSystem(str(tmp_path)))
    fake = servers["object"]
    if kind == "s3":
        return ObjectFileSystem(S3Provider("test-bucket", endpoint=fake.s3_endpoint,
                                           region=fake.region, access_key=fake.access_key,
                                           secret_key=fake.secret_key), name="s3")
    if kind == "gcs":
        return ObjectFileSystem(GCSProvider("test-bucket", endpoint=fake.gcs_endpoint), name="gcs")
    if kind == "ftp":
        return FTPFileSystem(host="127.0.0.1", port=servers["ftp"].port, user="gofr",
                             password="secret")
    return SFTPFileSystem(host="127.0.0.1", port=servers["sftp"].port, user="gofr",
                          password="secret")


@pytest.fixture(params=BACKENDS)
def fs(request, servers, tmp_path):
    f = _fs(request.param, servers, tmp_path)
    f.connect()
    yield f
    f.close()


def put_dir(fs, local_dir: str, name: str) -> None:
    """Copy every file of ``local_dir`` into ``fs`` under ``name``."""
    fs.mkdir(name)
    for fname in sorted(os.listdir(local_dir)):
        with open(os.path.join(local_dir, fname), "rb") as src, \
                fs.open(f"{name}/{fname}", "wb") as dst:
            dst.write(src.read())


def _bits(x) -> tuple:
    if isinstance(x, torch.Tensor):
        arr = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
        name = str(x.dtype).removeprefix("torch.")
    else:
        arr = np.asarray(jax.device_get(x))
        name = arr.dtype.name
        arr = arr.view(np.int16) if name == "bfloat16" else arr
    return tuple(arr.shape), name, np.ascontiguousarray(arr).tobytes()


def assert_same_tree(port: dict, ref: dict, where: str = "") -> int:
    assert set(port) == set(ref), (where, sorted(port), sorted(ref))
    n = 0
    for key, want in ref.items():
        if isinstance(want, dict):
            n += assert_same_tree(port[key], want, f"{where}/{key}")
        else:
            assert _bits(port[key]) == _bits(want), f"{where}/{key}"
            n += 1
    return n


def _fields(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_llama_loads_through_each_file_system_bit_identical(fs, ckpts, dtype):
    put_dir(fs, ckpts["llama"], "ckpt")
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rcfg, rparams = r_hf.load_llama_from_hf(ckpts["llama"], dtype=jd)
    assert _fields(t_hf.config_from_hf("ckpt", fs)) == _fields(r_hf.config_from_hf(ckpts["llama"]))
    tcfg, tparams = t_hf.load_llama_from_hf("ckpt", fs=fs, dtype=td, device="cpu")
    assert _fields(tcfg) == _fields(rcfg) and tcfg.dtype == td
    assert assert_same_tree(tparams, rparams) == 3 + 9


def test_whisper_loads_through_each_file_system_bit_identical(fs, ckpts):
    put_dir(fs, ckpts["whisper"], "asr")
    rcfg, rparams = r_wi.load_whisper_from_hf(ckpts["whisper"], dtype=jnp.float32)
    tcfg, tparams = t_wi.load_whisper_from_hf("asr", fs=fs, dtype=torch.float32, device="cpu")
    assert _fields(tcfg) == _fields(rcfg)
    assert assert_same_tree(tparams, rparams) > 20


def test_from_hf_through_each_file_system_serves_like_the_plain_path(fs, ckpts):
    put_dir(fs, ckpts["llama"], "ckpt")
    conf = EngineConfig(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32),
                        kv_layout="paged", kv_page_size=8, prefill_chunk_tokens=32)
    through = ServingEngine.from_hf("ckpt", fs=fs, engine_config=conf, device="cpu")
    plain = ServingEngine.from_hf(ckpts["llama"], engine_config=conf, device="cpu")
    assert type(through.tokenizer).__name__ == "BPETokenizer"
    for text in TEXTS:
        assert through.tokenizer.encode(text) == plain.tokenizer.encode(text)
    got = {}
    for name, eng in (("fs", through), ("plain", plain)):
        eng.start()
        try:
            got[name] = [eng.submit(t, max_new_tokens=6, temperature=0.0).result(60).token_ids
                         for t in TEXTS]
        finally:
            eng.stop()
    assert got["fs"] == got["plain"] and all(len(t) == 6 for t in got["fs"])


def test_the_references_local_file_system_raises_type_error_under_the_loaders(ckpts, tmp_path):
    """The probe of Queue C 51: ``config_from_hf(".", LocalFileSystem(d))``,
    on either package's loader, over the JAX package's file system."""
    ref_fs = RLocalFileSystem(ckpts["llama"])
    for loader in (r_hf.config_from_hf, t_hf.config_from_hf):
        with pytest.raises(TypeError, match="takes 2 positional arguments but 3 were given"):
            loader(".", ref_fs)
    with pytest.raises(TypeError, match="positional arguments"):
        r_wi.load_whisper_from_hf(".", fs=RLocalFileSystem(ckpts["whisper"]))
    port_fs = LocalFileSystem(ckpts["llama"])
    assert _fields(t_hf.config_from_hf(".", port_fs)) == _fields(r_hf.config_from_hf(ckpts["llama"]))
