"""The port's checkpoint loaders (``gofr_tpu_torch/models/hf_import.py``,
``models/whisper_import.py``) and ``ServingEngine.from_hf`` beside the JAX
package's, over files the test writes itself: tiny HF Llamas (untied, with
round-to-even ties and subnormals in an f32 weight, and tied) and a tiny
HF Whisper saved by ``transformers``, a sharded index and a BF16 file
written with the ``safetensors`` wheel. ``SafetensorsFile`` reads the
reference's tensors, ``config_from_hf``/``whisper_config_from_hf`` agree
field for field, loaded params agree bit for bit (f32 as stored, f32 cast
to bf16, bf16 as stored, through a file datasource), ``from_hf`` engines
give identical greedy tokens with a tokenizer asset and without one, a
missing tensor is a ``KeyError`` naming it, and ``sharding=`` is refused."""

import dataclasses
import io
import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

import jax.numpy as jnp  # noqa: E402

from gofr_tpu.models import hf_import as r_hf  # noqa: E402
from gofr_tpu.models import whisper_import as r_wi  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu_torch.models import hf_import as t_hf  # noqa: E402
from gofr_tpu_torch.models import whisper_import as t_wi  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.testutil.assets import bpe_spec, write_bpe_asset  # noqa: E402
from gofr_tpu_torch.testutil.params import perturb_norms_and_biases  # noqa: E402

ENGINE = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32), kv_layout="dense",
              prefill_chunk_tokens=32)
PROMPTS = ["the quick brown fox", "hello there", "<|begin_of_text|>the end"]
TIES = [1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3 * 2 ** -130, -(2 ** -133), 0.0, -0.0,
        65504.0, 1e-45, 3.3895314e38]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _hf_llama(path, tie: bool, seed: int):
    from transformers import LlamaConfig as HFConfig
    from transformers import LlamaForCausalLM

    torch.manual_seed(seed)
    hf_cfg = HFConfig(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                      rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
                      attn_implementation="eager")
    model = LlamaForCausalLM(hf_cfg).eval()
    perturb_norms_and_biases(dict(model.named_parameters()), torch.Generator().manual_seed(seed))
    with torch.no_grad():  # ties to even, subnormals, signed zeros, the bf16 edge
        model.model.layers[0].self_attn.q_proj.weight[0, :len(TIES)] = torch.tensor(TIES)
        model.model.norm.weight.uniform_(0.5, 1.5)
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Checkpoint directories: untied f32, tied f32, untied sharded f32,
    untied BF16, and one missing a tensor."""
    root = tmp_path_factory.mktemp("hf")
    out = {"untied": _hf_llama(root / "untied", tie=False, seed=0),
           "tied": _hf_llama(root / "tied", tie=True, seed=1)}
    tensors = safetensors_torch.load_file(os.path.join(out["untied"], "model.safetensors"))
    names = sorted(tensors)
    sharded = root / "sharded"
    sharded.mkdir()
    shutil.copy(os.path.join(out["untied"], "config.json"), sharded / "config.json")
    weight_map = {}
    for i, part in enumerate((names[::2], names[1::2])):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        safetensors_torch.save_file({n: tensors[n] for n in part}, str(sharded / fname))
        weight_map.update({n: fname for n in part})
    (sharded / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": weight_map}))
    out["sharded"] = str(sharded)
    bf16 = root / "bf16"
    bf16.mkdir()
    shutil.copy(os.path.join(out["untied"], "config.json"), bf16 / "config.json")
    safetensors_torch.save_file({n: t.to(torch.bfloat16) for n, t in tensors.items()},
                                str(bf16 / "model.safetensors"), metadata={"format": "pt"})
    out["bf16"] = str(bf16)
    missing = root / "missing"
    missing.mkdir()
    shutil.copy(os.path.join(out["untied"], "config.json"), missing / "config.json")
    safetensors_torch.save_file({n: t for n, t in tensors.items()
                                 if n != "model.layers.1.mlp.up_proj.weight"},
                                str(missing / "model.safetensors"))
    out["missing"] = str(missing)
    return out


@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    from transformers import WhisperConfig as HFWhisperConfig
    from transformers import WhisperForConditionalGeneration

    torch.manual_seed(11)
    hf_cfg = HFWhisperConfig(vocab_size=96, num_mel_bins=16, d_model=32, encoder_layers=2,
                             decoder_layers=2, encoder_attention_heads=4,
                             decoder_attention_heads=4, encoder_ffn_dim=64, decoder_ffn_dim=64,
                             max_source_positions=24, max_target_positions=16,
                             decoder_start_token_id=1, eos_token_id=2, pad_token_id=0,
                             activation_function="gelu", attn_implementation="eager")
    model = WhisperForConditionalGeneration(hf_cfg).eval()
    # transformers' init leaves every bias 0 and every LayerNorm 1 and 0
    perturb_norms_and_biases(dict(model.named_parameters()), torch.Generator().manual_seed(11))
    path = tmp_path_factory.mktemp("whisper")
    model.save_pretrained(str(path), safe_serialization=True)
    return str(path)


def _bits(x) -> tuple:
    """(shape, dtype name, raw bytes) of a tensor or array; bf16 as its bits."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).removeprefix("torch.")
        arr = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    else:
        arr = np.asarray(x)
        name = arr.dtype.name
        arr = arr.view(np.int16) if name == "bfloat16" else arr
    return tuple(arr.shape), name, np.ascontiguousarray(arr).tobytes()


def assert_same_tree(port: dict, ref: dict, where: str = "") -> int:
    """Every leaf bit for bit, the same keys at every level; returns the
    number of leaves."""
    assert set(port) == set(ref), (where, sorted(port), sorted(ref))
    n = 0
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, dict):
            n += assert_same_tree(got, want, f"{where}/{key}")
            continue
        assert got.device.type == "cpu"
        gs, gd, gb = _bits(got)
        ws, wd, wb = _bits(jax.device_get(want))
        assert (gs, gd) == (ws, wd), (f"{where}/{key}", gs, gd, ws, wd)
        assert gb == wb, f"{where}/{key} differs"
        n += 1
    return n


def test_safetensors_file_reads_the_reference_tensors(ckpts):
    for d in (ckpts["untied"], ckpts["bf16"]):
        path = os.path.join(d, "model.safetensors")
        ref, port = r_hf.SafetensorsFile.open(path), t_hf.SafetensorsFile.open(path)
        assert port.names() == ref.names()
        for name in ref.names():
            assert _bits(port.tensor(name)) == _bits(ref.tensor(name)), name
    with open(path, "rb") as f:
        data = f.read()
    from_bytes = t_hf.SafetensorsFile(data)
    assert all(torch.equal(from_bytes.tensor(n), port.tensor(n)) for n in port.names())


def test_safetensors_file_refuses_an_unknown_dtype():
    header = json.dumps({"x": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    blob = len(header).to_bytes(8, "little") + header.encode() + b"\x00\x00"
    with pytest.raises(ValueError, match="F8_E4M3"):
        t_hf.SafetensorsFile(blob).tensor("x")


@pytest.mark.parametrize("name", ["untied", "tied"])
def test_config_from_hf_matches_reference_field_for_field(ckpts, name):
    ref, port = r_hf.config_from_hf(ckpts[name]), t_hf.config_from_hf(ckpts[name])
    ref_fields = {k: v for k, v in dataclasses.asdict(ref).items() if k != "dtype"}
    port_fields = {k: v for k, v in dataclasses.asdict(port).items() if k != "dtype"}
    assert port_fields == ref_fields
    assert port.tie_embeddings is (name == "tied") and port.dtype == torch.bfloat16
    over = t_hf.config_from_hf(ckpts[name], max_seq_len=32)
    assert over.max_seq_len == r_hf.config_from_hf(ckpts[name], max_seq_len=32).max_seq_len == 32


CASES = [("untied", "f32"), ("untied", "bf16"), ("tied", "f32"), ("tied", "bf16"),
         ("sharded", "f32"), ("bf16", None), ("bf16", "f32")]


@pytest.mark.parametrize("name,dtype", CASES, ids=[f"{n}-{d}" for n, d in CASES])
def test_loaded_llama_params_are_bit_identical(ckpts, name, dtype):
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16, None: None}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16, None: None}[dtype]
    rcfg, rparams = r_hf.load_llama_from_hf(ckpts[name], dtype=jd)
    tcfg, tparams = t_hf.load_llama_from_hf(ckpts[name], dtype=td, device="cpu")
    assert tcfg.dtype == (td or torch.bfloat16)
    assert ("lm_head" in tparams) is (name != "tied")
    assert assert_same_tree(tparams, rparams) == (3 if name != "tied" else 2) + 9


def test_bf16_cast_rounds_to_nearest_even(ckpts):
    """The f32 ties, subnormals and signed zeros of layer 0's q_proj row 0
    cast to bf16 as ``ml_dtypes`` casts them."""
    import ml_dtypes

    _, tparams = t_hf.load_llama_from_hf(ckpts["untied"], dtype=torch.bfloat16, device="cpu")
    got = tparams["layers"]["wq"][0, :len(TIES), 0].view(torch.int16).numpy()
    want = np.asarray(TIES, np.float32).astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(1.0).view(np.int32) >> 16  # 1 + 2^-8 ties down to 1.0


class DictFS:
    """A file datasource over a dict of path -> bytes (``open``/``exists``)."""

    def __init__(self, root: str):
        self.files = {}
        for name in os.listdir(root):
            with open(os.path.join(root, name), "rb") as f:
                self.files[f"store/{name}"] = f.read()

    def exists(self, path: str) -> bool:
        return path in self.files

    def open(self, path: str, mode: str = "rb"):
        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])


@pytest.mark.parametrize("name", ["untied", "sharded"])
def test_load_through_a_file_datasource(ckpts, name):
    fs = DictFS(ckpts[name])
    _, rparams = r_hf.load_llama_from_hf("store", fs=fs, dtype=jnp.float32)
    cfg, tparams = t_hf.load_llama_from_hf("store", fs=fs, dtype=torch.float32, device="cpu")
    assert cfg.n_layers == 2
    assert_same_tree(tparams, rparams)


def test_a_missing_tensor_is_a_key_error_naming_it(ckpts):
    for loader, kw in ((r_hf.load_llama_from_hf, {}), (t_hf.load_llama_from_hf,
                                                        {"device": "cpu"})):
        with pytest.raises(KeyError, match=r"model\.layers\.1\.mlp\.up_proj\.weight"):
            loader(ckpts["missing"], **kw)
    with pytest.raises(FileNotFoundError):
        t_hf.load_llama_from_hf(os.path.dirname(ckpts["missing"]), device="cpu",
                                cfg=t_hf.config_from_hf(ckpts["missing"]))


def test_sharding_is_refused(ckpts):
    """``sharding=`` takes placements (a mesh of ranks loads each rank's
    slices: ``test_torch_parallel.py``): on a one-rank mesh a replicated
    placement loads the reference's tree; anything else raises. The
    engine's refusal covers a value that is not a placement and a placement
    that splits the weights (the tensor-parallel engine)."""
    import types

    from gofr_tpu_torch.parallel import build_mesh, named_sharding
    from gofr_tpu_torch.parallel.sharding import NamedSharding, P

    with pytest.raises(TypeError, match="NamedSharding"):
        t_hf.load_llama_from_hf(ckpts["untied"], sharding=object(), device="cpu")
    with pytest.raises(TypeError, match="NamedSharding"):
        ServingEngine.from_hf(ckpts["untied"], sharding=object(), device="cpu")
    tp2 = NamedSharding(types.SimpleNamespace(shape={"dp": 1, "fsdp": 1, "pp": 1, "sp": 1,
                                                     "ep": 1, "tp": 2}), P("tp"))
    with pytest.raises(NotImplementedError, match="tensor-parallel engine"):
        ServingEngine.from_hf(ckpts["untied"], sharding=tp2, device="cpu")
    _, rparams = r_hf.load_llama_from_hf(ckpts["untied"], dtype=jnp.float32)
    _, tparams = t_hf.load_llama_from_hf(ckpts["untied"], dtype=torch.float32, device="cpu",
                                         sharding=named_sharding(build_mesh()))
    assert_same_tree(tparams, rparams)


# ----------------------------------------------------------------- Whisper
def test_whisper_config_from_hf_matches_reference(whisper_ckpt):
    ref, port = r_wi.whisper_config_from_hf(whisper_ckpt), t_wi.whisper_config_from_hf(whisper_ckpt)
    assert ({k: v for k, v in dataclasses.asdict(port).items() if k != "dtype"}
            == {k: v for k, v in dataclasses.asdict(ref).items() if k != "dtype"})
    assert port.sot_id == 1 and port.eot_id == 2 and port.n_mels == 16


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loaded_whisper_params_are_bit_identical(whisper_ckpt, dtype):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    rcfg, rparams = r_wi.load_whisper_from_hf(whisper_ckpt, dtype=jd)
    tcfg, tparams = t_wi.load_whisper_from_hf(whisper_ckpt, dtype=td, device="cpu")
    assert tcfg.dtype == td and tcfg.max_text_len == rcfg.max_text_len == 16
    assert assert_same_tree(tparams, rparams) == 10 + 15 + 24
    assert tuple(tparams["conv1"].shape) == (3, 16, 32)


# ----------------------------------------------------------------- from_hf engines
def _tokens(engine, prompts, n: int = 8) -> list[list[int]]:
    engine.start()
    try:
        futs = [engine.submit(p, max_new_tokens=n) for p in prompts]
        return [f.result(timeout=120).token_ids for f in futs]
    finally:
        engine.stop()


@pytest.mark.parametrize("with_asset", [True, False], ids=["tokenizer-json", "byte-fallback"])
def test_from_hf_engines_give_identical_greedy_tokens(ckpts, tmp_path, with_asset):
    d = tmp_path / "ckpt"
    shutil.copytree(ckpts["untied"], d)
    if with_asset:
        write_bpe_asset(str(d), bpe_spec([("h", "e"), ("Ġ", "t"), ("Ġt", "he")]),
                        {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"})
    ref = JServingEngine.from_hf(str(d), dtype=jnp.float32, engine_config=JEngineConfig(**ENGINE))
    port = ServingEngine.from_hf(str(d), dtype=torch.float32,
                                 engine_config=EngineConfig(**ENGINE), device="cpu")
    want_kind = "BPETokenizer" if with_asset else "ByteTokenizer"
    assert type(ref.tokenizer).__name__ == type(port.tokenizer).__name__ == want_kind
    assert type(port.tokenizer).__module__.startswith("gofr_tpu_torch.")
    for p in PROMPTS:
        assert port.tokenizer.encode(p) == ref.tokenizer.encode(p)
    got, want = _tokens(port, PROMPTS), _tokens(ref, PROMPTS)
    assert got == want
    assert all(len(t) > 0 for t in got)
