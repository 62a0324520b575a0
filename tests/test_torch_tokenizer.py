"""The port's tokenizers (``gofr_tpu_torch/tokenizer/``) beside the JAX
package's: a byte-level BPE trained by the ``tokenizers`` wheel (GPT-2
pattern), a Llama-3-pattern BPE asset written from code, and the
hand-built SentencePiece protobuf (unigram and BPE modes). Over a seeded
corpus of letters, marks and digits of several scripts, punctuation,
symbols, CR/LF runs, contractions in both cases and special tokens, the
ids are identical and the decode round trip holds. The pre-tokenizer runs
on the standard library's ``re`` (the reference's on ``regex``): its
translated classes match ``regex``'s on every code point Python's tables
assign, and an unsupported ``\\p{..}`` raises. ``load_tokenizer`` by path
and through a file datasource."""

import functools
import io
import os
import re
import struct
import sys
import unicodedata

import numpy as np
import pytest

regex = pytest.importorskip("regex")

from gofr_tpu import tokenizer as rtok  # noqa: E402
from gofr_tpu.tokenizer import bpe as rbpe  # noqa: E402
from gofr_tpu_torch import tokenizer as ttok  # noqa: E402
from gofr_tpu_torch.testutil.assets import bpe_spec, write_bpe_asset  # noqa: E402
from gofr_tpu_torch.tokenizer import bpe as tbpe  # noqa: E402

SPECIALS = ("<|begin_of_text|>", "<|end_of_text|>")
POOLS = {
    "latin": "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ",
    "accented": "éèàùçñöüßøåÆŒĳſ",
    "greek": "αβγδεζηθλμπσωΑΒΓΔΩ",
    "cyrillic": "абвгдежзийклмнопрстуфхцчшщыэюяАБВГД",
    "cjk": "東京大阪日本語中文字漢",
    "kana": "ひらがなカタカナー",
    "arabic": "مرحبابالعالم",
    "hebrew": "שלוםעולם",
    "devanagari": "नमस्तेदुनिया",
    "thai": "สวัสดีชาวโลก",
    "marks": "̧́̈̃⃝ः",
    "digits": "0123456789",
    "other_digits": "٠١٢٣٤٥٦٧٨٩०१२३४५६७८९๐๑๒๓௧௨௩²³½ⅫⅧ𝟘𝟙",
    "punct": ".,;:!?\"'()[]{}-_/\\@#%&*«»¿¡…",
    "symbols": "$€£¥©®™°±×÷→←∑∞≈≠≤≥♠♥★☆🚀🔥😀👍🏽",
}
TOKENS = {
    "spaces": [" ", "  ", "\t", " ", "　", " ", "\x1c", " \t "],
    "newlines": ["\n", "\r\n", "\r\n\r\n", "\n\n\n", "\r", " \n ", "\r\r\n"],
    "contractions": ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'T", "'RE", "'Ve",
                     "'M", "'LL", "'D", "n't", "N'T", "don't", "I'M"],
}
SAMPLES = [
    "Hello, world!", "The quick brown fox jumps over 1337 lazy dogs.",
    "  leading spaces and\nnewlines\t\ttabs", "unicode: caffè, naïve, 東京, emoji 🚀🔥",
    "don't stop'n believin'", "x = (a + b) * c / d - e % f", "", "a", "12345678901",
    "line\r\n\r\nbreaks\n\n  trailing  ", "<|begin_of_text|>hello<|end_of_text|>",
    "<|bos|>hello world<|eos|> <|bos|>",
]


def corpus(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    pools = list(POOLS.values())
    out = []
    for _ in range(n):
        parts = []
        for _ in range(int(rng.integers(1, 14))):
            kind = rng.random()
            if kind < 0.55:
                pool = pools[int(rng.integers(len(pools)))]
                parts.append("".join(pool[int(i)] for i in rng.integers(0, len(pool),
                                                                        int(rng.integers(1, 9)))))
            elif kind < 0.9:
                group = list(TOKENS.values())[int(rng.integers(len(TOKENS)))]
                parts.append(group[int(rng.integers(len(group)))])
            else:
                parts.append(SPECIALS[int(rng.integers(len(SPECIALS)))])
        sep = " " if rng.random() < 0.6 else ""
        out.append(sep.join(parts))
    return out


CORPUS = SAMPLES + corpus(0, 160)
MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("a", "n"), ("Ġ", "a"),
          ("o", "n"), ("r", "e"), ("1", "2"), ("12", "3"), ("Ġ", "w"), ("o", "r"), ("Ġw", "or"),
          ("l", "d"), ("Ġwor", "ld"), ("'", "s"), ("Ċ", "Ċ"), ("ĠĠ", "ĠĠ"), ("Ġ", "Ġ"),
          ("æ", "Ŀ"), ("c", "a"), ("ca", "f")]


# ----------------------------------------------------------------- assets
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A byte-level BPE trained with the ``tokenizers`` wheel, as the JAX
    package's own test trains it, loaded by both packages."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|bos|>", "<|eos|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
    )
    tok.train_from_iterator(["the quick brown fox jumps over the lazy dog",
                             "hello world, hello tokenizers, hello bpe",
                             "numbers 0123456789 and symbols !@#$%^&*()",
                             "don't won't can't shouldn't", "unicode caffè naïve 東京 🚀"] * 4,
                            trainer)
    path = tmp_path_factory.mktemp("bpe") / "tokenizer.json"
    tok.save(str(path))
    return rbpe.BPETokenizer.from_file(str(path)), tbpe.BPETokenizer.from_file(str(path))


@pytest.fixture(scope="module")
def llama3(tmp_path_factory):
    """A Llama-3-pattern asset written from code, with a tokenizer_config
    naming bos and eos, loaded by both packages."""
    d = tmp_path_factory.mktemp("llama3")
    path = write_bpe_asset(str(d), bpe_spec(MERGES),
                           {"bos_token": "<|begin_of_text|>",
                            "eos_token": {"content": "<|end_of_text|>"}})
    return rbpe.BPETokenizer.from_file(path), tbpe.BPETokenizer.from_file(path), str(d)


def _sp_piece(piece: str, score: float, ptype: int) -> bytes:
    data = piece.encode("utf-8")
    body = bytes([0x0A, len(data)]) + data + bytes([0x15]) + struct.pack("<f", score)
    body += bytes([0x18, ptype])
    return bytes([0x0A, len(body)]) + body


def build_spm_model(model_type: int = 1) -> bytes:
    """A SentencePiece ModelProto by hand (the JAX package's test model)."""
    normal, unknown, control, byte = 1, 2, 3, 6
    pieces = [("<unk>", 0.0, unknown), ("<s>", 0.0, control), ("</s>", 0.0, control),
              ("▁", -2.0, normal), ("▁hello", -1.0, normal), ("▁world", -1.2, normal),
              ("▁he", -3.0, normal), ("llo", -3.1, normal)]
    pieces += [(c, -5.0, normal) for c in "helowrd"]
    pieces += [("▁h", -4.0, normal), ("ll", -4.5, normal)]
    pieces += [(f"<0x{b:02X}>", -20.0, byte) for b in range(256)]
    blob = b"".join(_sp_piece(p, s, t) for p, s, t in pieces)
    trainer = bytes([0x18, model_type, 0xC0, 0x02, 0, 0xC8, 0x02, 1, 0xD0, 0x02, 2])
    return blob + bytes([0x12, len(trainer)]) + trainer


# ----------------------------------------------------------------- BPE
def _special_ids(tok) -> tuple:
    return tok.bos_id, tok.eos_id, tok.pad_id, tok.vocab_size


@pytest.mark.parametrize("asset", ["trained", "llama3"])
def test_bpe_encode_is_identical_and_round_trips(asset, request):
    ref, port = request.getfixturevalue(asset)[:2]
    assert _special_ids(port) == _special_ids(ref)
    for text in CORPUS:
        ids = port.encode(text)
        assert ids == ref.encode(text), repr(text)
        assert port.decode(ids) == ref.decode(ids)
        specials = [t for t in (*SPECIALS, "<|bos|>", "<|eos|>") if t in port.special_tokens]
        want = text
        for t in specials:
            want = want.replace(t, "")
        assert port.decode(ids) == want, repr(text)


def test_bpe_pretokenizer_splits_as_regex_does():
    """The words the pre-tokenizer finds, for both patterns, over the corpus."""
    for pattern in (tbpe.LLAMA3_PATTERN, tbpe.GPT2_PATTERN):
        ours, theirs = tbpe.compile_pattern(pattern), regex.compile(pattern)
        for text in CORPUS:
            assert ours.findall(text) == theirs.findall(text), (pattern, text)


def test_bpe_llama3_asset_names_its_specials(llama3):
    ref, port, _ = llama3
    assert port.bos_id == port.special_tokens["<|begin_of_text|>"] == ref.bos_id
    assert port.eos_id == port.special_tokens["<|end_of_text|>"] == ref.eos_id
    ids = port.encode("<|begin_of_text|>the world<|end_of_text|>")
    assert ids[0] == port.bos_id and ids[-1] == port.eos_id
    assert port.encode("the world", add_bos=True) == ref.encode("the world", add_bos=True)
    assert port.encode(" the world") == [port.vocab["Ġthe"], port.vocab["Ġworld"]]


@functools.cache
def _assigned_text() -> str:
    """Every code point Python's Unicode tables assign, surrogates aside."""
    return "".join(chr(c) for c in range(0x110000)
                   if unicodedata.category(chr(c)) not in ("Cn", "Cs"))


@pytest.mark.parametrize("cls", [r"\p{L}", r"\p{N}", r"\P{L}", r"\pN", r"\s", r"\S",
                                 r"[^\s\p{L}\p{N}]", r"[^\r\n\p{L}\p{N}]", r"[\P{N}x]",
                                 r"[]\p{N}]", r"[^]\s]"])
def test_translated_classes_match_regex_on_every_assigned_code_point(cls):
    text = _assigned_text()
    assert re.findall(tbpe.translate_pattern(cls), text) == regex.findall(cls, text)


@pytest.mark.parametrize("pattern,name", [(r"\p{Lu}+", "Lu"), (r"[\p{M}a]", "M"),
                                          (r"\p{Han}", "Han"), (r"\P{Nd}", "Nd"), (r"\pM", "M")])
def test_an_unsupported_property_class_raises_with_its_name(pattern, name):
    with pytest.raises(ValueError, match=re.escape(f"\\p{{{name}}}")):
        tbpe.BPETokenizer({"a": 0}, [], pattern=pattern)


# ----------------------------------------------------------------- SentencePiece
@pytest.mark.parametrize("model_type", [1, 2], ids=["unigram", "bpe"])
def test_spm_encode_is_identical_and_decodes_alike(model_type):
    blob = build_spm_model(model_type)
    ref = rtok.SentencePieceTokenizer.from_bytes(blob)
    port = ttok.SentencePieceTokenizer.from_bytes(blob)
    assert (port.unk_id, port.bos_id, port.eos_id, port.pad_id, port.vocab_size) == \
        (ref.unk_id, ref.bos_id, ref.eos_id, ref.pad_id, ref.vocab_size)
    for text in CORPUS + ["hello world", "world hello hello", "hello 東"]:
        ids = port.encode(text)
        assert ids == ref.encode(text), repr(text)
        assert port.decode(ids) == ref.decode(ids)
        if not text.startswith(" "):  # the dummy prefix takes one leading space
            assert port.decode(ids) == text, repr(text)
    if model_type == 1:  # Viterbi: ▁hello + ▁world beats ▁he + llo + ...
        assert port.encode("hello world") == [4, 5]
    assert port.decode([1, 4, 2]) == "hello"


# ----------------------------------------------------------------- load_tokenizer
class DictFS:
    """A file datasource over a dict of path -> bytes (``open``/``exists``)."""

    def __init__(self, files: dict[str, bytes]):
        self.files = files

    def exists(self, path: str) -> bool:
        return path in self.files

    def open(self, path: str, mode: str = "rb"):
        if path not in self.files:
            raise FileNotFoundError(path)
        return io.BytesIO(self.files[path])


def test_load_tokenizer_by_path_matches_reference(llama3, tmp_path):
    _, _, directory = llama3
    spm_dir = tmp_path / "spm"
    spm_dir.mkdir()
    (spm_dir / "tokenizer.model").write_bytes(build_spm_model())
    cases = [directory, os.path.join(directory, "tokenizer.json"), str(spm_dir),
             str(spm_dir / "tokenizer.model")]
    for path in cases:
        ref, port = rtok.load_tokenizer(path), ttok.load_tokenizer(path)
        assert type(port).__name__ == type(ref).__name__
        assert type(port).__module__.startswith("gofr_tpu_torch.tokenizer")
        assert _special_ids(port) == _special_ids(ref)
        for text in CORPUS[:40]:
            assert port.encode(text) == ref.encode(text)
    empty = tmp_path / "empty"
    empty.mkdir()
    for loader in (rtok.load_tokenizer, ttok.load_tokenizer):
        with pytest.raises(FileNotFoundError):
            loader(str(empty))


def test_load_tokenizer_through_a_file_datasource(llama3):
    _, port_direct, directory = llama3
    files = {}
    for name in ("tokenizer.json", "tokenizer_config.json"):
        with open(os.path.join(directory, name), "rb") as f:
            files[f"bucket/tok/{name}"] = f.read()
    files["bucket/spm/tokenizer.model"] = build_spm_model(2)
    fs = DictFS(files)
    for path in ("bucket/tok", "bucket/tok/tokenizer.json", "bucket/spm"):
        ref, port = rtok.load_tokenizer(path, fs=fs), ttok.load_tokenizer(path, fs=fs)
        assert type(port).__name__ == type(ref).__name__
        assert _special_ids(port) == _special_ids(ref)
        for text in CORPUS[:40]:
            assert port.encode(text) == ref.encode(text)
    assert ttok.load_tokenizer("bucket/tok", fs=fs).encode(CORPUS[3]) == \
        port_direct.encode(CORPUS[3])
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer("bucket/none", fs=fs)


def test_the_port_imports_no_regex():
    """The port's BPE module compiles with ``re``; ``regex`` never loads in
    a fresh interpreter that imports it and encodes."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from gofr_tpu_torch.tokenizer import BPETokenizer\n"
            "from gofr_tpu_torch.testutil.assets import bpe_spec\n"
            "tok = BPETokenizer.from_spec(bpe_spec([('h', 'e')]))\n"
            "assert tok.decode(tok.encode('hello 東京 12345')) == 'hello 東京 12345'\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('regex', 'tokenizers', 'transformers', 'jax', 'gofr_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
