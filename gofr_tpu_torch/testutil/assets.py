"""Small tokenizer assets written from code, for tests and the card's smoke
run (nothing is downloaded): a byte-level BPE ``tokenizer.json`` in the HF
layout whose vocabulary is the 256 byte symbols, the given merges and the
given special tokens."""

from __future__ import annotations

import json
import os

from gofr_tpu_torch.tokenizer.bpe import LLAMA3_PATTERN, bytes_to_unicode


def bpe_spec(merges: list[tuple[str, str]], *, pattern: str = LLAMA3_PATTERN,
             special_tokens: tuple[str, ...] = ("<|begin_of_text|>", "<|end_of_text|>")) -> dict:
    """A parsed ``tokenizer.json``: byte symbols are ids 0..255 (in byte
    order), each merge's result the next id, then the special tokens; the
    pre-tokenizer is a Split on ``pattern`` before the byte-level map, as
    Llama-3's asset has it."""
    vocab = {ch: b for b, ch in sorted(bytes_to_unicode().items())}
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    added = [{"id": len(vocab) + i, "content": tok, "special": True}
             for i, tok in enumerate(special_tokens)]
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges]},
        "added_tokens": added,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": pattern}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False},
        ]},
    }


def write_bpe_asset(directory: str, spec: dict, tokenizer_config: dict | None = None) -> str:
    """``tokenizer.json`` (and ``tokenizer_config.json`` when given) under
    ``directory``; returns the tokenizer.json path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "tokenizer.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    if tokenizer_config is not None:
        with open(os.path.join(directory, "tokenizer_config.json"), "w") as f:
            json.dump(tokenizer_config, f)
    return path
