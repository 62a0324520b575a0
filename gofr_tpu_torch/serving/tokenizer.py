"""The tokenizer boundary (copy of ``gofr_tpu/serving/tokenizer.py``).

The engine needs only encode/decode and the special ids (the ``Tokenizer``
protocol); any implementation plugs in: ``ByteTokenizer`` (ids 0..2 are
pad/bos/eos, byte b is id b+3), the port's own BPE and SentencePiece
readers (``gofr_tpu_torch.tokenizer``), or ``HFTokenizer`` over a local
``transformers`` directory. ``pad_batch`` tokenizes and right-pads a text
batch for the /embed endpoint.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    pad_id = 0
    bos_id = 1
    eos_id = 2
    _offset = 3

    def __init__(self, vocab_size: int | None = None) -> None:
        self.vocab_size = vocab_size or (256 + self._offset)

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + [b + self._offset for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        data = bytes(
            i - self._offset for i in ids if self._offset <= i < self._offset + 256
        )
        return data.decode("utf-8", "replace")


def pad_batch(tokenizer: Tokenizer, texts: list[str], max_seq_len: int):
    """Tokenize and right-pad a text batch to a power-of-two bucket, at
    least 8 and at most ``max_seq_len`` (a few shapes for every batch).
    Returns (tokens [B, bucket] int32 ndarray, lens [B] list)."""
    ids = [tokenizer.encode(t)[:max_seq_len] for t in texts]
    max_len = max((len(i) for i in ids), default=1)
    bucket = 1 << (max_len - 1).bit_length() if max_len > 1 else 1
    bucket = min(max(bucket, 8), max_seq_len)
    arr = np.full((len(ids), bucket), tokenizer.pad_id, np.int32)
    lens = []
    for row, seq in enumerate(ids):
        seq = seq[:bucket]
        arr[row, : len(seq)] = seq
        lens.append(len(seq))
    return arr, lens


class HFTokenizer:
    """Adapter for a local ``transformers`` tokenizer directory (no network:
    pass a path that already holds tokenizer.json). ``transformers`` is
    imported when one is built, never with this module."""

    def __init__(self, path: str) -> None:
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id or 1
        self.eos_id = self._tok.eos_token_id or 2
        self.pad_id = self._tok.pad_token_id or 0
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)
