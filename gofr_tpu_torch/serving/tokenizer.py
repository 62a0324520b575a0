"""Byte-level tokenizer (copy of ``gofr_tpu/serving/tokenizer.py``'s
``ByteTokenizer``): ids 0..2 are pad/bos/eos, byte b is id b+3."""

from __future__ import annotations


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
