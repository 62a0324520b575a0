"""Real-model tokenizers (port of ``gofr_tpu/tokenizer/``), dependency-free.

The engine's tokenizer boundary (``serving/tokenizer.py``'s ``Tokenizer``
protocol) takes any encode/decode implementation; this package gives the
two families real Llama checkpoints ship with:

- ``BPETokenizer`` (bpe.py): byte-level BPE over the HF ``tokenizer.json``
  format (Llama-3 / GPT-2 lineage), its pre-tokenizer on the standard
  library's ``re``;
- ``SentencePieceTokenizer`` (spm.py): unigram Viterbi or SP-BPE over a
  SentencePiece ``.model`` protobuf (Llama-2 lineage), parsed with a
  built-in wire-format reader.

``load_tokenizer`` finds either asset by path, or through a file
datasource (``fs``: ``open``/``exists``) as weights load.
"""

from __future__ import annotations

import json
import os

from gofr_tpu_torch.tokenizer.bpe import BPETokenizer
from gofr_tpu_torch.tokenizer.spm import SentencePieceTokenizer

__all__ = ["BPETokenizer", "SentencePieceTokenizer", "load_tokenizer"]


def load_tokenizer(path: str, fs=None):
    """Auto-detect a tokenizer asset: a ``tokenizer.json`` (HF byte-level
    BPE) file or a directory holding one, or a SentencePiece ``.model``
    file (or a directory holding ``tokenizer.model``). Raises
    ``FileNotFoundError`` when there is none."""
    if fs is not None:
        exists = getattr(fs, "exists", None)

        def _read(p: str) -> bytes | None:
            if exists is not None and not exists(p):
                return None
            try:
                with fs.open(p, "rb") as f:
                    return f.read()
            except (FileNotFoundError, OSError):
                return None

        candidates = (
            [path]
            if path.endswith((".json", ".model"))
            else [os.path.join(path, n) for n in ("tokenizer.json", "tokenizer.model")]
        )
        for candidate in candidates:
            data = _read(candidate)
            if data is None:
                continue
            if candidate.endswith(".json"):
                cfg_raw = _read(
                    os.path.join(os.path.dirname(candidate), "tokenizer_config.json")
                )
                tok_cfg = json.loads(cfg_raw) if cfg_raw else None
                return BPETokenizer.from_spec(json.loads(data), tok_cfg)
            return SentencePieceTokenizer.from_bytes(data)
        raise FileNotFoundError(
            f"no tokenizer.json or tokenizer.model under {path}"
        )

    if os.path.isdir(path):
        for name in ("tokenizer.json", "tokenizer.model"):
            candidate = os.path.join(path, name)
            if os.path.exists(candidate):
                path = candidate
                break
        else:
            raise FileNotFoundError(
                f"no tokenizer.json or tokenizer.model under {path}"
            )
    if path.endswith(".json"):
        return BPETokenizer.from_file(path)
    return SentencePieceTokenizer.from_file(path)
