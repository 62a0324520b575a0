"""SentencePiece tokenizer (copy of ``gofr_tpu/tokenizer/spm.py``): own
``.model`` protobuf parser + encoder, pure Python.

Llama-2/Mistral-family checkpoints ship a SentencePiece ``tokenizer.model``
(a serialized ``ModelProto``). No ``sentencepiece`` wheel is needed:
this module reads the protobuf wire format directly (varint field walker —
no generated code) and implements both encode algorithms SP models use:

- **unigram**: Viterbi segmentation maximizing the sum of piece log-probs;
- **BPE**: greedy merge of the adjacent pair whose concatenation has the
  highest piece score (scores encode merge rank) — the Llama-2 model type.

Whitespace is escaped to ▁ (U+2581) with the standard dummy-prefix rule;
characters outside the vocab fall back to ``<0xNN>`` byte pieces when the
model carries them, else the unk id.
"""

from __future__ import annotations

import struct

_SPACE = "▁"  # ▁

# piece types (sentencepiece.ModelProto.SentencePiece.Type)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6


def _walk(buf: bytes, pos: int, end: int):
    """Yield (field_no, wire_type, value, new_pos) over a message body."""
    while pos < end:
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wire == 5:
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val, pos


def _signed(v: int) -> int:
    """Interpret a decoded varint as a two's-complement int64 (proto
    int32/-1 encodes as ten 0xFF-heavy bytes)."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


class SentencePieceTokenizer:
    def __init__(
        self,
        pieces: list[tuple[str, float, int]],  # (piece, score, type)
        *,
        model_type: int = 1,  # 1=unigram, 2=BPE
        unk_id: int = 0,
        bos_id: int = 1,
        eos_id: int = 2,
        pad_id: int = -1,
        add_dummy_prefix: bool = True,
        add_bos: bool = False,
    ) -> None:
        self.pieces = pieces
        self.model_type = model_type
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id if pad_id >= 0 else 0
        self.add_dummy_prefix = add_dummy_prefix
        self.add_bos = add_bos
        self.vocab_size = len(pieces)
        self.piece_to_id = {p: i for i, (p, _, _) in enumerate(pieces)}
        self.scores = {p: s for p, s, _ in pieces}
        self._max_piece_len = max((len(p) for p, _, t in pieces), default=1)
        self._byte_ids = {}
        for i, (p, _, t) in enumerate(pieces):
            if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                self._byte_ids[int(p[3:5], 16)] = i
        self._control_ids = {i for i, (_, _, t) in enumerate(pieces) if t == CONTROL}
        self._rev_bytes = {i: b for b, i in self._byte_ids.items()}

    # ------------------------------------------------------------ loading
    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceTokenizer":
        pieces: list[tuple[str, float, int]] = []
        model_type, unk_id, bos_id, eos_id, pad_id = 1, 0, 1, 2, -1
        add_dummy_prefix = True
        for field, wire, val, _ in _walk(data, 0, len(data)):
            if field == 1 and wire == 2:  # repeated SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 3:
                        model_type = v2
                    elif f2 == 40:
                        unk_id = v2
                    elif f2 == 41:
                        bos_id = _signed(v2)
                    elif f2 == 42:
                        eos_id = _signed(v2)
                    elif f2 == 43:
                        pad_id = _signed(v2)
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2, _ in _walk(val, 0, len(val)):
                    if f2 == 3:
                        add_dummy_prefix = bool(v2)
        return cls(
            pieces,
            model_type=model_type,
            unk_id=unk_id,
            bos_id=max(bos_id, 0),
            eos_id=max(eos_id, 0),
            pad_id=pad_id,
            add_dummy_prefix=add_dummy_prefix,
        )

    # ------------------------------------------------------------ encoding
    def _normalize(self, text: str) -> str:
        text = text.replace(" ", _SPACE)
        if self.add_dummy_prefix and not text.startswith(_SPACE):
            text = _SPACE + text
        return text

    def _char_fallback(self, ch: str) -> list[int]:
        if self._byte_ids:
            return [
                self._byte_ids.get(b, self.unk_id) for b in ch.encode("utf-8")
            ]
        return [self.unk_id]

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi: best[i] = max-score segmentation of text[:i]."""
        n = len(text)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        unk_penalty = min(self.scores.values(), default=0.0) - 10.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_piece_len), end):
                if best[start] == NEG:
                    continue
                piece = text[start:end]
                pid = self.piece_to_id.get(piece)
                if pid is not None and pid not in self._control_ids:
                    s = best[start] + self.scores[piece]
                    if s > best[end]:
                        best[end], back[end] = s, (start, pid)
            if best[end] == NEG:  # unknown char: byte-fallback or unk
                start = end - 1
                if best[start] > NEG:
                    best[end] = best[start] + unk_penalty
                    back[end] = (start, -1)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid == -1:
                ids[:0] = self._char_fallback(text[start:pos])
            else:
                ids.insert(0, pid)
            pos = start
        return ids

    def _encode_bpe(self, text: str) -> list[int]:
        """SP-BPE: repeatedly merge the adjacent pair whose concatenation
        is a piece with the highest score."""
        parts = list(text)
        while len(parts) > 1:
            best_score, best_i = None, -1
            for i in range(len(parts) - 1):
                cand = parts[i] + parts[i + 1]
                s = self.scores.get(cand)
                if s is not None and (best_score is None or s > best_score):
                    best_score, best_i = s, i
            if best_score is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        ids: list[int] = []
        for p in parts:
            pid = self.piece_to_id.get(p)
            if pid is None or pid in self._control_ids:
                ids.extend(self._char_fallback(p))
            else:
                ids.append(pid)
        return ids

    def encode(self, text: str, *, add_bos: bool | None = None) -> list[int]:
        text = self._normalize(text)
        if self.model_type == 2:
            ids = self._encode_bpe(text)
        else:
            ids = self._encode_unigram(text)
        if add_bos if add_bos is not None else self.add_bos:
            ids.insert(0, self.bos_id)
        return ids

    # ------------------------------------------------------------ decoding
    def decode(self, ids: list[int]) -> str:
        out: list[str] = []
        byte_run = bytearray()

        def flush() -> None:
            if byte_run:
                out.append(byte_run.decode("utf-8", "replace"))
                byte_run.clear()

        for i in ids:
            i = int(i)
            if i in self._rev_bytes:
                byte_run.append(self._rev_bytes[i])
                continue
            flush()
            if i in self._control_ids or not (0 <= i < len(self.pieces)):
                continue
            out.append(self.pieces[i][0])
        flush()
        text = "".join(out).replace(_SPACE, " ")
        if self.add_dummy_prefix:
            text = text.removeprefix(" ")  # undo the encode-side dummy prefix
        return text
