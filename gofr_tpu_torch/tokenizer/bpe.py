r"""Byte-level BPE tokenizer reading the HF ``tokenizer.json`` format (port
of ``gofr_tpu/tokenizer/bpe.py``).

Own implementation (no ``tokenizers`` dependency): parses vocab + merges,
applies the file's pre-tokenization pattern, and round-trips text through
the GPT-2 byte<->unicode table. Llama-3, GPT-2 and Qwen-family assets load
through it.

The reference compiles the asset's Split pattern with the third-party
``regex`` module, for its ``\p{L}``/``\p{N}`` classes. The port compiles it
with the standard library's ``re``: :func:`translate_pattern` rewrites
``\p{L}``, ``\p{N}`` (and ``\P{..}``, in or out of ``[...]``) into explicit
code-point ranges built once from ``unicodedata`` categories, and ``\s``/
``\S`` into the Unicode White_Space set ``regex`` matches (``re``'s ``\s``
also takes U+001C..U+001F). Any other ``\p{..}`` class raises with its
name. Code points that Python's Unicode tables leave unassigned and a newer
``regex`` assigns are the one place the two can split text differently.
"""

from __future__ import annotations

import functools
import json
import os
import re
import threading
import unicodedata
from typing import Any

# GPT-2 pre-tokenization pattern — the default when the asset doesn't
# carry its own Split pattern.
GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)
# Llama-3's Split pattern (its tokenizer.json): case-blind contractions,
# digits in runs of at most three, CR/LF kept apart
LLAMA3_PATTERN = (
    r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"""
    r"""|\s*[\r\n]+|\s+(?!\S)|\s+"""
)


def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 printable-byte table: maps every byte 0..255 to a unicode
    char such that 'visible' bytes map to themselves."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {c: b for b, c in _BYTE_ENCODER.items()}

# the Unicode White_Space property: what ``regex`` matches as \s
_WHITE_SPACE = (
    (0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
    (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000),
)
_MAX_CODE_POINT = 0x10FFFF


@functools.cache
def _category_ranges(major: str) -> tuple[tuple[int, int], ...]:
    """Inclusive code-point ranges whose general category starts with
    ``major`` ("L": Lu Ll Lt Lm Lo; "N": Nd Nl No)."""
    ranges: list[tuple[int, int]] = []
    start = None
    for cp in range(_MAX_CODE_POINT + 2):
        hit = cp <= _MAX_CODE_POINT and unicodedata.category(chr(cp))[0] == major
        if hit and start is None:
            start = cp
        elif not hit and start is not None:
            ranges.append((start, cp - 1))
            start = None
    return tuple(ranges)


def _complement(ranges: tuple[tuple[int, int], ...]) -> tuple[tuple[int, int], ...]:
    out, nxt = [], 0
    for lo, hi in ranges:
        if lo > nxt:
            out.append((nxt, lo - 1))
        nxt = hi + 1
    if nxt <= _MAX_CODE_POINT:
        out.append((nxt, _MAX_CODE_POINT))
    return tuple(out)


def _class_body(ranges: tuple[tuple[int, int], ...]) -> str:
    return "".join(
        f"\\U{lo:08x}" if lo == hi else f"\\U{lo:08x}-\\U{hi:08x}" for lo, hi in ranges
    )


def _property_ranges(name: str) -> tuple[tuple[int, int], ...]:
    if name not in ("L", "N"):
        raise ValueError(
            f"unsupported Unicode property \\p{{{name}}} in the pre-tokenizer pattern: "
            "only \\p{L} and \\p{N} are translated for the standard library's re"
        )
    return _category_ranges(name)


def translate_pattern(pattern: str) -> str:
    """The pattern with ``\\p{L}``/``\\p{N}`` (also ``\\pL``, ``\\P{..}``) and
    ``\\s``/``\\S`` as explicit code-point classes, for ``re``: a class
    escape inside ``[...]`` becomes its ranges, outside it a class of its
    own; a negated one outside a class is ``[^...]``, inside one its
    complement's ranges."""
    out: list[str] = []
    i, n = 0, len(pattern)
    in_class, body_start = False, 0
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            e = pattern[i + 1]
            ranges = None
            if e in "pP":
                if i + 2 < n and pattern[i + 2] == "{":
                    close = pattern.find("}", i + 3)
                    if close < 0:
                        raise ValueError(f"unterminated \\{e}{{ in pattern {pattern!r}")
                    name, end = pattern[i + 3:close], close + 1
                else:
                    name, end = pattern[i + 2:i + 3], i + 3
                ranges, negate = _property_ranges(name), e == "P"
            elif e in "sS":
                ranges, negate, end = _WHITE_SPACE, e == "S", i + 2
            if ranges is None:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class:
                out.append(_class_body(_complement(ranges) if negate else ranges))
            else:
                out.append(("[^" if negate else "[") + _class_body(ranges) + "]")
            i = end
            continue
        out.append(c)
        i += 1
        if in_class:
            if c == "]" and i - 1 > body_start:
                in_class = False
        elif c == "[":
            in_class = True
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            body_start = i  # a "]" first in the class is a literal
    return "".join(out)


@functools.lru_cache(maxsize=16)
def compile_pattern(pattern: str) -> re.Pattern:
    """``re`` compiled from :func:`translate_pattern` (kept per pattern)."""
    return re.compile(translate_pattern(pattern))


def _find_pattern(pre_tokenizer: dict | None) -> str:
    """Extract the Split regex from a (possibly nested) pre_tokenizer."""
    if not pre_tokenizer:
        return GPT2_PATTERN
    kind = pre_tokenizer.get("type")
    if kind == "Split":
        pat = pre_tokenizer.get("pattern", {})
        return pat.get("Regex") or pat.get("String") or GPT2_PATTERN
    if kind == "Sequence":
        for sub in pre_tokenizer.get("pretokenizers", []):
            if sub.get("type") == "Split":
                return _find_pattern(sub)
    return GPT2_PATTERN


class BPETokenizer:
    """Serving-engine Tokenizer (serving/tokenizer.py Protocol)."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        *,
        pattern: str = GPT2_PATTERN,
        special_tokens: dict[str, int] | None = None,
        bos_token: str | None = None,
        eos_token: str | None = None,
        pad_token: str | None = None,
        add_bos: bool = False,
    ) -> None:
        self.vocab = vocab
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.pattern = compile_pattern(pattern)
        self.special_tokens = dict(special_tokens or {})
        self.id_to_token = {i: t for t, i in vocab.items()}
        for tok, i in self.special_tokens.items():
            self.id_to_token.setdefault(i, tok)
        self.vocab_size = max(self.id_to_token, default=-1) + 1
        self.add_bos = add_bos

        def _sid(token: str | None, *fallbacks: str) -> int | None:
            for cand in (token, *fallbacks):
                if cand is not None:
                    i = self.special_tokens.get(cand)
                    if i is None:
                        i = self.vocab.get(cand)
                    if i is not None:
                        return i
            return None

        def _by_pattern(pat: str) -> int | None:
            rx = re.compile(pat)
            for tok, i in sorted(self.special_tokens.items(), key=lambda kv: kv[1]):
                if rx.search(tok):
                    return i
            return None

        bos = _sid(bos_token, "<|begin_of_text|>", "<s>", "<|endoftext|>")
        eos = _sid(eos_token, "<|end_of_text|>", "</s>", "<|endoftext|>")
        pad = _sid(pad_token, "<pad>")
        if bos is None:
            bos = _by_pattern(r"(?i)bos|begin")
        if eos is None:
            eos = _by_pattern(r"(?i)eos|end|im_end")
        # eos = -1 is the never-stop sentinel: no real vocab id may double
        # as a stop token (defaulting to 0 would make the engine stop on a
        # legitimate token). pad at 0 is only used to fill masked positions.
        self.bos_id = bos if bos is not None else 0
        self.eos_id = eos if eos is not None else -1
        self.pad_id = pad if pad is not None else (self.eos_id if self.eos_id >= 0 else 0)
        self._special_ids = frozenset(self.special_tokens.values())
        self._cache: dict[str, list[int]] = {}
        self._cache_lock = threading.Lock()
        if self.special_tokens:
            # one alternation that splits text on special-token literals
            alts = "|".join(
                re.escape(t)
                for t in sorted(self.special_tokens, key=len, reverse=True)
            )
            self._special_re = re.compile(f"({alts})")
        else:
            self._special_re = None

    # ------------------------------------------------------------ loading
    @classmethod
    def from_file(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            spec = json.load(f)
        tok_cfg = None
        cfg_path = os.path.join(os.path.dirname(path), "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                tok_cfg = json.load(f)
        return cls.from_spec(spec, tok_cfg)

    @classmethod
    def from_spec(
        cls, spec: dict, tokenizer_config: dict | None = None
    ) -> "BPETokenizer":
        """Build from a parsed tokenizer.json dict (and optionally the
        sibling tokenizer_config.json dict naming bos/eos/pad)."""
        model = spec.get("model", {})
        if model.get("type") not in (None, "BPE"):
            raise ValueError(f"unsupported tokenizer model type {model.get('type')}")
        vocab = model.get("vocab", {})
        merges_raw = model.get("merges", [])
        merges: list[tuple[str, str]] = []
        for m in merges_raw:
            if isinstance(m, str):
                a, _, b = m.partition(" ")
                merges.append((a, b))
            else:
                merges.append((m[0], m[1]))
        special = {
            t["content"]: t["id"]
            for t in spec.get("added_tokens", [])
            if t.get("special")
        }
        pattern = _find_pattern(spec.get("pre_tokenizer"))
        # tokenizer_config.json names the bos/eos tokens
        bos = eos = pad = None
        if tokenizer_config:

            def _name(v: Any) -> str | None:
                return v.get("content") if isinstance(v, dict) else v

            bos = _name(tokenizer_config.get("bos_token"))
            eos = _name(tokenizer_config.get("eos_token"))
            pad = _name(tokenizer_config.get("pad_token"))
        return cls(
            vocab,
            merges,
            pattern=pattern,
            special_tokens=special,
            bos_token=bos,
            eos_token=eos,
            pad_token=pad,
        )

    # ------------------------------------------------------------ encoding
    def _bpe_word(self, word: str) -> list[int]:
        """Merge loop for one pre-tokenized word (already byte-mapped)."""
        with self._cache_lock:
            cached = self._cache.get(word)
        if cached is not None:
            return cached
        parts = list(word)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        ids = []
        for p in parts:
            i = self.vocab.get(p)
            if i is None:  # unmergeable byte with no vocab entry
                ids.extend(self.vocab.get(ch, 0) for ch in p)
            else:
                ids.append(i)
        with self._cache_lock:
            if len(self._cache) > 65536:
                self._cache.clear()
            self._cache[word] = ids
        return ids

    def _encode_plain(self, text: str) -> list[int]:
        out: list[int] = []
        for word in self.pattern.findall(text):
            mapped = "".join(_BYTE_ENCODER[b] for b in word.encode("utf-8"))
            out.extend(self._bpe_word(mapped))
        return out

    def encode(self, text: str, *, add_bos: bool | None = None) -> list[int]:
        out: list[int] = []
        if add_bos if add_bos is not None else self.add_bos:
            out.append(self.bos_id)
        if self._special_re is None:
            out.extend(self._encode_plain(text))
            return out
        for chunk in self._special_re.split(text):
            if not chunk:
                continue
            sid = self.special_tokens.get(chunk)
            if sid is not None:
                out.append(sid)
            else:
                out.extend(self._encode_plain(chunk))
        return out

    # ------------------------------------------------------------ decoding
    def decode(self, ids: list[int]) -> str:
        data = bytearray()
        for i in ids:
            i = int(i)
            tok = self.id_to_token.get(i)
            if tok is None or i in self._special_ids:
                continue
            for ch in tok:
                b = _BYTE_DECODER.get(ch)
                if b is not None:
                    data.append(b)
                else:  # non-byte-level token (added non-special)
                    data.extend(ch.encode("utf-8"))
        return data.decode("utf-8", "replace")
