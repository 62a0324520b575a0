"""HPACK (RFC 7541), the header compression of HTTP/2, in Python: what
grpcio's C core does for the reference and the port's gRPC wire
(``grpcx/h2.py``) needs without it.

:class:`Decoder` takes the whole format: the static table (Appendix A), the
dynamic table with its eviction and the size update at the start of a block,
integers with an N-bit prefix, string literals raw or Huffman-coded
(Appendix B; grpcio's encoder Huffman-codes values), and the four
representations (indexed, literal with incremental indexing, without
indexing, never indexed). :class:`Encoder` writes literals without indexing,
naming a static-table entry where one matches, raw or Huffman-coded, so it
never touches the peer's dynamic table.
"""

from __future__ import annotations

STATIC_TABLE: tuple[tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
_STATIC_NAME: dict[str, int] = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_NAME.setdefault(_n, _i)

# Appendix B's code is canonical (codes of one length are consecutive, in
# symbol order, each length's first code following the last of the shorter):
# the 257 code lengths, symbol 0..255 then EOS, define it whole.
_HUFFMAN_LENGTHS = bytes((
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
))
EOS = 256


def _build_huffman() -> tuple[list[tuple[int, int]], dict[int, tuple[int, int, list[int]]]]:
    order = sorted(range(257), key=lambda s: (_HUFFMAN_LENGTHS[s], s))
    codes: list[tuple[int, int]] = [(0, 0)] * 257
    by_length: dict[int, tuple[int, int, list[int]]] = {}
    code, prev_len = 0, _HUFFMAN_LENGTHS[order[0]]
    for i, sym in enumerate(order):
        length = _HUFFMAN_LENGTHS[sym]
        if i:
            code = (code + 1) << (length - prev_len)
        prev_len = length
        codes[sym] = (code, length)
        first, _count, syms = by_length.setdefault(length, (code, 0, []))
        syms.append(sym)
        by_length[length] = (first, len(syms), syms)
    return codes, by_length


HUFFMAN_CODES, _BY_LENGTH = _build_huffman()
_MAX_LEN = max(_BY_LENGTH)


class HPACKError(ValueError):
    """A malformed header block (a COMPRESSION_ERROR on the connection)."""


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    out = bytearray()
    for b in data:
        code, length = HUFFMAN_CODES[b]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:  # pad with the most significant bits of EOS (all ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            entry = _BY_LENGTH.get(length)
            if entry is not None:
                first, count, syms = entry
                if first <= code < first + count:
                    sym = syms[code - first]
                    if sym == EOS:
                        raise HPACKError("EOS symbol in a Huffman string")
                    out.append(sym)
                    code = length = 0
                    continue
            if length > _MAX_LEN:
                raise HPACKError("invalid Huffman code")
    # padding: fewer than 8 bits, all ones (a prefix of EOS)
    if length > 7 or code != (1 << length) - 1:
        raise HPACKError("invalid Huffman padding")
    return bytes(out)


def encode_integer(value: int, prefix_bits: int, first_byte: int = 0) -> bytes:
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((first_byte | value,))
    out = bytearray((first_byte | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    if pos >= len(data):
        raise HPACKError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HPACKError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 35:
            raise HPACKError("integer too large")


def _entry_size(name: str, value: str) -> int:
    return len(name.encode()) + len(value.encode()) + 32


class Decoder:
    """A connection's header-block decoder, with its dynamic table.
    ``max_table_size`` is the bound our SETTINGS_HEADER_TABLE_SIZE gave the
    peer; its size updates may not exceed it."""

    def __init__(self, max_table_size: int = 4096) -> None:
        self.max_allowed = max_table_size
        self.max_size = max_table_size
        self.table: list[tuple[str, str]] = []  # newest first
        self.size = 0

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            name, value = self.table.pop()
            self.size -= _entry_size(name, value)

    def _add(self, name: str, value: str) -> None:
        self.table.insert(0, (name, value))
        self.size += _entry_size(name, value)
        self._evict()

    def _lookup(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise HPACKError("header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HPACKError(f"header index {index} past the tables")
        return self.table[i]

    def _string(self, data: bytes, pos: int) -> tuple[str, int]:
        if pos >= len(data):
            raise HPACKError("truncated string")
        huffman = bool(data[pos] & 0x80)
        n, pos = decode_integer(data, pos, 7)
        if pos + n > len(data):
            raise HPACKError("truncated string")
        raw = data[pos:pos + n]
        if huffman:
            raw = huffman_decode(raw)
        return raw.decode("utf-8", "surrogateescape"), pos + n

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        pos, end = 0, len(block)
        seen_field = False
        while pos < end:
            b = block[pos]
            if b & 0x80:  # indexed
                index, pos = decode_integer(block, pos, 7)
                headers.append(self._lookup(index))
                seen_field = True
            elif b & 0x40:  # literal with incremental indexing
                index, pos = decode_integer(block, pos, 6)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                self._add(name, value)
                headers.append((name, value))
                seen_field = True
            elif b & 0x20:  # dynamic table size update
                if seen_field:
                    raise HPACKError("table size update after a header field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.max_allowed:
                    raise HPACKError(f"table size {size} over the limit {self.max_allowed}")
                self.max_size = size
                self._evict()
            else:  # literal without indexing (0000) or never indexed (0001)
                index, pos = decode_integer(block, pos, 4)
                name = self._lookup(index)[0] if index else None
                if name is None:
                    name, pos = self._string(block, pos)
                value, pos = self._string(block, pos)
                headers.append((name, value))
                seen_field = True
        return headers


class Encoder:
    """Literals without indexing (RFC 7541 §6.2.2): stateless, so the
    peer's dynamic table and its size settings never matter. Strings are
    Huffman-coded when that is shorter, unless ``huffman=False``."""

    def __init__(self, huffman: bool = True) -> None:
        self.huffman = huffman

    def _string(self, s: str) -> bytes:
        raw = s.encode("utf-8", "surrogateescape")
        if self.huffman:
            coded = huffman_encode(raw)
            if len(coded) < len(raw):
                return encode_integer(len(coded), 7, 0x80) + coded
        return encode_integer(len(raw), 7) + raw

    def encode(self, headers: list[tuple[str, str]]) -> bytes:
        out = bytearray()
        for name, value in headers:
            index = _STATIC_NAME.get(name)
            if index is not None:
                out += encode_integer(index, 4)
            else:
                out += b"\x00" + self._string(name)
            out += self._string(value)
        return bytes(out)
