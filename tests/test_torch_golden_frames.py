"""The port's broker wire codecs (``gofr_tpu_torch/pubsub/kafka_wire.py``,
``mqtt.py``, ``nats.py`` and ``amqp_wire.py``) against the byte-exact
external vectors the JAX package's golden-frame tests pin
(``tests/test_golden_frames.py``: RFC 3720 CRC-32C, the protobuf zigzag
table, KIP-98's record batch layout, MQTT 3.1.1 §2.2.3 and §3.1, AMQP 1.0
§1.6 and §2.3, the NATS header block, the Redis protocol spec's RESP2
command and reply frames, RFC 4251's SSH data types and RFC 4253's
banner, bsonspec.org's BSON documents and every element type the Mongo
driver moves, and the CQL binary protocol v4's request, batch, result and
error frames), each vector run on both packages' codecs; then seeded
hypothesis cases in which each port encoder gives the reference's bytes for
the same record batch with headers, MQTT packet, NATS ``HPUB`` frame, AMQP
value, BSON document and CQL rows result, and each decoder inverts the other
package's encoder."""

import socket
import struct
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from gofr_tpu.datasource.pubsub import amqp_wire as ramqp
from gofr_tpu.datasource.pubsub import kafka_wire as rkafka
from gofr_tpu.datasource.pubsub import mqtt as rmqtt
from gofr_tpu.datasource.file import ssh_transport as rssh
from gofr_tpu.datasource.pubsub import nats as rnats
from gofr_tpu.datasource.redis import client as rredis
from gofr_tpu.datasource.document import bson as rbson
from gofr_tpu.datasource.widecolumn import cql_wire as rcql
from gofr_tpu_torch.datasource.file import ssh_transport as tssh
from gofr_tpu_torch.datasource.redis import client as tredis
from gofr_tpu_torch.datasource.document import bson as tbson
from gofr_tpu_torch.datasource.widecolumn import cql_wire as tcql
from gofr_tpu_torch.pubsub import amqp_wire as tamqp
from gofr_tpu_torch.pubsub import kafka_wire as tkafka
from gofr_tpu_torch.pubsub import mqtt as tmqtt
from gofr_tpu_torch.pubsub import nats as tnats

PKGS = {
    "ref": types.SimpleNamespace(kafka=rkafka, mqtt=rmqtt, amqp=ramqp, nats=rnats,
                                 redis=rredis, ssh=rssh, bson=rbson, cql=rcql),
    "port": types.SimpleNamespace(kafka=tkafka, mqtt=tmqtt, amqp=tamqp, nats=tnats,
                                  redis=tredis, ssh=tssh, bson=tbson, cql=tcql),
}
BOTH = pytest.mark.parametrize("side", sorted(PKGS))
HYP = settings(max_examples=60, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])


# ---------------------------------------------------------------- Kafka
@BOTH
def test_crc32c_rfc3720_vectors(side):
    crc32c = PKGS[side].kafka.crc32c
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c(b"\xff" * 32) == 0x62A8AB43
    assert crc32c(bytes(range(32))) == 0x46DD794E
    assert crc32c(bytes(range(31, -1, -1))) == 0x113FDB5C


@BOTH
def test_zigzag_varint_protobuf_vectors(side):
    k = PKGS[side].kafka
    assert k.varint(0) == b"\x00"
    assert k.varint(-1) == b"\x01"
    assert k.varint(1) == b"\x02"
    assert k.varint(-2) == b"\x03"
    assert k.varint(2147483647) == k.uvarint(4294967294)
    assert k.uvarint(0) == b"\x00"
    assert k.uvarint(127) == b"\x7f"
    assert k.uvarint(128) == b"\x80\x01"
    assert k.uvarint(300) == b"\xac\x02"


@BOTH
def test_record_batch_v2_layout_pins(side):
    k = PKGS[side].kafka
    batch = k.encode_record_batch(0, [(b"k", b"v", [])], timestamp_ms=1000)
    assert batch[16] == 2  # magic v2
    (stored_crc,) = struct.unpack(">I", batch[17:21])
    assert stored_crc == k.crc32c(batch[21:])  # the crc covers attributes onward
    records = k.decode_record_batches(batch)
    assert [(key, value) for _, key, value, _ in records] == [(b"k", b"v")]


# ---------------------------------------------------------------- MQTT 3.1.1
@BOTH
def test_remaining_length_spec_table(side):
    enc = PKGS[side].mqtt.encode_remaining_length
    assert enc(0) == b"\x00"
    assert enc(64) == b"\x40"
    assert enc(127) == b"\x7f"
    assert enc(128) == b"\x80\x01"
    assert enc(16383) == b"\xff\x7f"
    assert enc(16384) == b"\x80\x80\x01"
    assert enc(2097151) == b"\xff\xff\x7f"
    assert enc(2097152) == b"\x80\x80\x80\x01"
    assert enc(268435455) == b"\xff\xff\xff\x7f"


@BOTH
def test_connect_packet_layout(side):
    got = PKGS[side].mqtt.connect_packet("gofr", 60, clean_session=True)
    assert got == (b"\x10" b"\x10" b"\x00\x04MQTT" b"\x04" b"\x02" b"\x00\x3c" b"\x00\x04gofr")


@BOTH
def test_utf8_string_encoding(side):
    enc = PKGS[side].mqtt.encode_string
    assert enc("a/b") == b"\x00\x03a/b"
    assert enc("") == b"\x00\x00"


# ---------------------------------------------------------------- AMQP 1.0
@BOTH
def test_protocol_headers(side):
    a = PKGS[side].amqp
    assert a.PROTO_AMQP == b"AMQP\x00\x01\x00\x00"
    assert a.PROTO_SASL == b"AMQP\x03\x01\x00\x00"


@BOTH
def test_type_constructors_spec_1_6(side):
    a = PKGS[side].amqp
    enc = a.encode_value
    assert enc(None) == b"\x40"
    assert enc(True) == b"\x41"
    assert enc(False) == b"\x42"
    assert enc(a.Uint(0)) == b"\x43"
    assert enc(a.Uint(10)) == b"\x52\x0a"
    assert enc(a.Uint(300)) == b"\x70\x00\x00\x01\x2c"
    assert enc(a.Ulong(0)) == b"\x44"
    assert enc(a.Ulong(16)) == b"\x53\x10"
    assert enc(a.Ubyte(7)) == b"\x50\x07"
    assert enc(a.Ushort(258)) == b"\x60\x01\x02"
    assert enc("abc") == b"\xa1\x03abc"
    assert enc(a.Symbol("PLAIN")) == b"\xa3\x05PLAIN"
    assert enc(b"\x00\x01") == b"\xa0\x02\x00\x01"
    assert enc([]) == b"\x45"


@BOTH
def test_described_and_frame_layout(side):
    a = PKGS[side].amqp
    assert a.encode_value(a.Described(0x75, b"hi")) == b"\x00\x53\x75\xa0\x02hi"
    assert a.encode_frame(0, None) == b"\x00\x00\x00\x08\x02\x00\x00\x00"


# ---------------------------------------------------------------- NATS
@BOTH
def test_nats_headers_encoding(side):
    n = PKGS[side].nats
    raw = n.encode_headers({"Nats-Msg-Id": "x1"})
    assert raw == b"NATS/1.0\r\nNats-Msg-Id: x1\r\n\r\n"
    assert n.decode_headers(raw) == {"Nats-Msg-Id": "x1"}


# ---------------------------------------------------------------- Redis RESP2
@BOTH
def test_redis_command_encoding_spec_example(side):
    """The LLEN example straight from the Redis protocol spec."""
    enc = PKGS[side].redis._encode
    assert enc(["LLEN", "mylist"]) == b"*2\r\n$4\r\nLLEN\r\n$6\r\nmylist\r\n"
    assert enc(["SET", "k", "v"]) == b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$1\r\nv\r\n"


def _socketpair_client(side):
    a, b = socket.socketpair()
    c = PKGS[side].redis.RedisClient()
    c._sock, c._file = b, b.makefile("rb")
    return a, b, c


@BOTH
def test_redis_reply_decoding_spec_examples(side):
    """Canonical reply frames from the spec, through the real reader over a
    socketpair."""
    a, b, c = _socketpair_client(side)
    try:
        a.sendall(b"+OK\r\n:1000\r\n$6\r\nfoobar\r\n$-1\r\n"
                  b"*2\r\n$3\r\nfoo\r\n$3\r\nbar\r\n*-1\r\n")
        assert c._read_reply() == "OK"
        assert c._read_reply() == 1000
        assert c._read_reply() == "foobar"
        assert c._read_reply() is None
        assert c._read_reply() == ["foo", "bar"]
        assert c._read_reply() is None
    finally:
        a.close()
        b.close()


@BOTH
def test_redis_error_reply_raises(side):
    a, b, c = _socketpair_client(side)
    try:
        a.sendall(b"-ERR unknown command 'foobar'\r\n")
        with pytest.raises(PKGS[side].redis.RedisError, match="unknown command"):
            c._read_reply()
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------- SSH (RFC 4251, 4253)
@BOTH
def test_ssh_rfc4251_data_types(side):
    """string / uint32 / name-list encodings with the RFC 4251 §5 examples
    ('testing', the 'zlib,none' name-list), and its positive mpint examples."""
    s = PKGS[side].ssh
    assert s.sstr(b"testing") == b"\x00\x00\x00\x07testing"
    assert s.sstr(b"") == b"\x00\x00\x00\x00"
    assert s.u32(699921578) == b"\x29\xb7\xf4\xaa"
    assert s.name_list(b"zlib", b"none") == b"\x00\x00\x00\x09zlib,none"
    assert s.name_list() == b"\x00\x00\x00\x00"
    assert s.mpint(b"\x00") == b"\x00\x00\x00\x00"
    assert s.mpint(bytes.fromhex("09a378f9b2e332a7")) == bytes.fromhex("0000000809a378f9b2e332a7")
    assert s.mpint(b"\x80") == b"\x00\x00\x00\x02\x00\x80"


@BOTH
def test_ssh_version_banner_format(side):
    """RFC 4253 §4.2: identification string 'SSH-2.0-softwareversion'."""
    banner = PKGS[side].ssh.VERSION_STRING
    assert banner.startswith("SSH-2.0-")
    assert "\r" not in banner and "\n" not in banner
    assert banner == rssh.VERSION_STRING


# ------------------------------------------------- the port's bytes against the reference's
_token = st.text(alphabet=st.characters(min_codepoint=33, max_codepoint=126,
                                        blacklist_characters=":"), min_size=1, max_size=12)
_headers = st.lists(st.tuples(_token, st.binary(max_size=16)), max_size=4)
_records = st.lists(st.tuples(st.none() | st.binary(max_size=24), st.binary(max_size=64), _headers),
                    min_size=1, max_size=5)


@HYP
@given(base=st.integers(0, 2**40), records=_records, ts=st.integers(0, 2**41))
def test_record_batch_bytes_equal_and_cross_decode(base, records, ts):
    """The same record batch with headers: the same bytes from both encoders,
    and each decoder reads the other package's batch."""
    ours = tkafka.encode_record_batch(base, records, timestamp_ms=ts)
    theirs = rkafka.encode_record_batch(base, records, timestamp_ms=ts)
    assert ours == theirs
    want = [(base + i, k, v, h) for i, (k, v, h) in enumerate(records)]
    assert tkafka.decode_record_batches(theirs) == want
    assert rkafka.decode_record_batches(ours) == want


_topic = st.text(alphabet=st.characters(min_codepoint=48, max_codepoint=122), min_size=1,
                 max_size=20)


@HYP
@given(topic=_topic, payload=st.binary(max_size=300), qos=st.integers(0, 1),
       pid=st.integers(1, 0xFFFF), dup=st.booleans())
def test_mqtt_publish_bytes_equal_and_cross_parse(topic, payload, qos, pid, dup):
    """The same PUBLISH packet (a payload past 127 bytes takes a two-byte
    remaining length), and each parser reads the other package's packet."""
    ours = tmqtt.publish_packet(topic, payload, qos, pid, dup=dup)
    assert ours == rmqtt.publish_packet(topic, payload, qos, pid, dup=dup)
    n = 1
    while ours[n] & 0x80:  # the remaining length's continuation bytes
        n += 1
    flags, body = ours[0] & 0x0F, ours[1 + n:]
    assert tmqtt.encode_remaining_length(len(body)) == ours[1:1 + n]
    for parse in (tmqtt.parse_publish, rmqtt.parse_publish):
        assert parse(flags, body) == (topic, payload, qos, pid if qos else 0)
    assert tmqtt.subscribe_packet(pid, topic, qos) == rmqtt.subscribe_packet(pid, topic, qos)
    assert tmqtt.connect_packet(topic, pid, dup) == rmqtt.connect_packet(topic, pid, dup)


@HYP
@given(subject=_topic, headers=st.dictionaries(_token, _token, max_size=4),
       payload=st.binary(max_size=200))
def test_nats_hpub_frame_equal_and_cross_decode(subject, headers, payload):
    """The ``HPUB`` frame a publish with metadata sends, built from each
    package's header codec, is the same bytes; each decoder reads the
    other's header block."""
    def hpub(n):
        hdr = n.encode_headers(headers)
        return (f"HPUB {subject} {len(hdr)} {len(hdr) + len(payload)}".encode() + n.CRLF
                + hdr + payload + n.CRLF)

    assert hpub(tnats) == hpub(rnats)
    assert tnats.decode_headers(rnats.encode_headers(headers)) == headers
    assert rnats.decode_headers(tnats.encode_headers(headers)) == headers


def _amqp_values(a):
    leaf = st.one_of(
        st.none(), st.booleans(), st.integers(-(2**63), 2**63 - 1),
        st.integers(0, 2**32 - 1).map(a.Uint), st.integers(0, 2**64 - 1).map(a.Ulong),
        st.integers(0, 255).map(a.Ubyte), st.integers(0, 2**16 - 1).map(a.Ushort),
        st.text(max_size=300), st.binary(max_size=300),
        st.text(alphabet=st.characters(min_codepoint=33, max_codepoint=126),
                max_size=20).map(a.Symbol))
    return st.recursive(leaf, lambda inner: st.one_of(
        st.lists(inner, max_size=4),
        st.dictionaries(st.text(max_size=8), inner, max_size=3),
        st.tuples(st.integers(0, 0x7F), inner).map(lambda t: a.Described(*t))), max_leaves=12)


def _as_other(v, a):
    """A value built from one package's wrapper types, rebuilt from the
    other's (the wrappers are distinct classes in the two packages)."""
    for name in ("Uint", "Ulong", "Ubyte", "Ushort", "Symbol"):
        for src in (ramqp, tamqp):
            if type(v) is getattr(src, name):
                return getattr(a, name)(v)
    if isinstance(v, (ramqp.Described, tamqp.Described)):
        return a.Described(v.descriptor, _as_other(v.value, a))
    if isinstance(v, list):
        return [_as_other(x, a) for x in v]
    if isinstance(v, dict):
        return {_as_other(k, a): _as_other(x, a) for k, x in v.items()}
    return v


@HYP
@given(value=_amqp_values(tamqp))
def test_amqp_value_bytes_equal_and_cross_decode(value):
    """The same AMQP value (lists and maps past 255 bytes take the 32-bit
    constructors) encodes to the same bytes in both packages, and each
    decoder reads the other package's encoding back to the value."""
    ours = tamqp.encode_value(value)
    theirs = ramqp.encode_value(_as_other(value, ramqp))
    assert ours == theirs
    assert tamqp.Decoder(theirs).value() == value
    assert ramqp.Decoder(ours).value() == _as_other(value, ramqp)


@HYP
@given(body=st.binary(max_size=400), props=st.dictionaries(_token, _token, max_size=4),
       channel=st.integers(0, 2**16 - 1), handle=st.integers(0, 2**32 - 1))
def test_amqp_transfer_frame_equal_and_cross_decode(body, props, channel, handle):
    """A transfer frame carrying a message with application properties: the
    same bytes, and each package's frame and message decoders read the
    other's."""
    def frame(a):
        perf = a.Described(a.TRANSFER, [a.Uint(handle), a.Uint(7), b"tag", a.Uint(0), True])
        return a.encode_frame(channel, perf, a.encode_message(body, props))

    ours, theirs = frame(tamqp), frame(ramqp)
    assert ours == theirs
    for a, data in ((tamqp, theirs), (ramqp, ours)):
        ch, ftype, perf, payload = a.decode_frame(data)
        assert (ch, ftype, perf.descriptor) == (channel, 0, a.TRANSFER)
        assert int(perf.value[0]) == handle
        assert a.decode_message(payload) == (body, props)


# ---------------------------------------------------------------- BSON
# bsonspec.org's two examples, then one document per element type
BSON_SPEC = [
    ({"hello": "world"}, b"\x16\x00\x00\x00\x02hello\x00\x06\x00\x00\x00world\x00\x00"),
    ({"BSON": ["awesome", 5.05, 1986]},
     b"\x31\x00\x00\x00\x04BSON\x00\x26\x00\x00\x00\x020\x00\x08\x00\x00\x00awesome\x00"
     b"\x011\x00\x33\x33\x33\x33\x33\x33\x14\x40\x102\x00\xc2\x07\x00\x00\x00\x00"),
]


def _bson_elements(b):
    """(document, its bytes) for each element type the driver moves."""
    import datetime as dt

    def doc(etype: bytes, payload: bytes) -> bytes:
        body = etype + b"v\x00" + payload
        return struct.pack("<i", len(body) + 5) + body + b"\x00"

    return [
        ({"v": 1.5}, doc(b"\x01", struct.pack("<d", 1.5))),
        ({"v": {"a": True}}, doc(b"\x03", b"\x09\x00\x00\x00\x08a\x00\x01\x00")),
        ({"v": b"\x00\x01"}, doc(b"\x05", b"\x02\x00\x00\x00\x00\x00\x01")),
        ({"v": b.Binary(b"\xaa" * 16, subtype=4)},
         doc(b"\x05", b"\x10\x00\x00\x00\x04" + b"\xaa" * 16)),
        ({"v": b.ObjectId("507f1f77bcf86cd799439011")},
         doc(b"\x07", bytes.fromhex("507f1f77bcf86cd799439011"))),
        ({"v": False}, doc(b"\x08", b"\x00")),
        ({"v": dt.datetime(2026, 10, 18, 6, 4, 40, 123000, tzinfo=dt.timezone.utc)},
         doc(b"\x09", struct.pack("<q", 1792303480123))),
        ({"v": None}, doc(b"\x0a", b"")),
        ({"v": -7}, doc(b"\x10", struct.pack("<i", -7))),
        ({"v": 2**40}, doc(b"\x12", struct.pack("<q", 2**40))),
        ({"v": b.Int64(1)}, doc(b"\x12", struct.pack("<q", 1))),
    ]


@BOTH
def test_bson_spec_vectors(side):
    b = PKGS[side].bson
    for document, raw in BSON_SPEC + _bson_elements(b):
        assert b.encode_document(document) == raw, document
        back, end = b.decode_document(raw)
        assert (back, end) == (document, len(raw))


@BOTH
def test_bson_refuses_what_it_cannot_carry(side):
    b = PKGS[side].bson
    with pytest.raises(ValueError, match="NUL"):
        b.encode_document({"a\x00b": 1})
    with pytest.raises(TypeError, match="cannot encode set"):
        b.encode_document({"v": {1}})
    with pytest.raises(ValueError, match="0x13"):
        b.decode_document(b"\x08\x00\x00\x00\x13v\x00\x00")


def test_bson_binary_subtype_and_objectid_cross_decode():
    oid = tbson.ObjectId()
    assert (oid.binary[4:9], len(str(oid))) == (tbson._MACHINE, 24)
    raw = tbson.encode_document({"id": oid, "lsid": tbson.Binary(b"\x01" * 16, subtype=4)})
    back, _ = rbson.decode_document(raw)
    assert back["id"] == rbson.ObjectId(oid.binary) and back["lsid"].subtype == 4
    assert rbson.encode_document(back) == raw


_bson_key = st.text(st.characters(blacklist_characters="\x00", blacklist_categories=("Cs",)),
                    max_size=8)
_bson_scalar = st.one_of(st.none(), st.booleans(), st.integers(-(2**63), 2**63 - 1),
                         st.floats(allow_nan=False), st.text(max_size=20), st.binary(max_size=20))
_bson_value = st.recursive(
    _bson_scalar,
    lambda inner: st.one_of(st.lists(inner, max_size=4),
                            st.dictionaries(_bson_key, inner, max_size=4)),
    max_leaves=12)


@HYP
@given(document=st.dictionaries(_bson_key, _bson_value, max_size=6))
def test_bson_document_bytes_equal_and_cross_decode(document):
    ours, theirs = tbson.encode_document(document), rbson.encode_document(document)
    assert ours == theirs
    assert tbson.decode_document(theirs) == rbson.decode_document(ours) == (document, len(ours))


# ---------------------------------------------------------------- CQL v4
@BOTH
def test_cql_v4_request_frames(side):
    w = PKGS[side].cql
    startup = w.encode_startup(0)
    # native_protocol_v4.spec §2: version, flags, stream, opcode, length
    assert startup == (b"\x04\x00\x00\x00\x01\x00\x00\x00\x16\x00\x01"
                       b"\x00\x0bCQL_VERSION\x00\x053.0.0")
    assert w.encode_query(7, "SELECT 1") == (
        b"\x04\x00\x00\x07\x07\x00\x00\x00\x0f\x00\x00\x00\x08SELECT 1\x00\x01\x00")
    batch = w.encode_batch(9, w.LOGGED_BATCH, ["INSERT INTO t VALUES (1)", "DELETE FROM t"])
    assert batch == (b"\x04\x00\x00\x09\x0d\x00\x00\x00\x39\x00\x00\x02"
                     b"\x00\x00\x00\x00\x18INSERT INTO t VALUES (1)\x00\x00"
                     b"\x00\x00\x00\x00\x0dDELETE FROM t\x00\x00\x00\x01\x00")
    assert w.decode_batch(batch[9:]) == (
        w.LOGGED_BATCH, ["INSERT INTO t VALUES (1)", "DELETE FROM t"])
    assert w.parse_frame_header(batch[:9]) == (0x04, 9, w.OP_BATCH, 0x39)


@BOTH
def test_cql_v4_result_and_error_frames(side):
    w = PKGS[side].cql
    rows = w.encode_rows([{"id": 1, "name": "o'b", "ok": True, "score": None}])
    assert rows == (
        # kind Rows, flags Global_tables_spec, 4 columns, keyspace and table
        b"\x00\x00\x00\x02\x00\x00\x00\x01\x00\x00\x00\x04\x00\x02ks\x00\x01t"
        b"\x00\x02id\x00\x02\x00\x04name\x00\x0d\x00\x02ok\x00\x04"
        b"\x00\x05score\x00\x0d\x00\x00\x00\x01"
        b"\x00\x00\x00\x08\x00\x00\x00\x00\x00\x00\x00\x01\x00\x00\x00\x03o'b"
        b"\x00\x00\x00\x01\x01\xff\xff\xff\xff")
    assert w.decode_result(rows) == (w.RESULT_ROWS, [{"id": 1, "name": "o'b", "ok": True,
                                                       "score": None}])
    err = w.encode_error(0x2200, "unconfigured table t")
    assert err == b"\x00\x00\x22\x00\x00\x14unconfigured table t"
    exc = w.decode_error(err)
    assert (exc.code, str(exc)) == (0x2200, "unconfigured table t")
    void = w.encode_frame(3, w.OP_RESULT, struct.pack(">i", w.RESULT_VOID), response=True)
    assert void == b"\x84\x00\x00\x03\x08\x00\x00\x00\x04\x00\x00\x00\x01"


@BOTH
def test_cql_literals_and_interpolation(side):
    w = PKGS[side].cql
    assert [w.escape_literal(v) for v in (None, True, 7, 2.5, "o'b", b"\x01\xff")] == [
        "NULL", "true", "7", "2.5", "'o''b'", "0x01ff"]
    assert w.interpolate("INSERT INTO t VALUES (?, ?)", (1, "o'brien")) == \
        "INSERT INTO t VALUES (1, 'o''brien')"
    assert w.interpolate("SELECT '?' FROM t WHERE a=?", (5,)).endswith("a=5")
    with pytest.raises(w.CQLError):
        w.interpolate("SELECT ?", (1, 2))


_cql_kinds = [st.booleans(), st.integers(-(2**63), 2**63 - 1), st.floats(allow_nan=False),
              st.text(max_size=12), st.binary(max_size=12)]


@HYP
@given(rows=st.lists(st.sampled_from(_cql_kinds), min_size=1, max_size=4).flatmap(
    lambda kinds: st.lists(st.fixed_dictionaries(
        {f"c{i}": st.one_of(st.none(), kind) for i, kind in enumerate(kinds)}), max_size=5)))
def test_cql_rows_bytes_equal_and_cross_decode(rows):
    """A rows result (each column one type, cells null or of it): the same
    bytes, and each package decodes the other's back to the rows (a column
    takes its type from its first non-null cell, so mixed columns are not
    the codec's)."""
    ours, theirs = tcql.encode_rows(rows), rcql.encode_rows(rows)
    assert ours == theirs
    assert tcql.decode_result(theirs) == rcql.decode_result(ours) == (tcql.RESULT_ROWS, rows)
