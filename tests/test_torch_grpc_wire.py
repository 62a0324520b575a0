"""The port's own gRPC wire held to the standards and to the real
implementations, on the CPU: HPACK (``gofr_tpu_torch/grpcx/hpack.py``)
against RFC 7541 Appendix C's vectors, with and without Huffman coding, the
dynamic table's entries and size after every block; the protobuf wire
(``grpcx/protowire.py``) against ``google.protobuf`` on messages drawn by
hypothesis (fixed seed) from the port's copies of the four descriptor sets
(health, reflection, google.pubsub.v1, the coordination plane) and a proto of
every scalar type: bytes equal where no map is involved, each side
parses the other's bytes to an equal message, ``to_dict`` equals
``MessageToDict(preserving_proto_field_name=True)``, and every file's bytes
equal the set's. Then the HTTP/2 layer over a raw socket: the server's
SETTINGS first, PING answered, a compressed message refused with
UNIMPLEMENTED, a header block past one frame in CONTINUATION frames, and the
gRPC helpers (``grpc-timeout`` units, percent-encoded messages, ``-bin``
metadata). Every socket read has its own timeout."""

import asyncio
import base64
import math
import os
import shutil
import socket
import struct
import subprocess
import threading

import pytest
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st

from gofr_tpu_torch.grpcx import h2, hpack, protowire

pb_json = pytest.importorskip("google.protobuf.json_format")
from google.protobuf import descriptor_pb2, descriptor_pool, message_factory  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOCK_TIMEOUT = 5.0


# -- HPACK: RFC 7541 Appendix C ------------------------------------------------

def _hex(s: str) -> bytes:
    return bytes.fromhex("".join(s.split()))


C2 = [  # (block, headers, table after, size after), each on a fresh decoder
    ("400a 6375 7374 6f6d 2d6b 6579 0d63 7573 746f 6d2d 6865 6164 6572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")], 55),
    ("040c 2f73 616d 706c 652f 7061 7468", [(":path", "/sample/path")], [], 0),
    ("1008 7061 7373 776f 7264 0673 6563 7265 74", [("password", "secret")], [], 0),
    ("82", [(":method", "GET")], [], 0),
]

REQ = [
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com")],
    [(":method", "GET"), (":scheme", "http"), (":path", "/"), (":authority", "www.example.com"),
     ("cache-control", "no-cache")],
    [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
     (":authority", "www.example.com"), ("custom-key", "custom-value")],
]
REQ_TABLES = [
    ([(":authority", "www.example.com")], 57),
    ([("cache-control", "no-cache"), (":authority", "www.example.com")], 110),
    ([("custom-key", "custom-value"), ("cache-control", "no-cache"),
      (":authority", "www.example.com")], 164),
]
C3 = ["8286 8441 0f77 7777 2e65 7861 6d70 6c65 2e63 6f6d",
      "8286 84be 5808 6e6f 2d63 6163 6865",
      "8287 85bf 400a 6375 7374 6f6d 2d6b 6579 0c63 7573 746f 6d2d 7661 6c75 65"]
C4 = ["8286 8441 8cf1 e3c2 e5f2 3a6b a0ab 90f4 ff",
      "8286 84be 5886 a8eb 1064 9cbf",
      "8287 85bf 4088 25a8 49e9 5ba9 7d7f 8925 a849 e95b b8e8 b4bf"]

DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
DATE2 = "Mon, 21 Oct 2013 20:13:22 GMT"
LOC = "https://www.example.com"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
RESP = [
    [(":status", "302"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)],
    [(":status", "307"), ("cache-control", "private"), ("date", DATE1), ("location", LOC)],
    [(":status", "200"), ("cache-control", "private"), ("date", DATE2), ("location", LOC),
     ("content-encoding", "gzip"), ("set-cookie", COOKIE)],
]
RESP_TABLES = [
    ([("location", LOC), ("date", DATE1), ("cache-control", "private"), (":status", "302")], 222),
    ([(":status", "307"), ("location", LOC), ("date", DATE1), ("cache-control", "private")], 222),
    ([("set-cookie", COOKIE), ("content-encoding", "gzip"), ("date", DATE2)], 215),
]
C5 = ["4803 3330 3258 0770 7269 7661 7465 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133"
      " 2032 303a 3133 3a32 3120 474d 546e 1768 7474 7073 3a2f 2f77 7777 2e65 7861 6d70"
      " 6c65 2e63 6f6d",
      "4803 3330 37c1 c0bf",
      "88c1 611d 4d6f 6e2c 2032 3120 4f63 7420 3230 3133 2032 303a 3133 3a32 3220 474d"
      " 54c0 5a04 677a 6970 7738 666f 6f3d 4153 444a 4b48 514b 425a 584f 5157 454f 5049"
      " 5541 5851 5745 4f49 553b 206d 6178 2d61 6765 3d33 3630 303b 2076 6572 7369 6f6e"
      " 3d31"]
C6 = ["4882 6402 5885 aec3 771a 4b61 96d0 7abe 9410 54d4 44a8 2005 9504 0b81 66e0 82a6"
      " 2d1b ff6e 919d 29ad 1718 63c7 8f0b 97c8 e9ae 82ae 43d3",
      "4883 640e ffc1 c0bf",
      "88c1 6196 d07a be94 1054 d444 a820 0595 040b 8166 e084 a62d 1bff c05a 839b d9ab"
      " 77ad 94e7 821d d7f2 e6c7 b335 dfdf cd5b 3960 d5af 2708 7f36 72c1 ab27 0fb5 291f"
      " 9587 3160 65c0 03ed 4ee5 b106 3d50 07"]


@pytest.mark.parametrize("i", range(len(C2)))
def test_hpack_c2_single_representations(i):
    block, headers, table, size = C2[i]
    d = hpack.Decoder()
    assert d.decode(_hex(block)) == headers
    assert (d.table, d.size) == (table, size)


@pytest.mark.parametrize("section,blocks,expect,tables,table_size", [
    ("C.3", C3, REQ, REQ_TABLES, 4096),
    ("C.4", C4, REQ, REQ_TABLES, 4096),
    ("C.5", C5, RESP, RESP_TABLES, 256),
    ("C.6", C6, RESP, RESP_TABLES, 256),
])
def test_hpack_appendix_c_sequences(section, blocks, expect, tables, table_size):
    """One decoder across a section's three blocks: the dynamic table (and
    C.5/C.6's evictions at 256 bytes) after each is the RFC's."""
    d = hpack.Decoder(max_table_size=table_size)
    for block, headers, (table, size) in zip(blocks, expect, tables):
        assert d.decode(_hex(block)) == headers, section
        assert (d.table, d.size) == (table, size), section


def test_hpack_huffman_round_trip_and_rfc_strings():
    assert hpack.huffman_encode(b"www.example.com") == _hex("f1e3 c2e5 f23a 6ba0 ab90 f4ff")
    assert hpack.huffman_encode(b"no-cache") == _hex("a8eb 1064 9cbf")
    for raw in (bytes(range(256)), b"", b"a", COOKIE.encode(), bytes([255] * 9)):
        assert hpack.huffman_decode(hpack.huffman_encode(raw)) == raw


@pytest.mark.parametrize("bad,why", [
    (b"\xff\xff\xff\xff", "EOS"),                 # 30 ones: the EOS symbol
    (hpack.huffman_encode(b"a") + b"\xff", "pad"),  # a whole byte of padding
    (b"\x00", "pad"),                              # padding that is not all ones
])
def test_hpack_huffman_rejects_eos_and_bad_padding(bad, why):
    with pytest.raises(hpack.HPACKError):
        hpack.huffman_decode(bad)


def test_hpack_size_update_rules():
    d = hpack.Decoder(max_table_size=4096)
    d.decode(_hex(C3[0]))
    assert d.size == 57
    d.decode(b"\x20")  # size update to 0 at the start of a block evicts all
    assert (d.table, d.size, d.max_size) == ([], 0, 0)
    with pytest.raises(hpack.HPACKError):
        d.decode(b"\x3f\xe2\x1f")  # 4097 > the bound our SETTINGS gave
    with pytest.raises(hpack.HPACKError):
        d.decode(b"\x82\x20")  # an update after a header field
    with pytest.raises(hpack.HPACKError):
        d.decode(b"\xff\x00")  # an index past both tables


@pytest.mark.parametrize("huffman", [True, False])
def test_hpack_encoder_is_decodable_and_stateless(huffman):
    headers = [(":status", "200"), ("content-type", "application/grpc"),
               ("grpc-message", "x" * 300), ("custom-bin", "AAEC")]
    enc = hpack.Encoder(huffman=huffman)
    d = hpack.Decoder()
    for _ in range(2):
        assert d.decode(enc.encode(headers)) == headers
    assert d.table == []  # literals without indexing only


# -- protobuf: the port's wire against google.protobuf --------------------------

def _read(*parts) -> bytes:
    with open(os.path.join(ROOT, *parts), "rb") as f:
        return f.read()


def _coordination_fds() -> bytes:
    from gofr_tpu_torch.distributed import coordination_gofr

    return coordination_gofr._FDS


ALL_TYPES_PROTO = """
syntax = "proto3";
package wire.v1;
enum Color { RED = 0; GREEN = 1; BLUE = 2; }
message Scalars {
  double d = 1; float f = 2; int64 i64 = 3; uint64 u64 = 4; int32 i32 = 5;
  fixed64 f64 = 6; fixed32 f32 = 7; bool b = 8; string s = 9; bytes by = 10;
  uint32 u32 = 11; Color color = 12; sfixed32 sf32 = 13; sfixed64 sf64 = 14;
  sint32 si32 = 15; sint64 si64 = 16;
  repeated sint64 r_si64 = 17; repeated double r_d = 18; repeated Color r_color = 19;
  repeated fixed32 r_f32 = 20; repeated bool r_b = 21; repeated int32 r_i32 = 22;
  map<int32, string> by_id = 23; map<string, Scalars> children = 24;
  Scalars child = 25;
  oneof pick { string name = 26; int64 number = 27; Scalars nested = 28; }
  optional int32 maybe = 29;
}
"""


def _all_types_fds(tmp_path_factory) -> bytes:
    if shutil.which("protoc") is None:
        pytest.skip("needs the system protoc to compile the all-types proto")
    tmp = tmp_path_factory.mktemp("wire")
    (tmp / "wire.proto").write_text(ALL_TYPES_PROTO)
    out = tmp / "wire.binpb"
    subprocess.run(["protoc", f"--descriptor_set_out={out}", f"-I{tmp}", "wire.proto"],
                   check=True, capture_output=True, timeout=60)
    return out.read_bytes()


SETS = {
    "health": lambda f: _read("gofr_tpu_torch", "grpcx", "protos", "health.binpb"),
    "reflection": lambda f: _read("gofr_tpu_torch", "grpcx", "protos", "reflection.binpb"),
    "pubsub": lambda f: _read("gofr_tpu_torch", "pubsub", "protos", "pubsub_v1.binpb"),
    "coordination": lambda f: _coordination_fds(),
    "all_types": _all_types_fds,
}


def _ref_classes(fds_bytes: bytes) -> dict:
    fds = descriptor_pb2.FileDescriptorSet.FromString(fds_bytes)
    pool = descriptor_pool.DescriptorPool()
    for f in fds.file:
        pool.Add(f)
    out = {}
    for f in fds.file:
        fd = pool.FindFileByName(f.name)

        def walk(msgs):
            for m in msgs:
                out[m.full_name] = message_factory.GetMessageClass(m)
                walk(m.nested_types)

        walk(fd.message_types_by_name.values())
    return out


@pytest.fixture(scope="module", params=sorted(SETS))
def wire_set(request, tmp_path_factory):
    data = SETS[request.param](tmp_path_factory)
    return request.param, data, protowire.load_messages(data), _ref_classes(data)


def test_descriptor_files_keep_their_bytes(wire_set):
    """Reflection serves a file with the bytes its set held."""
    _name, data, _port, _ref = wire_set
    ours = protowire.parse_descriptor_set(data)
    theirs = descriptor_pb2.FileDescriptorSet.FromString(data).file
    assert [f.name for f in ours] == [f.name for f in theirs]
    assert [f.raw for f in ours] == [f.SerializeToString() for f in theirs]
    assert [f.package for f in ours] == [f.package for f in theirs]
    assert [[s.full_name for s in f.services] for f in ours] == \
        [[f"{f.package}.{s.name}" for s in f.service] for f in theirs]


_INT = {protowire.TYPE_INT32: (-(1 << 31), (1 << 31) - 1),
        protowire.TYPE_SINT32: (-(1 << 31), (1 << 31) - 1),
        protowire.TYPE_SFIXED32: (-(1 << 31), (1 << 31) - 1),
        protowire.TYPE_UINT32: (0, (1 << 32) - 1), protowire.TYPE_FIXED32: (0, (1 << 32) - 1),
        protowire.TYPE_INT64: (-(1 << 63), (1 << 63) - 1),
        protowire.TYPE_SINT64: (-(1 << 63), (1 << 63) - 1),
        protowire.TYPE_SFIXED64: (-(1 << 63), (1 << 63) - 1),
        protowire.TYPE_UINT64: (0, (1 << 64) - 1), protowire.TYPE_FIXED64: (0, (1 << 64) - 1)}


def _f32(x: float) -> float:
    return struct.unpack("<f", struct.pack("<f", x))[0]


def _scalar(f) -> st.SearchStrategy:
    t = f.type
    if t in _INT:
        lo, hi = _INT[t]
        return st.one_of(st.integers(lo, hi), st.sampled_from([0, lo, hi, 1, -1 if lo else 2]))
    if t == protowire.TYPE_BOOL:
        return st.booleans()
    if t == protowire.TYPE_STRING:
        return st.text(max_size=12)
    if t == protowire.TYPE_BYTES:
        return st.binary(max_size=12)
    if t == protowire.TYPE_DOUBLE:
        return st.floats(allow_nan=False, allow_infinity=True)
    if t == protowire.TYPE_FLOAT:
        return st.floats(allow_nan=False, allow_infinity=True, width=32).map(_f32)
    if t == protowire.TYPE_ENUM:
        return st.sampled_from(sorted(f.enum.values))
    raise AssertionError(t)


def _spec(mdesc, depth: int = 0) -> st.SearchStrategy:
    """A dict {field name: value} for one message: scalars, lists, maps,
    nested dicts, and at most one member of each oneof."""
    parts = {}
    for f in mdesc.fields:
        if f.oneof is not None:
            continue
        if f.is_map:
            kf, vf = f.message.by_number[1], f.message.by_number[2]
            if vf.type == protowire.TYPE_MESSAGE:
                if depth >= 2:
                    continue
                val = _spec(vf.message, depth + 1)
            else:
                val = _scalar(vf)
            parts[f.name] = st.dictionaries(_scalar(kf), val, max_size=3)
        elif f.type == protowire.TYPE_MESSAGE:
            if depth >= 2:
                continue
            sub = _spec(f.message, depth + 1)
            parts[f.name] = st.lists(sub, max_size=3) if f.repeated else st.one_of(st.none(), sub)
        elif f.repeated:
            parts[f.name] = st.lists(_scalar(f), max_size=4)
        else:
            parts[f.name] = _scalar(f)
    oneofs = []
    for name in mdesc.oneofs:
        members = [f for f in mdesc.fields if f.oneof == name]
        if not members:
            continue  # a proto3 optional's synthetic oneof
        choices = [st.none()]
        for f in members:
            if f.type == protowire.TYPE_MESSAGE:
                if depth < 2:
                    choices.append(st.tuples(st.just(f.name), _spec(f.message, depth + 1)))
            else:
                choices.append(st.tuples(st.just(f.name), _scalar(f)))
        oneofs.append(st.one_of(*choices))
    return st.tuples(st.fixed_dictionaries(parts), st.tuples(*oneofs)).map(
        lambda t: {**t[0], **{k: v for k, v in (c for c in t[1] if c is not None)}})


def _fill(msg, mdesc, spec: dict) -> None:
    """Set ``spec`` on ``msg`` with the API both message classes share."""
    for name, value in spec.items():
        f = mdesc.by_name[name]
        if value is None:
            continue
        if f.is_map:
            vf = f.message.by_number[2]
            target = getattr(msg, name)
            for k, v in value.items():
                if vf.type == protowire.TYPE_MESSAGE:
                    _fill(target[k], vf.message, v)
                else:
                    target[k] = v
        elif f.type == protowire.TYPE_MESSAGE and f.repeated:
            for v in value:
                _fill(getattr(msg, name).add(), f.message, v)
        elif f.type == protowire.TYPE_MESSAGE:
            sub = getattr(msg, name)
            sub.SetInParent()
            _fill(sub, f.message, value)
        elif f.repeated:
            getattr(msg, name).extend(value)
        else:
            setattr(msg, name, value)


def _has_map(mdesc, spec: dict) -> bool:
    for name, value in spec.items():
        f = mdesc.by_name[name]
        if f.is_map and value:
            return True
        if f.type == protowire.TYPE_MESSAGE and not f.is_map and value is not None:
            subs = value if f.repeated else [value]
            if any(_has_map(f.message, v) for v in subs):
                return True
    return False


def _eq_float_aware(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_eq_float_aware(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_eq_float_aware(x, y) for x, y in zip(a, b))
    return a == b


@seed(20261018)
@settings(max_examples=40, deadline=None, derandomize=False,
          suppress_health_check=[HealthCheck.function_scoped_fixture, HealthCheck.too_slow])
@given(data=st.data())
def test_protowire_matches_protobuf(wire_set, data):
    _name, _fds, port, ref = wire_set
    full = data.draw(st.sampled_from(sorted(port)))
    cls, rcls = port[full], ref[full]
    spec = data.draw(_spec(cls.DESCRIPTOR))
    ours, theirs = cls(), rcls()
    _fill(ours, cls.DESCRIPTOR, spec)
    _fill(theirs, cls.DESCRIPTOR, spec)
    has_map = _has_map(cls.DESCRIPTOR, spec)
    ob, tb = ours.SerializeToString(), theirs.SerializeToString()
    if not has_map:  # map entries' order is the implementation's own
        assert ob == tb
    # each side parses the other's bytes to an equal message
    assert rcls.FromString(ob) == theirs
    assert cls.FromString(tb) == ours
    assert cls.FromString(ob) == ours
    mine = ours.to_dict(preserving_proto_field_name=True)
    want = pb_json.MessageToDict(theirs, preserving_proto_field_name=True)
    assert _eq_float_aware(mine, want), (mine, want)
    for oneof in cls.DESCRIPTOR.oneofs:
        if any(f.oneof == oneof for f in cls.DESCRIPTOR.fields):
            assert ours.WhichOneof(oneof) == theirs.WhichOneof(oneof)


def test_protowire_presence_and_oneof_rules():
    """A sub-message is present once one of its fields is set (or a
    repeated field of it added to); setting one oneof member clears the
    others; unknown fields are skipped; scalars have no presence."""
    msgs = protowire.load_messages(_read("gofr_tpu_torch", "grpcx", "protos", "reflection.binpb"))
    ref = _ref_classes(_read("gofr_tpu_torch", "grpcx", "protos", "reflection.binpb"))
    name = "grpc.reflection.v1alpha.ServerReflectionResponse"
    for cls in (msgs[name], ref[name]):
        r = cls()
        assert not r.HasField("original_request")
        _ = r.original_request.host  # reading does not make it present
        assert not r.HasField("original_request")
        r.list_services_response.service.add().name = "a"
        assert r.WhichOneof("message_response") == "list_services_response"
        r.error_response.error_code = 0  # zero, yet present: it is in a oneof
        assert r.WhichOneof("message_response") == "error_response"
        assert not r.HasField("list_services_response")
    port_bytes = msgs[name](valid_host="h").SerializeToString()
    unknown = port_bytes + b"\xf8\x06\x07" + b"\x82\x07\x02hi"  # fields 111 and 112
    assert msgs[name].FromString(unknown).valid_host == "h"
    with pytest.raises(AttributeError):
        msgs[name]().no_such_field
    with pytest.raises(TypeError):
        msgs[name](valid_host=3)


# -- HTTP/2 over a raw socket ----------------------------------------------------

def _frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    return len(payload).to_bytes(3, "big") + bytes((ftype, flags)) + sid.to_bytes(4, "big") + payload


def _read_frame(sock: socket.socket) -> tuple[int, int, int, bytes]:
    def exact(n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("closed")
            buf += chunk
        return buf

    head = exact(9)
    n = int.from_bytes(head[:3], "big")
    return head[3], head[4], int.from_bytes(head[5:9], "big") & 0x7FFFFFFF, exact(n) if n else b""


class _LoopServer:
    """The port's RpcServer on a loop thread, serving echo handlers."""

    def __init__(self) -> None:
        from gofr_tpu_torch.grpcx.runtime import method_handler

        async def echo(request, context):
            context.set_trailing_metadata(context.invocation_metadata())
            return request

        handlers = {"/t.T/Echo": method_handler("unary_unary", echo)}
        self.server = h2.RpcServer(handlers.get)
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        self.port = asyncio.run_coroutine_threadsafe(
            self.server.start("127.0.0.1", 0), self.loop).result(SOCK_TIMEOUT)

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.server.stop(0.1), self.loop).result(SOCK_TIMEOUT)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(SOCK_TIMEOUT)


@pytest.fixture
def loop_server():
    s = _LoopServer()
    yield s
    s.close()


def _request_headers(extra=()) -> bytes:
    return hpack.Encoder().encode([
        (":method", "POST"), (":scheme", "http"), (":path", "/t.T/Echo"),
        (":authority", "x"), ("content-type", "application/grpc"), ("te", "trailers"),
        *extra])


def _raw_call(port: int, frames: bytes) -> dict:
    """Send the preface, SETTINGS and ``frames``; read until the stream's
    END_STREAM. Returns what came back."""
    out = {"first": None, "pings": [], "headers": [], "data": b"", "settings_ack": False}
    dec = hpack.Decoder()
    with socket.create_connection(("127.0.0.1", port), timeout=SOCK_TIMEOUT) as sock:
        sock.settimeout(SOCK_TIMEOUT)
        sock.sendall(h2.PREFACE + _frame(h2.SETTINGS, 0, 0) + _frame(h2.PING, 0, 0, b"pingpong")
                     + frames)
        block = b""
        while True:
            ftype, flags, sid, payload = _read_frame(sock)
            if out["first"] is None:
                out["first"] = ftype
            if ftype == h2.SETTINGS and not flags & h2.FLAG_ACK:
                sock.sendall(_frame(h2.SETTINGS, h2.FLAG_ACK, 0))
            elif ftype == h2.SETTINGS:
                out["settings_ack"] = True
            elif ftype == h2.PING and flags & h2.FLAG_ACK:
                out["pings"].append(payload)
                if out["headers"] and "grpc-status" in out["headers"][-1]:
                    return out
            elif ftype in (h2.HEADERS, h2.CONTINUATION):
                block += payload
                if flags & h2.FLAG_END_HEADERS:
                    out["headers"].append(dict(dec.decode(block)))
                    block = b""
                    if "grpc-status" in out["headers"][-1] and out["pings"]:
                        return out
            elif ftype == h2.DATA:
                out["data"] += payload


def test_raw_h2_settings_first_ping_and_compressed_refusal(loop_server):
    body = b"\x01" + (3).to_bytes(4, "big") + b"abc"  # compressed flag set
    frames = _frame(h2.HEADERS, h2.FLAG_END_HEADERS, 1, _request_headers()) \
        + _frame(h2.DATA, h2.FLAG_END_STREAM, 1, body)
    out = _raw_call(loop_server.port, frames)
    assert out["first"] == h2.SETTINGS  # the server's preface comes first
    assert out["headers"][-1]["grpc-status"] == str(h2.StatusCode.UNIMPLEMENTED.value[0])
    assert out["pings"] == [b"pingpong"] and out["settings_ack"]


def test_raw_h2_continuation_both_ways(loop_server):
    """A 40 KB metadata value: our raw client splits the block over HEADERS
    and CONTINUATION frames, the server reassembles it, and echoes it back
    in trailers that themselves exceed one frame."""
    big = "v" * 40_000
    block = _request_headers([("x-big", big)])
    frames = _frame(h2.HEADERS, 0, 1, block[:16_384]) \
        + _frame(h2.CONTINUATION, 0, 1, block[16_384:32_768]) \
        + _frame(h2.CONTINUATION, h2.FLAG_END_HEADERS, 1, block[32_768:]) \
        + _frame(h2.DATA, h2.FLAG_END_STREAM, 1, h2.encode_message(b"hello"))
    out = _raw_call(loop_server.port, frames)
    trailers = out["headers"][-1]
    assert trailers["grpc-status"] == "0"
    assert trailers["x-big"] == big
    assert out["data"] == h2.encode_message(b"hello")


def test_port_client_large_metadata_and_bin_round_trip(loop_server):
    async def go():
        ch = h2.Channel(f"127.0.0.1:{loop_server.port}")
        try:
            call = ch.unary_unary("/t.T/Echo")
            md = (("x-big", "w" * 30_000), ("blob-bin", bytes(range(256))))
            return await asyncio.wait_for(call(b"ping", metadata=md, timeout=5), SOCK_TIMEOUT)
        finally:
            await ch.close()

    assert asyncio.run(go()) == b"ping"


@pytest.mark.parametrize("seconds,expect", [
    (0.5, "500000u"), (2.0, "2000000u"), (1e-6, "1000n"), (150.0, "150000m"),
    (3 * 3600 * 24 * 365, "94608000S"), (4 * 3600 * 24 * 365, "2102400M"),
])
def test_grpc_timeout_units(seconds, expect):
    enc = h2.encode_timeout(seconds)
    assert len(enc) <= 9
    assert enc == expect
    assert h2.decode_timeout(enc) == pytest.approx(seconds, rel=1e-6)
    for unit, scale in (("H", 3600), ("M", 60), ("S", 1), ("m", 1e-3), ("u", 1e-6), ("n", 1e-9)):
        assert h2.decode_timeout(f"7{unit}") == pytest.approx(7 * scale)
    with pytest.raises(ValueError):
        h2.decode_timeout("123456789S")  # nine digits


def test_grpc_message_percent_encoding_and_bin_metadata():
    msg = "bad: 100% / naïve\n"
    enc = h2.encode_grpc_message(msg)
    assert enc == "bad: 100%25 / na%C3%AFve%0A"
    assert h2.decode_grpc_message(enc) == msg
    headers = h2.metadata_headers([("Trace-Bin", b"\x00\x01\xff"), ("k", "v")])
    assert headers == [("trace-bin", base64.b64encode(b"\x00\x01\xff").decode().rstrip("=")),
                       ("k", "v")]
    assert h2.headers_metadata(headers + [(":status", "200"), ("grpc-status", "0")]) == \
        (("trace-bin", b"\x00\x01\xff"), ("k", "v"))
