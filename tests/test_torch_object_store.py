"""The port's object stores (``gofr_tpu_torch/datasource/file/object_store.py``,
``gcs.py``, ``s3.py``) and its fake (``gofr_tpu_torch/testutil/
object_store_server.py``) beside the JAX package's: the cases of
``tests/test_object_store.py`` one by one, each with every client (either
package's ``ObjectFileSystem`` over its own ``GCSProvider`` or
``S3Provider``) against either package's ``FakeObjectStore``, so each fake
verifies the other package's SigV4 signatures. Then SigV4 itself: the
signing key, canonical request, string to sign and the signed headers are
byte-equal for fixed keys and a fixed time; the ``app_file_stats``
observations by operation and backend equal the reference's; ``read_range``
pulls only the bytes asked for. Weight loading through these stores is in
``tests/test_torch_file_weights.py``."""

import datetime
import types

import pytest

from gofr_tpu.datasource.file import gcs as rgcs
from gofr_tpu.datasource.file import object_store as robj
from gofr_tpu.datasource.file import s3 as rs3
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu.testutil.object_store_server import FakeObjectStore as RFakeObjectStore
from gofr_tpu_torch.datasource.file import gcs as tgcs
from gofr_tpu_torch.datasource.file import object_store as tobj
from gofr_tpu_torch.datasource.file import s3 as ts3
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil.object_store_server import FakeObjectStore

PKGS = {
    "ref": types.SimpleNamespace(gcs=rgcs, s3=rs3, obj=robj, manager=r_new_metrics_manager),
    "port": types.SimpleNamespace(gcs=tgcs, s3=ts3, obj=tobj, manager=new_metrics_manager),
}
SIDES = sorted(PKGS)


@pytest.fixture(scope="module")
def fakes():
    out = {"ref": RFakeObjectStore(), "port": FakeObjectStore()}
    yield out
    for fake in out.values():
        fake.close()


def gcs_fs(side, fake):
    p = PKGS[side]
    return p.obj.ObjectFileSystem(p.gcs.GCSProvider("test-bucket", endpoint=fake.gcs_endpoint),
                                  name="gcs")


def s3_fs(side, fake, secret=None):
    p = PKGS[side]
    return p.obj.ObjectFileSystem(
        p.s3.S3Provider("test-bucket", endpoint=fake.s3_endpoint, region=fake.region,
                        access_key=fake.access_key, secret_key=secret or fake.secret_key),
        name="s3")


CASES = [(c, s, kind) for c in SIDES for s in SIDES for kind in ("gcs", "s3")]


@pytest.fixture(params=CASES, ids=[f"{c}-client-{s}-fake-{k}" for c, s, k in CASES])
def fs(request, fakes):
    client, server, kind = request.param
    fake = fakes[server]
    fake.store.blobs.clear()
    return (gcs_fs if kind == "gcs" else s3_fs)(client, fake)


# ---------------------------------------------------------------- the reference's cases
class TestStorageContract:
    def test_write_read_roundtrip(self, fs):
        with fs.open("dir/hello.txt", "wb") as f:
            f.write(b"hello object world")
        assert fs.exists("dir/hello.txt")
        with fs.open("dir/hello.txt", "rb") as f:
            assert f.read() == b"hello object world"
        # text mode: the object store's default mode, as the reference's
        with fs.open("dir/hello.txt") as f:
            assert f.read() == "hello object world"

    def test_range_reader(self, fs):
        with fs.open("blob.bin", "wb") as f:
            f.write(bytes(range(100)))
        assert fs.read_range("blob.bin", 10, 5) == bytes(range(10, 15))
        assert fs.read_range("blob.bin", 90) == bytes(range(90, 100))

    def test_stat_and_missing(self, fs):
        with fs.open("a/b.txt", "wb") as f:
            f.write(b"12345")
        info = fs.stat("a/b.txt")
        assert (info.name, info.size, info.is_dir) == ("b.txt", 5, False)
        assert not fs.exists("nope.txt")
        with pytest.raises(FileNotFoundError):
            fs.stat("nope.txt")
        with pytest.raises(FileNotFoundError):
            fs.open("nope.txt", "rb")

    def test_read_dir_objects_and_prefixes(self, fs):
        for name in ("m/config.json", "m/weights.safetensors", "m/sub/x.bin", "top.txt"):
            with fs.open(name, "wb") as f:
                f.write(b"x")
        entries = {e.name: e for e in fs.read_dir("m")}
        assert set(entries) == {"config.json", "weights.safetensors", "sub"}
        assert entries["sub"].is_dir
        assert not entries["config.json"].is_dir
        top = {e.name for e in fs.read_dir("")}
        assert "top.txt" in top and "m" in top

    def test_rename_and_remove(self, fs):
        with fs.open("old.txt", "wb") as f:
            f.write(b"data")
        fs.rename("old.txt", "new.txt")
        assert not fs.exists("old.txt") and fs.exists("new.txt")
        fs.remove("new.txt")
        assert not fs.exists("new.txt")

    def test_remove_all_prefix(self, fs):
        for i in range(3):
            with fs.open(f"tree/f{i}", "wb") as f:
                f.write(b"x")
        with fs.open("keep.txt", "wb") as f:
            f.write(b"x")
        fs.remove_all("tree")
        assert fs.read_dir("tree") == []
        assert fs.exists("keep.txt")

    def test_health_check(self, fs):
        assert fs.health_check()["status"] == "UP"


S3_CASES = [(c, s) for c in SIDES for s in SIDES]


@pytest.mark.parametrize("client,server", S3_CASES)
class TestS3Signing:
    def test_bad_secret_rejected(self, fakes, client, server):
        bad = s3_fs(client, fakes[server], secret="wrong-secret")
        with pytest.raises(OSError, match="403"):
            with bad.open("x.txt", "wb") as f:
                f.write(b"data")

    def test_good_secret_accepted(self, fakes, client, server):
        good = s3_fs(client, fakes[server])
        with good.open("signed.txt", "wb") as f:
            f.write(b"data")
        assert good.exists("signed.txt")


# ---------------------------------------------------------------- SigV4 byte for byte
class FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2024, 5, 17, 8, 9, 10, tzinfo=tz)


def test_sigv4_pieces_are_byte_equal_for_fixed_keys_and_time(monkeypatch):
    for mod in (rs3, ts3):
        monkeypatch.setattr(mod, "datetime", types.SimpleNamespace(
            datetime=FixedNow, timezone=datetime.timezone))
    assert ts3.signing_key("secret", "20240517", "eu-west-1", "s3") == \
        rs3.signing_key("secret", "20240517", "eu-west-1", "s3")
    assert ts3.signing_key("wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "20150830", "us-east-1",
                           "iam").hex() == \
        "c4afb1cc5771d871763a393e44b703571b55cc28424d1a5e86da6ed3c154a4b9"  # AWS's example
    headers = {"host": "s3.example:9000", "x-amz-date": "20240517T080910Z",
               "x-amz-content-sha256": "UNSIGNED", "range": "bytes=0-  9"}
    for method, path, query in (("GET", "/b/k ey/ü.bin", "list-type=2&prefix=a%2Fb&delimiter=/"),
                                ("PUT", "/b/x", ""), ("HEAD", "/b", "z=1&a=&m=%20")):
        creq = ts3.canonical_request(method, path, query, headers, sorted(headers), "abc")
        assert creq == rs3.canonical_request(method, path, query, headers, sorted(headers), "abc")
        scope = "20240517/eu-west-1/s3/aws4_request"
        assert ts3.string_to_sign("20240517T080910Z", scope, creq) == \
            rs3.string_to_sign("20240517T080910Z", scope, creq)
    for payload in (b"", b"payload", bytes(range(256)) * 3):
        kw = dict(endpoint="http://127.0.0.1:9000", region="eu-west-1", access_key="AK",
                  secret_key="SK")
        got = ts3.S3Provider("bkt", **kw)._sign("PUT", "/bkt/a b", "x=1", payload,
                                                {"Range": "bytes=1-2"})
        want = rs3.S3Provider("bkt", **kw)._sign("PUT", "/bkt/a b", "x=1", payload,
                                                 {"Range": "bytes=1-2"})
        assert got == want and got["x-amz-date"] == "20240517T080910Z"


# ---------------------------------------------------------------- stats and ranges
@pytest.mark.parametrize("kind", ["gcs", "s3"])
def test_file_stats_by_operation_and_backend_match_the_reference(fakes, kind):
    seen = {}
    ops = ("OPEN_WRITE", "WRITE", "OPEN_READ", "READ_RANGE", "STAT", "READDIR", "RENAME",
           "DELETE", "DELETE_ALL")
    for side in SIDES:
        fakes[side].store.blobs.clear()
        fs = (gcs_fs if kind == "gcs" else s3_fs)(side, fakes[side])
        m = PKGS[side].manager()
        m.new_histogram("app_file_stats", "Duration of file-system operations in milliseconds")
        fs.use_metrics(m)
        fs.use_logger(None)
        fs.use_tracer(None)
        fs.connect()
        for name in ("p/a.bin", "p/b.bin"):
            with fs.open(name, "wb") as f:
                f.write(b"0123456789")
        with fs.open("p/a.bin", "rb") as f:
            f.read()
        fs.read_range("p/a.bin", 2, 3)
        fs.stat("p/a.bin")
        fs.read_dir("p")
        fs.rename("p/a.bin", "p/c.bin")
        fs.remove("p/c.bin")
        fs.remove_all("p")
        with fs.create("q.bin") as f:
            f.write(b"q")
        seen[side] = {op: m.get("app_file_stats").snapshot({"operation": op,
                                                            "backend": kind})[1] for op in ops}
        fs.close()
    assert seen["port"] == seen["ref"]
    assert seen["port"]["WRITE"] == 3 and seen["port"]["DELETE"] == 1


@pytest.mark.parametrize("kind", ["gcs", "s3"])
def test_read_range_pulls_only_the_bytes_asked_for(fakes, kind):
    """A safetensors-style header probe: the reply carries the asked range,
    not the object."""
    fake = fakes["port"]
    fake.store.blobs.clear()
    fs = (gcs_fs if kind == "gcs" else s3_fs)("port", fake)
    blob = (1234).to_bytes(8, "little") + b"{" * 1234 + bytes(1 << 20)
    with fs.open("w.safetensors", "wb") as f:
        f.write(blob)
    head = fs.read_range("w.safetensors", 0, 8)
    n = int.from_bytes(head, "little")
    assert n == 1234 and fs.read_range("w.safetensors", 8, n) == b"{" * 1234
    reader = fs.provider.new_reader("w.safetensors", offset=8, length=n)
    raw = reader.raw._resp
    assert int(raw.headers["Content-Length"]) == n and raw.status == 206
    reader.close()
