"""The port's SFTP file system and SSH transport
(``gofr_tpu_torch/datasource/file/sftp.py``, ``ssh_transport.py``) and its
SFTP server (``gofr_tpu_torch/testutil/sftp_server.py``) beside the JAX
package's: the cases of ``tests/test_sftp.py`` one by one, each with either
package's ``SFTPFileSystem`` against either package's ``MiniSFTPServer``.
The curve25519 key exchange, the ed25519 host-key signature, the
aes128-ctr + hmac-sha2-256 packets and password auth are thus run
cross-wired: each side derives its keys on its own from the exchange hash.
Then the port's repair of ROADMAP Queue C 51 (``open(name, mode)`` and
``exists``), and the refusal at construction without ``cryptography``."""

import hashlib
import os
import types

import pytest

pytest.importorskip("cryptography")

from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.datasource.file import sftp as rsftp  # noqa: E402
from gofr_tpu.datasource.file import ssh_transport as rssh  # noqa: E402
from gofr_tpu.testutil.sftp_server import MiniSFTPServer as RMiniSFTPServer  # noqa: E402
from gofr_tpu_torch.config import MapConfig  # noqa: E402
from gofr_tpu_torch.datasource.file import sftp as tsftp  # noqa: E402
from gofr_tpu_torch.datasource.file import ssh_transport as tssh  # noqa: E402
from gofr_tpu_torch.testutil import sftp_server as tsftp_server  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(sftp=rsftp, ssh=rssh, Server=RMiniSFTPServer,
                                 MapConfig=RMapConfig),
    "port": types.SimpleNamespace(sftp=tsftp, ssh=tssh, Server=tsftp_server.MiniSFTPServer,
                                  MapConfig=MapConfig),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {side: PKGS[side].Server(str(tmp_path_factory.mktemp(f"sftp-root-{side}")),
                                   user="gofr", password="secret") for side in SIDES}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(params=CROSS, ids=[f"{c}-client-{s}-server" for c, s in CROSS])
def pair(request, servers):
    client, side = request.param
    server = servers[side]
    f = PKGS[client].sftp.SFTPFileSystem(host="127.0.0.1", port=server.port, user="gofr",
                                         password="secret")
    f.connect()
    yield f, server, PKGS[client]
    f.close()


@pytest.fixture
def fs(pair):
    return pair[0]


@pytest.fixture
def server(pair):
    return pair[1]


@pytest.fixture
def mods(pair):
    """The client's package: its errors are the ones raised."""
    return pair[2]


def test_handshake_and_auth(fs):
    assert fs.getwd() == "/"
    assert fs.health_check()["status"] == "UP"


@pytest.mark.parametrize("client,side", CROSS)
def test_wrong_password_rejected(servers, client, side):
    p = PKGS[client]
    bad = p.sftp.SFTPFileSystem(host="127.0.0.1", port=servers[side].port, user="gofr",
                                password="nope")
    with pytest.raises(p.ssh.SSHAuthError):
        bad.connect()


def test_file_roundtrip(fs, server):
    with fs.create("hello.txt") as f:
        f.write(b"hello over ssh")
    with fs.open("hello.txt") as f:
        assert f.read() == b"hello over ssh"
    # the bytes really landed in the server's root on disk
    with open(os.path.join(server.root, "hello.txt"), "rb") as disk:
        assert disk.read() == b"hello over ssh"
    info = fs.stat("hello.txt")
    assert info.size == 14 and not info.is_dir


def test_append_mode(fs):
    with fs.open_file("log.txt", "wb") as f:
        f.write(b"line1\n")
    with fs.open_file("log.txt", "ab") as f:
        f.write(b"line2\n")
    with fs.open("log.txt") as f:
        assert f.read() == b"line1\nline2\n"


def test_dirs_rename_remove(fs, mods):
    fs.mkdir("a/b/c")  # parents
    fs.stat("a/b/c")
    with fs.create("a/b/c/f.bin") as f:
        f.write(b"x" * 100)
    entries = fs.read_dir("a/b")
    assert [e.name for e in entries] == ["c"]
    assert entries[0].is_dir

    fs.rename("a/b/c/f.bin", "a/b/c/g.bin")
    assert fs.stat("a/b/c/g.bin").size == 100
    with pytest.raises(mods.sftp.SFTPError):
        fs.stat("a/b/c/f.bin")

    fs.remove_all("a")  # recursive
    with pytest.raises(mods.sftp.SFTPError):
        fs.stat("a")


def test_chdir_and_relative_paths(fs):
    fs.mkdir("workdir")
    fs.chdir("workdir")
    assert fs.getwd() == "/workdir"
    with fs.create("rel.txt") as f:
        f.write(b"relative")
    assert fs.stat("/workdir/rel.txt").size == 8
    fs.chdir("/")
    fs.remove_all("workdir")


def test_path_escape_contained(fs, server, mods):
    """chroot containment: ../ cannot leave the server root."""
    secret = os.path.join(os.path.dirname(server.root), "outside.txt")
    with open(secret, "w") as f:
        f.write("secret")
    try:
        # normalization pins the path inside the root → no such file there
        with pytest.raises(mods.sftp.SFTPError):
            fs.open("../outside.txt").read()
    finally:
        os.remove(secret)


def test_large_transfer_exercises_flow_control(fs):
    """> window/2 bytes each way forces CHANNEL_WINDOW_ADJUST."""
    blob = os.urandom(3 * 1024 * 1024)
    with fs.create("big.bin") as f:
        f.write(blob)
    with fs.open("big.bin") as f:
        assert f.read() == blob
    fs.remove("big.bin")


def test_seek_and_partial_read(fs):
    with fs.create("seek.bin") as f:
        f.write(b"0123456789")
    with fs.open("seek.bin") as f:
        f.seek(4)
        assert f.read(3) == b"456"
        assert f.tell() == 7
    fs.remove("seek.bin")


@pytest.mark.parametrize("side", SIDES)
def test_from_config(side):
    p = PKGS[side]
    f = p.sftp.SFTPFileSystem.from_config(p.MapConfig({
        "SFTP_HOST": "h", "SFTP_PORT": "2022", "SFTP_USER": "u",
        "SFTP_PASSWORD": "p", "SFTP_HOST_KEY_FINGERPRINT": "AB:cd",
    }, use_env=False))
    assert (f.host, f.port, f.user, f.password, f.host_key_fingerprint) == \
        ("h", 2022, "u", "p", "abcd")


@pytest.mark.parametrize("side", SIDES)
def test_health_down_when_disconnected(side):
    f = PKGS[side].sftp.SFTPFileSystem(host="127.0.0.1", port=1, connect_timeout=0.3)
    assert f.health_check()["status"] == "DOWN"


def test_text_mode_returns_str(fs):
    with fs.open_file("text.txt", "w") as f:
        f.write("line1\nline2\n")
    with fs.open_file("text.txt", "r") as f:
        content = f.read()
    assert isinstance(content, str) and content.splitlines() == ["line1", "line2"]
    fs.remove("text.txt")


def test_remove_all_unlinks_symlink_without_recursing(fs, server, mods):
    """A symlinked directory inside the tree is unlinked, not descended —
    its target's contents must survive."""
    target = os.path.join(os.path.dirname(server.root), "shared-data")
    os.makedirs(target, exist_ok=True)
    keep = os.path.join(target, "keep.txt")
    with open(keep, "w") as f:
        f.write("precious")
    try:
        fs.mkdir("staging")
        os.symlink(target, os.path.join(server.root, "staging", "shared"))
        fs.remove_all("staging")
        assert os.path.exists(keep), "symlink target contents must survive"
        with pytest.raises(mods.sftp.SFTPError):
            fs.stat("staging")
    finally:
        import shutil

        shutil.rmtree(target, ignore_errors=True)


def test_text_plus_mode_read_write_seek(fs):
    """'w+'/'r+' text modes use BufferedRandom: write, seek, read back."""
    with fs.open_file("rw.txt", "w+") as f:
        f.write("alpha beta")
        f.seek(0)
        assert f.read() == "alpha beta"
    with fs.open_file("rw.txt", "r+") as f:
        assert f.read(5) == "alpha"
    fs.remove("rw.txt")


def test_host_key_pinning(fs, server, mods):
    good = hashlib.sha256(mods.ssh.ed25519_blob(server.host_key.public_key())).hexdigest()
    assert good == hashlib.sha256(rssh.ed25519_blob(server.host_key.public_key())).hexdigest()
    pinned = mods.sftp.SFTPFileSystem(host="127.0.0.1", port=server.port, user="gofr",
                                      password="secret", host_key_fingerprint=good)
    pinned.connect()
    assert pinned.health_check()["status"] == "UP"
    pinned.close()

    wrong = mods.sftp.SFTPFileSystem(host="127.0.0.1", port=server.port, user="gofr",
                                     password="secret", host_key_fingerprint="ab" * 32)
    with pytest.raises(mods.ssh.SSHError, match="fingerprint mismatch"):
        wrong.connect()


def test_dangling_symlink_lists_and_deletes(fs, server, mods):
    fs.mkdir("dangling")
    os.symlink("/no/such/target", os.path.join(server.root, "dangling", "dead"))
    names = [e.name for e in fs.read_dir("dangling")]
    assert names == ["dead"]
    fs.remove_all("dangling")
    with pytest.raises(mods.sftp.SFTPError):
        fs.stat("dangling")


# ---------------------------------------------------------------- Queue C 51
@pytest.mark.parametrize("side", SIDES)
def test_open_takes_a_mode_and_exists_on_either_server(servers, side):
    port = tsftp.SFTPFileSystem(host="127.0.0.1", port=servers[side].port, user="gofr",
                                password="secret")
    ref = rsftp.SFTPFileSystem(host="127.0.0.1", port=servers[side].port, user="gofr",
                               password="secret")
    port.connect()
    ref.connect()
    try:
        with port.open("m.bin", "wb") as f:
            f.write(b"\x00weights\xff")
        with port.open("m.bin", "rb") as f, ref.open("m.bin") as g:
            assert f.read() == g.read() == b"\x00weights\xff"
        with port.open("m.txt", "w") as f:
            f.write("text")
        with port.open("m.txt", "r") as f:
            assert f.read() == "text"
        assert port.exists("m.bin") and not port.exists("nope.bin")
        with pytest.raises(TypeError, match="positional argument"):
            ref.open("m.bin", "rb")
        port.remove("m.bin")
        port.remove("m.txt")
    finally:
        port.close()
        ref.close()


def test_without_cryptography_both_refuse_at_construction(monkeypatch, tmp_path):
    """No silent downgrade: the port's file system and server raise naming
    ``cryptography`` when it is missing."""
    monkeypatch.setattr(tssh, "_HAS_CRYPTO", False)
    monkeypatch.setattr(tsftp_server, "Ed25519PrivateKey", None)
    with pytest.raises(RuntimeError, match="cryptography"):
        tsftp.SFTPFileSystem(host="127.0.0.1", port=1)
    with pytest.raises(RuntimeError, match="cryptography"):
        tsftp_server.MiniSFTPServer(str(tmp_path))
