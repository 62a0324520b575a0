"""The port's FTP file system (``gofr_tpu_torch/datasource/file/ftp.py``) and
its RFC 959 server (``gofr_tpu_torch/testutil/ftp_server.py``) beside the
JAX package's: the cases of ``tests/test_ftp.py`` one by one, each with
either package's ``FTPFileSystem`` against either package's
``MiniFTPServer`` (auth, passive data connections, whole-file semantics,
directories, rename, recursive delete, chroot containment, health). Then
the port's repair of ROADMAP Queue C 51 (``open(name, mode)`` and
``exists``) beside the reference's ``open(name)``."""

import ftplib
import os
import types

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource.file.ftp import FTPFileSystem as RFTPFileSystem
from gofr_tpu.testutil.ftp_server import MiniFTPServer as RMiniFTPServer
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource.file.ftp import FTPFileSystem
from gofr_tpu_torch.testutil.ftp_server import MiniFTPServer

PKGS = {
    "ref": types.SimpleNamespace(FS=RFTPFileSystem, Server=RMiniFTPServer, MapConfig=RMapConfig),
    "port": types.SimpleNamespace(FS=FTPFileSystem, Server=MiniFTPServer, MapConfig=MapConfig),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    out = {side: PKGS[side].Server(str(tmp_path_factory.mktemp(f"ftp-root-{side}")),
                                   user="gofr", password="secret") for side in SIDES}
    yield out
    for s in out.values():
        s.close()


@pytest.fixture(params=CROSS, ids=[f"{c}-client-{s}-server" for c, s in CROSS])
def pair(request, servers):
    client, side = request.param
    server = servers[side]
    f = PKGS[client].FS(host="127.0.0.1", port=server.port, user="gofr", password="secret")
    f.connect()
    yield f, server
    f.close()


@pytest.fixture
def fs(pair):
    return pair[0]


@pytest.fixture
def server(pair):
    return pair[1]


def test_login_and_health(fs):
    health = fs.health_check()
    assert health["status"] == "UP"
    assert fs.getwd() == "/"


@pytest.mark.parametrize("client,side", CROSS)
def test_bad_login_rejected(servers, client, side):
    bad = PKGS[client].FS(host="127.0.0.1", port=servers[side].port, user="gofr",
                          password="wrong")
    with pytest.raises(ftplib.error_perm):
        bad.connect()


def test_roundtrip_and_on_disk(fs, server):
    with fs.create("report.bin") as f:
        f.write(b"ftp payload")
    assert fs.open("report.bin").read() == b"ftp payload"
    with open(os.path.join(server.root, "report.bin"), "rb") as disk:
        assert disk.read() == b"ftp payload"
    assert fs.stat("report.bin").size == 11


def test_text_and_append_modes(fs):
    with fs.open_file("notes.txt", "w") as f:
        f.write("alpha\n")
    with fs.open_file("notes.txt", "a") as f:
        f.write("beta\n")
    with fs.open_file("notes.txt", "r") as f:
        assert f.read() == "alpha\nbeta\n"
    fs.remove("notes.txt")


def test_dirs_rename_recursive_delete(fs):
    fs.mkdir("x/y/z")
    with fs.create("x/y/z/deep.bin") as f:
        f.write(b"d" * 64)
    entries = fs.read_dir("x/y")
    assert [e.name for e in entries] == ["z"] and entries[0].is_dir
    fs.rename("x/y/z/deep.bin", "x/y/z/deeper.bin")
    assert fs.stat("x/y/z/deeper.bin").size == 64
    fs.remove_all("x")
    with pytest.raises(FileNotFoundError):
        fs.stat("x")


def test_chdir(fs):
    fs.mkdir("sub")
    fs.chdir("sub")
    assert fs.getwd() == "/sub"
    with fs.create("in_sub.txt") as f:
        f.write(b"s")
    fs.chdir("/")
    assert fs.stat("/sub/in_sub.txt").size == 1
    fs.remove_all("sub")


def test_chroot_containment(fs, server):
    outside = os.path.join(os.path.dirname(server.root), "ftp-secret.txt")
    with open(outside, "w") as f:
        f.write("secret")
    try:
        # 550 maps to FileNotFoundError: the path does not exist within
        # the visible (chrooted) tree
        with pytest.raises(FileNotFoundError):
            fs.open("../ftp-secret.txt")
    finally:
        os.remove(outside)


@pytest.mark.parametrize("side", SIDES)
def test_from_config(side):
    p = PKGS[side]
    f = p.FS.from_config(p.MapConfig({
        "FTP_HOST": "h", "FTP_PORT": "2121", "FTP_USER": "u", "FTP_PASSWORD": "p",
    }, use_env=False))
    assert (f.host, f.port, f.user, f.password) == ("h", 2121, "u", "p")
    d = p.FS.from_config(p.MapConfig({}, use_env=False))
    assert (d.host, d.port, d.user, d.password) == ("localhost", 21, "anonymous", "")


@pytest.mark.parametrize("side", SIDES)
def test_health_down_when_dark(side):
    f = PKGS[side].FS(host="127.0.0.1", port=1, connect_timeout=0.3)
    assert f.health_check()["status"] == "DOWN"
    assert f.health_check() == RFTPFileSystem(host="127.0.0.1", port=1).health_check()


def test_missing_file_maps_to_filenotfound(fs):
    with pytest.raises(FileNotFoundError):
        fs.open("no-such.bin")
    with pytest.raises(FileNotFoundError):
        fs.remove("no-such.bin")


def test_mtime_populated_from_mlsx_facts(fs):
    with fs.create("timed.bin") as f:
        f.write(b"t")
    try:
        entries = [e for e in fs.read_dir(".") if e.name == "timed.bin"]
        assert entries and entries[0].mod_time > 0
        assert fs.stat("timed.bin").mod_time > 0
    finally:
        fs.remove("timed.bin")


def test_mkdir_over_existing_file_raises(fs):
    with fs.create("blocker") as f:
        f.write(b"x")
    try:
        with pytest.raises(ftplib.error_perm):
            fs.mkdir("blocker/sub")
    finally:
        fs.remove("blocker")


def test_append_creates_missing_file(fs):
    """'a' on a file that does not exist yet must create it, like open()."""
    with fs.open_file("fresh.log", "a") as f:
        f.write("first\n")
    with fs.open_file("fresh.log", "r") as f:
        assert f.read() == "first\n"
    fs.remove("fresh.log")


# ---------------------------------------------------------------- Queue C 51
@pytest.mark.parametrize("side", SIDES)
def test_open_takes_a_mode_and_exists_on_either_server(servers, side):
    """The port's ``open(name, "rb")`` is the reference's ``open(name)`` (the
    same bytes); other modes are ``open_file``'s; ``exists`` asks the
    server. The reference's ``open`` takes no mode."""
    port = FTPFileSystem(host="127.0.0.1", port=servers[side].port, user="gofr",
                         password="secret")
    ref = RFTPFileSystem(host="127.0.0.1", port=servers[side].port, user="gofr",
                         password="secret")
    port.connect()
    ref.connect()
    try:
        with port.open("m.bin", "wb") as f:
            f.write(b"\x00weights\xff")
        assert port.open("m.bin", "rb").read() == ref.open("m.bin").read() == b"\x00weights\xff"
        with port.open("m.txt", "w") as f:
            f.write("text")
        with port.open("m.txt", "r") as f:
            assert f.read() == "text"
        assert port.exists("m.bin") and not port.exists("nope.bin")
        with pytest.raises(TypeError, match="positional argument"):
            ref.open("m.bin", "rb")
        with pytest.raises(FileNotFoundError):
            port.open("nope.bin", "rb")
        port.remove("m.bin")
        port.remove("m.txt")
    finally:
        port.close()
        ref.close()
