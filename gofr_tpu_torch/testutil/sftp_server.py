"""In-process SFTP server for tests — the sshd stand-in (SURVEY §4
tier 4), like kafka_broker.py / postgres_server.py.

A real SSH 2.0 endpoint on the shared transport (curve25519 kex,
ed25519 host key generated per server, aes128-ctr + hmac-sha2-256,
password auth) serving SFTP v3 over a local root directory with
chroot-style path containment. The client and server derive their
session keys independently from the exchange hash, so the handshake is
genuine cryptographic interop, not shared state.

The port's copy of ``gofr_tpu/testutil/sftp_server.py``; it imports nothing of the JAX package.
One difference: each accepted socket sets ``TCP_NODELAY``, as the port's other
fakes do (ROADMAP Queue C 43 and 50); no byte on the wire changes.
"""

from __future__ import annotations

import os
import posixpath
import socket
import stat as stat_mod
import struct
import threading
from typing import Any

try:
    from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey
except ImportError:  # guarded in MiniSFTPServer.__init__
    Ed25519PrivateKey = None  # type: ignore[assignment]

from gofr_tpu_torch.datasource.file import sftp as fx
from gofr_tpu_torch.datasource.file.ssh_transport import (
    Reader,
    SSHError,
    SSHServerSession,
    SSHTransport,
    sstr,
    u32,
)


class MiniSFTPServer:
    def __init__(self, root: str, port: int = 0, user: str = "gofr",
                 password: str = "secret") -> None:
        if Ed25519PrivateKey is None:
            raise RuntimeError(
                "MiniSFTPServer needs the cryptography package "
                "(ed25519 host key)"
            )
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.user, self.password = user, password
        self.host_key = Ed25519PrivateKey.generate()
        self._running = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(8)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="sftp-server").start()

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            transport = SSHTransport(conn, server_side=True, host_key=self.host_key)
            transport.handshake()
            session = SSHServerSession(
                transport,
                lambda u, p: u == self.user and p == self.password,
            )
            session.accept()
            _SFTPSubsystem(self.root, transport).run()
        except (SSHError, ConnectionError, OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass


class _SFTPSubsystem:
    """SFTP v3 request loop over one channel, rooted at ``root``."""

    def __init__(self, root: str, transport: SSHTransport) -> None:
        self.root = root
        self.stream = fx._PacketStream(transport)
        self._handles: dict[bytes, Any] = {}
        self._dirs: dict[bytes, list] = {}
        self._hcount = 0

    # -- path containment ---------------------------------------------------
    def _real(self, vpath: str) -> str:
        norm = posixpath.normpath("/" + vpath.replace("\\", "/"))
        full = os.path.normpath(os.path.join(self.root, norm.lstrip("/")))
        if not (full == self.root or full.startswith(self.root + os.sep)):
            raise PermissionError(f"path escapes root: {vpath}")
        return full

    def _virtual(self, vpath: str) -> str:
        norm = posixpath.normpath("/" + vpath.replace("\\", "/"))
        # POSIX normpath preserves exactly two leading slashes
        return "/" + norm.lstrip("/") if norm != "/" else "/"

    # -- responses ----------------------------------------------------------
    def _status(self, rid: int, code: int, message: str = "") -> None:
        self.stream.write_packet(
            fx.FXP_STATUS, u32(rid) + u32(code) + sstr(message.encode()) + sstr(b"en")
        )

    def _attrs_bytes(self, st: os.stat_result) -> bytes:
        return (
            u32(fx.ATTR_SIZE | fx.ATTR_PERMISSIONS | fx.ATTR_ACMODTIME)
            + struct.pack(">Q", st.st_size)
            + u32(st.st_mode)
            + u32(int(st.st_atime)) + u32(int(st.st_mtime))
        )

    def _new_handle(self, obj: Any) -> bytes:
        self._hcount += 1
        h = f"h{self._hcount}".encode()
        self._handles[h] = obj
        return h

    # -- the loop -----------------------------------------------------------
    def run(self) -> None:
        ptype, r = self.stream.read_packet()
        if ptype != fx.FXP_INIT:
            raise SSHError("expected FXP_INIT")
        self.stream.write_packet(fx.FXP_VERSION, u32(3))
        while True:
            ptype, r = self.stream.read_packet()
            rid = r.uint32()
            try:
                self._dispatch(ptype, rid, r)
            except FileNotFoundError as exc:
                self._status(rid, fx.FX_NO_SUCH_FILE, str(exc))
            except PermissionError as exc:
                self._status(rid, fx.FX_PERMISSION_DENIED, str(exc))
            except (OSError, ValueError) as exc:
                self._status(rid, fx.FX_FAILURE, str(exc))

    def _dispatch(self, ptype: int, rid: int, r: Reader) -> None:
        if ptype == fx.FXP_OPEN:
            path = self._real(r.string().decode())
            pflags = r.uint32()
            fx.decode_attrs(r)
            if pflags & fx.FXF_CREAT and not os.path.exists(path):
                open(path, "wb").close()
            if pflags & fx.FXF_TRUNC:
                open(path, "wb").close()
            f = open(path, "r+b" if pflags & fx.FXF_WRITE else "rb")
            h = self._new_handle(f)
            self.stream.write_packet(fx.FXP_HANDLE, u32(rid) + sstr(h))
        elif ptype == fx.FXP_CLOSE:
            h = r.string()
            obj = self._handles.pop(h, None)
            self._dirs.pop(h, None)
            if hasattr(obj, "close"):
                obj.close()
            self._status(rid, fx.FX_OK)
        elif ptype == fx.FXP_READ:
            h, offset, length = r.string(), r.uint64(), r.uint32()
            f = self._handles[h]
            f.seek(offset)
            data = f.read(min(length, 1 << 20))
            if not data:
                self._status(rid, fx.FX_EOF, "eof")
            else:
                self.stream.write_packet(fx.FXP_DATA, u32(rid) + sstr(data))
        elif ptype == fx.FXP_WRITE:
            h, offset, data = r.string(), r.uint64(), r.string()
            f = self._handles[h]
            f.seek(offset)
            f.write(data)
            f.flush()
            self._status(rid, fx.FX_OK)
        elif ptype in (fx.FXP_STAT, fx.FXP_LSTAT):
            statter = os.stat if ptype == fx.FXP_STAT else os.lstat
            st = statter(self._real(r.string().decode()))
            self.stream.write_packet(fx.FXP_ATTRS, u32(rid) + self._attrs_bytes(st))
        elif ptype == fx.FXP_REALPATH:
            v = self._virtual(r.string().decode())
            self.stream.write_packet(
                fx.FXP_NAME,
                u32(rid) + u32(1) + sstr(v.encode()) + sstr(v.encode()) + u32(0),
            )
        elif ptype == fx.FXP_OPENDIR:
            path = self._real(r.string().decode())
            if not os.path.isdir(path):
                raise FileNotFoundError(path)
            entries = sorted(os.listdir(path))
            h = self._new_handle(None)
            # lstat: dangling symlinks must list, not fail the directory
            self._dirs[h] = [(e, os.lstat(os.path.join(path, e))) for e in entries]
            self.stream.write_packet(fx.FXP_HANDLE, u32(rid) + sstr(h))
        elif ptype == fx.FXP_READDIR:
            h = r.string()
            entries = self._dirs.get(h)
            if entries is None:
                raise ValueError("bad directory handle")
            if not entries:
                self._status(rid, fx.FX_EOF, "eof")
                return
            batch, self._dirs[h] = entries[:64], entries[64:]
            body = u32(rid) + u32(len(batch))
            for name, st in batch:
                body += sstr(name.encode()) + sstr(name.encode())
                body += self._attrs_bytes(st)
            self.stream.write_packet(fx.FXP_NAME, body)
        elif ptype == fx.FXP_REMOVE:
            path = self._real(r.string().decode())
            # a symlink is removable even when it points at a directory
            if os.path.isdir(path) and not os.path.islink(path):
                raise OSError("is a directory")
            os.remove(path)
            self._status(rid, fx.FX_OK)
        elif ptype == fx.FXP_MKDIR:
            path = self._real(r.string().decode())
            if os.path.exists(path):
                raise OSError(f"already exists: {path}")
            os.mkdir(path)
            self._status(rid, fx.FX_OK)
        elif ptype == fx.FXP_RMDIR:
            os.rmdir(self._real(r.string().decode()))
            self._status(rid, fx.FX_OK)
        elif ptype == fx.FXP_RENAME:
            old = self._real(r.string().decode())
            new = self._real(r.string().decode())
            os.rename(old, new)
            self._status(rid, fx.FX_OK)
        elif ptype == fx.FXP_SETSTAT:
            self._real(r.string().decode())
            fx.decode_attrs(r)
            self._status(rid, fx.FX_OK)
        else:
            self._status(rid, fx.FX_OP_UNSUPPORTED, f"unsupported op {ptype}")


def start_sftp_server(root: str, **kw: Any) -> MiniSFTPServer:
    return MiniSFTPServer(root, **kw)
