"""In-process FTP server for tests (RFC 959 + MLSD/MLST of RFC 3659),
rooted in a local directory with chroot-style containment — the FTP
service-container stand-in (SURVEY §4 tier 4).

Serves the verb subset the driver (and stdlib ftplib) uses: USER/PASS,
TYPE, PWD/CWD, PASV/EPSV passive data connections, RETR/STOR, DELE,
MKD/RMD, RNFR/RNTO, MLSD/MLST, SIZE, NOOP, QUIT.

The port's copy of ``gofr_tpu/testutil/ftp_server.py``; it imports nothing of the JAX package.
One difference: each accepted control and data socket sets ``TCP_NODELAY``, as the port's other
fakes do (ROADMAP Queue C 43 and 50); no byte on the wire changes.
"""

from __future__ import annotations

import os
import posixpath
import socket
import threading
from typing import Any


class MiniFTPServer:
    def __init__(self, root: str, port: int = 0, user: str = "gofr",
                 password: str = "secret") -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.user, self.password = user, password
        self._running = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(8)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="ftp-server").start()

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
            threading.Thread(target=_FTPSession(self, conn).run,
                             daemon=True).start()


class _FTPSession:
    def __init__(self, server: MiniFTPServer, conn: socket.socket) -> None:
        self.server = server
        self.conn = conn
        self.cwd = "/"
        self.authed = False
        self._pending_user = ""
        self._rename_from = ""
        self._data_listener: socket.socket | None = None

    # -- plumbing ------------------------------------------------------------
    def _send(self, code: int, text: str) -> None:
        self.conn.sendall(f"{code} {text}\r\n".encode())

    def _send_multi(self, code: int, lines: list[str], tail: str) -> None:
        out = "".join(f"{code}-{line}\r\n" for line in lines)
        self.conn.sendall(out.encode() + f"{code} {tail}\r\n".encode())

    def _real(self, vpath: str) -> str:
        joined = vpath if vpath.startswith("/") else posixpath.join(self.cwd, vpath)
        norm = posixpath.normpath(joined)
        full = os.path.normpath(os.path.join(self.server.root, norm.lstrip("/")))
        if not (full == self.server.root or full.startswith(self.server.root + os.sep)):
            raise PermissionError(vpath)
        return full

    def _open_data(self) -> socket.socket:
        if self._data_listener is None:
            # surfaces as a 550 protocol error, not a dead session
            raise OSError("use PASV first")
        data, _ = self._data_listener.accept()
        data.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._data_listener.close()
        self._data_listener = None
        return data

    def _facts(self, path: str, name: str) -> str:
        st = os.lstat(path)
        kind = "dir" if os.path.isdir(path) else "file"
        return f"type={kind};size={st.st_size};modify=20240101000000; {name}"

    # -- session loop --------------------------------------------------------
    def run(self) -> None:
        try:
            self._send(220, "gofr-mini-ftp ready")
            buf = b""
            while self.server._running:
                while b"\r\n" not in buf:
                    chunk = self.conn.recv(4096)
                    if not chunk:
                        return
                    buf += chunk
                line, buf = buf.split(b"\r\n", 1)
                verb, _, arg = line.decode().partition(" ")
                if not self._dispatch(verb.upper(), arg):
                    return
        except (OSError, PermissionError):
            pass
        finally:
            try:
                self.conn.close()
            except OSError:
                pass

    def _dispatch(self, verb: str, arg: str) -> bool:
        try:
            return self._dispatch_inner(verb, arg)
        except PermissionError:
            self._send(550, "path escapes root")
        except FileNotFoundError:
            self._send(550, "no such file or directory")
        except OSError as exc:
            self._send(550, str(exc))
        return True

    def _dispatch_inner(self, verb: str, arg: str) -> bool:
        if verb == "USER":
            self._pending_user = arg
            self._send(331, "password required")
            return True
        if verb == "PASS":
            if (self._pending_user == self.server.user
                    and arg == self.server.password):
                self.authed = True
                self._send(230, "logged in")
            else:
                self._send(530, "login incorrect")
            return True
        if verb == "QUIT":
            self._send(221, "bye")
            return False
        if not self.authed:
            self._send(530, "not logged in")
            return True

        if verb == "TYPE":
            self._send(200, f"type set to {arg}")
        elif verb == "NOOP":
            self._send(200, "ok")
        elif verb == "PWD":
            self._send(257, f'"{self.cwd}"')
        elif verb == "CWD":
            real = self._real(arg)
            if not os.path.isdir(real):
                raise FileNotFoundError(arg)
            joined = arg if arg.startswith("/") else posixpath.join(self.cwd, arg)
            self.cwd = posixpath.normpath(joined)
            self._send(250, "cwd ok")
        elif verb in ("PASV", "EPSV"):
            if self._data_listener is not None:
                # a transfer command that errored before opening its data
                # connection left the old listener behind — reap it
                self._data_listener.close()
                self._data_listener = None
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.bind(("127.0.0.1", 0))
            listener.listen(1)
            self._data_listener = listener
            port = listener.getsockname()[1]
            if verb == "PASV":
                p1, p2 = port // 256, port % 256
                self._send(227, f"entering passive mode (127,0,0,1,{p1},{p2})")
            else:
                self._send(229, f"entering extended passive mode (|||{port}|)")
        elif verb == "MLSD":
            real = self._real(arg or self.cwd)
            if not os.path.isdir(real):
                raise FileNotFoundError(arg)
            self._send(150, "here comes the directory listing")
            data = self._open_data()
            try:
                for entry in sorted(os.listdir(real)):
                    data.sendall(
                        (self._facts(os.path.join(real, entry), entry) + "\r\n").encode()
                    )
            finally:
                data.close()
            self._send(226, "directory send ok")
        elif verb == "MLST":
            real = self._real(arg or self.cwd)
            if not os.path.exists(real):
                raise FileNotFoundError(arg)
            self._send_multi(250, [" " + self._facts(real, arg or self.cwd)], "end")
        elif verb == "SIZE":
            real = self._real(arg)
            if not os.path.isfile(real):
                raise FileNotFoundError(arg)
            self._send(213, str(os.path.getsize(real)))
        elif verb == "RETR":
            real = self._real(arg)
            if not os.path.isfile(real):
                raise FileNotFoundError(arg)
            self._send(150, "opening data connection")
            data = self._open_data()
            try:
                with open(real, "rb") as f:
                    while True:
                        chunk = f.read(65536)
                        if not chunk:
                            break
                        data.sendall(chunk)
            finally:
                data.close()
            self._send(226, "transfer complete")
        elif verb == "STOR":
            real = self._real(arg)
            self._send(150, "ok to send data")
            data = self._open_data()
            try:
                with open(real, "wb") as f:
                    while True:
                        chunk = data.recv(65536)
                        if not chunk:
                            break
                        f.write(chunk)
            finally:
                data.close()
            self._send(226, "transfer complete")
        elif verb == "DELE":
            real = self._real(arg)
            if not os.path.isfile(real):
                raise FileNotFoundError(arg)
            os.remove(real)
            self._send(250, "deleted")
        elif verb == "MKD":
            os.mkdir(self._real(arg))
            self._send(257, "created")
        elif verb == "RMD":
            os.rmdir(self._real(arg))
            self._send(250, "removed")
        elif verb == "RNFR":
            self._rename_from = arg
            self._send(350, "ready for RNTO")
        elif verb == "RNTO":
            if not self._rename_from:
                self._send(503, "RNFR first")
            else:
                os.rename(self._real(self._rename_from), self._real(arg))
                self._rename_from = ""
                self._send(250, "renamed")
        else:
            self._send(502, f"command {verb} not implemented")
        return True


def start_ftp_server(root: str, **kw: Any) -> MiniFTPServer:
    return MiniFTPServer(root, **kw)
