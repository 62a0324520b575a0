"""FTP file system — the FileSystem contract over RFC 959.

Reference parity: pkg/gofr/datasource/file/ftp (1,119 LoC over
jlaffaye/ftp). The client side rides the stdlib ``ftplib`` (passive
mode, binary type) the way the reference rides its FTP library; the
test server (testutil/ftp_server.py) implements the server half of the
protocol from the RFC. Configure via ``FTP_HOST``/``FTP_PORT``/
``FTP_USER``/``FTP_PASSWORD``.

FTP has no partial-write or seek semantics — files upload/download
whole (RETR/STOR), so ``open_file`` materializes through an in-memory
spool that flushes on close, mirroring the reference's
read-all/write-all wrappers.

The port's copy of ``gofr_tpu/datasource/file/ftp.py``; it imports nothing of the JAX package.
``open`` takes a mode and the file system has ``exists``, so the weight
loaders read through it (ROADMAP Queue C 51).
"""

from __future__ import annotations

import ftplib
import io
import posixpath
from typing import Any

from gofr_tpu_torch.datasource.file.local import FileInfo


def _parse_mlsx_time(modify: str) -> float:
    """RFC 3659 modify fact (YYYYMMDDHHMMSS[.sss], UTC) → epoch seconds."""
    import calendar
    import time as time_mod

    base = modify.split(".")[0]
    if len(base) != 14 or not base.isdigit():
        return 0.0
    try:
        return float(calendar.timegm(time_mod.strptime(base, "%Y%m%d%H%M%S")))
    except ValueError:
        return 0.0


class _FTPWriteSpool(io.BytesIO):
    """Buffers writes; STORs the whole payload on close."""

    def __init__(self, fs: "FTPFileSystem", path: str, initial: bytes = b"") -> None:
        super().__init__()
        if initial:
            self.write(initial)
        self._fs = fs
        self._path = path
        self._flushed = False

    def close(self) -> None:
        if not self._flushed:
            # STOR straight from the spool (no getvalue copy); flag flips
            # only on SUCCESS so a failed upload raises again on retry
            # instead of silently dropping the data
            self.seek(0)
            self._fs._conn().storbinary(f"STOR {self._path}", self)
            self._flushed = True
        super().close()


class FTPFileSystem:
    def __init__(self, host: str = "localhost", port: int = 21,
                 user: str = "anonymous", password: str = "",
                 connect_timeout: float = 5.0) -> None:
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.connect_timeout = connect_timeout
        self._ftp: ftplib.FTP | None = None
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "FTPFileSystem":
        return cls(
            host=config.get_or_default("FTP_HOST", "localhost"),
            port=int(config.get_or_default("FTP_PORT", "21")),
            user=config.get_or_default("FTP_USER", "anonymous"),
            password=config.get_or_default("FTP_PASSWORD", ""),
        )

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        ftp = ftplib.FTP()
        ftp.connect(self.host, self.port, timeout=self.connect_timeout)
        ftp.login(self.user, self.password)
        ftp.voidcmd("TYPE I")  # binary
        self._ftp = ftp
        if self._logger:
            self._logger.debug(
                f"ftp connected to {self.user}@{self.host}:{self.port}"
            )

    def _conn(self) -> ftplib.FTP:
        if self._ftp is None:
            raise ConnectionError("ftp file system not connected")
        return self._ftp

    # -- FileSystem contract ------------------------------------------------
    def create(self, name: str) -> _FTPWriteSpool:
        return _FTPWriteSpool(self, name)

    def open(self, name: str, mode: str = "rb"):
        """A binary read, as the reference's ``open(name)``; any other mode
        goes to ``open_file``."""
        if mode != "rb":
            return self.open_file(name, mode)
        return self._retr(name)

    def exists(self, name: str) -> bool:
        return self._exists(name)

    def _retr(self, name: str) -> io.BytesIO:
        buf = io.BytesIO()
        try:
            self._conn().retrbinary(f"RETR {name}", buf.write)
        except ftplib.error_perm as exc:
            if str(exc)[:3] == "550":
                raise FileNotFoundError(name) from exc  # consistent with stat()
            raise
        buf.seek(0)
        return buf

    def open_file(self, name: str, mode: str = "r"):
        binary = "b" in mode
        if mode in ("r", "rb"):
            data = self._retr(name)
            return data if binary else io.TextIOWrapper(data, encoding="utf-8")
        if mode in ("w", "wb", "w+", "wb+", "w+b"):
            spool = _FTPWriteSpool(self, name)
        elif mode in ("a", "ab"):
            try:
                existing = self._retr(name).getvalue()
            except FileNotFoundError:  # open() maps 550 already
                existing = b""
            spool = _FTPWriteSpool(self, name, initial=existing)
        else:
            raise ValueError(f"unsupported mode {mode!r}")
        return spool if binary else io.TextIOWrapper(spool, encoding="utf-8",
                                                     write_through=True)

    def remove(self, name: str) -> None:
        try:
            self._conn().delete(name)
        except ftplib.error_perm as exc:
            if str(exc)[:3] == "550":
                raise FileNotFoundError(name) from exc
            raise

    def remove_all(self, name: str) -> None:
        conn = self._conn()
        try:
            entries = self.read_dir(name)
        except ftplib.error_perm:
            # not a directory (or absent): plain delete — tolerate only
            # genuinely-gone, never a denied delete (Go RemoveAll parity)
            try:
                conn.delete(name)
            except ftplib.error_perm as exc:
                if str(exc)[:3] == "550" and not self._exists(name):
                    return
                raise
            return
        for e in entries:
            child = posixpath.join(name, e.name)
            if e.is_dir:
                self.remove_all(child)
            else:
                conn.delete(child)
        conn.rmd(name)

    def _exists(self, name: str) -> bool:
        try:
            self.stat(name)
            return True
        except (FileNotFoundError, ftplib.error_perm):
            return False

    def rename(self, old: str, new: str) -> None:
        self._conn().rename(old, new)

    def _is_dir(self, name: str) -> bool:
        try:
            return self.stat(name).is_dir
        except (FileNotFoundError, ftplib.error_perm):
            return False

    def mkdir(self, name: str, parents: bool = True) -> None:
        if not parents:
            self._conn().mkd(name)
            return
        parts = name.strip("/").split("/")
        prefix = "/" if name.startswith("/") else ""
        cur = ""
        for p in parts:
            cur = f"{cur}/{p}" if cur else prefix + p
            try:
                self._conn().mkd(cur)
            except ftplib.error_perm:
                # tolerate only "already a directory" — a denied MKD on a
                # missing path is a real failure, not idempotence
                if not self._is_dir(cur):
                    raise

    def read_dir(self, name: str = ".") -> list[FileInfo]:
        out = []
        for entry, facts in self._conn().mlsd(name):
            if entry in (".", ".."):
                continue
            out.append(FileInfo(
                entry,
                int(facts.get("size", 0)),
                facts.get("type") == "dir",
                _parse_mlsx_time(facts.get("modify", "")),
            ))
        return sorted(out, key=lambda f: f.name)

    def stat(self, name: str) -> FileInfo:
        conn = self._conn()
        try:
            resp = conn.sendcmd(f"MLST {name}")
        except ftplib.error_perm as exc:
            if str(exc)[:3] in ("500", "502"):
                # MLST unsupported (plain RFC 959 server): SIZE probes a
                # file; CWD round-trip probes a directory
                return self._stat_fallback(name, exc)
            raise FileNotFoundError(name) from exc
        # "250- type=...;size=...; path\r\n250 end" — the facts ride the
        # continuation line; RFC 3659: pathname follows the FIRST space
        # after the facts (names may contain spaces)
        facts_line = next(l for l in resp.splitlines() if "=" in l)
        if facts_line.startswith("250-"):
            facts_line = facts_line[4:]
        facts_part, _, base = facts_line.strip().partition(" ")
        facts = dict(
            f.split("=", 1) for f in facts_part.split(";") if "=" in f
        )
        return FileInfo(
            posixpath.basename(base),
            int(facts.get("size", 0)),
            facts.get("type") == "dir",
            _parse_mlsx_time(facts.get("modify", "")),
        )

    def _stat_fallback(self, name: str, cause: Exception) -> FileInfo:
        conn = self._conn()
        try:
            size = conn.size(name)
            return FileInfo(posixpath.basename(name), int(size or 0), False, 0.0)
        except ftplib.error_perm:
            pass
        here = conn.pwd()
        try:
            conn.cwd(name)
            conn.cwd(here)
            return FileInfo(posixpath.basename(name), 0, True, 0.0)
        except ftplib.error_perm:
            raise FileNotFoundError(name) from cause

    def chdir(self, name: str) -> None:
        self._conn().cwd(name)

    def getwd(self) -> str:
        return self._conn().pwd()

    # -- lifecycle / health --------------------------------------------------
    def health_check(self) -> dict[str, Any]:
        try:
            self._conn().voidcmd("NOOP")
            return {
                "status": "UP",
                "details": {
                    "backend": "ftp",
                    "host": f"{self.user}@{self.host}:{self.port}",
                    "cwd": self.getwd(),
                },
            }
        except Exception as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "ftp", "host": f"{self.host}:{self.port}",
                            "error": str(exc)},
            }

    def close(self) -> None:
        if self._ftp is not None:
            try:
                self._ftp.quit()
            except Exception:
                self._ftp.close()
            self._ftp = None
