"""Object-store file systems (GCS/S3) behind the FileSystem contract.

Reference parity: pkg/gofr/datasource/file/interface.go:48-61 — the
``StorageProvider`` interface (Connect, NewReader, NewRangeReader,
NewWriter, DeleteObject, CopyObject, StatObject, ListObjects, ListDir)
that each cloud backend implements, wrapped by a common FileSystem facade
(common_fs.go) so handlers and the weight loader use one API for local
disk and cloud buckets alike.

``ObjectFileSystem`` adapts any provider to the surface the rest of the
framework expects: ``open``/``exists`` (the hf_import + tokenizer weight-
loading contract), ``read_dir``/``stat``/``rename``/``remove``, and the
provider-pattern ``use_logger``/``use_metrics``/``use_tracer`` hooks with
``app_file_stats`` timing like datasource/file/observability.py.

The port's copy of ``gofr_tpu/datasource/file/object_store.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import io
import time
from typing import Any, Protocol

from gofr_tpu_torch.datasource.file.local import FileInfo


@dataclasses.dataclass
class ObjectInfo:
    """interface.go:64-70."""

    name: str
    size: int
    content_type: str = "application/octet-stream"
    last_modified: float = 0.0
    is_dir: bool = False


class StorageProvider(Protocol):
    """interface.go:48-61 (stateless low-level ops)."""

    def connect(self) -> None: ...

    def new_reader(
        self, name: str, offset: int = 0, length: int = -1
    ) -> io.BufferedIOBase: ...

    def write_object(self, name: str, data: bytes) -> None: ...

    def delete_object(self, name: str) -> None: ...

    def copy_object(self, src: str, dst: str) -> None: ...

    def stat_object(self, name: str) -> ObjectInfo: ...

    def list_objects(self, prefix: str) -> list[str]: ...

    def list_dir(self, prefix: str) -> tuple[list[ObjectInfo], list[str]]: ...


class _ObjectWriter(io.BytesIO):
    """Buffered writer: the object is committed on close (object stores
    have no partial writes)."""

    def __init__(self, commit) -> None:
        super().__init__()
        self._commit = commit
        self._done = False

    def close(self) -> None:
        if not self._done:
            self._done = True
            data = self.getvalue()
            super().close()
            self._commit(data)
        else:
            super().close()


class ObjectFileSystem:
    def __init__(self, provider: Any, name: str = "object-store") -> None:
        self.provider = provider
        self.name = name
        self._logger: Any = None
        self._metrics: Any = None

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        self.provider.connect()
        if self._logger:
            self._logger.log(f"connected to {self.name}")

    def _observe(self, op: str, start: float) -> None:
        if self._metrics:
            self._metrics.record_histogram(
                "app_file_stats", (time.perf_counter() - start) * 1e3,
                operation=op, backend=self.name,
            )

    # -- the open/exists weight-loading contract -------------------------------
    def open(self, name: str, mode: str = "r"):
        """Read modes stream the object; write modes buffer and commit on
        close. Text modes wrap in a TextIOWrapper."""
        start = time.perf_counter()
        binary = "b" in mode
        if any(m in mode for m in ("w", "a", "x")):
            if "a" in mode:
                raise ValueError("object stores do not support append mode")
            raw = _ObjectWriter(lambda data: self._commit_write(name, data))
            self._observe("OPEN_WRITE", start)
            return raw if binary else io.TextIOWrapper(raw)
        reader = self.provider.new_reader(name)
        self._observe("OPEN_READ", start)
        return reader if binary else io.TextIOWrapper(reader)

    def open_file(self, name: str, mode: str = "r"):
        return self.open(name, mode)

    def create(self, name: str):
        return self.open(name, "wb")

    def _commit_write(self, name: str, data: bytes) -> None:
        start = time.perf_counter()
        self.provider.write_object(name, data)
        self._observe("WRITE", start)

    def exists(self, name: str) -> bool:
        try:
            self.provider.stat_object(name)
            return True
        except FileNotFoundError:
            return False

    def read_range(self, name: str, offset: int, length: int = -1) -> bytes:
        """NewRangeReader (interface.go:53): partial object reads, e.g. a
        safetensors header probe without pulling gigabytes of weights."""
        start = time.perf_counter()
        with self.provider.new_reader(name, offset=offset, length=length) as r:
            data = r.read()
        self._observe("READ_RANGE", start)
        return data

    # -- FileSystem surface ----------------------------------------------------
    def remove(self, name: str) -> None:
        start = time.perf_counter()
        self.provider.delete_object(name)
        self._observe("DELETE", start)

    def remove_all(self, prefix: str) -> None:
        start = time.perf_counter()
        for obj in self.provider.list_objects(_as_prefix(prefix)):
            self.provider.delete_object(obj)
        self._observe("DELETE_ALL", start)

    def rename(self, old: str, new: str) -> None:
        start = time.perf_counter()
        self.provider.copy_object(old, new)
        self.provider.delete_object(old)
        self._observe("RENAME", start)

    def mkdir(self, name: str, parents: bool = True) -> None:
        """Object stores are flat; directories exist implicitly."""

    def read_dir(self, name: str = "") -> list[FileInfo]:
        start = time.perf_counter()
        objects, prefixes = self.provider.list_dir(_as_prefix(name))
        out = [
            FileInfo(
                name=o.name.rsplit("/", 1)[-1],
                size=o.size,
                is_dir=False,
                mod_time=o.last_modified,
            )
            for o in objects
        ]
        out.extend(
            FileInfo(
                name=p.rstrip("/").rsplit("/", 1)[-1], size=0, is_dir=True, mod_time=0
            )
            for p in prefixes
        )
        self._observe("READDIR", start)
        return out

    def stat(self, name: str) -> FileInfo:
        start = time.perf_counter()
        info = self.provider.stat_object(name)
        self._observe("STAT", start)
        return FileInfo(
            name=info.name.rsplit("/", 1)[-1],
            size=info.size,
            is_dir=info.is_dir,
            mod_time=info.last_modified,
        )

    def health_check(self) -> dict[str, Any]:
        try:
            self.provider.list_objects("")
            return {"status": "UP", "details": {"backend": self.name}}
        except Exception as exc:
            return {
                "status": "DOWN",
                "details": {"backend": self.name, "error": str(exc)},
            }

    def close(self) -> None:
        close = getattr(self.provider, "close", None)
        if callable(close):
            close()


def _as_prefix(name: str) -> str:
    name = name.strip("/")
    if name in ("", "."):
        return ""
    return name + "/"
