"""Local filesystem implementation of the FileSystem contract
(datasource/file/local_fs.go, ~240 LoC).

The port's copy of ``gofr_tpu/datasource/file/local.py``; it imports nothing of the JAX package.
``open`` takes a mode and the file system has ``exists``, so the weight
loaders (``models.hf_import``, ``models.whisper_import``, the tokenizer)
read through it: the reference's ``open(name)`` takes no mode and its
loaders' ``open(path, "rb")`` raises ``TypeError`` (ROADMAP Queue C 51).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time
from typing import Any


@dataclasses.dataclass
class FileInfo:
    name: str
    size: int
    is_dir: bool
    mod_time: float

    def mode(self) -> int:
        return 0o644


class LocalFileSystem:
    def __init__(self, root: str | None = None) -> None:
        self._cwd = os.path.abspath(root or os.getcwd())

    # provider pattern no-ops
    def use_logger(self, logger: Any) -> None:
        pass

    def use_metrics(self, metrics: Any) -> None:
        pass

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        pass

    def _abs(self, name: str) -> str:
        return name if os.path.isabs(name) else os.path.join(self._cwd, name)

    # -- FileSystem contract (interface.go:12-133) -----------------------------
    def create(self, name: str):
        return open(self._abs(name), "w+b")

    def open(self, name: str, mode: str = "rb"):
        """A binary read, as the reference's ``open(name)``; any other mode
        goes to ``open_file`` (the loaders call ``open(path, "rb")``)."""
        if mode != "rb":
            return self.open_file(name, mode)
        return open(self._abs(name), "rb")

    def open_file(self, name: str, mode: str = "r"):
        return open(self._abs(name), mode)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._abs(name))

    def remove(self, name: str) -> None:
        os.remove(self._abs(name))

    def remove_all(self, name: str) -> None:
        target = self._abs(name)
        if os.path.isdir(target):
            shutil.rmtree(target)
        elif os.path.exists(target):
            os.remove(target)

    def rename(self, old: str, new: str) -> None:
        os.rename(self._abs(old), self._abs(new))

    def mkdir(self, name: str, parents: bool = True) -> None:
        if parents:
            os.makedirs(self._abs(name), exist_ok=True)
        else:
            os.mkdir(self._abs(name))

    def read_dir(self, name: str = ".") -> list[FileInfo]:
        out = []
        for entry in os.scandir(self._abs(name)):
            st = entry.stat()
            out.append(FileInfo(entry.name, st.st_size, entry.is_dir(), st.st_mtime))
        return sorted(out, key=lambda f: f.name)

    def stat(self, name: str) -> FileInfo:
        st = os.stat(self._abs(name))
        return FileInfo(os.path.basename(name), st.st_size, os.path.isdir(self._abs(name)), st.st_mtime)

    def chdir(self, name: str) -> None:
        target = self._abs(name)
        if not os.path.isdir(target):
            raise NotADirectoryError(target)
        self._cwd = target

    def getwd(self) -> str:
        return self._cwd

    def health_check(self) -> dict[str, Any]:
        ok = os.path.isdir(self._cwd) and os.access(self._cwd, os.W_OK)
        return {
            "status": "UP" if ok else "DOWN",
            "details": {"root": self._cwd, "writable": ok},
        }

    def close(self) -> None:
        pass
