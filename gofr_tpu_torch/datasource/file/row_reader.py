"""Row readers (datasource/file/row_reader.go): iterate a file as rows —
JSON (array or JSONL) and text lines — binding each row like Request.bind.

The port's copy of ``gofr_tpu/datasource/file/row_reader.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterator


class JSONRowReader:
    """Reads a JSON array file or JSONL stream row by row."""

    def __init__(self, fileobj: Any) -> None:
        self._file = fileobj
        self._rows: Iterator[Any] | None = None

    def _iter_rows(self) -> Iterator[Any]:
        data = self._file.read()
        if isinstance(data, bytes):
            data = data.decode("utf-8")
        text = data.strip()
        if text.startswith("["):
            yield from json.loads(text)
        else:
            for line in text.splitlines():
                line = line.strip()
                if line:
                    yield json.loads(line)

    def next(self) -> bool:
        if self._rows is None:
            self._rows = self._iter_rows()
        try:
            self._current = next(self._rows)
            return True
        except StopIteration:
            return False

    def scan(self, target: Any) -> Any:
        row = self._current
        if target is dict or target is None:
            return row
        cls = target if isinstance(target, type) else type(target)
        if dataclasses.is_dataclass(cls) and isinstance(row, dict):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in row.items() if k in names})
        if isinstance(target, dict) and isinstance(row, dict):
            target.clear()
            target.update(row)
            return target
        return row

    def __iter__(self) -> Iterator[Any]:
        while self.next():
            yield self._current


class TextRowReader:
    """Reads a file line by line."""

    def __init__(self, fileobj: Any) -> None:
        self._file = fileobj
        self._current = ""

    def next(self) -> bool:
        line = self._file.readline()
        if isinstance(line, bytes):
            line = line.decode("utf-8", "replace")
        if not line:
            return False
        self._current = line.rstrip("\n")
        return True

    def scan(self, target: Any = str) -> str:
        return self._current

    def __iter__(self) -> Iterator[str]:
        while self.next():
            yield self._current
