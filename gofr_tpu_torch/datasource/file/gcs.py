"""GCS StorageProvider — the JSON API over plain HTTP(S).

Reference parity: pkg/gofr/datasource/file/gcs (401 LoC wrapping
cloud.google.com/go/storage). This image has no google-cloud SDK, so the
provider speaks the public GCS JSON API directly:

- read:   GET  {endpoint}/storage/v1/b/{bucket}/o/{object}?alt=media
          (Range header for NewRangeReader)
- stat:   GET  {endpoint}/storage/v1/b/{bucket}/o/{object}
- list:   GET  {endpoint}/storage/v1/b/{bucket}/o?prefix=&delimiter=/
- write:  POST {endpoint}/upload/storage/v1/b/{bucket}/o?uploadType=media&name=
- copy:   POST {endpoint}/storage/v1/b/{bucket}/o/{src}/copyTo/b/{bucket}/o/{dst}
- delete: DELETE {endpoint}/storage/v1/b/{bucket}/o/{object}

``token_provider`` supplies the Bearer token (metadata-server or service-
account flow); tests run tokenless against testutil/object_store_server.py.

The port's copy of ``gofr_tpu/datasource/file/gcs.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Callable

from gofr_tpu_torch.datasource.file.object_store import ObjectInfo


class GCSProvider:
    def __init__(
        self,
        bucket: str,
        endpoint: str = "https://storage.googleapis.com",
        token_provider: Callable[[], str] | None = None,
        timeout: float = 30.0,
    ) -> None:
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self.token_provider = token_provider
        self.timeout = timeout

    # -- plumbing --------------------------------------------------------------
    def _headers(self, extra: dict | None = None) -> dict:
        headers = dict(extra or {})
        if self.token_provider is not None:
            headers["Authorization"] = f"Bearer {self.token_provider()}"
        return headers

    def _object_url(self, name: str, media: bool = False) -> str:
        quoted = urllib.parse.quote(name, safe="")
        url = f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{quoted}"
        return url + "?alt=media" if media else url

    def _request(
        self, url: str, method: str = "GET", data: bytes | None = None,
        headers: dict | None = None,
    ):
        req = urllib.request.Request(
            url, data=data, headers=self._headers(headers), method=method
        )
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise FileNotFoundError(url) from None
            raise OSError(f"gcs {method} {url}: HTTP {exc.code}") from exc

    # -- StorageProvider -------------------------------------------------------
    def connect(self) -> None:
        self.list_objects("")  # validates bucket + credentials

    def new_reader(self, name: str, offset: int = 0, length: int = -1):
        headers = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        resp = self._request(self._object_url(name, media=True), headers=headers)
        return io.BufferedReader(_RawResponse(resp))

    def write_object(self, name: str, data: bytes) -> None:
        url = (
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={urllib.parse.quote(name, safe='')}"
        )
        with self._request(
            url, method="POST", data=data,
            headers={"Content-Type": "application/octet-stream"},
        ):
            pass

    def delete_object(self, name: str) -> None:
        with self._request(self._object_url(name), method="DELETE"):
            pass

    def copy_object(self, src: str, dst: str) -> None:
        url = (
            f"{self.endpoint}/storage/v1/b/{self.bucket}/o/"
            f"{urllib.parse.quote(src, safe='')}/copyTo/b/{self.bucket}/o/"
            f"{urllib.parse.quote(dst, safe='')}"
        )
        with self._request(url, method="POST", data=b""):
            pass

    def stat_object(self, name: str) -> ObjectInfo:
        with self._request(self._object_url(name)) as resp:
            meta = json.loads(resp.read())
        return ObjectInfo(
            name=meta.get("name", name),
            size=int(meta.get("size", 0)),
            content_type=meta.get("contentType", "application/octet-stream"),
            last_modified=float(meta.get("generation", 0)) / 1e6,
        )

    def list_objects(self, prefix: str) -> list[str]:
        items, _ = self._list(prefix, delimiter=None)
        return [i["name"] for i in items]

    def list_dir(self, prefix: str) -> tuple[list[ObjectInfo], list[str]]:
        items, prefixes = self._list(prefix, delimiter="/")
        objects = [
            ObjectInfo(
                name=i["name"],
                size=int(i.get("size", 0)),
                content_type=i.get("contentType", "application/octet-stream"),
                last_modified=float(i.get("generation", 0)) / 1e6,
            )
            for i in items
        ]
        return objects, prefixes

    def _list(self, prefix: str, delimiter: str | None):
        params = {"prefix": prefix}
        if delimiter:
            params["delimiter"] = delimiter
        items: list[dict] = []
        prefixes: list[str] = []
        page_token = None
        while True:
            if page_token:
                params["pageToken"] = page_token
            url = (
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o?"
                + urllib.parse.urlencode(params)
            )
            with self._request(url) as resp:
                body = json.loads(resp.read())
            items.extend(body.get("items", []))
            prefixes.extend(body.get("prefixes", []))
            page_token = body.get("nextPageToken")
            if not page_token:
                return items, prefixes


class _RawResponse(io.RawIOBase):
    """File-like over an HTTPResponse so callers get a real BufferedReader."""

    def __init__(self, resp: Any) -> None:
        self._resp = resp

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._resp.read(len(b))
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            self._resp.close()
        finally:
            super().close()
