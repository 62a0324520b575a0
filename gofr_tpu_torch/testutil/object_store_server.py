"""In-process object-store fakes: a GCS JSON-API server and an S3 REST
server over one shared blob map — the reference CI's storage-emulator
pattern (fake-gcs-server / localstack) without docker.

The S3 fake *verifies* AWS SigV4 with the configured secret (recomputing
the canonical request from the received request), so the driver's signer
is tested for real, not just for header presence.

The port's copy of ``gofr_tpu/testutil/object_store_server.py``; it imports nothing of the JAX package.
One difference: each accepted socket sets ``TCP_NODELAY``, as the port's other
fakes do (ROADMAP Queue C 43 and 50); no byte on the wire changes.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from gofr_tpu_torch.datasource.file.s3 import (
    canonical_request,
    signing_key,
    string_to_sign,
)


class _BlobStore:
    def __init__(self) -> None:
        self.blobs: dict[str, bytes] = {}
        self.lock = threading.Lock()

    def list(self, prefix: str, delimiter: str | None):
        """-> (objects [(name, size)], common prefixes)."""
        with self.lock:
            names = sorted(n for n in self.blobs if n.startswith(prefix))
            if not delimiter:
                return [(n, len(self.blobs[n])) for n in names], []
            objects, prefixes = [], []
            seen: set[str] = set()
            for n in names:
                rest = n[len(prefix) :]
                if delimiter in rest:
                    p = prefix + rest.split(delimiter, 1)[0] + delimiter
                    if p not in seen:
                        seen.add(p)
                        prefixes.append(p)
                else:
                    objects.append((n, len(self.blobs[n])))
            return objects, prefixes


def _parse_range(header: str | None, size: int) -> tuple[int, int]:
    if not header or not header.startswith("bytes="):
        return 0, size
    start_s, _, end_s = header[6:].partition("-")
    start = int(start_s or 0)
    end = int(end_s) + 1 if end_s else size
    return start, min(end, size)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "FakeObjectStore/1"
    # a reply is a header send then a body send: without this, Nagle's
    # algorithm holds the body behind the client's delayed ACK
    disable_nagle_algorithm = True

    def log_message(self, *args: Any) -> None:
        pass

    def _read_body(self) -> bytes:
        n = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(n) if n else b""

    def _reply(
        self, code: int, body: bytes = b"", content_type: str = "application/json",
        headers: dict | None = None,
    ) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(body)


# ---------------------------------------------------------------------- GCS
class _GCSHandler(_Handler):
    store: _BlobStore
    bucket: str

    def do_GET(self) -> None:
        parsed = urllib.parse.urlparse(self.path)
        params = dict(urllib.parse.parse_qsl(parsed.query))
        base = f"/storage/v1/b/{self.bucket}/o"
        if parsed.path == base:  # list
            objects, prefixes = self.store.list(
                params.get("prefix", ""), params.get("delimiter")
            )
            body = {
                "items": [{"name": n, "size": str(s)} for n, s in objects],
            }
            if prefixes:
                body["prefixes"] = prefixes
            self._reply(200, json.dumps(body).encode())
            return
        if parsed.path.startswith(base + "/"):
            name = urllib.parse.unquote(parsed.path[len(base) + 1 :])
            with self.store.lock:
                blob = self.store.blobs.get(name)
            if blob is None:
                self._reply(404, b'{"error": "not found"}')
                return
            if params.get("alt") == "media":
                start, end = _parse_range(self.headers.get("Range"), len(blob))
                data = blob[start:end]
                code = 206 if self.headers.get("Range") else 200
                self._reply(code, data, "application/octet-stream")
            else:
                self._reply(
                    200,
                    json.dumps(
                        {"name": name, "size": str(len(blob)), "generation": "1"}
                    ).encode(),
                )
            return
        self._reply(404, b"{}")

    def do_POST(self) -> None:
        parsed = urllib.parse.urlparse(self.path)
        params = dict(urllib.parse.parse_qsl(parsed.query))
        upload_base = f"/upload/storage/v1/b/{self.bucket}/o"
        if parsed.path == upload_base and params.get("uploadType") == "media":
            name = params.get("name", "")
            data = self._read_body()
            with self.store.lock:
                self.store.blobs[name] = data
            self._reply(
                200, json.dumps({"name": name, "size": str(len(data))}).encode()
            )
            return
        # copyTo: /storage/v1/b/{b}/o/{src}/copyTo/b/{b}/o/{dst}
        marker = f"/copyTo/b/{self.bucket}/o/"
        base = f"/storage/v1/b/{self.bucket}/o/"
        if parsed.path.startswith(base) and marker in parsed.path:
            src_enc, _, dst_enc = parsed.path[len(base) :].partition(marker)
            src = urllib.parse.unquote(src_enc)
            dst = urllib.parse.unquote(dst_enc)
            self._read_body()
            with self.store.lock:
                if src not in self.store.blobs:
                    self._reply(404, b'{"error": "not found"}')
                    return
                self.store.blobs[dst] = self.store.blobs[src]
            self._reply(200, json.dumps({"name": dst}).encode())
            return
        self._reply(404, b"{}")

    def do_DELETE(self) -> None:
        base = f"/storage/v1/b/{self.bucket}/o/"
        name = urllib.parse.unquote(
            urllib.parse.urlparse(self.path).path[len(base) :]
        )
        with self.store.lock:
            existed = self.store.blobs.pop(name, None)
        self._reply(204 if existed is not None else 404, b"")


# ----------------------------------------------------------------------- S3
class _S3Handler(_Handler):
    store: _BlobStore
    bucket: str
    region: str
    access_key: str
    secret_key: str

    def _verify_sig(self, payload: bytes) -> bool:
        auth = self.headers.get("Authorization", "")
        if not auth.startswith("AWS4-HMAC-SHA256 "):
            return False
        fields = dict(
            part.strip().split("=", 1)
            for part in auth[len("AWS4-HMAC-SHA256 ") :].split(",")
        )
        credential = fields.get("Credential", "")
        signed_headers = fields.get("SignedHeaders", "").split(";")
        got_sig = fields.get("Signature", "")
        try:
            access_key, date, region, service, _ = credential.split("/")
        except ValueError:
            return False
        if access_key != self.access_key or region != self.region:
            return False
        parsed = urllib.parse.urlparse(self.path)
        headers = {h: self.headers.get(h, "") for h in signed_headers}
        creq = canonical_request(
            self.command,
            urllib.parse.unquote(parsed.path),
            parsed.query,
            headers,
            signed_headers,
            self.headers.get("x-amz-content-sha256", hashlib.sha256(payload).hexdigest()),
        )
        sts = string_to_sign(
            self.headers.get("x-amz-date", ""),
            f"{date}/{region}/{service}/aws4_request",
            creq,
        )
        want = hmac.new(
            signing_key(self.secret_key, date, region, service),
            sts.encode(),
            hashlib.sha256,
        ).hexdigest()
        return hmac.compare_digest(want, got_sig)

    def _key(self) -> str:
        path = urllib.parse.unquote(urllib.parse.urlparse(self.path).path)
        prefix = f"/{self.bucket}"
        if path == prefix or path == prefix + "/":
            return ""
        return path[len(prefix) + 1 :]

    def _handle(self) -> None:
        payload = self._read_body()
        if not self._verify_sig(payload):
            self._reply(403, b"<Error><Code>SignatureDoesNotMatch</Code></Error>",
                        "application/xml")
            return
        key = self._key()
        if self.command == "GET" and not key:
            self._list()
            return
        if self.command == "GET":
            with self.store.lock:
                blob = self.store.blobs.get(key)
            if blob is None:
                self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>",
                            "application/xml")
                return
            start, end = _parse_range(self.headers.get("Range"), len(blob))
            code = 206 if self.headers.get("Range") else 200
            self._reply(code, blob[start:end], "application/octet-stream")
            return
        if self.command == "HEAD":
            with self.store.lock:
                blob = self.store.blobs.get(key)
            if blob is None:
                self._reply(404, b"")
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(blob)))
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            return
        if self.command == "PUT":
            src = self.headers.get("x-amz-copy-source")
            if src:
                src_key = urllib.parse.unquote(src)[len(f"/{self.bucket}/") :]
                with self.store.lock:
                    if src_key not in self.store.blobs:
                        self._reply(404, b"<Error><Code>NoSuchKey</Code></Error>",
                                    "application/xml")
                        return
                    self.store.blobs[key] = self.store.blobs[src_key]
                self._reply(200, b"<CopyObjectResult/>", "application/xml")
            else:
                with self.store.lock:
                    self.store.blobs[key] = payload
                self._reply(200, b"")
            return
        if self.command == "DELETE":
            with self.store.lock:
                self.store.blobs.pop(key, None)
            self._reply(204, b"")
            return
        self._reply(405, b"")

    def _list(self) -> None:
        params = dict(
            urllib.parse.parse_qsl(urllib.parse.urlparse(self.path).query)
        )
        objects, prefixes = self.store.list(
            params.get("prefix", ""), params.get("delimiter")
        )
        parts = ["<?xml version='1.0'?><ListBucketResult>"]
        for name, size in objects:
            parts.append(
                f"<Contents><Key>{name}</Key><Size>{size}</Size></Contents>"
            )
        for p in prefixes:
            parts.append(f"<CommonPrefixes><Prefix>{p}</Prefix></CommonPrefixes>")
        parts.append("</ListBucketResult>")
        self._reply(200, "".join(parts).encode(), "application/xml")

    do_GET = do_PUT = do_DELETE = do_HEAD = _handle


class FakeObjectStore:
    """One shared blob map served over a GCS dialect and an S3 dialect."""

    def __init__(
        self, bucket: str = "test-bucket", region: str = "us-east-1",
        access_key: str = "AKIATEST", secret_key: str = "testsecret",
    ) -> None:
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.store = _BlobStore()

        gcs_handler = type(
            "GCSHandler", (_GCSHandler,), {"store": self.store, "bucket": bucket}
        )
        s3_handler = type(
            "S3Handler",
            (_S3Handler,),
            {
                "store": self.store,
                "bucket": bucket,
                "region": region,
                "access_key": access_key,
                "secret_key": secret_key,
            },
        )
        self._gcs_server = ThreadingHTTPServer(("127.0.0.1", 0), gcs_handler)
        self._s3_server = ThreadingHTTPServer(("127.0.0.1", 0), s3_handler)
        for srv, name in ((self._gcs_server, "fake-gcs"), (self._s3_server, "fake-s3")):
            threading.Thread(target=srv.serve_forever, name=name, daemon=True).start()

    @property
    def gcs_endpoint(self) -> str:
        return f"http://127.0.0.1:{self._gcs_server.server_address[1]}"

    @property
    def s3_endpoint(self) -> str:
        return f"http://127.0.0.1:{self._s3_server.server_address[1]}"

    def close(self) -> None:
        for srv in (self._gcs_server, self._s3_server):
            srv.shutdown()
            srv.server_close()
