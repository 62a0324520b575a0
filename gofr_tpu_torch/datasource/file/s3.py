"""S3 StorageProvider — the REST API with real AWS Signature V4 signing.

Reference parity: pkg/gofr/datasource/file/s3 (1432 LoC wrapping
aws-sdk-go-v2). No AWS SDK in this image, so the provider speaks the S3
REST API directly (path-style addressing) and implements SigV4 from the
public spec with hashlib/hmac:

- read:   GET    {endpoint}/{bucket}/{key}   (Range header for ranges)
- write:  PUT    {endpoint}/{bucket}/{key}
- stat:   HEAD   {endpoint}/{bucket}/{key}
- list:   GET    {endpoint}/{bucket}?list-type=2&prefix=&delimiter=
- copy:   PUT    {endpoint}/{bucket}/{dst}  x-amz-copy-source: /{bucket}/{src}
- delete: DELETE {endpoint}/{bucket}/{key}

The test broker (testutil/object_store_server.py) *verifies* the SigV4
signature with the shared secret, so the signer is exercised for real.

The port's copy of ``gofr_tpu/datasource/file/s3.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import io
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Any

from gofr_tpu_torch.datasource.file.gcs import _RawResponse
from gofr_tpu_torch.datasource.file.object_store import ObjectInfo

_ALGO = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def signing_key(secret_key: str, date: str, region: str, service: str) -> bytes:
    """AWS4 key derivation: date -> region -> service -> aws4_request."""
    k = _hmac(f"AWS4{secret_key}".encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def canonical_request(
    method: str, path: str, query: str, headers: dict[str, str],
    signed_headers: list[str], payload_hash: str,
) -> str:
    canon_query = "&".join(
        sorted(
            f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
            for k, v in urllib.parse.parse_qsl(query, keep_blank_values=True)
        )
    )
    canon_headers = "".join(
        f"{h}:{' '.join(headers[h].split())}\n" for h in signed_headers
    )
    return "\n".join(
        [
            method,
            urllib.parse.quote(path, safe="/-_.~"),
            canon_query,
            canon_headers,
            ";".join(signed_headers),
            payload_hash,
        ]
    )


def string_to_sign(timestamp: str, scope: str, canon_request: str) -> str:
    return "\n".join([_ALGO, timestamp, scope, _sha256(canon_request.encode())])


class S3Provider:
    def __init__(
        self,
        bucket: str,
        endpoint: str = "https://s3.amazonaws.com",
        region: str = "us-east-1",
        access_key: str = "",
        secret_key: str = "",
        timeout: float = 30.0,
    ) -> None:
        self.bucket = bucket
        self.endpoint = endpoint.rstrip("/")
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.timeout = timeout
        self._host = urllib.parse.urlparse(self.endpoint).netloc

    # -- SigV4 -----------------------------------------------------------------
    def _sign(
        self, method: str, path: str, query: str, payload: bytes,
        extra_headers: dict[str, str] | None = None,
    ) -> dict[str, str]:
        now = datetime.datetime.now(datetime.timezone.utc)
        timestamp = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        payload_hash = _sha256(payload)
        headers = {
            "host": self._host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": timestamp,
        }
        for k, v in (extra_headers or {}).items():
            headers[k.lower()] = v
        signed = sorted(headers)
        scope = f"{date}/{self.region}/s3/aws4_request"
        creq = canonical_request(method, path, query, headers, signed, payload_hash)
        sts = string_to_sign(timestamp, scope, creq)
        signature = hmac.new(
            signing_key(self.secret_key, date, self.region, "s3"),
            sts.encode(),
            hashlib.sha256,
        ).hexdigest()
        headers["Authorization"] = (
            f"{_ALGO} Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={signature}"
        )
        headers.pop("host")  # urllib sets it; it stays in the signature
        return headers

    def _request(
        self, method: str, key: str = "", query: str = "",
        data: bytes | None = None, extra_headers: dict[str, str] | None = None,
    ):
        path = f"/{self.bucket}" + (f"/{urllib.parse.quote(key)}" if key else "")
        url = f"{self.endpoint}{path}" + (f"?{query}" if query else "")
        payload = data or b""
        headers = self._sign(method, path, query, payload, extra_headers)
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                raise FileNotFoundError(f"s3://{self.bucket}/{key}") from None
            detail = exc.read()[:200].decode("utf-8", "replace")
            raise OSError(f"s3 {method} {path}: HTTP {exc.code} {detail}") from exc

    # -- StorageProvider -------------------------------------------------------
    def connect(self) -> None:
        self.list_objects("")

    def new_reader(self, name: str, offset: int = 0, length: int = -1):
        extra = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            extra["Range"] = f"bytes={offset}-{end}"
        resp = self._request("GET", name, extra_headers=extra)
        return io.BufferedReader(_RawResponse(resp))

    def write_object(self, name: str, data: bytes) -> None:
        with self._request("PUT", name, data=data):
            pass

    def delete_object(self, name: str) -> None:
        with self._request("DELETE", name):
            pass

    def copy_object(self, src: str, dst: str) -> None:
        source = f"/{self.bucket}/{urllib.parse.quote(src)}"
        with self._request(
            "PUT", dst, extra_headers={"x-amz-copy-source": source}
        ):
            pass

    def stat_object(self, name: str) -> ObjectInfo:
        with self._request("HEAD", name) as resp:
            return ObjectInfo(
                name=name,
                size=int(resp.headers.get("Content-Length", 0)),
                content_type=resp.headers.get(
                    "Content-Type", "application/octet-stream"
                ),
                last_modified=0.0,
            )

    def list_objects(self, prefix: str) -> list[str]:
        objects, _ = self._list(prefix, delimiter=None)
        return [o.name for o in objects]

    def list_dir(self, prefix: str) -> tuple[list[ObjectInfo], list[str]]:
        return self._list(prefix, delimiter="/")

    def _list(self, prefix: str, delimiter: str | None):
        params = {"list-type": "2", "prefix": prefix}
        if delimiter:
            params["delimiter"] = delimiter
        objects: list[ObjectInfo] = []
        prefixes: list[str] = []
        token = None
        while True:
            if token:
                params["continuation-token"] = token
            query = urllib.parse.urlencode(sorted(params.items()))
            with self._request("GET", "", query=query) as resp:
                root = ET.fromstring(resp.read())
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for el in root.findall(f"{ns}Contents"):
                objects.append(
                    ObjectInfo(
                        name=el.findtext(f"{ns}Key", ""),
                        size=int(el.findtext(f"{ns}Size", "0")),
                    )
                )
            for el in root.findall(f"{ns}CommonPrefixes"):
                prefixes.append(el.findtext(f"{ns}Prefix", ""))
            token = root.findtext(f"{ns}NextContinuationToken")
            if not token:
                return objects, prefixes
