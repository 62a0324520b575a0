"""DynamoDB-shaped test server: x-amz-json-1.0 command endpoint that
VERIFIES SigV4 signatures (same discipline as the S3 test broker — the
driver's signing is exercised for real, not trusted).

The port's copy of ``gofr_tpu/testutil/dynamodb_server.py``; it imports nothing of the JAX package.
One difference, not a byte on the wire: ``commands`` counts the commands
served, by operation (``PutItem``, ``GetItem``, ...), and the requests
refused for their signature under ``REJECTED``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any

from gofr_tpu_torch.datasource.file.s3 import (
    canonical_request,
    signing_key,
    string_to_sign,
)


class MiniDynamoDBServer:
    def __init__(self, access_key: str = "AK", secret_key: str = "SK",
                 region: str = "us-east-1") -> None:
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.tables: dict[str, dict[str, dict]] = {"kv": {}}
        self._httpd: HTTPServer | None = None
        self.commands: dict[str, int] = {}

    @property
    def port(self) -> int:
        assert self._httpd is not None
        return self._httpd.server_port

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "MiniDynamoDBServer":
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a: Any) -> None:
                pass

            def _reply(self, code: int, body: dict) -> None:
                raw = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/x-amz-json-1.0")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def _verify_sig(self, payload: bytes) -> bool:
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("AWS4-HMAC-SHA256 "):
                    return False
                fields = dict(
                    part.strip().split("=", 1)
                    for part in auth[len("AWS4-HMAC-SHA256 ") :].split(",")
                )
                signed_headers = fields.get("SignedHeaders", "").split(";")
                try:
                    access_key, date, region, service, _ = fields.get(
                        "Credential", ""
                    ).split("/")
                except ValueError:
                    return False
                if (access_key != server.access_key
                        or region != server.region or service != "dynamodb"):
                    return False
                parsed = urllib.parse.urlparse(self.path)
                headers = {h: self.headers.get(h, "") for h in signed_headers}
                creq = canonical_request(
                    "POST", urllib.parse.unquote(parsed.path), parsed.query,
                    headers, signed_headers,
                    self.headers.get(
                        "x-amz-content-sha256",
                        hashlib.sha256(payload).hexdigest(),
                    ),
                )
                sts = string_to_sign(
                    self.headers.get("x-amz-date", ""),
                    f"{date}/{region}/{service}/aws4_request", creq,
                )
                want = hmac.new(
                    signing_key(server.secret_key, date, region, service),
                    sts.encode(), hashlib.sha256,
                ).hexdigest()
                return hmac.compare_digest(want, fields.get("Signature", ""))

            def do_POST(self) -> None:
                payload = self.rfile.read(
                    int(self.headers.get("Content-Length", 0))
                )
                verified = self._verify_sig(payload)
                op = self.headers.get("X-Amz-Target", "").split(".")[-1]
                name = op if verified else "REJECTED"
                server.commands[name] = server.commands.get(name, 0) + 1
                if not verified:
                    self._reply(403, {
                        "__type": "UnrecognizedClientException",
                        "message": "signature mismatch",
                    })
                    return
                body = json.loads(payload or b"{}")
                table_name = body.get("TableName", "")
                table = server.tables.get(table_name)
                if table is None:
                    self._reply(400, {
                        "__type": "ResourceNotFoundException",
                        "message": f"table {table_name} not found",
                    })
                    return
                if op == "PutItem":
                    item = body["Item"]
                    # store by the FIRST attribute (the partition key by
                    # driver convention)
                    pk = next(iter(item))
                    table[item[pk]["S"]] = item
                    self._reply(200, {})
                elif op == "GetItem":
                    key = next(iter(body["Key"].values()))["S"]
                    item = table.get(key)
                    self._reply(200, {"Item": item} if item else {})
                elif op == "DeleteItem":
                    key = next(iter(body["Key"].values()))["S"]
                    table.pop(key, None)
                    self._reply(200, {})
                elif op == "DescribeTable":
                    self._reply(200, {"Table": {
                        "TableName": table_name,
                        "TableStatus": "ACTIVE",
                        "ItemCount": len(table),
                    }})
                else:
                    self._reply(400, {
                        "__type": "UnknownOperationException",
                        "message": op,
                    })

        self._httpd = HTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self._httpd.serve_forever, daemon=True).start()
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
