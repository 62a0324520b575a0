"""DynamoDB KV driver: the DynamoDB JSON API with real SigV4 signing.

Reference parity: pkg/gofr/datasource/kv-store/dynamodb (Get/Set/Delete
over aws-sdk-go-v2, dynamo.go:138-224). No AWS SDK in this image, so the
driver posts ``application/x-amz-json-1.0`` commands (GetItem/PutItem/
DeleteItem/DescribeTable) directly, signed with the same SigV4
implementation the S3 provider proved out (datasource/file/s3.py — the
testutil server VERIFIES signatures, so signing is exercised for real).

Item shape matches the reference: partition key attribute holds the key,
a string attribute holds the value (dynamo.go Get reads Item["value"].S).

The port's copy of ``gofr_tpu/datasource/kv/dynamodb.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import datetime
import hashlib
import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

import hmac as _hmac_mod

from gofr_tpu_torch.datasource.file.s3 import (
    _sha256,
    canonical_request,
    signing_key,
    string_to_sign,
)
from gofr_tpu_torch.datasource.kv.store import KVError

_TARGET = "DynamoDB_20120810"


class DynamoDBKVStore:
    def __init__(
        self,
        table: str,
        endpoint: str = "",
        region: str = "us-east-1",
        access_key: str = "",
        secret_key: str = "",
        session_token: str = "",
        partition_key: str = "key",
        value_attribute: str = "value",
        timeout: float = 10.0,
    ) -> None:
        self.table = table
        self.region = region
        self.endpoint = (
            endpoint or f"https://dynamodb.{region}.amazonaws.com"
        ).rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token
        self.partition_key = partition_key
        self.value_attribute = value_attribute
        self.timeout = timeout
        self._host = urllib.parse.urlparse(self.endpoint).netloc
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "DynamoDBKVStore":
        return cls(
            table=config.get_or_default("DYNAMODB_TABLE", "kv"),
            endpoint=config.get_or_default("DYNAMODB_ENDPOINT", ""),
            region=config.get_or_default("AWS_REGION", "us-east-1"),
            access_key=config.get_or_default("AWS_ACCESS_KEY_ID", ""),
            secret_key=config.get_or_default("AWS_SECRET_ACCESS_KEY", ""),
            session_token=config.get_or_default("AWS_SESSION_TOKEN", ""),
            partition_key=config.get_or_default("DYNAMODB_PARTITION_KEY", "key"),
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics
        try:
            metrics.new_histogram("app_dynamodb_stats", "DynamoDB op latency")
        except Exception:
            pass

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        health = self.health_check()
        if self._logger:
            self._logger.info(
                f"DynamoDB KV store {self.table} at {self.endpoint}: "
                f"{health['status']}"
            )

    def close(self) -> None:
        pass

    # -- signed command --------------------------------------------------------
    def _command(self, op: str, body: dict) -> dict:
        payload = json.dumps(body).encode()
        now = datetime.datetime.now(datetime.timezone.utc)
        timestamp = now.strftime("%Y%m%dT%H%M%SZ")
        date = now.strftime("%Y%m%d")
        payload_hash = _sha256(payload)
        headers = {
            "host": self._host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": timestamp,
            "x-amz-target": f"{_TARGET}.{op}",
        }
        if self.session_token:
            # STS/role-based temporary credentials (the common deployment
            # mode) are rejected without the signed security-token header
            headers["x-amz-security-token"] = self.session_token
        signed = sorted(headers)
        creq = canonical_request("POST", "/", "", headers, signed, payload_hash)
        scope = f"{date}/{self.region}/dynamodb/aws4_request"
        sts = string_to_sign(timestamp, scope, creq)
        signature = _hmac_mod.new(
            signing_key(self.secret_key, date, self.region, "dynamodb"),
            sts.encode(), hashlib.sha256,
        ).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={';'.join(signed)}, Signature={signature}"
        )
        headers["Content-Type"] = "application/x-amz-json-1.0"
        req = urllib.request.Request(
            self.endpoint + "/", data=payload, headers=headers, method="POST"
        )
        start = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")
            raise KVError(f"dynamodb {op} failed: {exc.code} {detail}") from None
        except urllib.error.URLError as exc:
            # unreachable endpoint must surface as the contract's KVError,
            # not a transport type callers don't catch
            raise KVError(f"dynamodb {op} failed: {exc.reason}") from None
        finally:
            if self._metrics:
                self._metrics.record_histogram(
                    "app_dynamodb_stats", time.perf_counter() - start,
                    operation=op,
                )
        return out

    # -- KVStore contract (datasources.go:366-378) -----------------------------
    def get(self, key: str) -> str:
        out = self._command("GetItem", {
            "TableName": self.table,
            "Key": {self.partition_key: {"S": key}},
            "ConsistentRead": True,
        })
        item = out.get("Item")
        if not item or self.value_attribute not in item:
            raise KVError(key)
        return item[self.value_attribute]["S"]

    def set(self, key: str, value: str) -> None:
        self._command("PutItem", {
            "TableName": self.table,
            "Item": {
                self.partition_key: {"S": key},
                self.value_attribute: {"S": str(value)},
            },
        })

    def delete(self, key: str) -> None:
        self._command("DeleteItem", {
            "TableName": self.table,
            "Key": {self.partition_key: {"S": key}},
        })

    def health_check(self) -> dict[str, Any]:
        try:
            out = self._command("DescribeTable", {"TableName": self.table})
            return {
                "status": "UP",
                "details": {
                    "backend": "dynamodb",
                    "table": self.table,
                    "endpoint": self.endpoint,
                    "table_status": out.get("Table", {}).get("TableStatus"),
                },
            }
        except Exception as exc:
            return {"status": "DOWN", "details": {"error": str(exc)}}
