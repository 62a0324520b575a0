"""The port's KV stores (``gofr_tpu_torch/datasource/kv``) and its DynamoDB
fake (``gofr_tpu_torch/testutil/dynamodb_server.py``) beside the JAX
package's:

- ``InMemoryKVStore``, ``FileKVStore`` and ``TTLKVStore`` run one operation
  sequence on both packages with equal results, each backend's own answers
  included: a non-string value comes back as it was given from memory and
  from a file store until it is reloaded, and as its ``str`` from DynamoDB
  (ROADMAP Queue C 53); a missing key is a ``KVError`` with the same text;
- ``DynamoDBKVStore`` crosses the wire both ways (either package's client
  against either package's ``MiniDynamoDBServer``, each server verifying
  the other's SigV4 signatures), the cases of ``tests/test_dynamodb_kv.py``
  one by one with equal results, a wrong secret refused with the
  reference's 403 on both;
- for a fixed clock the signed request (headers and body) is byte-equal.
"""

import datetime
import json
import time
import types
import urllib.error
import urllib.request

import pytest

from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.datasource import kv as rkv
from gofr_tpu.datasource.kv import dynamodb as rdyn
from gofr_tpu.datasource.kv import store as rstore
from gofr_tpu.metrics import new_metrics_manager as r_new_metrics_manager
from gofr_tpu.testutil.dynamodb_server import MiniDynamoDBServer as RMiniDynamoDBServer
from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.datasource import kv as tkv
from gofr_tpu_torch.datasource.kv import dynamodb as tdyn
from gofr_tpu_torch.datasource.kv import store as tstore
from gofr_tpu_torch.metrics import new_metrics_manager
from gofr_tpu_torch.testutil import MiniDynamoDBServer

PKGS = {
    "ref": types.SimpleNamespace(kv=rkv, store=rstore, dyn=rdyn, server=RMiniDynamoDBServer,
                                 config=RMapConfig, manager=r_new_metrics_manager),
    "port": types.SimpleNamespace(kv=tkv, store=tstore, dyn=tdyn, server=MiniDynamoDBServer,
                                  config=MapConfig, manager=new_metrics_manager),
}
SIDES = sorted(PKGS)
CROSS = [(c, s) for c in SIDES for s in SIDES]


def outcome(fn, *args):
    """What a call gave: its value, or its error's type name and text."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - the error is the result
        return ("raised", type(exc).__name__, str(exc))


def sequence(store, reload=None) -> list:
    """One operation sequence over the KV contract; ``reload`` (a file
    store's ``connect``) runs before the last reads."""
    out = [outcome(store.get, "absent")]
    store.set("alpha", "1")
    store.set("beta", "two")
    store.set("n", 5)  # the contract says str; each backend answers its own way
    store.set("alpha", "updated")
    out += [outcome(store.get, k) for k in ("alpha", "beta", "n")]
    store.delete("beta")
    store.delete("beta")  # idempotent
    out.append(outcome(store.get, "beta"))
    if reload is not None:
        reload()
        out += [outcome(store.get, k) for k in ("alpha", "n")]
    out.append(store.health_check()["status"])
    return out


@pytest.mark.parametrize("backend", ["memory", "file", "ttl"])
def test_embedded_stores_answer_as_the_reference(tmp_path, backend):
    got = {}
    for side in SIDES:
        mod = PKGS[side].store
        if backend == "memory":
            store = mod.InMemoryKVStore()
            got[side] = sequence(store)
        elif backend == "file":
            store = mod.FileKVStore(str(tmp_path / f"{side}.json"))
            store.connect()
            got[side] = sequence(store, reload=store.connect)
            got[side].append(json.loads((tmp_path / f"{side}.json").read_text()))
        else:
            store = mod.TTLKVStore()
            got[side] = sequence(store)
        got[side].append(store.health_check()["details"])
    if backend == "file":  # the details name the file
        for side in SIDES:
            got[side][-1].pop("path")
    assert got["port"] == got["ref"]
    n = got["port"][3]
    # Queue C 53: the int stays an int in memory, and a file store gives its
    # str only after a reload
    assert n == ("ok", 5)
    if backend == "file":
        assert got["port"][5:7] == [("ok", "updated"), ("ok", "5")]


def test_ttl_store_expires_and_purges_as_the_reference(monkeypatch):
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    got = {}
    for side in SIDES:
        clock[0] = 1000.0
        mod = PKGS[side].store
        store = mod.TTLKVStore(default_ttl=10.0)
        store.set("a", "1")
        store.set("b", "2", ttl=30.0)
        store.set("c", "3", ttl=5.0)
        steps = [outcome(store.get, "c")]
        clock[0] = 1006.0
        steps += [outcome(store.get, "c"), outcome(store.get, "a"), store.health_check()]
        clock[0] = 1011.0
        steps += [store.purge(), outcome(store.get, "a"), outcome(store.get, "b"),
                  store.health_check()]
        store.set("d", "4", ttl=None)
        clock[0] = 2000.0
        steps += [store.purge(), outcome(store.get, "d")]
        cfgs = [mod.TTLKVStore.from_config(PKGS[side].config({"KV_DEFAULT_TTL_SECONDS": v},
                                                             use_env=False)).default_ttl
                for v in ("0", "-1", "2.5")]
        got[side] = steps + [cfgs, issubclass(mod.KVError, KeyError)]
    assert got["port"] == got["ref"]
    assert got["port"][-2] == [None, None, 2.5]


def test_package_exports_match():
    assert sorted(tkv.__all__) == sorted(rkv.__all__)
    assert tkv.DynamoDBKVStore.__module__ == "gofr_tpu_torch.datasource.kv.dynamodb"


# ---------------------------------------------------------------- DynamoDB
@pytest.fixture
def servers():
    out = {side: PKGS[side].server().start() for side in SIDES}
    yield out
    for s in out.values():
        s.close()


def dynamo(client: str, server, **kw):
    return PKGS[client].dyn.DynamoDBKVStore(
        table=kw.pop("table", "kv"), endpoint=server.endpoint, region=server.region,
        access_key=server.access_key, secret_key=kw.pop("secret_key", server.secret_key), **kw)


@pytest.mark.parametrize("client,server", CROSS)
def test_dynamodb_sequence_crossed_both_ways(servers, client, server):
    """``test_set_get_delete_roundtrip``, ``test_missing_key_raises`` and the
    shared-contract case over one client and one server, against the
    reference's client on the reference's server."""
    got = {}
    for c, s in ((client, server), ("ref", "ref")):
        srv = PKGS[s].server().start() if (c, s) == ("ref", "ref") else servers[s]
        try:
            store = dynamo(c, srv)
            store.connect()
            got[(c, s)] = sequence(store) + [sorted(srv.tables["kv"].items())]
        finally:
            if (c, s) == ("ref", "ref"):
                srv.close()
    assert got[(client, server)] == got[("ref", "ref")]
    # Queue C 53: DynamoDB answers the str of what was set
    assert got[(client, server)][3] == ("ok", "5")


@pytest.mark.parametrize("client,server", CROSS)
def test_dynamodb_wrong_secret_is_refused_both_ways(servers, client, server):
    bad = dynamo(client, servers[server], secret_key="WRONG")
    err = outcome(bad.set, "x", "y")
    assert err[:2] == ("raised", "KVError") and "403" in err[2], err
    assert "signature mismatch" in err[2]
    assert "x" not in servers[server].tables["kv"]
    if server == "port":
        assert servers[server].commands == {"REJECTED": 1}


@pytest.mark.parametrize("client,server", CROSS)
def test_dynamodb_missing_table_and_health_crossed(client, server):
    srv = PKGS[server].server().start()
    store = dynamo(client, srv)
    store.table = "nope"
    err = outcome(store.set, "x", "y")
    assert err[:2] == ("raised", "KVError") and "ResourceNotFound" in err[2]
    store.table = "kv"
    health = store.health_check()
    assert health["status"] == "UP" and health["details"]["table_status"] == "ACTIVE"
    srv.close()
    down = store.health_check()
    assert down["status"] == "DOWN" and "dynamodb DescribeTable failed" in down["details"]["error"]


def test_dynamodb_metrics_and_fake_counts_agree():
    """``app_dynamodb_stats``: registered by the driver with the
    reference's kind and description (and listed in the port's catalog),
    one observation a command by operation, equal to what the port's fake
    served."""
    from gofr_tpu_torch.serving.metrics_catalog import SELF_REGISTERED_METRICS

    counts = {}
    for side in SIDES:
        srv, manager = MiniDynamoDBServer().start(), PKGS[side].manager()
        store = dynamo(side, srv)
        store.use_metrics(manager)
        store.use_metrics(manager)  # a second registration is absorbed
        store.connect()
        sequence(store)
        hist = manager.get("app_dynamodb_stats")
        counts[side] = ({op: hist.snapshot({"operation": op})[1]
                         for op in ("GetItem", "PutItem", "DeleteItem", "DescribeTable")},
                        dict(srv.commands), type(hist).__name__, hist.description)
        srv.close()
    assert counts["port"] == counts["ref"]
    observed, served = counts["port"][:2]
    assert observed == served == {"GetItem": 5, "PutItem": 4, "DeleteItem": 2, "DescribeTable": 2}
    assert ("histogram", "app_dynamodb_stats", counts["port"][3], None) in SELF_REGISTERED_METRICS


class FixedNow(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 10, 18, 6, 4, 40, tzinfo=datetime.timezone.utc)


@pytest.mark.parametrize("token", ["", "session-token"])
def test_signed_request_is_byte_equal_for_a_fixed_clock(monkeypatch, token):
    sent = {}

    def capture(side):
        def urlopen(req, timeout=None):
            sent[side] = (req.full_url, req.get_method(), sorted(req.header_items()), req.data)
            raise urllib.error.URLError("captured")
        return urlopen

    for side in SIDES:
        mod = PKGS[side].dyn
        monkeypatch.setattr(mod, "datetime", types.SimpleNamespace(
            datetime=FixedNow, timezone=datetime.timezone))
        monkeypatch.setattr(urllib.request, "urlopen", capture(side))
        store = mod.DynamoDBKVStore("kv", endpoint="http://127.0.0.1:9", access_key="AK",
                                    secret_key="SK", session_token=token)
        assert outcome(store.set, "k", "v")[:2] == ("raised", "KVError")
    assert sent["port"] == sent["ref"]
    headers = dict(sent["port"][2])
    assert headers["X-amz-date"] == "20261018T060440Z"
    assert headers["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20261018/us-east-1/dynamodb/aws4_request, ")
    assert ("X-amz-security-token" in headers) == bool(token)
