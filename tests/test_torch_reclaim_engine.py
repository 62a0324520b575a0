"""The reclamation plane on the port engine against the JAX ServingEngine,
on the CPU at ``LlamaConfig.tiny`` (vocab 300, the JAX package's params
carried across), after the engine cases of the reference's
``tests/test_reclaim.py``.

Each scenario runs on a pair of JAX engines and on a pair of port engines
of the same configuration (6 slots, buckets of 16, 16-token chunks, a
64-entry prefix cache; 8-token pages on the paged layouts), on paged bf16,
dense bf16 and paged int8: a preemptible source and a survivor, both
migrators on one ``PrefixIndex``, the survivor the source's push peer
through ``local_engine_store``. Held equal on both sides:

- ``begin_reclaim``'s summary (``accepted``, ``drained``, the
  evacuation's ``outcome``, ``entries``, ``committed`` and ``target``),
  the evacuated key sets, and the survivor serving each evacuated prompt
  token-identically to a cold engine with the same prefill calls and
  ragged dispatches; a second notice is refused; on int8 only
  whole-prompt entries evacuate;
- RECLAIMING: the status, the ``preemptible`` and ``reclaim`` details,
  and a submit refused with a retriable 503 carrying ``retry_after``;
- a ``kv.evacuate`` fault: ``degraded``, nothing partial on the survivor,
  and a cold re-prefill there with the cold engine's tokens and counts;
- the three reclamation series, and no slot or page left owned.

Under a notice, queued batch-class rows fail retriable on both sides and
interactive rows finish. A running batch-class row is where the two part
(ROADMAP Queue C 24): the reference's sweep skips every row with a block
in flight, and with dispatches pipelined a decoding row has one at the
top of every iteration but the one right after its prefill completes, so
its rows drain; the port stops feeding the row and pages it out once its
blocks are read, so it fails retriable, stamped ``reclaim-preempted``, as
the reference's docstring describes. The notice lands two blocks into
decoding.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu.http import errors as jerrors  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import batch as jbatch  # noqa: E402
from gofr_tpu.serving import prefix_index as jpi  # noqa: E402
from gofr_tpu.serving import tenancy as jtenancy  # noqa: E402
from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch import errors as terrors  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as tpi  # noqa: E402
from gofr_tpu_torch.serving import tenancy as ttenancy  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=6, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16, prefix_cache_entries=64)
LAYOUT_KW = {
    "paged-bf16": dict(kv_layout="paged", kv_page_size=8),
    "dense-bf16": {},
    "paged-int8": dict(kv_layout="paged", kv_page_size=8, kv_dtype="int8"),
}
LAYOUTS = pytest.mark.parametrize("layout", sorted(LAYOUT_KW))
CHUNKED = "the reclaimed system prompt " * 3  # 84 tokens: six 16-token chunks
SHORT = "short sys"  # 10 tokens: one whole-prompt prefill
PROMPTS = (CHUNKED, SHORT)
SWEPT = "the swept prompt, two chunks "  # 29 tokens and a name: two 16-token chunks
TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and in a parallel
    test run their spin-waits cost seconds per engine test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models():
    jcfg = jllama.LlamaConfig.tiny(vocab_size=300)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg = tllama.LlamaConfig.tiny(vocab_size=300)
    return jcfg, jparams, tcfg, params_from_jax(jax.device_get(jparams), device="cpu")


class Metrics:
    """Records every call an engine makes on its metrics manager."""

    def __init__(self) -> None:
        self.calls: list[tuple] = []

    def __getattr__(self, method: str):
        def record(name=None, *args, **labels):
            self.calls.append((method, name, tuple(sorted(labels.items()))))
        return record

    def reclamation(self) -> list[tuple]:
        names = ("app_replica_reclamations_total", "app_kv_evacuations_total",
                 "app_reclaim_drain_seconds")
        return sorted(c for c in self.calls if c[1] in names)


class Side:
    """One package's engines, migrators, batch module, tenancy and chaos."""

    def __init__(self, models, name: str) -> None:
        jcfg, jparams, tcfg, tparams = models
        self.jax = name == "jax"
        self.pi = jpi if self.jax else tpi
        self.batch = jbatch if self.jax else tbatch
        self.chaos = jchaos if self.jax else tchaos
        self.errors = jerrors if self.jax else terrors
        self.tenancy = jtenancy if self.jax else ttenancy
        self._cfg, self._params = (jcfg, jparams) if self.jax else (tcfg, tparams)

    def engine(self, rid: str, index, layout: str, **kw):
        """(engine, its migrator), not started."""
        conf = {**BASE, **LAYOUT_KW[layout], **{k: v for k, v in kw.items()
                                               if k not in ("tenants", "metrics")}}
        migrator = self.pi.KVMigrator(rid, index)
        extra = {"kv_migrator": migrator, "tenants": kw.get("tenants"),
                 "metrics": kw.get("metrics")}
        if self.jax:
            return JServingEngine(self._cfg, self._params, JEngineConfig(**conf),
                                  JByteTokenizer(), **extra), migrator
        return ServingEngine(self._cfg, self._params, EngineConfig(**conf), ByteTokenizer(),
                             device="cpu", **extra), migrator

    def fleet(self, layout: str, **src_kw):
        """(source, survivor, source's migrator), started, the survivor the
        source's push peer."""
        index = self.pi.PrefixIndex()
        src, mig = self.engine("src", index, layout, preemptible=True, **src_kw)
        dst, _ = self.engine("dst", index, layout)
        mig.add_push_peer("dst", self.pi.local_engine_store(dst))
        src.start(), dst.start()
        return src, dst, mig


def _sides(models, scenario):
    outs = [scenario(Side(models, name)) for name in ("jax", "port")]
    assert outs[1] == outs[0]
    return outs[1]


class Calls:
    """Prefill computes (on the engine thread) and ragged dispatches of one
    engine while open."""

    def __init__(self, side: Side, engine, monkeypatch) -> None:
        self.n = {"prefill": 0, "ragged": 0}
        real_prefill, real_ragged = side.batch.prefill_compute, engine._dispatch_ragged

        def prefill(*a, **k):
            if threading.current_thread() is engine._thread:
                self.n["prefill"] += 1
            return real_prefill(*a, **k)

        def ragged(*a, **k):
            self.n["ragged"] += 1
            return real_ragged(*a, **k)

        monkeypatch.setattr(side.batch, "prefill_compute", prefill)
        monkeypatch.setattr(engine, "_dispatch_ragged", ragged)


def _serve(engine, prompt, max_new=6, **kw):
    return engine.submit(prompt, max_new_tokens=max_new, temperature=0.0, **kw).result(TIMEOUT)


def _cold(side: Side, layout: str, monkeypatch) -> dict:
    """Each prompt on a fresh engine: (tokens, prefill calls, ragged)."""
    out = {}
    for p in PROMPTS:
        engine, _ = side.engine("cold", side.pi.PrefixIndex(), layout)
        calls = Calls(side, engine, monkeypatch)
        engine.start()
        try:
            out[p] = (_serve(engine, p).token_ids, dict(calls.n))
        finally:
            engine.stop()
            monkeypatch.undo()
    return out


def pause_rows(side: Side, engine, rows: int, tokens: int = 1) -> threading.Event:
    """Hold the engine thread at its next block read once ``rows`` rows
    have ``tokens`` tokens out, until the returned event is set: the
    notice then lands while those rows are mid-generation, however fast
    the host."""
    release = threading.Event()
    name = "_consume_block" if side.jax else "_consume"
    real = getattr(engine, name)

    def consume(rec):
        if not release.is_set() and sum(s is not None and len(s.tokens) >= tokens
                                        for s in engine.slots) >= rows:
            release.wait(TIMEOUT)
        return real(rec)

    setattr(engine, name, consume)
    return release


def _owned(engine) -> tuple:
    """Busy slots, requests left and (paged) pages owned."""
    pages = 0
    if engine.paged_cache is not None:
        stats = engine.paged_cache.stats()
        pages = stats["total_blocks"] - stats["free_blocks"]
    return sum(s is not None for s in engine.slots), len(engine._by_id), pages


@LAYOUTS
def test_reclaim_evacuates_to_the_survivor(models, layout, monkeypatch):
    def scenario(side):
        cold = _cold(side, layout, monkeypatch)
        metrics = Metrics()
        src, dst, mig = side.fleet(layout, metrics=metrics)
        try:
            for p in PROMPTS:
                assert _serve(src, p).token_ids == cold[p][0]
            src_keys = sorted(src._prefix_cache.keys())
            summary = src.begin_reclaim(10.0)
            dst_keys = sorted(dst._prefix_cache.keys())
            warm = {}
            for p in PROMPTS:
                calls = Calls(side, dst, monkeypatch)
                warm[p] = (_serve(dst, p).token_ids, dict(calls.n))
                monkeypatch.undo()
            again = src.begin_reclaim(10.0)
            return {"summary": summary, "src_keys": src_keys, "dst_keys": dst_keys,
                    "warm": warm, "cold": cold, "again": again,
                    "status": src.health_check()["status"], "owned": _owned(src),
                    "evacuations": mig.evacuations_total, "series": metrics.reclamation()}
        finally:
            src.stop(), dst.stop()

    out = _sides(models, scenario)
    ev = out["summary"]["evacuation"]
    assert out["summary"]["accepted"] and out["summary"]["drained"]
    assert ev["outcome"] == "committed" and ev["target"] == "dst"
    assert ev["committed"] == ev["entries"] == len(out["src_keys"]) > 0
    assert out["src_keys"] == out["dst_keys"]
    assert {p: w[0] for p, w in out["warm"].items()} == {p: c[0] for p, c in out["cold"].items()}
    if layout == "paged-int8":
        # no chunk cache on int8: only the whole-prompt entry of SHORT
        assert not any(k.startswith("chunkpfx:") for k in out["src_keys"])
        assert out["warm"][SHORT][1]["prefill"] == 0
    else:
        # a full chunk-chain hit and a whole-prompt hit: nothing computed
        assert all(w[1] == {"prefill": 0, "ragged": 0} for w in out["warm"].values())
    assert out["again"]["accepted"] is False and out["status"] == "DOWN"
    assert out["owned"] == (0, 0, 0) and out["evacuations"] == 1
    assert out["series"] == [
        ("increment_counter", "app_kv_evacuations_total", (("outcome", "committed"),)),
        ("increment_counter", "app_replica_reclamations_total", ()),
        ("record_histogram", "app_reclaim_drain_seconds", ()),
    ]


@LAYOUTS
def test_kv_evacuate_fault_degrades_to_cold_reprefill(models, layout, monkeypatch):
    def scenario(side):
        cold = _cold(side, layout, monkeypatch)
        src, dst, mig = side.fleet(layout)
        try:
            for p in PROMPTS:
                _serve(src, p)
            before = sorted(dst._prefix_cache.keys())
            with side.chaos.active(side.chaos.ChaosInjector(303, {"kv.evacuate": 1.0})):
                summary = src.begin_reclaim(10.0)
            after = sorted(dst._prefix_cache.keys())
            served = {}
            for p in PROMPTS:
                calls = Calls(side, dst, monkeypatch)
                served[p] = (_serve(dst, p).token_ids, dict(calls.n))
                monkeypatch.undo()
            return {"summary": summary, "unchanged": before == after, "served": served,
                    "cold": cold, "failed": mig.failed_evacuations_total}
        finally:
            src.stop(), dst.stop()

    out = _sides(models, scenario)
    ev = out["summary"]["evacuation"]
    assert ev["outcome"] == "degraded" and ev["committed"] == 0 and ev["entries"] > 0
    assert out["unchanged"] and out["failed"] == 1
    assert out["served"] == out["cold"]  # a cold re-prefill: same tokens, same work


@LAYOUTS
def test_reclaiming_refuses_and_reports(models, layout):
    """While the drain runs, health reads RECLAIMING with the preemptible
    and reclaim details, and a submit is a retriable 503."""

    def scenario(side):
        src, dst, _ = side.fleet(layout)
        release = pause_rows(side, src, 1)
        try:
            fut = src.submit(CHUNKED, max_new_tokens=40, temperature=0.0)
            while not any(s is not None and s.tokens for s in src.slots):
                time.sleep(0.002)
            result: dict = {}
            notice = threading.Thread(target=lambda: result.update(src.begin_reclaim(30.0)))
            notice.start()
            while src.health_check()["status"] != "RECLAIMING":
                time.sleep(0.002)
            health = src.health_check()
            try:
                src.submit(SHORT, max_new_tokens=2)
                refused = None
            except side.errors.ErrorServiceUnavailable as exc:
                refused = (exc.status_code, exc.retry_after is not None)
            release.set()
            r = fut.result(TIMEOUT)
            notice.join(TIMEOUT)
            details = health["details"]
            return {"status": health["status"], "preemptible": details.get("preemptible"),
                    "reclaim": sorted(details.get("reclaim", {})),
                    "deadline_in_notice": 0 < details["reclaim"]["deadline_s"] <= 30.0,
                    "refused": refused, "finish": r.finish_reason, "drained": result["drained"],
                    "keys": sorted(details), "owned": _owned(src),
                    "stamped": "reclaim" in src.timeline.get(r.request_id).to_dict()["phases_ms"]}
        finally:
            release.set()
            src.stop(), dst.stop()

    out = _sides(models, scenario)
    assert out["status"] == "RECLAIMING" and out["preemptible"] is True
    assert out["reclaim"] == ["deadline_s"] and out["deadline_in_notice"]
    assert out["refused"] == (503, True)
    assert out["finish"] == "length" and out["drained"] and out["owned"] == (0, 0, 0)
    assert out["stamped"]


@LAYOUTS
def test_notice_sweeps_batch_class_rows(models, layout):
    """Two rows run (interactive and batch) and two batch rows wait; the
    notice fails the queued batch rows retriable and the interactive row
    finishes on both sides. The running batch row drains on the reference
    and pages out retriable on the port (Queue C 24)."""

    def scenario(side):
        tenants = side.tenancy.TenantRegistry()
        tenants.set_policy(side.tenancy.TenantPolicy(name="bulk", deadline_class="batch",
                                                     deadline_s=600.0))
        tenants.set_policy(side.tenancy.TenantPolicy(name="gold", deadline_class="interactive",
                                                     deadline_s=600.0))
        src, dst, _ = side.fleet(layout, tenants=tenants, max_slots=2)
        # two blocks past the first token: a row whose prefill has just
        # completed is not yet in a dispatched block, and the reference
        # sweeps it there
        release = pause_rows(side, src, 2, tokens=9)
        try:
            # two chunks each, so the interactive row is still decoding
            # when the batch row's prefill completes
            running = {name: src.submit(SWEPT + name, max_new_tokens=40, temperature=0.0,
                                        tenant=name)
                       for name in ("gold", "bulk")}
            while sum(s is not None and len(s.tokens) >= 9 for s in src.slots) < 2:
                time.sleep(0.002)
            queued = [src.submit(f"queued {i}", max_new_tokens=4, tenant="bulk") for i in range(2)]
            result: dict = {}
            notice = threading.Thread(target=lambda: result.update(src.begin_reclaim(60.0)))
            notice.start()
            while not src._reclaiming:
                time.sleep(0.001)
            release.set()
            outcomes = {}
            for name, fut in [*running.items(), *(("queued", f) for f in queued)]:
                try:
                    r = fut.result(TIMEOUT)
                    outcomes.setdefault(name, []).append(r.finish_reason)
                except side.errors.ErrorServiceUnavailable as exc:
                    outcomes.setdefault(name, []).append((exc.status_code, exc.retry_after))
            notice.join(TIMEOUT)
            bulk = src.timeline.get(running["bulk"].request_id)
            return {"outcomes": outcomes, "drained": result.get("drained"),
                    "owned": _owned(src), "bulk_phases": sorted(bulk.to_dict()["phases_ms"])}
        finally:
            release.set()
            src.stop(), dst.stop()

    outs = [scenario(Side(models, name)) for name in ("jax", "port")]
    for out in outs:
        assert out["outcomes"]["gold"] == ["length"]
        assert out["outcomes"]["queued"] == [(503, 0.5), (503, 0.5)]
        assert out["drained"] and out["owned"] == (0, 0, 0)
    jax_out, port_out = outs
    assert jax_out["outcomes"]["bulk"] == ["length"]
    assert port_out["outcomes"]["bulk"] == [(503, 0.5)]
    assert "reclaim-preempted" in port_out["bulk_phases"]
    assert "reclaim-preempted" not in jax_out["bulk_phases"]


HOST_READS = ("item", "tolist", "numpy", "cpu", "__int__", "__bool__", "__float__")


@pytest.mark.parametrize("layout", ["paged-bf16", "dense-bf16"])
def test_sweep_reads_the_host_only_at_the_sync_sites(models, layout, monkeypatch):
    """A notice's sweep (a running batch row paged out and failed, a
    queued one failed) reads no tensor to the host on the engine thread:
    every read there is inside ``_block_sync`` or ``_first_token``."""
    from gofr_tpu_torch.serving import engine as tengine_mod

    side = Side(models, "port")
    tenants = ttenancy.TenantRegistry()
    tenants.set_policy(ttenancy.TenantPolicy(name="bulk", deadline_class="batch",
                                             deadline_s=600.0))
    src, dst, _ = side.fleet(layout, tenants=tenants, max_slots=2)
    release = pause_rows(side, src, 2)
    reads = {"outside": [], "inside": 0}
    site = threading.local()

    def in_site(fn):
        def wrapped(*a, **k):
            site.depth = getattr(site, "depth", 0) + 1
            try:
                return fn(*a, **k)
            finally:
                site.depth -= 1
        return wrapped

    for name in HOST_READS:
        def reader(self, *a, _real=getattr(torch.Tensor, name), _name=name, **k):
            if threading.current_thread() is src._thread:
                if getattr(site, "depth", 0):
                    reads["inside"] += 1
                else:
                    reads["outside"].append(_name)
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, reader)
    monkeypatch.setattr(tengine_mod, "_block_sync", in_site(tengine_mod._block_sync))
    monkeypatch.setattr(ServingEngine, "_first_token", in_site(ServingEngine._first_token))
    try:
        running = [src.submit(CHUNKED + f" row {i}", max_new_tokens=30, tenant="bulk")
                   for i in range(2)]
        while sum(s is not None and len(s.tokens) > 0 for s in src.slots) < 2:
            time.sleep(0.002)
        queued = src.submit("queued bulk", max_new_tokens=4, tenant="bulk")
        result: dict = {}
        notice = threading.Thread(target=lambda: result.update(src.begin_reclaim(60.0)))
        notice.start()
        while not src._reclaiming:
            time.sleep(0.001)
        release.set()
        notice.join(TIMEOUT)
        summary = result
        failed = 0
        for fut in running + [queued]:
            with pytest.raises(terrors.ErrorServiceUnavailable):
                fut.result(TIMEOUT)
            failed += 1
    finally:
        release.set()
        src.stop(), dst.stop()
        monkeypatch.undo()
    assert failed == 3 and summary["evacuation"]["outcome"] == "committed"
    assert reads["outside"] == [] and reads["inside"] > 0
