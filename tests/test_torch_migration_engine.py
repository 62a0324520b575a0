"""Cross-replica KV on the port engine against the JAX ServingEngine, on the
CPU at ``LlamaConfig.tiny`` (vocab 300, the JAX package's params carried
across): KV migration and the engine side of P/D disaggregation, after the
engine cases of the reference's ``tests/test_kv_reuse.py`` and
``tests/test_disagg.py``.

Each scenario runs twice, once on a pair of JAX engines and once on a pair
of port engines of the same configuration (6 slots, buckets of 16, 16-token
chunks, a 64-entry prefix cache; 8-token pages on the paged layout): a
source replica ``A`` and a destination ``B`` whose ``KVMigrator`` holds
``A`` through ``local_engine_fetcher``. Greedy tokens, prefill and ragged
call counts, prefix tiers and the migrator's counters must be equal on both
sides. One test crosses the packages: a JAX engine's cache entries go
through the reference's wire encoder and the port's decoder into a port
engine, which serves the same greedy tokens as the JAX engine fed the same
entries. The last holds the engine's rule of no new host sync: with keyed
submits and migration on, the engine thread reads the host only at its two
sync sites.
"""

import threading

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from gofr_tpu import chaos as jchaos  # noqa: E402
from gofr_tpu.models import llama as jllama  # noqa: E402
from gofr_tpu.serving import ByteTokenizer as JByteTokenizer  # noqa: E402
from gofr_tpu.serving import EngineConfig as JEngineConfig  # noqa: E402
from gofr_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from gofr_tpu.serving import batch as jbatch  # noqa: E402
from gofr_tpu.serving import prefix_index as jpi  # noqa: E402
from gofr_tpu_torch import chaos as tchaos  # noqa: E402
from gofr_tpu_torch.models import llama as tllama  # noqa: E402
from gofr_tpu_torch.models.convert import params_from_jax  # noqa: E402
from gofr_tpu_torch.serving import batch as tbatch  # noqa: E402
from gofr_tpu_torch.serving import engine as tengine_mod  # noqa: E402
from gofr_tpu_torch.serving import prefix_index as tpi  # noqa: E402
from gofr_tpu_torch.serving.engine import EngineConfig, ServingEngine  # noqa: E402
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer  # noqa: E402

BASE = dict(max_slots=6, max_seq_len=128, prefill_buckets=(16,), max_queue=64,
            prefill_chunk_tokens=16, prefix_cache_entries=64)
LAYOUT_KW = {"dense": {}, "paged": dict(kv_layout="paged", kv_page_size=8)}
LAYOUTS = pytest.mark.parametrize("layout", ["dense", "paged"])
CHUNKED = "the shared system prompt " * 3  # 76 tokens: five 16-token chunks
SHORT = "short sys"  # 10 tokens: one whole-prompt prefill
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


class Side:
    """One package's engines, migrator, batch module and chaos tier."""

    def __init__(self, models, name):
        jcfg, jparams, tcfg, tparams = models
        self.name = name
        self.jax = name == "jax"
        self.pi = jpi if self.jax else tpi
        self.batch = jbatch if self.jax else tbatch
        self.chaos = jchaos if self.jax else tchaos
        self._cfg, self._params = (jcfg, jparams) if self.jax else (tcfg, tparams)

    def engine(self, migrator=None, **kw):
        conf = {**BASE, **kw}
        if self.jax:
            return JServingEngine(self._cfg, self._params, JEngineConfig(**conf),
                                  JByteTokenizer(), kv_migrator=migrator)
        return ServingEngine(self._cfg, self._params, EngineConfig(**conf), ByteTokenizer(),
                             device="cpu", kv_migrator=migrator)

    def wire_pair(self, role_a="unified", role_b="unified", **kw):
        """(index, source A, destination B, B's migrator), B peered to A."""
        index = self.pi.PrefixIndex()
        a = self.engine(role=role_a, **kw)
        migrator = self.pi.KVMigrator("B", index)
        b = self.engine(migrator=migrator, role=role_b, **kw)
        migrator.add_peer("A", self.pi.local_engine_fetcher(a))
        return index, a, b, migrator

    def faults(self, point):
        """One fault at ``point`` while the block runs."""
        return self.chaos.active(self.chaos.ChaosInjector(0, {point: 1.0}, max_faults=1))


def _sides(models, scenario):
    """(JAX outcome, port outcome) of one scenario; equal on both sides."""
    outs = [scenario(Side(models, name)) for name in ("jax", "port")]
    assert outs[1] == outs[0]
    return outs[1]


class Calls:
    """Counts prefill computes and ragged dispatches of one engine while
    open (both the monolithic prefill and the chunk dispatch go through
    one of the two)."""

    def __init__(self, side, engine, monkeypatch):
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


def _serve(engine, prompt, max_new=5, **kw):
    r = engine.submit(prompt, max_new_tokens=max_new, temperature=0.0, **kw).result(TIMEOUT)
    tl = engine.timeline.get(r.request_id)
    return r, tl


def _advertise(index, engine, replica_id="A", seq=1):
    adv = engine.prefix_advertisement()
    assert adv
    assert index.observe(replica_id, seq, adv)


def _stopped(*engines):
    for e in engines:
        e.stop()


def _contiguous(tl, prompt_tokens):
    """The chunk spans of the last tenancy abut and cover the prompt once."""
    pos = 0
    for c in tl.prefill_chunks:
        if c["start"] == 0:
            pos = 0
        assert c["start"] == pos, tl.prefill_chunks
        pos = c["start"] + c["tokens"]
    return pos == prompt_tokens


# --------------------------------------------------------------- migration
@LAYOUTS
def test_second_replica_serves_migrated_chain_zero_prefill(models, layout, monkeypatch):
    """A chunked prompt cached only on A admits on B through migration with
    zero prefill computes and zero ragged dispatches, token-identical to
    A; the transfer is paid once (a third request hits B locally)."""

    def scenario(side):
        index, a, b, mig = side.wire_pair(**LAYOUT_KW[layout])
        a.start(), b.start()
        try:
            r1, _ = _serve(a, CHUNKED)
            _advertise(index, a)
            calls = Calls(side, b, monkeypatch)
            r2, t2 = _serve(b, CHUNKED)
            migrated = dict(calls.n)
            r3, t3 = _serve(b, CHUNKED)
            monkeypatch.undo()
            return {"tokens": r1.token_ids, "same": r2.token_ids == r3.token_ids == r1.token_ids,
                    "calls": migrated, "tiers": (t2.prefix_tier, t3.prefix_tier),
                    "all_hits": all(c["prefix_hit"] for c in t2.prefill_chunks),
                    "migrations": mig.migrations_total, "terminal": t2.terminal_marks}
        finally:
            _stopped(a, b)

    out = _sides(models, scenario)
    assert out["same"] and out["calls"] == {"prefill": 0, "ragged": 0} and out["all_hits"]
    assert out["tiers"] == ("remote", "device") and out["migrations"] == 1


@pytest.mark.parametrize("layout,kv_dtype", [("dense", "bf16"), ("paged", "bf16"),
                                             ("paged", "int8"), ("dense", "int8")])
def test_monolithic_prompt_migrates_whole(models, layout, kv_dtype, monkeypatch):
    """A prompt of at most one chunk migrates through the whole-prompt
    key with no prefill compute, on bf16 and int8 KV alike; on int8 KV a
    chunked prompt does not migrate (the reference keeps no chunk cache
    there) and is computed, on both sides."""

    def scenario(side):
        index, a, b, mig = side.wire_pair(kv_dtype=kv_dtype, **LAYOUT_KW[layout])
        a.start(), b.start()
        try:
            r1, _ = _serve(a, SHORT, 4)
            c1, _ = _serve(a, CHUNKED, 4)
            _advertise(index, a)
            calls = Calls(side, b, monkeypatch)
            r2, t2 = _serve(b, SHORT, 4)
            short_calls = dict(calls.n)
            c2, tc = _serve(b, CHUNKED, 4)
            monkeypatch.undo()
            return {"tokens": (r1.token_ids, c1.token_ids),
                    "same": (r2.token_ids == r1.token_ids, c2.token_ids == c1.token_ids),
                    "short_calls": short_calls, "tiers": (t2.prefix_tier, tc.prefix_tier),
                    "chunked_calls": {k: v - short_calls[k] for k, v in calls.n.items()},
                    "migrations": mig.migrations_total}
        finally:
            _stopped(a, b)

    out = _sides(models, scenario)
    assert out["same"] == (True, True) and out["short_calls"] == {"prefill": 0, "ragged": 0}
    assert out["tiers"][0] == "remote"
    if kv_dtype == "int8":
        assert out["migrations"] == 1 and out["chunked_calls"]["ragged"] > 0
    else:
        assert out["migrations"] == 2 and out["chunked_calls"] == {"prefill": 0, "ragged": 0}


def test_stale_advertisement_degrades_to_compute_miss(models):
    """An advertisement of keys A never cached, then a real one of entries
    A has since dropped, degrade to compute misses with the cold tokens."""

    def scenario(side):
        index, a, b, mig = side.wire_pair()
        index.observe("A", 99, [["chunkpfx:16:0:16:deadbeef", "device"]])
        a.start(), b.start()
        try:
            prompt = "never cached anywhere " * 3
            cold, _ = _serve(a, prompt, 4)
            r, tl = _serve(b, prompt, 4)
            _advertise(index, a, seq=100)
            a._prefix_cache.clear()
            r2, tl2 = _serve(b, prompt + "x", 4)
            return {"tokens": cold.token_ids, "same": r.token_ids == cold.token_ids,
                    "tier": tl.prefix_tier, "migrations": mig.migrations_total,
                    "second": (r2.finish_reason, tl2.prefix_tier, r2.token_ids),
                    "covered": _contiguous(tl2, r2.prompt_tokens)}
        finally:
            _stopped(a, b)

    out = _sides(models, scenario)
    assert out["same"] and out["tier"] == "miss" and out["migrations"] == 0 and out["covered"]


@LAYOUTS
def test_migrate_fault_keeps_the_fetched_prefix_and_computes_the_rest(models, layout,
                                                                       monkeypatch):
    """B migrates prompt P (five chunks); A then serves Q, which shares P's
    first two chunks, and advertises it. Under a ``kv.migrate`` fault B
    keeps the two chunks it fetched before, computes Q's other three in
    chunk dispatches and serves A's tokens; the fault counts as a failed
    fetch and nothing is migrated."""
    q = CHUNKED[:32] + "but a different tail " * 2  # 32 shared tokens + 44

    def scenario(side):
        index, a, b, mig = side.wire_pair(**LAYOUT_KW[layout])
        a.start(), b.start()
        try:
            _serve(a, CHUNKED)
            _advertise(index, a)
            _serve(b, CHUNKED)
            want, _ = _serve(a, q)
            _advertise(index, a, seq=2)
            calls = Calls(side, b, monkeypatch)
            with side.faults("kv.migrate"):
                got, tl = _serve(b, q)
            monkeypatch.undo()
            hits = [c["tokens"] for c in tl.prefill_chunks if c["prefix_hit"]]
            computed = [c["tokens"] for c in tl.prefill_chunks if not c["prefix_hit"]]
            return {"tokens": want.token_ids, "same": got.token_ids == want.token_ids,
                    "hits": hits, "computed": sum(computed) == got.prompt_tokens - 32,
                    "chunks_computed": len(computed), "tier": tl.prefix_tier,
                    "ragged": calls.n["ragged"] > 0, "prefill": calls.n["prefill"],
                    "counters": (mig.migrations_total, mig.failed_fetches_total),
                    "covered": _contiguous(tl, got.prompt_tokens)}
        finally:
            _stopped(a, b)

    out = _sides(models, scenario)
    assert out["same"] and out["hits"] == [32] and out["computed"]
    assert out["chunks_computed"] == 3 and out["prefill"] == 0
    assert out["tier"] == "device" and out["ragged"] and out["counters"] == (1, 1)
    assert out["covered"]


# ------------------------------------------------------- P/D disaggregation
def test_prefill_only_retires_with_handoff_and_emits_nothing(models):
    def scenario(side):
        eng = side.engine(role="prefill")
        eng.start()
        try:
            frames = []
            r = eng.submit(CHUNKED, max_new_tokens=1, prefill_only=True,
                           stream_cb=lambda t, p, d: frames.append((t, d))).result(TIMEOUT)
            tl = eng.timeline.get(r.request_id)
            return {"reason": r.finish_reason, "tokens": r.token_ids,
                    "completion": r.completion_tokens, "frames": frames,
                    "terminal": (tl.terminal_marks, tl.finish_reason),
                    "advertised": bool(eng.prefix_advertisement()), "role": eng.role}
        finally:
            eng.stop()

    out = _sides(models, scenario)
    assert out["reason"] == "handoff" and out["tokens"] == [] and out["completion"] == 0
    assert out["frames"] == [(-1, True)] and out["terminal"] == (1, "handoff")
    assert out["advertised"] and out["role"] == "prefill"


@LAYOUTS
def test_handoff_is_token_identical_with_zero_prefill_compute(models, layout, monkeypatch):
    """The decode replica admits the handed-off chain (chunked and short
    prompts) with zero prefill computes and ragged dispatches, with the
    tokens of a unified replica serving the same prompt."""

    def scenario(side):
        _index, a, b, mig = side.wire_pair("prefill", "decode", **LAYOUT_KW[layout])
        ref = side.engine(**LAYOUT_KW[layout])
        a.start(), b.start(), ref.start()
        try:
            out = {}
            for name, prompt, max_new in (("chunked", CHUNKED, 5), ("short", SHORT, 4)):
                r0, _ = _serve(ref, prompt, max_new)
                rp, _ = _serve(a, prompt, 1, prefill_only=True)
                calls = Calls(side, b, monkeypatch)
                r1, tl = _serve(b, prompt, max_new, handoff_from="A")
                monkeypatch.undo()
                out[name] = {"reason": rp.finish_reason, "tokens": r0.token_ids,
                             "same": r1.token_ids == r0.token_ids, "calls": calls.n,
                             "tier": tl.prefix_tier, "terminal": tl.terminal_marks,
                             "covered": _contiguous(tl, r1.prompt_tokens)}
            out["handoffs"] = mig.handoffs_total
            return out
        finally:
            _stopped(a, b, ref)

    out = _sides(models, scenario)
    for name in ("chunked", "short"):
        o = out[name]
        assert o["reason"] == "handoff" and o["same"] and o["tier"] == "remote"
        assert o["calls"] == {"prefill": 0, "ragged": 0} and o["terminal"] == 1
    assert out["chunked"]["covered"] and out["handoffs"] == 2


@pytest.mark.parametrize("fault", ["evicted", "kv.handoff"])
def test_incomplete_chain_fails_whole_handoff_then_reprefills(models, fault):
    """A source that lost a middle chunk, or a ``kv.handoff`` fault, fails
    the whole handoff: nothing partial is committed, the decode replica
    re-prefills (here the advisory fetch finds no advertisement) and
    serves the unified tokens."""

    def scenario(side):
        _index, a, b, mig = side.wire_pair("prefill", "decode")
        ref = side.engine()
        a.start(), b.start(), ref.start()
        try:
            r0, _ = _serve(ref, CHUNKED)
            _serve(a, CHUNKED, 1, prefill_only=True)
            keys = sorted((k for k, _t in a.prefix_advertisement(128) if k.startswith("chunkpfx:")),
                          key=lambda k: int(k.split(":")[2]))
            if fault == "evicted":
                a._prefix_cache.evict(keys[1])
                r1, tl = _serve(b, CHUNKED, handoff_from="A")
            else:
                with side.faults("kv.handoff"):
                    r1, tl = _serve(b, CHUNKED, handoff_from="A")
            return {"tokens": r0.token_ids, "same": r1.token_ids == r0.token_ids,
                    "chunks": len(keys), "handoffs": mig.handoffs_total,
                    "failed": mig.failed_fetches_total, "tier": tl.prefix_tier,
                    "terminal": tl.terminal_marks, "covered": _contiguous(tl, r1.prompt_tokens),
                    "computed": sum(c["tokens"] for c in tl.prefill_chunks
                                    if not c["prefix_hit"])}
        finally:
            _stopped(a, b, ref)

    out = _sides(models, scenario)
    assert out["same"] and out["handoffs"] == 0 and out["failed"] == 1 and out["chunks"] == 5
    assert out["tier"] == "miss" and out["computed"] == 76 and out["covered"]


def test_role_is_validated_as_the_reference_does(models):
    for side in (Side(models, "jax"), Side(models, "port")):
        with pytest.raises(ValueError, match="TPU_REPLICA_ROLE"):
            side.engine(role="router")
        assert side.engine(role="decode").role == "decode"


# ------------------------------------------------------------- cross-package
@pytest.mark.parametrize("prompt", [SHORT, CHUNKED], ids=["whole", "chained"])
def test_reference_entries_serve_on_the_port(models, prompt):
    """A JAX engine's cache entries, encoded by the reference's
    ``encode_entry``, decoded by the port's ``decode_entry`` and fetched
    by a port engine's migrator, serve the same greedy tokens as a JAX
    engine fed the same entries through the reference's decoder, with
    zero prefill computes on both."""
    jside, tside = Side(models, "jax"), Side(models, "port")
    source = jside.engine()
    source.start()
    try:
        want, _ = _serve(source, prompt, 6)
        keys = [k for k, _t in source.prefix_advertisement(128)]
        payloads = {k: jpi.encode_entry(source._prefix_cache.get(k)) for k in keys}
    finally:
        source.stop()
    out = {}
    for side, decode in ((jside, jpi.decode_entry), (tside, tpi.decode_entry)):
        index = side.pi.PrefixIndex()
        index.observe("src", 1, [[k, "device"] for k in keys])
        mig = side.pi.KVMigrator("dst", index)
        mig.add_peer("src", lambda ks, _d=decode: {k: _d(payloads[k]) for k in ks if k in payloads})
        dst = side.engine(migrator=mig)
        dst.start()
        try:
            r, tl = _serve(dst, prompt, 6)
        finally:
            dst.stop()
        out[side.name] = (r.token_ids, tl.prefix_tier, mig.migrations_total)
    assert out["port"] == out["jax"] == (want.token_ids, "remote", 1)


# ------------------------------------------------------------ no new syncs
HOST_READS = ("item", "tolist", "numpy", "cpu", "__int__", "__float__", "__bool__",
              "__index__")


def test_keyed_migration_reads_the_host_only_at_the_sync_sites(models, monkeypatch):
    """With keyed submits and migration (a chained and a whole-prompt
    hit), a handoff and a cold prompt, every read of a tensor to the host
    on the engine thread happens inside ``_block_sync`` or
    ``_first_token``, as on an engine with neither: the port adds no host
    sync to the engine thread."""
    side = Side(models, "port")
    handed = "handed off " * 3
    counts = {}
    for wired in (True, False):
        if wired:
            index, a, b, mig = side.wire_pair()
            engines = [a, b]
        else:
            b = side.engine()
            engines = [b]
        reads = {"outside": [], "inside": 0}
        site = threading.local()

        def in_site(fn):
            def wrapped(*a_, **k_):
                site.depth = getattr(site, "depth", 0) + 1
                try:
                    return fn(*a_, **k_)
                finally:
                    site.depth -= 1
            return wrapped

        for name in HOST_READS:
            def reader(self, *a_, _real=getattr(torch.Tensor, name), _name=name, _b=b, **k_):
                if threading.current_thread() is _b._thread:
                    if getattr(site, "depth", 0):
                        reads["inside"] += 1
                    else:
                        reads["outside"].append(_name)
                return _real(self, *a_, **k_)

            monkeypatch.setattr(torch.Tensor, name, reader)
        monkeypatch.setattr(tengine_mod, "_block_sync", in_site(tengine_mod._block_sync))
        monkeypatch.setattr(ServingEngine, "_first_token", in_site(ServingEngine._first_token))
        for e in engines:
            e.start()
        try:
            if wired:
                for p in (CHUNKED, SHORT):
                    _serve(a, p, 6)
                _serve(a, handed, 1, prefill_only=True)
                _advertise(index, a)
            prompts = (CHUNKED, SHORT, "cold prompt, never seen " * 2)
            outs = [_serve(b, p, 6, idempotency_key=f"k{i}" if wired else None)[0].token_ids
                    for i, p in enumerate(prompts)]
            outs.append(_serve(b, handed, 6, handoff_from="A" if wired else None)[0].token_ids)
        finally:
            _stopped(*engines)
            monkeypatch.undo()
        counts[wired] = (reads["outside"], reads["inside"] > 0, outs)
        if wired:
            assert (mig.migrations_total, mig.handoffs_total) == (2, 1)
    assert counts[True][0] == counts[False][0] == []
    assert counts[True][1] and counts[True][2] == counts[False][2]
