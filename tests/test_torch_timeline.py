"""The port's request timelines and flight recorder against the JAX
package's, on the CPU: seeded operation sequences (stamps, blocks, chunks,
spans, terminal marks, reuse observations, ring overflow) with the clocks
injected, so both sides see the same times, give equal ``to_dict``,
``latency_summary``, ``snapshot``, reuse counts and exported JSONL; the
ring keeps its bound and every in-flight timeline.
"""

import itertools
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from gofr_tpu.serving import timeline as jtimeline  # noqa: E402
from gofr_tpu_torch.serving import timeline as ttimeline  # noqa: E402
from gofr_tpu_torch.tracing import InMemoryExporter, SimpleSpanProcessor, Tracer  # noqa: E402


class _Clock:
    """A fake ``time`` module: monotonic and wall time advance by seeded
    steps, identically for both sides."""

    def __init__(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)
        self.t = 1000.0

    def monotonic(self) -> float:
        self.t += float(self._rng.integers(1, 50)) / 1000.0
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t


def _run(mod, seed: int, monkeypatch, tmp_path) -> dict:
    monkeypatch.setattr(mod, "time", _Clock(seed))
    rng = np.random.default_rng(seed)
    rec = mod.TimelineRecorder(capacity=int(rng.integers(1, 6)))
    exporter = rec.export_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"))
    tracer = Tracer("t", SimpleSpanProcessor(InMemoryExporter()))
    live: dict[int, object] = {}
    finished = []
    ids = itertools.count(1)
    for _ in range(300):
        op = int(rng.integers(0, 9))
        if op == 0 or not live:
            rid = next(ids)
            tl = rec.begin(rid, prompt_tokens=int(rng.integers(1, 4000)))
            tl.tenant = ["gold", None, "bulk"][rid % 3]
            live[rid] = tl
            continue
        rid = sorted(live)[int(rng.integers(0, len(live)))]
        tl = live[rid]
        if op == 1:
            tl.stamp(mod.PHASES[int(rng.integers(1, len(mod.PHASES)))])
        elif op == 2:
            tl.block(int(rng.integers(0, 9)))
        elif op == 3:
            tl.chunk(len(tl.prefill_chunks), int(rng.integers(1, 257)),
                     prefix_hit=bool(rng.integers(0, 2)), start=256 * len(tl.prefill_chunks))
        elif op == 4:
            tl.prefix_tier = tl.prefix_tier or ["miss", "device", "host"][int(rng.integers(0, 3))]
            rec.observe_prefix_reuse(f"key{int(rng.integers(0, 20))}")
        elif op == 5:
            tl.stamp(f"preempted:{int(rng.integers(1, 3))}")
        elif op == 6:
            tl.open_span(["queue", "prefill", "decode"][int(rng.integers(0, 3))],
                         tracer.start_span("s", activate=False))
        else:
            reason = ["stop", "length", "cancel", "shed"][int(rng.integers(0, 4))]
            assert rec.finish(tl, reason)
            assert not rec.finish(tl, "error")  # a second settler is only counted
            finished.append(tl.to_dict())
            del live[rid]
    exporter.close()
    return _no_trace_ids({
        "finished": finished,
        "snapshot": rec.snapshot(limit=int(rng.integers(0, 8))),
        "latency": rec.latency_summary(),
        "in_flight": sorted(t.request_id for t in rec.in_flight()),
        "completed": [t.request_id for t in rec.completed()],
        "reuse": {f"key{i}": rec.reuse_count(f"key{i}") for i in range(21)},
        "gets": [None if rec.get(i) is None else rec.get(i).request_id for i in range(1, 60)],
        "jsonl": [json.loads(line) for line in open(exporter.path)],
        "capacity": rec._done.maxlen,
    })


def _no_trace_ids(view):
    """Trace ids are random: keep only whether one is set."""
    if isinstance(view, dict):
        return {k: (v is not None) if k == "trace_id" else _no_trace_ids(v)
                for k, v in view.items()}
    if isinstance(view, list):
        return [_no_trace_ids(v) for v in view]
    return view


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_seeded_operations_give_equal_views(seed, monkeypatch, tmp_path):
    ref = _run(jtimeline, seed, monkeypatch, tmp_path)
    port = _run(ttimeline, seed, monkeypatch, tmp_path)
    assert port == ref
    assert len(port["completed"]) <= port["capacity"]
    assert port["snapshot"]["completed_count"] <= port["capacity"]
    assert all(d["terminal_marks"] == 2 for d in port["finished"])
    assert len(port["jsonl"]) == len(port["finished"])


def test_ring_bound_and_span_closing():
    """The ring drops the oldest completed timelines and keeps every
    in-flight one; the terminal mark ends each open span once."""
    tracer = Tracer("t", SimpleSpanProcessor(InMemoryExporter()))
    rec = ttimeline.TimelineRecorder(capacity=3)
    live = rec.begin(100)
    live.open_span("queue", tracer.start_span("q", activate=False))
    for rid in range(1, 6):
        tl = rec.begin(rid)
        tl.open_span("decode", tracer.start_span("d", activate=False))
        displaced = tracer.start_span("d2", activate=False)
        tl.open_span("decode", displaced)  # the first decode span ends here
        rec.finish(tl, "stop")
    snap = rec.snapshot()
    assert snap["in_flight_count"] == 1 and snap["completed_count"] == 3
    assert [t["request_id"] for t in snap["completed"]] == [5, 4, 3]
    assert rec.get(100) is live and rec.get(1) is None
    assert tracer.open_spans() == 1  # only the live request's queue span
    rec.finish(live, "cancel")
    assert tracer.open_spans() == 0
    assert rec.latency_summary()["completed"] == 3
