"""Request-lifecycle timelines + the ``/requestz`` flight recorder (port of
``gofr_tpu/serving/timeline.py``, the same code; ``serving/handlers.py``
serves the ``/requestz`` routes).

Every request the engine accepts gets a :class:`RequestTimeline`: a set of
monotonic phase stamps (submitted → admitted → prefill start/end → first
token → per-decode-block syncs → detok → terminal) recorded at points the
engine thread **already touches** — the heartbeat stamps, the
``_block_sync`` consume, the detok executor. The hard constraint
(docs/observability.md): instrumentation reads only host-side data that is
already materialized at the existing sync points. Zero new device syncs:
on the card that rules out ``int(t)``, ``.item()``, ``.tolist()`` and
``bool(t)`` on a CUDA tensor anywhere in a stamp, a span attribute or a
metric.

The :class:`TimelineRecorder` keeps every in-flight timeline plus a
bounded ring of the last-N completed ones; :meth:`TimelineRecorder.snapshot`
is the JSON view the reference serves at ``/requestz``. That is
the answer to "where did this request's 200 ms go": per-phase offsets,
decode-block cadence, and the trace id that links the timeline to its
span tree and structured log records.

Thread model: the recorder's own mutex guards only membership (the
in-flight dict and the completed ring) and is never held across a call
out. Per-timeline mutation is single-writer-per-phase (the engine thread,
the submitting thread, the detok executor each own distinct stamps) and
uses GIL-atomic list/dict/attribute operations, so the hot path pays one
``time.monotonic()`` and a dict write per stamp; ``/requestz`` readers
get racy-but-consistent-enough snapshots of a live request by design.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any

# canonical phase names, in lifecycle order (decode-block syncs are
# aggregated as counters, not individual stamps — a 1024-token request
# would otherwise grow 256 entries)
PHASES = (
    "submitted",
    "admitted",
    "prefill_start",
    "prefill_end",
    "first_token",
    "detok_done",
)


class RequestTimeline:
    """One request's lifecycle record. Stamps are monotonic seconds; the
    JSON view renders them as millisecond offsets from ``submitted``."""

    __slots__ = (
        "request_id", "trace_id", "created_unix", "prompt_tokens",
        "phases", "decode_blocks", "decode_tokens", "last_block_at",
        "prefill_chunks", "prefix_tier", "finish_reason", "terminal_at",
        "terminal_marks", "spans", "tenant", "_t0",
    )

    def __init__(self, request_id: int, prompt_tokens: int = 0,
                 trace_id: str | None = None) -> None:
        self.request_id = request_id
        self.trace_id = trace_id
        self.created_unix = time.time()  # wall clock, display only
        self._t0 = time.monotonic()
        self.prompt_tokens = prompt_tokens
        self.phases: dict[str, float] = {}
        self.decode_blocks = 0
        self.decode_tokens = 0
        self.last_block_at: float | None = None
        # chunked-prefill record (continuous batching): one entry per
        # committed prefill chunk — {index, tokens, prefix_hit, ms}. A
        # monolithic (single-bucket) prefill leaves this empty; the
        # prefill_start→prefill_end stamps cover it either way.
        self.prefill_chunks: list[dict[str, Any]] = []
        # warmest KV source that served this request's cached prefix:
        # device | host | remote | miss (None until admission walks the
        # cache; docs/performance.md "KV reuse tiers"). First stamp wins
        # — a requeued admission keeps its original attribution.
        self.prefix_tier: str | None = None
        # multi-tenant plane (docs/serving.md "Multi-tenancy"): the
        # request's tenant label — per-tenant SLO attainment is directly
        # scrapeable off /requestz (preempted:<n> phase stamps mark each
        # preemption of the row)
        self.tenant: str | None = None
        self.finish_reason: str | None = None
        self.terminal_at: float | None = None
        # how many times a terminal state was recorded for this request —
        # the chaos tier asserts EXACTLY one (a second mark means two
        # settlement paths both thought they won)
        self.terminal_marks = 0
        # phase -> Span, registered by the engine when a tracer is wired;
        # all still-open spans are force-ended at the terminal mark so a
        # fault path can never leak one (Span.end is idempotent)
        self.spans: dict[str, Any] = {}

    # -- stamping (hot path: one monotonic read + a dict write) --------------
    def stamp(self, phase: str, t: float | None = None) -> None:
        """Record a phase stamp; the FIRST stamp for a phase wins (a
        requeued admission keeps its original queue-wait truth)."""
        self.phases.setdefault(phase, time.monotonic() if t is None else t)

    def block(self, n_tokens: int, t: float | None = None) -> None:
        """One consumed decode block: committed token count for this row
        at the block's single host sync."""
        self.decode_blocks += 1
        self.decode_tokens += int(n_tokens)
        self.last_block_at = time.monotonic() if t is None else t

    def chunk(self, index: int, n_tokens: int, prefix_hit: bool = False,
              start: int = 0) -> None:
        """One committed prefill chunk (or a skipped cached prefix),
        stamped at the ragged block's single host sync — same zero-new-
        device-syncs rule as :meth:`block`. ``start`` is the chunk's
        token offset in the prompt: the chaos tier audits that committed
        spans are contiguous and never overlap (a requeued request
        restarts at 0 — double-prefilling committed KV is the bug class
        the audit pins)."""
        self.prefill_chunks.append({
            "index": int(index),
            "start": int(start),
            "tokens": int(n_tokens),
            "prefix_hit": bool(prefix_hit),
            "ms": round((time.monotonic() - self._t0) * 1e3, 3),
        })

    # -- span registry -------------------------------------------------------
    def open_span(self, phase: str, span: Any) -> Any:
        if span is not None:
            displaced = self.spans.get(phase)
            if displaced is not None and displaced is not span:
                # re-opening a phase (a requeued request re-prefilling
                # after a warm restart): the displaced span would lose
                # its only closing handle — end it now (idempotent)
                try:
                    displaced.end()
                except Exception:
                    pass
            self.spans[phase] = span
            if self.trace_id is None:
                self.trace_id = span.trace_id
        return span

    def end_span(self, phase: str) -> None:
        span = self.spans.get(phase)
        if span is not None:
            span.end()

    def close_spans(self) -> None:
        for span in list(self.spans.values()):
            try:
                span.end()
            except Exception:
                pass  # a torn span must not block terminal settlement

    # -- terminal ------------------------------------------------------------
    @property
    def terminal(self) -> bool:
        return self.finish_reason is not None

    def mark_terminal(self, reason: str, t: float | None = None) -> bool:
        """Record the terminal phase. Returns True for the FIRST mark;
        later marks only bump ``terminal_marks`` (the exactly-once audit
        counter) without overwriting the recorded reason."""
        self.terminal_marks += 1
        if self.finish_reason is not None:
            return False
        self.finish_reason = reason
        self.terminal_at = time.monotonic() if t is None else t
        self.stamp("terminal", self.terminal_at)
        self.close_spans()
        return True

    # -- derived (bench + histograms read these) -----------------------------
    def phase_delta(self, a: str, b: str) -> float | None:
        """Seconds from phase ``a`` to phase ``b``; None when either is
        missing."""
        ta, tb = self.phases.get(a), self.phases.get(b)
        if ta is None or tb is None:
            return None
        return tb - ta

    def queue_wait_s(self) -> float | None:
        return self.phase_delta("submitted", "admitted")

    def ttft_s(self) -> float | None:
        return self.phase_delta("submitted", "first_token")

    def e2e_s(self) -> float | None:
        return self.phase_delta("submitted", "terminal")

    # -- JSON view -----------------------------------------------------------
    def _ms(self, t: float) -> float:
        return round((t - self._t0) * 1e3, 3)

    def to_dict(self) -> dict[str, Any]:
        # snapshot first: an in-flight timeline is being stamped by the
        # engine thread while /requestz serializes it — iterating the
        # live dict would raise "changed size during iteration"
        phases = {
            p: self._ms(t)
            for p, t in sorted(list(self.phases.items()), key=lambda kv: kv[1])
        }
        out: dict[str, Any] = {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "created_unix": round(self.created_unix, 6),
            "prompt_tokens": self.prompt_tokens,
            "terminal": self.terminal,
            "finish_reason": self.finish_reason,
            "terminal_marks": self.terminal_marks,
            "phases_ms": phases,
            "decode": {
                "blocks": self.decode_blocks,
                "tokens": self.decode_tokens,
                "last_block_ms": (
                    self._ms(self.last_block_at)
                    if self.last_block_at is not None else None
                ),
            },
        }
        if self.prefill_chunks:
            # snapshot (list() of the live list): the engine thread may
            # append a chunk while /requestz serializes an in-flight row
            out["prefill_chunks"] = list(self.prefill_chunks)
        if self.prefix_tier is not None:
            out["prefix_tier"] = self.prefix_tier
        if self.tenant is not None:
            out["tenant"] = self.tenant
        for key, value in (
            ("queue_wait_ms", self.queue_wait_s()),
            ("ttft_ms", self.ttft_s()),
            ("e2e_ms", self.e2e_s()),
        ):
            out[key] = round(value * 1e3, 3) if value is not None else None
        if not self.terminal:
            out["age_ms"] = self._ms(time.monotonic())
        return out


class TimelineExporter:
    """Streaming JSONL sink for completed timelines: one ``to_dict()``
    line per terminal settlement, written as requests finish. The bounded
    ``/requestz`` ring keeps the last 256 — a production-load run settles
    millions, and an offline goodput scorer or capacity planner needs every
    one of them. Writes happen on the
    settling thread (usually the detok executor) under the exporter's own
    lock, NEVER under the recorder mutex — a slow disk must not stall
    ``/requestz`` readers or the engine's settlement path."""

    def __init__(self, path: str, *, append: bool = False) -> None:
        self.path = path
        self._mu = threading.Lock()
        self._fh = open(path, "a" if append else "w", encoding="utf-8")
        self._lines = 0

    def write(self, tl: "RequestTimeline") -> None:
        line = json.dumps(tl.to_dict(), sort_keys=True)
        with self._mu:
            if self._fh.closed:
                return  # settled after close(): the ring still has it
            self._fh.write(line + "\n")
            self._lines += 1

    @property
    def lines(self) -> int:
        with self._mu:
            return self._lines

    def flush(self) -> None:
        with self._mu:
            if not self._fh.closed:
                self._fh.flush()

    def close(self) -> None:
        with self._mu:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "TimelineExporter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


class TimelineRecorder:
    """The flight recorder: all in-flight timelines plus a bounded ring
    of the last ``capacity`` completed ones."""

    # bounded prefix-reuse observation map (the spill tier's demotion
    # scorer reads it): far larger than any prefix cache so a hot key's
    # count survives its slabs moving between tiers
    REUSE_KEYS = 4096

    def __init__(self, capacity: int = 256) -> None:
        self._mu = threading.Lock()
        self._inflight: dict[int, RequestTimeline] = {}
        self._done: collections.deque[RequestTimeline] = collections.deque(
            maxlen=max(1, int(capacity))
        )
        # prefix-cache key -> observed reuse count, LRU-bounded. Fed by
        # the engine's admission-time cache hits; consumed by the spill
        # tier's demotion policy (serving/kv_spill.py) — a prefix the
        # timelines show being reused must outlive a one-shot prefix
        # under host-RAM byte pressure, whatever the raw LRU order says.
        self._reuse: "collections.OrderedDict[Any, int]" = (
            collections.OrderedDict()
        )
        self._exporter: TimelineExporter | None = None

    def observe_prefix_reuse(self, key: Any) -> None:
        """Record one admission-time hit on a prefix-cache key (engine
        thread; one dict write under the leaf lock)."""
        with self._mu:
            self._reuse[key] = self._reuse.get(key, 0) + 1
            self._reuse.move_to_end(key)
            while len(self._reuse) > self.REUSE_KEYS:
                self._reuse.popitem(last=False)

    def reuse_count(self, key: Any) -> int:
        """Observed reuse score for a prefix-cache key (0 = never seen
        re-used) — the spill tier's demotion ordering signal."""
        with self._mu:
            return self._reuse.get(key, 0)

    def begin(self, request_id: int, prompt_tokens: int = 0,
              trace_id: str | None = None) -> RequestTimeline:
        tl = RequestTimeline(request_id, prompt_tokens, trace_id)
        tl.stamp("submitted", tl._t0)
        with self._mu:
            self._inflight[request_id] = tl
        return tl

    def export_jsonl(self, path: str, *, append: bool = False) -> TimelineExporter:
        """Stream every subsequently-completed timeline to ``path`` as
        JSONL (one ``to_dict()`` object per line). Returns the exporter;
        the caller owns its lifetime (``close()`` or context-manage it —
        a closed exporter silently stops receiving, it never unhooks
        itself mid-settlement). One exporter at a time: re-calling
        replaces the hook, the displaced exporter is closed."""
        exporter = TimelineExporter(path, append=append)
        with self._mu:
            displaced, self._exporter = self._exporter, exporter
        if displaced is not None:
            displaced.close()
        return exporter

    def finish(self, tl: RequestTimeline, reason: str) -> bool:
        """Terminal settlement for one timeline. Exactly the future-
        settlement winner calls this with effect; a second call (two
        paths racing) is counted on the timeline, never double-ringed."""
        if not tl.mark_terminal(reason):
            return False
        with self._mu:
            self._inflight.pop(tl.request_id, None)
            self._done.append(tl)
            exporter = self._exporter
        if exporter is not None:
            # outside the recorder mutex: a slow disk stalls only the
            # settling thread, never /requestz readers
            try:
                exporter.write(tl)
            except Exception:
                pass  # export is observability, never a settlement gate
        return True

    def get(self, request_id: int) -> RequestTimeline | None:
        with self._mu:
            tl = self._inflight.get(request_id)
            if tl is not None:
                return tl
            for done in reversed(self._done):
                if done.request_id == request_id:
                    return done
        return None

    def all(self) -> list[RequestTimeline]:
        with self._mu:
            return list(self._inflight.values()) + list(self._done)

    def in_flight(self) -> list[RequestTimeline]:
        with self._mu:
            return list(self._inflight.values())

    def completed(self) -> list[RequestTimeline]:
        with self._mu:
            return list(self._done)

    def latency_summary(self) -> dict[str, Any]:
        """Median phase latencies over the completed ring — the compact
        health-check view of the same numbers the histograms export."""
        with self._mu:
            done = list(self._done)
            inflight = len(self._inflight)
        out: dict[str, Any] = {
            "in_flight": inflight, "completed": len(done),
        }
        for key, read in (
            ("ttft_ms_p50", RequestTimeline.ttft_s),
            ("queue_wait_ms_p50", RequestTimeline.queue_wait_s),
            ("e2e_ms_p50", RequestTimeline.e2e_s),
        ):
            values = sorted(
                v for v in (read(tl) for tl in done) if v is not None
            )
            if values:
                out[key] = round(values[len(values) // 2] * 1e3, 3)
        return out

    def snapshot(self, limit: int = 64) -> dict[str, Any]:
        """The ``/requestz`` view: every in-flight timeline (oldest
        first) and the newest ``limit`` completed ones."""
        limit = max(0, int(limit))
        with self._mu:
            inflight = list(self._inflight.values())
            # [-0:] would be the WHOLE list — an explicit zero guard
            done = list(self._done)[-limit:] if limit else []
        return {
            "in_flight": [tl.to_dict() for tl in inflight],
            "completed": [tl.to_dict() for tl in reversed(done)],
            "in_flight_count": len(inflight),
            "completed_count": len(done),
        }
