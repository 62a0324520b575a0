"""The continuous-batching serving engine (port of
``gofr_tpu/serving/engine.py``: the dense slot cache and the paged pool,
each with bf16 or int8 KV, monolithic and chunked prefill, and the request
lifecycle).

Requests queue in a priority + FIFO :class:`Scheduler` (lower priority
first) that assigns slots and gates each admission round by a prefill
token budget. Each loop iteration a :class:`StepPlanner` plans the step:
the decode rows first, then whole-chunk grants to the partially prefilled
prompts (oldest first), then an admission quota. An admitted prompt of at
most one chunk that fits a prefill bucket prefills whole at its padded
bucket in one call (flash kernel), commits its K/V into its slot row of
the dense cache or into pages of the shared pool, and samples the first
token with a generator seeded by (engine seed, request id). A longer
prompt becomes a chunk cursor: its chunks run in the unified ragged
dispatch (``batch.ragged_step``, ``ragged_step_paged``/``_q``) together
with the N-step decode block, and the dispatch that completes the prompt
samples its first token on the device from a generator seeded the same
way, so a request draws the same first token on either route. Decoding
runs as N-step device blocks (sampling and stop evaluation on the device)
and the host syncs once per dispatch. Dispatches are pipelined
``decode_sync_every`` deep: dispatch k+depth goes out before dispatch k's
packed result is read, so the host's bookkeeping overlaps the device. A
row retires on its stop token, its length limit, a cancel or its deadline
and frees its slot (and its pages) at once; tokens of a retired row still
in flight are dropped when their block is read.

The lifecycle: ``submit`` takes a ``priority`` and a ``deadline`` (seconds
the caller still cares), answers 503 while the engine drains or after it
stopped, and sheds with a 429 when the queue-wait estimate
(:class:`QueueWaitEstimator`) passes the request's deadline or
``shed_max_wait_s``. A prompt longer than ``max_seq_len - 1`` is served
from its tail. A request still queued past its deadline fails with a 504
and is never prefilled; one past it mid-stream retires with
``deadline_exceeded``. ``cancel`` sets a flag that the engine thread
resolves at its next admission, dispatch scan or token commit. Token
frames and each request's final settlement run on one detok worker
thread, off the engine thread, in order; a ``stream_cb`` that raises
cancels its request. ``drain`` stops admission, waits for the work in
hand, fails what is left with a retriable 503, and stops.

``kv_layout="dense"`` (the default, as in the reference) reserves a
``[slots, max_seq_len]`` row per slot (``llama.KVCache``); decode reads a
row's whole layer cache in plain PyTorch, as the reference's XLA does.
``kv_layout="paged"`` commits memory by resident tokens through a page
pool and decodes through the paged kernels; there a chunk cursor the pool
cannot cover requeues from chunk 0 once nothing of it is in flight, and a
prompt the whole pool can never hold fails at admission with a 413. With
``kv_dtype="int8"`` either layout stores K/V as int8 with f32 per-vector
scales. Weight-only int8 params (``llama.quantize_params``) serve as they
are. Not ported yet: the prefix cache and chunk-prefix cache, speculative
decoding, LoRA, dedup/HA, the supervisor, timelines, tracing, metrics,
``health_check``, reclamation and tenancy.

Runs on the card unless constructed with ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import dataclasses
import logging
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from gofr_tpu_torch._device import resolve_device, to_device
from gofr_tpu_torch.errors import (
    ErrorDeadlineExceeded,
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.sampling import sample_logits
from gofr_tpu_torch.serving import batch as batch_ops
from gofr_tpu_torch.serving.kv_cache import OutOfBlocks, PagedKVCache
from gofr_tpu_torch.serving.scheduler import QueueFull, Scheduler
from gofr_tpu_torch.serving.shed import QueueWaitEstimator
from gofr_tpu_torch.serving.stepplan import ChunkCursor, StepPlan, StepPlanner
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

log = logging.getLogger(__name__)


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 1024
    max_new_tokens_default: int = 128
    max_queue: int = 256
    prefill_buckets: tuple[int, ...] = DEFAULT_BUCKETS
    # fresh admissions per step plan at most (the planner's max_admissions)
    admission_per_step: int = 4
    # the scheduler's per-admission-round prompt-token gate: a later
    # prompt longer than what is left of it waits for the next round
    prefill_token_budget: int = 4096
    # prompts longer than this, or longer than the largest bucket, prefill
    # in chunks of this many tokens (on the paged layout aligned down to
    # the page grid), interleaved with decode blocks in one ragged
    # dispatch; also the per-iteration prefill budget when
    # step_token_budget is 0 (auto)
    prefill_chunk_tokens: int = 256
    # explicit per-iteration token target: decode rows (rows * multi_step)
    # are reserved first, prefill chunks fill the rest; 0 = auto
    step_token_budget: int = 0
    # "dense" reserves [slots, max_seq] rows; "paged" commits memory by
    # resident tokens through the page pool (serving/kv_cache.py)
    kv_layout: str = "dense"
    kv_page_size: int = 16  # any size: the CUDA kernels have no tile rule
    kv_num_pages: int | None = None  # default: slots*max_seq worth of pages
    # "int8" stores K/V quantized (per-vector absmax, f32 scales): half the
    # bytes per resident token and half the decode KV stream
    kv_dtype: str = "bf16"
    # decode tokens per device block (the N of the N-step block)
    multi_step: int = 4
    # dispatches outstanding before the host reads the oldest one (the
    # pipeline depth): 1 = dispatch k+1, then read k
    decode_sync_every: int = 1
    # back-off after a failed loop iteration
    idle_sleep_s: float = 0.002
    # load shedding: a 429 at submit when the queue-wait estimate passes
    # this many seconds (0 disables the threshold; a request's own
    # deadline always sheds against the estimate)
    shed_max_wait_s: float = 0.0
    # the shed estimator's service time before the first completed
    # request (0: a cold engine sheds nothing)
    shed_cold_prior_s: float = 0.0
    # drain(): how long the work in hand gets before what is left fails
    # with a retriable 503
    drain_deadline_s: float = 30.0

    @classmethod
    def from_config(cls, config: Any) -> "EngineConfig":
        """Every field from its ``TPU_*`` knob, with the reference's
        defaults and parsing. ``config`` is any object with ``get(key)``
        (None when unset) and ``get_or_default(key, default)``."""
        num_pages = config.get("TPU_KV_NUM_PAGES")
        buckets = config.get("TPU_BATCH_PREFILL_BUCKETS")
        multi_step = config.get("TPU_BATCH_MULTI_STEP")
        return cls(
            max_slots=int(config.get_or_default("TPU_BATCH_MAX_SLOTS", "8")),
            max_seq_len=int(config.get_or_default("TPU_BATCH_MAX_TOKENS", "1024")),
            max_new_tokens_default=int(config.get_or_default("TPU_MAX_NEW_TOKENS_DEFAULT", "128")),
            max_queue=int(config.get_or_default("TPU_BATCH_MAX_QUEUE", "256")),
            prefill_buckets=(
                tuple(int(b) for b in buckets.split(",") if b.strip())
                if buckets else DEFAULT_BUCKETS
            ),
            admission_per_step=int(config.get_or_default("TPU_BATCH_ADMISSION_PER_STEP", "4")),
            prefill_token_budget=int(config.get_or_default("TPU_BATCH_PREFILL_BUDGET", "4096")),
            prefill_chunk_tokens=int(config.get_or_default("TPU_PREFILL_CHUNK_TOKENS", "256")),
            step_token_budget=int(config.get_or_default("TPU_STEP_TOKEN_BUDGET", "0")),
            idle_sleep_s=float(config.get_or_default("TPU_IDLE_SLEEP_S", "0.002")),
            kv_layout=config.get_or_default("TPU_KV_LAYOUT", "dense"),
            kv_page_size=int(config.get_or_default("TPU_KV_PAGE_SIZE", "16")),
            kv_num_pages=int(num_pages) if num_pages else None,
            kv_dtype=config.get_or_default("TPU_KV_DTYPE", "bf16"),
            # the reference's unset value means 4 while spec decoding is
            # off, and the port has no spec decoding
            multi_step=int(multi_step) if multi_step else 4,
            decode_sync_every=int(config.get_or_default("TPU_DECODE_SYNC_EVERY", "1")),
            shed_max_wait_s=float(config.get_or_default("TPU_SHED_MAX_WAIT_S", "0")),
            shed_cold_prior_s=float(config.get_or_default("TPU_SHED_COLD_PRIOR_S", "0")),
            drain_deadline_s=float(config.get_or_default("TPU_DRAIN_DEADLINE_S", "30")),
        )


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "kv_exhausted" | "cancel" | "deadline_exceeded"
    ttft_s: float
    duration_s: float


class _Requeue(Exception):
    """Raised inside admission when KV pages are short for now (paged
    layout): the request goes back to the head of its priority class."""


class _Request:
    __slots__ = (
        "id", "prompt_ids", "max_new_tokens", "temperature", "top_k", "top_p",
        "stream_cb", "future", "created", "first_token_at", "tokens",
        "stop_ids", "dispatched", "kv_exhausted", "priority", "canceled", "deadline",
    )

    def __init__(self, rid: int, prompt_ids: list[int], max_new_tokens: int,
                 temperature: float, top_k: int, top_p: float,
                 stream_cb: Callable | None, stop_ids: set[int], *,
                 priority: int = 0, deadline: float | None = None) -> None:
        self.id = rid
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stream_cb = stream_cb
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.future.request_id = rid
        self.created = time.perf_counter()
        self.first_token_at: float | None = None
        self.tokens: list[int] = []
        self.stop_ids = stop_ids
        self.dispatched = 0  # decode steps dispatched (>= committed)
        self.kv_exhausted = False  # cut short by pool pressure, not its budget
        self.priority = priority
        self.canceled = False  # set by cancel() or a failing stream_cb
        # absolute perf_counter time the caller stops caring; None = never
        self.deadline = (self.created + deadline) if deadline else None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def remaining(self, now: float) -> float | None:
        """Seconds left of the deadline (None without one), never below 0."""
        if self.deadline is None:
            return None
        return max(self.deadline - now, 0.0)


class _Inflight:
    """A dispatched, not yet read block: its packed device result, the
    (slot, request) decode rows and the (slot, request, cursor, start, n,
    finishes) chunk rows it was built from. By the time it is read a slot
    may have been retired or re-admitted; ``slots[slot] is req`` tells."""

    __slots__ = ("packed", "rows", "steps", "prefill_rows")

    def __init__(self, packed: torch.Tensor, rows: list, steps: int,
                 prefill_rows: list | None = None) -> None:
        self.packed = packed
        self.rows = rows
        self.steps = steps
        self.prefill_rows = prefill_rows or []


def _stop_id(req: _Request) -> int:
    """The row's stop id on the device (-1: none, or more than one)."""
    return next(iter(req.stop_ids)) if len(req.stop_ids) == 1 else -1


def _request_seed(seed: int, request_id: int) -> int:
    """The first-token generator's seed: a function of (seed, request id)
    alone, so a request's first draw does not depend on what ran before."""
    return (seed * 1_000_003 + request_id) & 0x7FFF_FFFF_FFFF_FFFF


class ServingEngine:
    """Owns the model params, the KV cache (dense or paged), the admission
    scheduler, the loop thread and the detok worker."""

    def __init__(
        self,
        cfg: llama.LlamaConfig,
        params: dict,
        engine_config: EngineConfig | None = None,
        tokenizer: Any = None,
        *,
        seed: int = 0,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.model_cfg = cfg
        self.params = params
        self.config = engine_config or EngineConfig()
        if self.config.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={self.config.kv_layout!r}: must be dense or paged")
        if self.config.multi_step < 1:
            raise ValueError("multi_step must be >= 1")
        if self.config.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype={self.config.kv_dtype!r}: must be bf16 or int8")
        self.tokenizer = tokenizer or ByteTokenizer(cfg.vocab_size)
        self.seed = seed
        self._block_steps = int(self.config.multi_step)
        self._sync_every = max(1, int(self.config.decode_sync_every))

        B, S = self.config.max_slots, self.config.max_seq_len
        chunk = max(1, int(self.config.prefill_chunk_tokens))
        self.cache: llama.KVCache | None = None
        self.paged_cache: PagedKVCache | None = None
        if self.config.kv_layout == "paged":
            page = self.config.kv_page_size
            self.paged_cache = PagedKVCache(
                cfg, num_pages=self.config.kv_num_pages or (B * S + page - 1) // page,
                page_size=page, max_slots=B, max_seq_len=S, device=self.device,
                kv_dtype=self.config.kv_dtype,
            )
            # chunk boundaries stay on the page grid: the chunk size aligns
            # down to whole pages (at least one)
            chunk = max(page, (chunk // page) * page)
        else:
            self.cache = llama.KVCache.create(
                cfg, B, max_len=S, kv_dtype=self.config.kv_dtype, device=self.device,
            )
        self._chunk_tokens = min(chunk, S)
        self._planner = StepPlanner(
            chunk_tokens=self._chunk_tokens, block_steps=self._block_steps,
            step_token_budget=self.config.step_token_budget,
            max_admissions=self.config.admission_per_step,
        )
        self._cursors: dict[int, ChunkCursor] = {}  # slot -> mid-prefill cursor
        self._cursor_seq = 0  # admission order of cursors
        # host mirrors, authoritative for rebuilding the device state
        self.cache_len = np.zeros(B, np.int32)  # committed tokens per slot
        self.last_token = np.zeros(B, np.int64)
        self.temperature = np.ones(B, np.float32)
        self.top_k = np.zeros(B, np.int64)
        self.top_p = np.ones(B, np.float32)
        self.slots: list[_Request | None] = [None] * B
        # dispatched, not yet read blocks, oldest first; at most
        # decode_sync_every outstanding after each dispatch
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._dec_state: batch_ops.DecodeState | None = None  # None: rebuild
        # slots prefilled since the last dispatch: slot -> (first token,
        # resident length, remaining budget, stop id), folded into the
        # device state at the next dispatch
        self._pending_admit: dict[int, tuple[int, int, int, int]] = {}
        self._mask_host: np.ndarray | None = None
        self._mask_dev: torch.Tensor | None = None
        self._rng = torch.Generator(device=self.device).manual_seed(seed)

        # admission: the scheduler owns the queue and which slots are
        # taken; every path that frees a slot releases it exactly once
        self._sched = Scheduler(B, self.config.max_queue, self.config.prefill_token_budget)
        self._by_id: dict[int, _Request] = {}  # queued + active, by request id
        self._count_lock = threading.Lock()  # guards _by_id, _next_id
        # makes submit's stop check + registration atomic with stop()'s flag
        self._submit_mu = threading.Lock()
        self._next_id = 0
        self._shed = QueueWaitEstimator(cold_prior_s=self.config.shed_cold_prior_s)
        self._draining = False
        self._stop_requested = False
        self._idle = threading.Event()  # set by the loop when drained dry
        # token frames and final settlement run on ONE worker, off the
        # engine thread, so a slow client never stalls the device; one
        # worker keeps each request's frames in order (tokens, then done).
        # It is handed host ints and strings only, never a device tensor.
        self._detok = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serving-detok"
        )
        self._detok_depth = 0  # tasks queued on the worker
        self._detok_mu = threading.Lock()
        self._detok_idle = threading.Event()  # set while nothing is queued
        self._detok_idle.set()
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running:
            return
        if self._stop_requested:
            raise RuntimeError("a stopped engine does not restart")
        self._idle.clear()
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop the loop thread and the detok worker, and fail every request
        not yet finished with a retriable 503."""
        with self._submit_mu:
            self._stop_requested = True  # before the sweep: see submit
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                log.error("serving engine thread did not exit within %gs", join_timeout)
            else:
                self._thread = None
        # queued settlements still run (wait=False drains the queue without
        # blocking on a client's stream_cb); later ones run inline
        self._detok.shutdown(wait=False)
        with self._count_lock:
            leftovers = list(self._by_id.values())
            self._by_id.clear()
        for req in leftovers:
            self._settle_future(req, ErrorServiceUnavailable(
                "engine stopped before the request was served; retry", retry_after=1.0,
            ))

    def drain(self, deadline_s: float | None = None, *, join_timeout: float = 10.0) -> bool:
        """Graceful drain: stop admitting (submit answers a retriable 503),
        let queued and running generations finish within ``deadline_s``
        (``drain_deadline_s`` by default), fail what is left with a
        retriable 503 and cancel it, then stop. True when everything
        finished in time."""
        if not self._running:
            self.stop(join_timeout=join_timeout)
            return True
        deadline_s = self.config.drain_deadline_s if deadline_s is None else deadline_s
        self._draining = True
        self._idle.clear()
        self._wake.set()
        t0 = time.monotonic()
        drained = self._idle.wait(timeout=deadline_s)
        if drained:
            # the loop went dry, but settlement rides the detok worker:
            # "drained" means every generation finished, so it must land
            # inside the same deadline
            drained = self._detok_idle.wait(timeout=max(deadline_s - (time.monotonic() - t0), 0.0))
        if not drained:
            with self._count_lock:
                remainder = list(self._by_id.values())
            for req in remainder:
                self._settle_future(req, ErrorServiceUnavailable(
                    "server draining; retry on another replica", retry_after=1.0,
                ))
                req.canceled = True  # the loop frees its slot and pages
                try:
                    self._sched.cancel(req.id)
                except KeyError:
                    pass
            if remainder:
                log.warning("drain deadline passed with %d request(s) in flight; "
                            "failed them with a retriable error", len(remainder))
            self._wake.set()
            # a short window for the loop to reclaim the canceled slots
            self._idle.wait(timeout=5.0)
        self.stop(join_timeout=join_timeout)
        return drained

    # ---------------------------------------------------------------- submit
    def submit(
        self,
        prompt: str | list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        priority: int = 0,
        deadline: float | None = None,
        stream_cb: Callable[[int, str, bool], None] | None = None,
    ) -> concurrent.futures.Future:
        """Thread-safe submit; the Future resolves to a GenerationResult.
        Lower ``priority`` is admitted first. ``deadline`` is the caller's
        remaining budget in seconds: a request still queued when it passes
        fails with ``ErrorDeadlineExceeded`` (504) without a prefill; one
        mid-stream retires with finish reason ``deadline_exceeded``.
        ``stream_cb(token_id, text_piece, done)`` runs on the detok worker
        for every token and once more with ``done`` at the end; if it
        raises, the request is canceled. Raises ``ErrorServiceUnavailable``
        (503) while draining or after stop, ``ErrorTooManyRequests`` (429)
        when shed or when the queue is full."""
        if self._draining:
            raise ErrorServiceUnavailable("server draining; retry on another replica",
                                          retry_after=1.0)
        # load shedding before any per-request work
        est_wait = self._shed.estimate_wait(self._sched.pending(), self.config.max_slots)
        shed_cap = self.config.shed_max_wait_s
        missed = deadline is not None and 0 < deadline < est_wait
        if missed or (shed_cap > 0 and est_wait > shed_cap):
            raise ErrorTooManyRequests(
                f"estimated queue wait {est_wait:.2f}s exceeds "
                + (f"request deadline {deadline:.2f}s" if missed
                   else f"shed threshold {shed_cap:.2f}s"),
                retry_after=est_wait,
            )
        with self._count_lock:
            self._next_id += 1
            rid = self._next_id
        prompt_ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        if not prompt_ids:
            raise ValueError("empty prompt")
        # keep the TAIL within the sequence budget; a prompt that does not
        # route chunked also keeps within the largest bucket
        max_prompt = self.config.max_seq_len - 1
        if not self._route_chunked(min(len(prompt_ids), max_prompt)):
            max_prompt = min(max_prompt, max(self._buckets()))
        prompt_ids = prompt_ids[-max_prompt:]
        budget = self.config.max_seq_len - len(prompt_ids)
        max_new = min(max_new_tokens or self.config.max_new_tokens_default, budget)
        req = _Request(
            rid, prompt_ids, max_new, float(temperature), int(top_k), float(top_p), stream_cb,
            stop_ids={self.tokenizer.eos_id}, priority=int(priority), deadline=deadline,
        )
        with self._submit_mu:
            if self._stop_requested:
                raise ErrorServiceUnavailable("server stopped; retry on another replica",
                                              retry_after=1.0)
            with self._count_lock:
                self._by_id[rid] = req
            try:
                self._sched.submit(rid, len(prompt_ids), max_new, req.priority)
            except QueueFull:
                with self._count_lock:
                    self._by_id.pop(rid, None)
                raise ErrorTooManyRequests(retry_after=max(est_wait, 1.0)) from None
        self._idle.clear()
        self._wake.set()
        return req.future

    async def generate(self, prompt: str | list[int], **kw: Any) -> GenerationResult:
        """Asyncio-friendly submit + await."""
        return await asyncio.wrap_future(self.submit(prompt, **kw))

    async def stream(self, prompt: str | list[int], *,
                     on_result: Callable[[GenerationResult], None] | None = None,
                     **kw: Any):
        """Async iterator of (token_id, text_piece). ``on_result`` gets the
        final GenerationResult after the last token. Leaving the iterator
        early cancels the request."""
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def cb(token_id: int, piece: str, done: bool) -> None:
            loop.call_soon_threadsafe(q.put_nowait, (token_id, piece, done))

        future = self.submit(prompt, stream_cb=cb, **kw)
        try:
            while True:
                token_id, piece, done = await q.get()
                if done:
                    break
                yield token_id, piece
            result = await asyncio.wrap_future(future)
            if on_result is not None:
                on_result(result)
        finally:
            # the consumer left mid-stream: free the slot instead of
            # decoding into the void
            if not future.done():
                self.cancel(future.request_id)

    def cancel(self, request_id: int) -> None:
        """Mark a queued or running request canceled. A running one frees
        its slot at the engine thread's next dispatch scan or token commit,
        a queued one at the next admission; nothing else changes here."""
        with self._count_lock:
            req = self._by_id.get(request_id)
        if req is not None:
            req.canceled = True
        try:
            self._sched.cancel(request_id)  # a no-op once admitted
        except KeyError:
            pass
        self._wake.set()

    # ------------------------------------------------------------------ loop
    def _loop(self) -> None:
        while self._running:
            try:
                plan = self._plan_step()
                did = self._admit(plan)
                if any(s is not None for s in self.slots):
                    did |= self._decode_step(plan)
                elif self._inflight:
                    # every row of the in-flight blocks retired meanwhile
                    self._consume(self._inflight.popleft())
                    did = True
                if not did:
                    if (self._draining and not self._inflight
                            and not any(s is not None for s in self.slots)
                            and self._sched.pending() == 0):
                        self._idle.set()  # drained dry: drain() waits on this
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as exc:  # the loop must outlive a failed step
                log.exception("serving engine step failed")
                self._fail_all(exc)
                time.sleep(self.config.idle_sleep_s)

    def _plan_step(self) -> StepPlan:
        """This iteration's step plan: decode rows reserved first, chunk
        grants for the cursors, an admission quota from what is left."""
        decode_rows = sum(
            1 for slot, req in enumerate(self.slots)
            if req is not None and slot not in self._cursors
        )
        return self._planner.plan(
            decode_rows=decode_rows, cursors=list(self._cursors.values()),
            free_slots=sum(1 for s in self.slots if s is None),
            queue_depth=self._sched.pending(),
        )

    def _route_chunked(self, prompt_len: int) -> bool:
        """True when a prompt prefills through a chunk cursor and the ragged
        dispatch: longer than a chunk, or longer than every bucket."""
        return prompt_len > self._chunk_tokens or prompt_len > max(self._buckets())

    def _admit(self, plan: StepPlan) -> bool:
        """Admit up to the plan's quota through the scheduler, each into the
        slot it assigns. Canceled requests finish ``"cancel"``, expired ones
        fail with a 504 before any prefill, and a request the pool cannot
        hold yet goes back to the head of its priority class."""
        sched = self._sched
        if not sched.pending():
            return False
        # a canceled request resolves only through admit, so the quota is
        # at least one while anything is queued (a submit may also have
        # raced the plan's read of the queue)
        pairs, canceled_ids = sched.admit(max(plan.admit_cap, 1))
        for rid in canceled_ids:
            with self._count_lock:
                req = self._by_id.pop(rid, None)
            if req is not None:
                self._finish(req, "cancel")
        for rid, slot in pairs:
            with self._count_lock:
                req = self._by_id.get(rid)
            if req is None or req.canceled or req.expired(time.perf_counter()):
                sched.release(slot)
                with self._count_lock:
                    self._by_id.pop(rid, None)
                if req is not None and req.canceled:
                    self._finish(req, "cancel")
                elif req is not None:
                    # expired while queued: never prefill it; the caller
                    # gets a 504
                    self._settle_async(req, exc=ErrorDeadlineExceeded())
                continue
            try:
                if self._route_chunked(len(req.prompt_ids)):
                    self._start_cursor(slot, req)
                else:
                    self._prefill_into(slot, req)
            except _Requeue:
                # pages short for now: back to the head of its class; the
                # rest of this round's pairs proceed
                sched.release(slot)
                self._resubmit_front(req)
            except Exception as exc:
                log.exception("prefill failed for request %d", rid)
                self.slots[slot] = None
                self._cursors.pop(slot, None)
                self.cache_len[slot] = 0
                self._free_kv(slot)
                try:
                    sched.release(slot)
                except KeyError:  # a retire inside the failed call released it
                    pass
                with self._count_lock:
                    self._by_id.pop(rid, None)
                self._settle_async(req, exc=exc)
        return bool(pairs or canceled_ids)

    def _resubmit_front(self, req: _Request) -> None:
        """Requeue at the head of the request's priority class after
        transient pool pressure; a queue that will not take it fails the
        request with a 429."""
        try:
            self._sched.submit(req.id, len(req.prompt_ids), req.max_new_tokens,
                               req.priority, front=True)
        except Exception:
            with self._count_lock:
                self._by_id.pop(req.id, None)
            self._settle_async(req, exc=ErrorTooManyRequests())

    def _start_cursor(self, slot: int, req: _Request) -> None:
        """Admit a long prompt as a chunk cursor: claim the slot and leave
        the prompt to the planner's chunk grants. On the paged layout pages
        are claimed at the first grant; a prompt the whole pool can never
        hold fails with a 413 before the slot is touched."""
        pc = self.paged_cache
        total = len(req.prompt_ids)
        if pc is not None and pc.pages_needed(total) > pc.num_pages:
            raise ErrorRequestEntityTooLarge(
                f"prompt needs {pc.pages_needed(total)} KV pages; the pool has "
                f"{pc.num_pages} in total"
            )
        cursor = ChunkCursor(req=req, slot=slot, total=total, seq=self._cursor_seq)
        self._cursor_seq += 1
        self.slots[slot] = req
        self.cache_len[slot] = 0
        self.last_token[slot] = 0
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self._cursors[slot] = cursor

    def _cursor_health(self, slot: int, req: _Request, cursor: ChunkCursor) -> None:
        """The mid-prefill exits, run at each dispatch scan once nothing of
        the cursor is in flight (an in-flight ragged dispatch still writes
        through the slot's pages): cancel and deadline retire the row; a
        cursor the pool could not cover requeues from chunk 0 at the head
        of its class. A dense slot row always covers its cursor."""
        if cursor.in_flight > 0:
            return
        if req.canceled:
            self._retire(slot, "cancel")
        elif req.expired(time.perf_counter()):
            self._retire(slot, "deadline_exceeded")
        elif cursor.blocked:
            log.info("KV pool short; request %d requeues from chunk 0", req.id)
            self._cursors.pop(slot, None)
            self.slots[slot] = None
            self.cache_len[slot] = 0
            self._free_kv(slot)
            self._sched.release(slot)
            self._resubmit_front(req)

    def _prefill_into(self, slot: int, req: _Request) -> None:
        cfg, pc = self.model_cfg, self.paged_cache
        ids = req.prompt_ids
        S = len(ids)
        bucket = batch_ops.pad_bucket(S, self._buckets())
        if pc is not None:
            if pc.pages_needed(bucket) > pc.num_pages:
                # permanent: however empty the pool gets, this never fits
                raise ErrorRequestEntityTooLarge(
                    f"prompt needs {pc.pages_needed(bucket)} KV pages; the pool has "
                    f"{pc.num_pages} in total"
                )
            try:
                pc.alloc_slot(slot, seq_id=req.id, prompt_len=S, reserve_tokens=bucket)
            except OutOfBlocks:
                raise _Requeue() from None
        tokens = np.full((1, bucket), self.tokenizer.pad_id, np.int64)
        tokens[0, :S] = ids
        last_logits, k_slab, v_slab = batch_ops.prefill_compute(
            cfg, self.params, to_device(tokens, self.device),
            to_device(np.array([S], np.int32), self.device),
        )
        if pc is not None:
            pc.write_prefill(slot, k_slab, v_slab)
        elif self.cache.quantized:
            self.cache = batch_ops.insert_slot_quantized(self.cache, k_slab, v_slab, slot)
        else:
            self.cache.k, self.cache.v = batch_ops.insert_slot(
                self.cache.k, self.cache.v, k_slab, v_slab, slot
            )
        gen = torch.Generator(device=self.device).manual_seed(_request_seed(self.seed, req.id))
        first = sample_logits(
            last_logits, gen, temperature=req.temperature, top_k=req.top_k, top_p=req.top_p
        )
        first_id = int(first[0])  # host sync: the first token is needed now
        self._commit_prefilled(slot, req, first_id, S)

    def _commit_prefilled(self, slot: int, req: _Request, first_id: int, resident: int) -> None:
        """Monolithic route: set the slot's mirrors and queue the fold into
        the device state for the next dispatch, then commit the token."""
        self.slots[slot] = req
        self.cache_len[slot] = resident
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        # the budget folds both limits (max_new and the sequence cap, which
        # submit clamped max_new to) and counts what is left after this token
        self._pending_admit[slot] = (
            first_id, resident, req.max_new_tokens - 1, _stop_id(req),
        )
        self._commit_first_token(slot, req, first_id)

    def _commit_first_token(self, slot: int, req: _Request, first_id: int) -> None:
        """The first-token commit both routes share (monolithic prefill,
        and the ragged dispatch that folded the token on the device): TTFT,
        emission and the one stop/length retire chain."""
        self.last_token[slot] = first_id
        req.first_token_at = time.perf_counter()
        self._shed.observe_ttft(req.first_token_at - req.created)
        self._emit(req, first_id)
        if first_id in req.stop_ids:
            self._retire(slot, "stop")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "length")

    # ---------------------------------------------------------------- decode
    def _decode_step(self, plan: StepPlan) -> bool:
        """Dispatch the next N-step block (the unified ragged dispatch when
        the plan granted chunks), then read the oldest one still
        outstanding once more than ``decode_sync_every`` are in flight."""
        inflight = self._dispatch(plan)
        if inflight is not None:
            self._inflight.append(inflight)
        did = inflight is not None
        if self._inflight and (inflight is None or len(self._inflight) > self._sync_every):
            self._consume(self._inflight.popleft())
            did = True
        return did

    def _slot_in_flight(self, slot: int, req: _Request) -> bool:
        return any(
            any(s == slot and r is req for s, r in rec.rows) for rec in self._inflight
        )

    def _make_device_state(self) -> batch_ops.DecodeState:
        """The device state from the host mirrors: cold start, or after a
        failure. Valid only with no block in flight."""
        B = self.config.max_slots
        budget = np.zeros(B, np.int32)
        done = np.ones(B, bool)
        stop = np.full(B, -1, np.int64)
        for slot, req in enumerate(self.slots):
            if req is None or slot in self._cursors:
                # a mid-prefill row is not decoding: it stays frozen until
                # its final chunk's fold on the device
                continue
            remaining = req.max_new_tokens - len(req.tokens)
            budget[slot] = max(remaining, 0)
            done[slot] = remaining <= 0
            if len(req.stop_ids) == 1:
                stop[slot] = next(iter(req.stop_ids))
        self._pending_admit.clear()  # the mirrors already hold these rows
        return batch_ops.make_decode_state(
            self.last_token, np.maximum(self.cache_len, 1), done, budget, stop,
            self.temperature, self.top_k, self.top_p, self._rng, device=self.device,
        )

    def _fold_admissions(self, state: batch_ops.DecodeState) -> batch_ops.DecodeState:
        items = sorted(self._pending_admit.items())
        self._pending_admit.clear()
        idx = np.array([s for s, _ in items], np.int64)

        def col(i: int, dtype: Any) -> torch.Tensor:
            return to_device(np.array([v[i] for _, v in items], dtype), self.device)

        return batch_ops.admit_decode_state(
            state, to_device(idx, self.device), col(0, np.int64), col(1, np.int32),
            col(2, np.int32), col(3, np.int64),
            to_device(self.temperature[idx], self.device),
            to_device(self.top_k[idx], self.device),
            to_device(self.top_p[idx], self.device),
            to_device(np.zeros(len(items), np.int32), self.device),
        )

    def _dispatch(self, plan: StepPlan) -> _Inflight | None:
        pc = self.paged_cache
        N = self._block_steps
        now = time.perf_counter()
        rows: list[tuple[int, _Request]] = []
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            cursor = self._cursors.get(slot)
            if cursor is not None:  # mid-prefill: not a decode row
                self._cursor_health(slot, req, cursor)
                continue
            if req.canceled:
                # tokens still in flight for the row are dropped when their
                # block is read (the slots[slot] is req check)
                self._retire(slot, "cancel")
                continue
            if req.expired(now):
                self._retire(slot, "deadline_exceeded")
                continue
            if req.kv_exhausted:
                continue  # retires once its in-flight tokens are read
            # page coverage for the whole block, including the steps
            # dispatched but not yet read (the device runs ahead of the
            # committed host mirror by every block in flight); a dense slot
            # row covers max_seq_len
            in_flight = req.dispatched - (len(req.tokens) - 1)
            if pc is None or pc.try_reserve_slot(slot, in_flight + N):
                rows.append((slot, req))
                continue
            log.warning("KV pool exhausted; retiring request %d early", req.id)
            req.kv_exhausted = True
            if not self._slot_in_flight(slot, req):
                self._retire(slot, "kv_exhausted")

        # the plan's chunk grants, page coverage reserved up front (with
        # each cursor's dispatched-ahead gap, like decode's); a cursor the
        # pool cannot cover is blocked and requeues once not in flight
        chunk_rows: list[tuple[int, ChunkCursor, _Request, int, int]] = []
        for slot, grant in plan.grants:
            cursor = self._cursors.get(slot)
            if cursor is None or cursor.blocked or cursor.remaining <= 0:
                continue
            if cursor.req.canceled or cursor.req.expired(now):
                continue  # _cursor_health retires it once nothing is in flight
            n = min(grant, cursor.remaining)
            if pc is not None and not self._cover_chunk(pc, slot, cursor, n):
                cursor.blocked = True
                continue
            chunk_rows.append((slot, cursor, cursor.req, cursor.dispatched, n))
        if not rows and not chunk_rows:
            return None

        mask = np.zeros(self.config.max_slots, bool)
        for slot, _ in rows:
            mask[slot] = True
        state = self._dec_state
        if state is None:
            state = self._make_device_state()
        elif self._pending_admit:
            state = self._fold_admissions(state)
        if self._mask_host is None or not np.array_equal(mask, self._mask_host):
            self._mask_dev = to_device(mask, self.device)
            self._mask_host = mask
        if chunk_rows:
            # with no decode row the dispatch runs the chunks alone (0 steps)
            steps = N if rows else 0
            packed, self._dec_state = self._dispatch_ragged(state, chunk_rows, steps)
            prefill_rows = []
            for slot, cursor, req, start, n in chunk_rows:
                cursor.dispatched = start + n
                prefill_rows.append((slot, req, cursor, start, n, start + n >= cursor.total))
        else:
            steps, prefill_rows = N, []
            cfg, params = self.model_cfg, self.params
            if pc is None:
                packed, self.cache, self._dec_state = batch_ops.decode_block(
                    cfg, params, self.cache, state, self._mask_dev, N,
                )
            elif pc.quantized:
                (packed, pc.k_pool, pc.v_pool, pc.ks_pool, pc.vs_pool,
                 self._dec_state) = batch_ops.decode_block_paged_q(
                    cfg, params, *pc.pools(), state, pc.tables_device(), self._mask_dev, N,
                )
            else:
                packed, pc.k_pool, pc.v_pool, self._dec_state = batch_ops.decode_block_paged(
                    cfg, params, pc.k_pool, pc.v_pool, state, pc.tables_device(),
                    self._mask_dev, N,
                )
        for _, req in rows:
            req.dispatched += steps
        return _Inflight(packed, rows, steps, prefill_rows)

    @staticmethod
    def _cover_chunk(pc: PagedKVCache, slot: int, cursor: ChunkCursor, n: int) -> bool:
        """Reserve the pages of a cursor's next ``n`` tokens: its first
        pages at its first grant, then coverage past what is in flight."""
        if cursor.allocated:
            return pc.try_reserve_slot(slot, cursor.in_flight + n)
        try:
            pc.alloc_slot(slot, seq_id=cursor.req.id, prompt_len=0, reserve_tokens=n)
        except OutOfBlocks:
            return False
        cursor.allocated = True
        return True

    def _dispatch_ragged(
        self, state: batch_ops.DecodeState, chunk_rows: list, steps: int,
    ) -> tuple[torch.Tensor, batch_ops.DecodeState]:
        """Assemble and launch ONE unified ragged dispatch: the granted
        chunks (per-row slices of their prompts in a [B, C] buffer) and the
        decode block, against the same cache or page pool. Rows whose chunk
        completes the prompt get their first token sampled on the device
        and folded into the decode state inside the dispatch."""
        pc = self.paged_cache
        B, C = self.config.max_slots, self._chunk_tokens
        chunk = np.full((B, C), -1, np.int64)
        # rows not chunking start past the dense cache's end, as in the
        # reference; only the chunk rows' entries are read
        start = np.full(B, self.config.max_seq_len, np.int32)
        finish = np.zeros(B, bool)
        new_len = np.zeros(B, np.int32)
        budgets = np.zeros(B, np.int32)
        stops = np.full(B, -1, np.int64)
        kvcap = np.zeros(B, np.int32)
        slots, seeds = [], []
        for slot, cursor, req, start_pos, n in chunk_rows:
            chunk[slot, :n] = req.prompt_ids[start_pos:start_pos + n]
            start[slot] = start_pos
            finish[slot] = start_pos + n >= cursor.total
            new_len[slot] = start_pos + n
            budgets[slot] = req.max_new_tokens - 1
            stops[slot] = _stop_id(req)
            if pc is not None:
                kvcap[slot] = pc.owned_capacity(slot)
            slots.append(slot)
            seeds.append(_request_seed(self.seed, req.id))

        def up(a: np.ndarray) -> torch.Tensor:
            return to_device(a, self.device)

        rows = up(np.array(slots, np.int64))
        tail = (up(finish), up(new_len), up(budgets), up(stops), up(self.temperature),
                up(self.top_k), up(self.top_p), seeds, self._mask_dev, steps)
        cfg, params = self.model_cfg, self.params
        if pc is None:
            packed, _, self.cache, new_state = batch_ops.ragged_step(
                cfg, params, self.cache, state, up(chunk), up(start), rows, *tail,
            )
            return packed, new_state
        args = (pc.tables_device(), up(chunk), up(start), rows, up(kvcap), *tail)
        if pc.quantized:
            (packed, _, pc.k_pool, pc.v_pool, pc.ks_pool, pc.vs_pool,
             new_state) = batch_ops.ragged_step_paged_q(cfg, params, *pc.pools(), state, *args)
        else:
            packed, _, pc.k_pool, pc.v_pool, new_state = batch_ops.ragged_step_paged(
                cfg, params, pc.k_pool, pc.v_pool, state, *args,
            )
        return packed, new_state

    def _consume(self, rec: _Inflight) -> None:
        packed = rec.packed.cpu().numpy()  # the block's one host-device sync
        for slot, req in rec.rows:
            if self.slots[slot] is not req:
                continue  # retired (and maybe re-admitted) since dispatch
            n_valid = int(packed[slot, rec.steps + 1])
            device_done = bool(packed[slot, rec.steps])
            for i in range(n_valid):
                self._commit_token(slot, req, int(packed[slot, i]))
                if self.slots[slot] is not req:
                    break  # retired mid-block: the tail is discarded
            if self.slots[slot] is not req:
                continue
            self.cache_len[slot] += n_valid
            if self.paged_cache is not None:
                self.paged_cache.advance_slot(slot, n_valid)
            if req.kv_exhausted:
                if not self._slot_in_flight(slot, req):
                    self._retire(slot, "kv_exhausted")
            elif device_done:
                # the host's own stop/length chain normally retired the row
                # already; this catches a host/device divergence
                self._retire(
                    slot, "stop" if req.tokens and req.tokens[-1] in req.stop_ids else "length"
                )
        # chunk rows (ragged dispatches only): commit each chunk's
        # residency; a row whose prompt finished takes its first token from
        # the trailing column of the same packed read
        for slot, req, cursor, start, n, fin in rec.prefill_rows:
            if self.slots[slot] is not req or self._cursors.get(slot) is not cursor:
                continue  # retired or requeued since dispatch: a stale chunk
            cursor.committed = start + n
            self.cache_len[slot] = cursor.committed
            if self.paged_cache is not None:
                self.paged_cache.advance_slot(slot, n)
            if fin:
                self._cursors.pop(slot)
                self._commit_first_token(slot, req, int(packed[slot, rec.steps + 2]))

    # ----------------------------------------------------------- bookkeeping
    def _commit_token(self, slot: int, req: _Request, token_id: int) -> None:
        """Deliver one decoded token and run the retire chain."""
        self.last_token[slot] = token_id
        self._emit(req, token_id)
        if req.canceled:
            self._retire(slot, "cancel")
        elif req.expired(time.perf_counter()):
            self._retire(slot, "deadline_exceeded")
        elif token_id in req.stop_ids:
            self._retire(slot, "stop")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "kv_exhausted" if req.kv_exhausted else "length")
        elif len(req.prompt_ids) + len(req.tokens) >= self.config.max_seq_len:
            self._retire(slot, "length")

    def _emit(self, req: _Request, token_id: int) -> None:
        """Record a token and queue its frame on the detok worker; a
        callback that raises cancels the request."""
        req.tokens.append(token_id)
        if req.stream_cb is None or token_id in req.stop_ids:
            return
        cb = req.stream_cb

        def frame() -> None:
            try:
                cb(token_id, self.tokenizer.decode([token_id]), False)
            except Exception as exc:
                if not req.canceled:
                    log.warning("stream callback of request %d failed (%r); canceling it", req.id, exc)
                req.canceled = True

        self._submit_detok(frame)  # dropped after stop: nobody reads it

    def _submit_detok(self, task: Callable[[], None]) -> bool:
        """Queue ``task`` on the detok worker with depth accounting (what
        drain waits on). False when the worker is already shut down."""
        with self._detok_mu:
            self._detok_depth += 1
            self._detok_idle.clear()

        def run() -> None:
            try:
                task()
            finally:
                self._detok_done()

        try:
            self._detok.submit(run)
            return True
        except RuntimeError:
            self._detok_done()
            return False

    def _detok_done(self) -> None:
        with self._detok_mu:
            self._detok_depth -= 1
            if self._detok_depth == 0:
                self._detok_idle.set()

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self._cursors.pop(slot, None)
        self.cache_len[slot] = 0
        self._free_kv(slot)
        self._sched.release(slot)
        if req is not None:
            with self._count_lock:
                self._by_id.pop(req.id, None)
            self._finish(req, reason)

    def _free_kv(self, slot: int) -> None:
        """Give the slot's pages back (a dense slot row needs nothing)."""
        if self.paged_cache is not None:
            self.paged_cache.free_slot(slot)

    def _finish(self, req: _Request, reason: str) -> None:
        """Settle a request that ran (or was canceled in the queue) with its
        result, behind its token frames on the detok worker."""
        now = time.perf_counter()
        self._shed.observe_request(now - req.created)
        out_ids = [t for t in req.tokens if t not in req.stop_ids]
        ttft = (req.first_token_at - req.created) if req.first_token_at else 0.0

        def build() -> GenerationResult:
            return GenerationResult(
                request_id=req.id,
                text=self.tokenizer.decode(out_ids),
                token_ids=out_ids,
                prompt_tokens=len(req.prompt_ids),
                completion_tokens=len(out_ids),
                finish_reason=reason,
                ttft_s=ttft,
                duration_s=now - req.created,
            )

        self._settle_async(req, build=build)

    def _settle_async(self, req: _Request, build: Callable[[], GenerationResult] | None = None,
                      exc: Exception | None = None) -> None:
        """The engine thread's terminal settlement: the done frame, then
        the future (with ``build()``'s result, made there, or ``exc``), on
        the detok worker behind the request's token frames; inline once
        the worker has shut down, so a terminal state is never lost."""

        def settle() -> None:
            if req.stream_cb is not None:
                try:
                    req.stream_cb(-1, "", True)
                except Exception:
                    pass  # the client is gone; the future still settles
            self._try_resolve(req, value=None if build is None else build(), exc=exc)

        if not self._submit_detok(settle):
            settle()

    @staticmethod
    def _try_resolve(req: _Request, value: Any = None, exc: Exception | None = None) -> bool:
        """Resolve a request's future once; a second settler loses quietly."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(value)
        except concurrent.futures.InvalidStateError:
            return False
        return True

    def _settle_future(self, req: _Request, exc: Exception) -> None:
        """Fail a request from outside the engine thread (drain, stop), and
        wake a stream consumer with its done frame."""
        if self._try_resolve(req, exc=exc) and req.stream_cb is not None:
            try:
                req.stream_cb(-1, "", True)
            except Exception:
                pass

    def _fail_all(self, exc: Exception) -> None:
        """A failed step leaves the pipeline unknown: drop the in-flight
        blocks, rebuild the device state from the mirrors next time, and
        fail every active request."""
        self._inflight.clear()
        self._pending_admit.clear()
        self._cursors.clear()
        self._dec_state = None
        self._mask_host = self._mask_dev = None
        for slot, req in enumerate(self.slots):
            if req is not None:
                self.slots[slot] = None
                self.cache_len[slot] = 0
                self._free_kv(slot)
                try:
                    self._sched.release(slot)
                except KeyError:
                    pass
                with self._count_lock:
                    self._by_id.pop(req.id, None)
                self._settle_async(req, exc=exc)

    def _buckets(self) -> tuple[int, ...]:
        return tuple(
            b for b in self.config.prefill_buckets if b <= self.config.max_seq_len
        ) or (self.config.max_seq_len,)
