"""The continuous-batching serving engine (port of
``gofr_tpu/serving/engine.py``: the dense slot cache and the paged pool,
each with bf16 or int8 KV, monolithic and chunked prefill).

Requests queue FIFO. Each loop iteration a :class:`StepPlanner` plans the
step: the decode rows first, then whole-chunk grants to the partially
prefilled prompts (oldest first), then an admission quota. An admitted
prompt of at most one chunk that fits a prefill bucket prefills whole at
its padded bucket in one call (flash kernel), commits its K/V into its
slot row of the dense cache or into pages of the shared pool, and
samples the first token with a generator seeded by (engine seed, request
id). A longer prompt becomes a chunk cursor: its chunks run in the
unified ragged dispatch (``batch.ragged_step``, ``ragged_step_paged``/
``_q``) together with the N-step decode block, and the dispatch that
completes the prompt samples its first token on the device from a
generator seeded the same way, so a request draws the same first token on
either route. Decoding runs as N-step device blocks (sampling and stop
evaluation on the device) and the host syncs once per dispatch. Dispatches
are double-buffered: dispatch k+1 goes out before dispatch k's packed
result is read, so the host's bookkeeping overlaps the device. A row
retires on its stop token or its length limit and frees its slot (and
its pages) at once.

``kv_layout="dense"`` (the default, as in the reference) reserves a
``[slots, max_seq_len]`` row per slot (``llama.KVCache``); decode reads a
row's whole layer cache in plain PyTorch, as the reference's XLA does.
``kv_layout="paged"`` commits memory by resident tokens through a page
pool and decodes through the paged kernels; there a chunk cursor the pool
cannot cover requeues from chunk 0 once nothing of it is in flight. With
``kv_dtype="int8"`` either layout stores K/V as int8 with f32 per-vector
scales. A prompt is refused at submit only when it cannot fit
``max_seq_len`` (with one position left to generate) or the whole pool.
Weight-only int8 params (``llama.quantize_params``) serve as they are.
Not ported yet: the prefix cache and chunk-prefix cache, speculative
decoding, LoRA, cancel and deadlines, dedup/HA, the supervisor, timelines,
tracing, metrics and tenancy.

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
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.sampling import sample_logits
from gofr_tpu_torch.serving import batch as batch_ops
from gofr_tpu_torch.serving.kv_cache import OutOfBlocks, PagedKVCache
from gofr_tpu_torch.serving.stepplan import ChunkCursor, StepPlan, StepPlanner
from gofr_tpu_torch.serving.tokenizer import ByteTokenizer

DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)

log = logging.getLogger(__name__)


class QueueFull(RuntimeError):
    """The admission queue holds ``max_queue`` requests: retry later."""


class EngineStopped(RuntimeError):
    """The engine stopped before the request was served."""


@dataclasses.dataclass
class EngineConfig:
    max_slots: int = 8
    max_seq_len: int = 1024
    max_new_tokens_default: int = 128
    max_queue: int = 256
    prefill_buckets: tuple[int, ...] = DEFAULT_BUCKETS
    # fresh admissions per step plan at most (the planner's max_admissions)
    admission_per_step: int = 4
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
    # back-off after a failed loop iteration
    idle_sleep_s: float = 0.002


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str  # "stop" | "length" | "kv_exhausted"
    ttft_s: float
    duration_s: float


class _Requeue(Exception):
    """Raised inside admission when KV pages are short for now (paged
    layout): the request goes back to the head of the queue."""


class _Request:
    __slots__ = (
        "id", "prompt_ids", "max_new_tokens", "temperature", "top_k", "top_p",
        "stream_cb", "future", "created", "first_token_at", "tokens",
        "stop_ids", "dispatched", "kv_exhausted",
    )

    def __init__(self, rid: int, prompt_ids: list[int], max_new_tokens: int,
                 temperature: float, top_k: int, top_p: float,
                 stream_cb: Callable | None, stop_ids: set[int]) -> None:
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
    """Owns the model params, the KV cache (dense or paged) and the loop
    thread."""

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
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._dec_state: batch_ops.DecodeState | None = None  # None: rebuild
        # slots prefilled since the last dispatch: slot -> (first token,
        # resident length, remaining budget, stop id), folded into the
        # device state at the next dispatch
        self._pending_admit: dict[int, tuple[int, int, int, int]] = {}
        self._mask_host: np.ndarray | None = None
        self._mask_dev: torch.Tensor | None = None
        self._rng = torch.Generator(device=self.device).manual_seed(seed)

        self._queue: collections.deque[_Request] = collections.deque()
        self._mu = threading.Lock()  # guards _queue, _next_id, _stopped
        self._next_id = 0
        self._stopped = False
        self._running = False
        self._thread: threading.Thread | None = None
        self._wake = threading.Event()

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running:
            return
        with self._mu:
            if self._stopped:
                raise EngineStopped("a stopped engine does not restart")
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="serving-engine", daemon=True)
        self._thread.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop the loop thread and fail every request not yet finished."""
        with self._mu:
            self._stopped = True
        self._running = False
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            if self._thread.is_alive():
                log.error("serving engine thread did not exit within %gs", join_timeout)
            else:
                self._thread = None
        # swept after the join: the loop may have put a request back at the
        # head of the queue while it was stopping
        with self._mu:
            leftovers = list(self._queue)
            self._queue.clear()
        if self._thread is None:  # the loop is gone, so its slots are ours
            leftovers += [req for req in self.slots if req is not None]
        for req in leftovers:
            self._settle(req, exc=EngineStopped("engine stopped before the request was served"))

    # ---------------------------------------------------------------- submit
    def submit(
        self,
        prompt: str | list[int],
        *,
        max_new_tokens: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        stream_cb: Callable[[int, str, bool], None] | None = None,
    ) -> concurrent.futures.Future:
        """Thread-safe submit; the Future resolves to a GenerationResult.
        ``stream_cb(token_id, text_piece, done)`` runs on the engine thread
        for every token and once more with ``done`` at the end."""
        prompt_ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        if not prompt_ids:
            raise ValueError("empty prompt")
        if len(prompt_ids) >= self.config.max_seq_len:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens leaves no position to generate "
                f"within max_seq_len={self.config.max_seq_len}"
            )
        pc = self.paged_cache
        if pc is not None and pc.pages_needed(len(prompt_ids)) > pc.num_pages:
            raise ValueError(
                f"prompt needs {pc.pages_needed(len(prompt_ids))} KV pages; the pool has "
                f"{pc.num_pages} in total"
            )
        budget = self.config.max_seq_len - len(prompt_ids)
        max_new = min(max_new_tokens or self.config.max_new_tokens_default, budget)
        with self._mu:
            if self._stopped:
                raise EngineStopped("engine stopped")
            if len(self._queue) >= self.config.max_queue:
                raise QueueFull(f"{self.config.max_queue} requests already queued")
            self._next_id += 1
            req = _Request(
                self._next_id, prompt_ids, max_new, float(temperature), int(top_k),
                float(top_p), stream_cb, stop_ids={self.tokenizer.eos_id},
            )
            self._queue.append(req)
        self._wake.set()
        return req.future

    async def generate(self, prompt: str | list[int], **kw: Any) -> GenerationResult:
        """Asyncio-friendly submit + await."""
        return await asyncio.wrap_future(self.submit(prompt, **kw))

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
        with self._mu:
            depth = len(self._queue)
        return self._planner.plan(
            decode_rows=decode_rows, cursors=list(self._cursors.values()),
            free_slots=sum(1 for s in self.slots if s is None), queue_depth=depth,
        )

    def _route_chunked(self, prompt_len: int) -> bool:
        """True when a prompt prefills through a chunk cursor and the ragged
        dispatch: longer than a chunk, or longer than every bucket."""
        return prompt_len > self._chunk_tokens or prompt_len > max(self._buckets())

    def _admit(self, plan: StepPlan) -> bool:
        """Admit up to the plan's quota of queued requests FIFO into free
        slots. A request the pool cannot hold yet stays at the head;
        nothing overtakes it."""
        did = False
        cap = max(plan.admit_cap, 1)  # a submit may have raced the plan
        for slot in range(self.config.max_slots):
            if cap <= 0:
                break
            if self.slots[slot] is not None:
                continue
            with self._mu:
                if not self._queue:
                    break
                req = self._queue.popleft()
            try:
                if self._route_chunked(len(req.prompt_ids)):
                    self._start_cursor(slot, req)
                else:
                    self._prefill_into(slot, req)
            except _Requeue:
                with self._mu:
                    self._queue.appendleft(req)
                break
            except Exception as exc:
                log.exception("prefill failed for request %d", req.id)
                self.slots[slot] = None
                self._cursors.pop(slot, None)
                self._free_kv(slot)
                self._settle(req, exc=exc)
            did = True
            cap -= 1
        return did

    def _start_cursor(self, slot: int, req: _Request) -> None:
        """Admit a long prompt as a chunk cursor: claim the slot and leave
        the prompt to the planner's chunk grants. On the paged layout pages
        are claimed at the first grant."""
        cursor = ChunkCursor(req=req, slot=slot, total=len(req.prompt_ids), seq=self._cursor_seq)
        self._cursor_seq += 1
        self.slots[slot] = req
        self.cache_len[slot] = 0
        self.last_token[slot] = 0
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self._cursors[slot] = cursor

    def _cursor_health(self, slot: int, req: _Request, cursor: ChunkCursor) -> None:
        """A cursor the pool could not cover requeues from chunk 0, at the
        head of the queue, once nothing of it is in flight (an in-flight
        ragged dispatch still writes through the slot's pages). A dense
        slot row always covers its cursor, which is never blocked."""
        if cursor.in_flight > 0 or not cursor.blocked:
            return
        log.info("KV pool short; request %d requeues from chunk 0", req.id)
        self._cursors.pop(slot, None)
        self.slots[slot] = None
        self.cache_len[slot] = 0
        self._free_kv(slot)
        with self._mu:
            self._queue.appendleft(req)

    def _prefill_into(self, slot: int, req: _Request) -> None:
        cfg, pc = self.model_cfg, self.paged_cache
        ids = req.prompt_ids
        S = len(ids)
        bucket = batch_ops.pad_bucket(S, self._buckets())
        if pc is not None:
            if pc.pages_needed(bucket) > pc.num_pages:
                raise ValueError(
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
        self._emit(req, first_id)
        if first_id in req.stop_ids:
            self._retire(slot, "stop")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "length")

    # ---------------------------------------------------------------- decode
    def _decode_step(self, plan: StepPlan) -> bool:
        """Dispatch the next N-step block (the unified ragged dispatch when
        the plan granted chunks), then read the oldest one still
        outstanding (double-buffered: one dispatch stays in flight)."""
        inflight = self._dispatch(plan)
        if inflight is not None:
            self._inflight.append(inflight)
        did = inflight is not None
        if self._inflight and (inflight is None or len(self._inflight) > 1):
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
        rows: list[tuple[int, _Request]] = []
        for slot, req in enumerate(self.slots):
            if req is None or req.kv_exhausted:
                continue
            cursor = self._cursors.get(slot)
            if cursor is not None:  # mid-prefill: not a decode row
                self._cursor_health(slot, req, cursor)
                continue
            # page coverage for the whole block, including the steps
            # dispatched but not yet read (the device runs ahead of the
            # committed host mirror); a dense slot row covers max_seq_len
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
        self.last_token[slot] = token_id
        self._emit(req, token_id)
        if token_id in req.stop_ids:
            self._retire(slot, "stop")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "kv_exhausted" if req.kv_exhausted else "length")
        elif len(req.prompt_ids) + len(req.tokens) >= self.config.max_seq_len:
            self._retire(slot, "length")

    def _emit(self, req: _Request, token_id: int) -> None:
        req.tokens.append(token_id)
        if req.stream_cb is not None and token_id not in req.stop_ids:
            try:
                req.stream_cb(token_id, self.tokenizer.decode([token_id]), False)
            except Exception:
                log.exception("stream callback of request %d failed; streaming stops", req.id)
                req.stream_cb = None

    def _retire(self, slot: int, reason: str) -> None:
        req = self.slots[slot]
        self.slots[slot] = None
        self._cursors.pop(slot, None)
        self.cache_len[slot] = 0
        self._free_kv(slot)
        if req is not None:
            self._finish(req, reason)

    def _free_kv(self, slot: int) -> None:
        """Give the slot's pages back (a dense slot row needs nothing)."""
        if self.paged_cache is not None:
            self.paged_cache.free_slot(slot)

    def _finish(self, req: _Request, reason: str) -> None:
        now = time.perf_counter()
        out_ids = [t for t in req.tokens if t not in req.stop_ids]
        result = GenerationResult(
            request_id=req.id,
            text=self.tokenizer.decode(out_ids),
            token_ids=out_ids,
            prompt_tokens=len(req.prompt_ids),
            completion_tokens=len(out_ids),
            finish_reason=reason,
            ttft_s=(req.first_token_at - req.created) if req.first_token_at else 0.0,
            duration_s=now - req.created,
        )
        if req.stream_cb is not None:
            try:
                req.stream_cb(-1, "", True)
            except Exception:
                log.exception("stream callback of request %d failed", req.id)
        self._settle(req, value=result)

    @staticmethod
    def _settle(req: _Request, value: Any = None, exc: Exception | None = None) -> None:
        """Resolve a request's future once; a second settler loses quietly."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(value)
        except concurrent.futures.InvalidStateError:
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
                self._settle(req, exc=exc)

    def _buckets(self) -> tuple[int, ...]:
        return tuple(
            b for b in self.config.prefill_buckets if b <= self.config.max_seq_len
        ) or (self.config.max_seq_len,)
