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
are.

KV reuse (``prefix_cache_entries > 0``): a prompt that prefills whole is
looked up under ``prefill:{bucket}:{S}:{digest}:-``; a hit skips the
prefill forward, writes the cached slabs into the slot row or its pages
(quantizing them for int8 KV) and samples the first token from the cached
logits with the request's own generator. On bf16 KV a chunked prompt is
also cached at every chunk boundary (``chunkpfx:{C}:{start}:{end}:
{digest}:-``, the digest of the whole prefix): admission walks the longest
cached chain, writes its slabs (``write_span`` on pages, ``insert_chunk``
on the dense row) and starts its cursor there, and a chain that covers the
whole prompt admits straight to decode with zero prefill dispatches. Each
chunk that becomes resident is stored with its prefix's last-position
logits. With ``kv_spill_bytes > 0`` the cache is a
:class:`~gofr_tpu_torch.serving.kv_spill.TieredPrefixCache`: device-tier
evictions spill to pinned host memory and a host hit re-uploads.

Speculative decoding (``spec_tokens = K > 0``): every prompt prefills
whole (clamped to the largest bucket), and each step drafts up to K tokens
per greedy row by prompt lookup over prompt + output, verifies all rows in
one chunk forward of K+1 positions, accepts the longest draft prefix that
greedy decoding would have produced (lossless) and samples a bonus token,
with one host sync per step. Sampled rows take plain one-token steps. The
mode is unpipelined: the host's mirrors are authoritative and the device
decode state is not used.

LoRA adapter multiplexing (``lora=AdapterRegistry(...)``): a request may
name an ``adapter_id``. ``submit`` answers an unknown id, or any id on an
engine without a registry, with a 400 and starts the adapter's upload to
the device table once every rejection gate has passed; admission pins the
adapter's table slot for the row's life (``AdapterBusy``, every slot
pinned or an upload that failed, requeues like pool pressure), and every
path that takes a row out releases the pin. Rows with different adapters
decode in the same block: each sampling site adds the low-rank delta of
the token that produced the logits, gathered by the row's slot (the
prompt's last token for a first token, ``last_token`` for a decode step).
Prefix-cache keys end in the adapter id (``-`` for none); cached logits
stay base-model logits. A registry with ``spec_tokens > 0`` is a
``ValueError``.

Tenant classes (``tenants=TenantRegistry(...)``): a request that names a
``tenant`` takes its class's priority (when it passed none) and default
deadline (when it has none); a request with no tenant is untouched. Load
shedding counts only waiters of the same or a higher class, and a metered
tenant over its token-rate budget (prompt plus ``max_new``) gets a 429.
Chunk grants walk cursors by (priority, age). The preemption ladder
(``tenant_preempt``, on by default): when a strictly higher class waits
and no slot is free (or, on the paged layout, the pool cannot hold its
prompt), the lowest-class row (on a tie, the one with more tokens out) is
paused once nothing of it is in flight: its whole chunk spans below its
resident length go into the prefix cache (bf16 KV with the chunk cache;
int8 KV recomputes them), its slot, pages and adapter pin are freed and it
requeues. Its resume is an ordinary admission of the prompt plus the
tokens it emitted: it walks the chunk chain warm, computes the tail and
samples the NEXT token within what is left of its budget; nothing is
re-emitted and its TTFT stays its first token's. Equal classes never
preempt each other, and spec mode never preempts.

The self-healing plane (driven by
:class:`~gofr_tpu_torch.serving.supervisor.EngineSupervisor`): the loop
stamps ``heartbeat`` every iteration and after each host sync, counts its
working time (``busy_seconds``), flags ``loop_crashed`` when an exception
escapes it, and marks a dispatch signature's first run (``in_cold_dispatch``:
on the card the kernel build and cuBLAS's first GEMM) so the watchdog
does not read it as a stall. ``warm_restart`` fails the in-flight rows
retriable, requeues the never-prefilled ones in FIFO order with their
deadlines, quarantine-leaks the scheduler and pool of a thread that does
not join (that thread retires itself through the identity guard when it
thaws: ``_check_retired``), rebuilds the runtime state through the one
constructor ``_init_runtime_state``, clears the prefix cache and bumps
``epoch``. A device loss (the ``device.loss`` chaos point) poisons the KV
storage on the host side: every KV tensor becomes a 0-element one, so its
memory goes back and every later use raises on the host BEFORE any launch
(the three kernel wrappers refuse a 0-element pool; the dense reads fail
their shape checks). A kernel handed a released pointer would instead read
address 0, and that illegal-address fault is sticky: it kills the CUDA
context of the whole process. ``_fail_all`` finds the KV unhealthy (0
elements, or a one-element probe that raises), counts a
``device_poisonings``, rebuilds the storage in place (the old released
before the new is allocated) and fails the rows in flight; a storm of
poisonings makes the supervisor restart. A real sticky CUDA error is out
of reach of any in-process restart: every rebuild fails and the supervisor
parks the engine WEDGED once its budget is spent. ``health_check`` reports
WEDGED, RESTARTING, DOWN, DRAINING, SUSPECT or UP with the slots, queue,
page pool, caches, adapters, tenants, device telemetry and supervisor.
The chaos points (``gofr_tpu_torch.chaos``) sit where the reference has
them: ``engine.step``, ``decode.dispatch`` and ``device.loss``,
``sched.submit``/``admit``/``plan``, ``kv.alloc``, ``kv.spill``,
``lora.upload`` and ``tenant.preempt``.

The observability plane: with ``metrics=`` (a
:class:`~gofr_tpu_torch.metrics.Manager` on which
:func:`~gofr_tpu_torch.serving.metrics_catalog.register_serving_metrics`
registered the series) the engine emits the reference's ``app_*`` series at
the reference's sites: queue depth and wait, the step plan, prefix hits by
tier, chunk sizes, preemptions, TTFT, TPOT, block time, occupancy, host
ms per decode step, end-to-end latency, sheds and deadline and KV-pool
retirements. With ``tracer=`` each request's spans hang off the caller's
span (``submit(trace_ctx=...)``): ``engine.queue``, then under it
``serve.prefill b{bucket}`` or one ``serve.prefill_chunk`` per computed
chunk, ``serve.decode`` and ``serve.detok``. Every request with an id gets
a :class:`~gofr_tpu_torch.serving.timeline.RequestTimeline` in
``self.timeline`` (the ``/requestz`` flight recorder, ``requestz_capacity``
completed ones kept) whose terminal mark is recorded exactly once, by the
path that settles the future first, which also ends every span still
open. ``health_check`` reports ``request_latency`` from it, and the spill
tier orders its demotions by the timeline's reuse counts. The rule of the
plane: it reads only host data that is already there (the host mirrors,
the packed block after its one sync, the clocks) and never
``int()``, ``.item()``, ``.tolist()`` or ``bool()`` of a CUDA tensor, so
it adds no host sync. The dispatch syncs go through the module's
``_block_sync`` (a test counts them); a prefill's first-token sync is
``_first_token``'s, and the prefill span closes after it, so both measure
the device's work and not its enqueueing. ``app_decode_host_ms_per_step``
is the host's time per step: the dispatch's assembly and launch
(``_Inflight.host_s``) plus the consume after the sync. Eager PyTorch
blocks a launch while the CUDA launch queue is full, so on a long block
that launch time can include device time.

The HA plane: ``submit(fence_epoch=)`` and ``cancel(fence_epoch=)``
check the caller's epoch against ``epoch`` (``check_fence``) before
anything else, so a router acting on a view from before a warm restart
gets a 409 and takes no request id. ``submit(idempotency_key=)`` is
exactly-once through the :class:`~gofr_tpu_torch.serving.dedup.DedupRegistry`:
the owner's frames go through a seq-numbered
:class:`~gofr_tpu_torch.serving.dedup.ReplayStream` (tokens ``1..N``, the
terminal ``N+1``, on the detok worker for every settlement path), a
duplicate attaches to the live future (and replays what its stream has
not seen) or replays the stored terminal, and the settlement gate keeps a
result and forgets a failure. ``resume(key, last_seq=)`` replays the
unseen suffix token-identically and rides the generation on (404 past the
replay window), and ``orphan(rid, grace_s=)`` lets a keyed stream whose
last client vanished run on for a grace before a reaper cancels it.

Cross-replica KV (``kv_migrator=``, a
:class:`~gofr_tpu_torch.serving.prefix_index.KVMigrator`, with a prefix
cache): a local miss asks the migrator for the whole-prompt entry or for
the rest of the chunk chain from the replica that advertises it
(``prefix_advertisement`` is this engine's side of the index), uploads it
``non_blocking`` and puts it into the local cache; the tier is
``remote``. Every failure (a stale advertisement, a dead peer, a
``kv.migrate`` fault) is a compute miss of what was not fetched. P/D
disaggregation: ``submit(prefill_only=True)`` computes the prompt's KV
into the prefix cache and retires with ``"handoff"`` at its first token,
emitting nothing; ``submit(handoff_from=replica)`` fetches the whole
chain from that replica first (``kv.handoff``: a complete chain or
nothing, then the advisory fetch, then compute). On int8 KV only the
whole-prompt entry migrates, as the reference keeps no chunk cache there.
``role`` is the replica's (``TPU_REPLICA_ROLE``).

The reclamation plane: ``preemptible`` (``TPU_REPLICA_PREEMPTIBLE``)
rides the heartbeat, and ``begin_reclaim(deadline_s)`` runs a notice's
ladder: RECLAIMING (a retriable 503 at ``submit``, an epoch bump), the
engine thread's sweep of batch-class rows (queued ones fail retriable;
running ones stop being fed, page their chunk spans out once nothing of
them is in flight, and fail retriable), a drain within
``1 - reclaim_evacuate_frac`` of the notice, a whole-or-nothing push of the
prefix cache to a survivor through the migrator (``kv.evacuate``), then
``stop``. On int8 KV only whole-prompt entries evacuate, as no chunk cache
is kept there.

The app plane serves it: ``serving/handlers.py`` binds ``/generate``,
``/generate/stream`` (SSE, ``Last-Event-ID`` re-attach),
``/generate/cancel``, ``/ws/generate`` (WebSocket), ``/v1/models``,
``/requestz`` and ``/kv/fetch`` on a ``gofr_tpu_torch.app.App``, whose
metrics port serves ``/metrics``;
``serving/remote.py`` and the router's ``HTTPReplica`` are the remote
streaming client; ``logger=`` takes the app's structured logger, whose
lines carry the active span's ``trace_id``/``span_id`` (log correlation).
``python -m gofr_tpu_torch.serve`` runs one. ``from_hf`` builds an engine
from an HF-layout checkpoint and its tokenizer asset, ``from_checkpoint``
from the newest committed step of a ``CheckpointManager`` directory (warm
restart). Their ``sharding=`` takes a placement that splits no weight
(a replicated one): the engine serves whole weights on one card, and a
placement that splits them (``tp`` or ``fsdp`` > 1) waits for the
tensor-parallel engine (ROADMAP Queue A item 13).

Runs on the card unless constructed with ``device="cpu"``.
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import logging
import threading
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from gofr_tpu_torch import chaos
from gofr_tpu_torch._device import resolve_device, to_device
from gofr_tpu_torch.errors import (
    ErrorDeadlineExceeded,
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
)
from gofr_tpu_torch.models import llama
from gofr_tpu_torch.ops.sampling import sample_logits
from gofr_tpu_torch.serving import batch as batch_ops
from gofr_tpu_torch.serving.dedup import DedupEntry, DedupRegistry, ReplayGap, ReplayStream
from gofr_tpu_torch.serving.kv_cache import OutOfBlocks, PagedKVCache
from gofr_tpu_torch.serving.kv_spill import TieredPrefixCache, _to_device
from gofr_tpu_torch.serving.lora import AdapterBusy, UnknownAdapter
from gofr_tpu_torch.serving.prefix_cache import PrefixCache
from gofr_tpu_torch.serving.scheduler import QueueFull, Scheduler
from gofr_tpu_torch.serving.shed import QueueWaitEstimator
from gofr_tpu_torch.serving.stepplan import ChunkCursor, StepPlan, StepPlanner
from gofr_tpu_torch.serving.tenancy import DEADLINE_CLASSES
from gofr_tpu_torch.serving.timeline import TimelineRecorder
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
    # decode tokens per device block (the N of the N-step block); None:
    # 1 under speculative decoding, else 4
    multi_step: int | None = None
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
    # KV reuse: the device prefix cache's entry and byte bounds (0 entries:
    # off), and the host spill tier's bytes under it (0: no spill tier)
    prefix_cache_entries: int = 0
    prefix_cache_bytes: int = 256 * 1024 * 1024
    kv_spill_bytes: int = 0
    # speculative decoding: drafts per verify step (0: off) and the n-gram
    # the prompt lookup matches
    spec_tokens: int = 0
    spec_ngram: int = 3
    # multi-tenant preemption: when a strictly higher class waits and the
    # batch is full (slots or KV pages), pause the lowest-class row and
    # resume it warm later. Off: a tenant storm delays higher classes
    tenant_preempt: bool = True
    # the /requestz flight recorder: completed timelines kept in its ring
    # (every in-flight one is always kept)
    requestz_capacity: int = 256
    # the replica's disaggregation role, carried by the membership
    # heartbeat: "unified" serves whole generations, "prefill" computes
    # prompt KV and hands it off, "decode" admits handed-off chains. The
    # engine runs both phases whatever its role (a decode replica
    # re-prefills when a handoff fails)
    role: str = "unified"
    # the reclamation plane: a preemptible replica runs on reclaimable
    # (spot) capacity, carried by the heartbeat (the router steers
    # interactive tenants off it); begin_reclaim keeps this fraction of a
    # notice's budget for the KV evacuation after the drain
    preemptible: bool = False
    reclaim_evacuate_frac: float = 0.35
    # the HA plane: emitted frames kept per keyed request for a resume
    # (tokens plus the terminal), successful terminals kept in the
    # idempotency registry (LRU; live entries are bounded by the requests
    # in flight), and how long a keyed stream whose client vanished runs
    # on awaiting a resume before it is canceled
    stream_replay_tokens: int = 512
    idem_capacity: int = 1024
    stream_orphan_grace_s: float = 10.0

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
            multi_step=int(multi_step) if multi_step else None,
            decode_sync_every=int(config.get_or_default("TPU_DECODE_SYNC_EVERY", "1")),
            shed_max_wait_s=float(config.get_or_default("TPU_SHED_MAX_WAIT_S", "0")),
            shed_cold_prior_s=float(config.get_or_default("TPU_SHED_COLD_PRIOR_S", "0")),
            drain_deadline_s=float(config.get_or_default("TPU_DRAIN_DEADLINE_S", "30")),
            prefix_cache_entries=int(config.get_or_default("TPU_PREFIX_CACHE_ENTRIES", "0")),
            prefix_cache_bytes=int(
                config.get_or_default("TPU_PREFIX_CACHE_BYTES", str(256 * 1024 * 1024))
            ),
            kv_spill_bytes=int(config.get_or_default("TPU_KV_SPILL_BYTES", "0")),
            spec_tokens=int(config.get_or_default("TPU_SPEC_TOKENS", "0")),
            spec_ngram=int(config.get_or_default("TPU_SPEC_NGRAM", "3")),
            tenant_preempt=config.get_or_default("TPU_TENANT_PREEMPT", "1")
            not in ("0", "false", "off"),
            requestz_capacity=int(config.get_or_default("TPU_REQUESTZ_CAPACITY", "256")),
            role=config.get_or_default("TPU_REPLICA_ROLE", "unified"),
            preemptible=config.get_or_default("TPU_REPLICA_PREEMPTIBLE", "0")
            not in ("0", "false", "off"),
            reclaim_evacuate_frac=float(config.get_or_default("TPU_RECLAIM_EVACUATE_FRAC", "0.35")),
            stream_replay_tokens=int(config.get_or_default("TPU_STREAM_REPLAY_TOKENS", "512")),
            idem_capacity=int(config.get_or_default("TPU_IDEM_CAPACITY", "1024")),
            stream_orphan_grace_s=float(config.get_or_default("TPU_STREAM_ORPHAN_GRACE_S", "10")),
        )


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    # "stop" | "length" | "kv_exhausted" | "cancel" | "deadline_exceeded" | "handoff"
    finish_reason: str
    ttft_s: float
    duration_s: float


class _Requeue(Exception):
    """Raised inside admission when KV pages are short for now (paged
    layout): the request goes back to the head of its priority class."""


class _ThreadRetired(BaseException):
    """Raised on a loop thread that finds it has been replaced (a warm
    restart that could not join it quarantined its state and started a
    successor). A BaseException so the per-step ``except Exception``
    recovery never catches it: a retired thread that settled futures,
    wrote rebuilt state or ran ``_fail_all`` would race its replacement
    over state it no longer owns."""


class _Request:
    __slots__ = (
        "id", "prompt_ids", "max_new_tokens", "temperature", "top_k", "top_p",
        "stream_cb", "future", "created", "first_token_at", "tokens",
        "stop_ids", "dispatched", "kv_exhausted", "priority", "canceled", "deadline",
        "tenant", "adapter_id", "adapter_slot", "preemptions", "timeline", "trace_ctx",
        "idem_key", "replay", "prefill_only", "handoff_from",
    )

    def __init__(self, rid: int, prompt_ids: list[int], max_new_tokens: int,
                 temperature: float, top_k: int, top_p: float,
                 stream_cb: Callable | None, stop_ids: set[int], *,
                 priority: int = 0, deadline: float | None = None,
                 created: float | None = None) -> None:
        self.id = rid
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.stream_cb = stream_cb
        self.future: concurrent.futures.Future = concurrent.futures.Future()
        self.future.request_id = rid
        # request times are time.monotonic(), the clock of the request's
        # timeline: a moment both record is one reading (the submit, the
        # admission, the first token), so the two TTFTs are one number
        self.created = time.monotonic() if created is None else created
        self.first_token_at: float | None = None
        self.tokens: list[int] = []
        self.stop_ids = stop_ids
        self.dispatched = 0  # decode steps dispatched (>= committed)
        self.kv_exhausted = False  # cut short by pool pressure, not its budget
        self.priority = priority
        self.canceled = False  # set by cancel() or a failing stream_cb
        # the multi-tenant plane: the tenant's name (its class drives the
        # preemption ladder), the named LoRA adapter and its pinned device
        # table slot (0 = base), and how often the row was preempted
        self.tenant: str | None = None
        self.adapter_id: str | None = None
        self.adapter_slot = 0
        self.preemptions = 0
        # the observability plane: the flight-recorder timeline and the
        # caller's span that the request's spans hang off
        self.timeline: Any = None
        self.trace_ctx: Any = None
        # the HA plane: the idempotency key and the replay ring of a keyed
        # request; the disaggregation plane: a prefill-only request retires
        # with "handoff" at its first token, a handoff_from one fetches its
        # prompt's KV from the named prefill replica first
        self.idem_key: str | None = None
        self.replay: ReplayStream | None = None
        self.prefill_only = False
        self.handoff_from: str | None = None
        # absolute monotonic time the caller stops caring; None = never
        self.deadline = (self.created + deadline) if deadline else None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    def remaining(self, now: float) -> float | None:
        """Seconds left of the deadline (None without one), never below 0."""
        if self.deadline is None:
            return None
        return max(self.deadline - now, 0.0)

    @property
    def serve_ids(self) -> list[int]:
        """The tokens an admission makes KV-resident: the prompt plus every
        token already emitted. A fresh request has none, so this is its
        prompt; a preempted one resumes by prefilling its whole generated
        context and sampling the NEXT token."""
        return self.prompt_ids + self.tokens

    @property
    def new_budget(self) -> int:
        """Tokens the request may still emit: the admission-time budget of
        a fresh and of a resumed request."""
        return self.max_new_tokens - len(self.tokens)


class _Inflight:
    """A dispatched, not yet read block: its packed device result, the
    (slot, request) decode rows and the (slot, request, cursor, start, n,
    finishes, row) chunk rows it was built from, ``row`` the chunk row's
    place in ``last_logits`` (the ragged dispatch's [K, V] last-position
    logits in chunk-row order, kept only while chunk-prefix caching is on).
    By the time it is read a slot may have been retired or re-admitted;
    ``slots[slot] is req`` tells. ``dispatched_at`` is the perf_counter
    time of the launch, ``host_s`` the host's seconds from the start of
    the dispatch's assembly to the launch call's return (on the card that
    includes any wait for room in a full CUDA launch queue)."""

    __slots__ = ("packed", "rows", "steps", "prefill_rows", "last_logits",
                 "dispatched_at", "host_s")

    def __init__(self, packed: torch.Tensor, rows: list, steps: int,
                 prefill_rows: list | None = None,
                 last_logits: torch.Tensor | None = None,
                 dispatched_at: float = 0.0, host_s: float = 0.0) -> None:
        self.packed = packed
        self.rows = rows
        self.steps = steps
        self.prefill_rows = prefill_rows or []
        self.last_logits = last_logits
        self.dispatched_at = dispatched_at
        self.host_s = host_s


def _block_sync(packed: torch.Tensor) -> np.ndarray:
    """The dispatch's one host sync: read a block's packed result to the
    host. The pipelined decode and ragged blocks and the speculative
    verify step read through here and nowhere else, so a test can count
    the syncs (a prefill's first token is ``_first_token``'s own)."""
    # gofrlint: disable=host-sync -- the dispatch's one sanctioned read of a block
    return packed.cpu().numpy()


def _stop_id(req: _Request) -> int:
    """The row's stop id on the device (-1: none, or more than one)."""
    return next(iter(req.stop_ids)) if len(req.stop_ids) == 1 else -1


def _request_seed(seed: int, request_id: int) -> int:
    """The first-token generator's seed: a function of (seed, request id)
    alone, so a request's first draw does not depend on what ran before."""
    return (seed * 1_000_003 + request_id) & 0x7FFF_FFFF_FFFF_FFFF



def _whole_weights(sharding: Any) -> None:
    """The engine serves whole weights on one card: a ``sharding=`` that
    is not a placement raises TypeError, one that splits a weight (``tp``
    or ``fsdp`` > 1) NotImplementedError; None or a replicated placement
    passes."""
    if sharding is None:
        return
    from gofr_tpu_torch.parallel.sharding import shards_any

    if shards_any(sharding):
        raise NotImplementedError(
            "a sharding= that splits the weights (tp or fsdp > 1) needs the tensor-parallel "
            "engine (ROADMAP Queue A item 13); the engine serves whole weights on one card"
        )

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
        prefix_cache: Any = None,
        lora: Any = None,
        tenants: Any = None,
        metrics: Any = None,
        tracer: Any = None,
        kv_migrator: Any = None,
        logger: Any = None,
    ) -> None:
        self.device = resolve_device(device)
        # the app's structured logger (gofr_tpu_torch.logging.Logger: info,
        # warn, error), or None for the module's stdlib logger
        self._logger = logger
        self.model_cfg = cfg
        self.params = params
        self.config = engine_config or EngineConfig()
        conf = self.config
        if conf.role not in ("prefill", "decode", "unified"):
            raise ValueError(f"TPU_REPLICA_ROLE={conf.role!r}: must be prefill, decode or unified")
        # read by a membership announcer (the heartbeat's role)
        self.role = conf.role
        # the reclamation plane: the capacity class rides the heartbeat;
        # begin_reclaim() is the notice path, its deadline absolute
        # monotonic, and _reclaim_swept set once no batch-class row is left
        # for the engine thread's sweep
        self.preemptible = conf.preemptible
        self._reclaiming = False
        self._reclaim_deadline: float | None = None
        self._reclaim_swept = False
        if conf.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={conf.kv_layout!r}: must be dense or paged")
        if conf.multi_step is not None and conf.multi_step < 1:
            raise ValueError("multi_step must be >= 1")
        if conf.kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_dtype={conf.kv_dtype!r}: must be bf16 or int8")
        if conf.spec_tokens < 0:
            raise ValueError("TPU_SPEC_TOKENS must be >= 0")
        if conf.multi_step is not None and conf.multi_step > 1 and conf.spec_tokens > 0:
            raise ValueError(
                "TPU_SPEC_TOKENS and TPU_BATCH_MULTI_STEP>1 are both chunking policies; "
                "enable one"
            )
        # the multi-tenant plane, both optional: the LoRA adapter registry
        # (serving/lora.py) and the tenant policy registry
        # (serving/tenancy.py); an engine without them runs the code it
        # ran before either existed
        self._lora = lora
        self._tenants = tenants
        if lora is not None and conf.spec_tokens > 0:
            raise ValueError(
                "TPU_SPEC_TOKENS and a LoRA adapter registry are mutually exclusive: "
                "the speculative verify path has no adapter gather"
            )
        self.tokenizer = tokenizer or ByteTokenizer(cfg.vocab_size)
        self.seed = seed
        # the observability plane, both optional: a metrics Manager with the
        # serving catalog registered (serving/metrics_catalog.py) and a
        # Tracer. The flight recorder is always on and outlives warm
        # restarts: a restart must not erase the record of what it swept
        self._metrics = metrics
        self._tracer = tracer
        self.timeline = TimelineRecorder(conf.requestz_capacity)
        # the N-step block: an explicit multi_step wins; speculative mode
        # verifies one chunk per step instead; else 4 steps per host sync
        if conf.multi_step is not None:
            self._block_steps = int(conf.multi_step)
        elif conf.spec_tokens > 0:
            self._block_steps = 1
        else:
            self._block_steps = 4
        self._sync_every = max(1, int(conf.decode_sync_every))
        # speculative mode keeps every prefill whole: spec chunking and
        # prefill chunking are both per-dispatch policies, and the spec
        # path is unpipelined
        self._chunk_enabled = conf.spec_tokens == 0
        # chunk-prefix entries hold full-width slabs; an int8 layout would
        # re-quantize them at every hit and drift, so int8 engines keep
        # only the whole-prompt cache
        self._chunk_cache_enabled = conf.kv_dtype != "int8"
        if prefix_cache is not None:
            self._prefix_cache = prefix_cache
        elif conf.prefix_cache_entries > 0 and conf.kv_spill_bytes > 0:
            # host-tier demotion by the timeline's observed reuse, not raw LRU
            self._prefix_cache = TieredPrefixCache(
                conf.prefix_cache_entries, max_bytes=conf.prefix_cache_bytes,
                spill_bytes=conf.kv_spill_bytes, device=self.device, metrics=metrics,
                reuse_score=lambda key: self.timeline.reuse_count(key),
            )
        elif conf.prefix_cache_entries > 0:
            self._prefix_cache = PrefixCache(
                conf.prefix_cache_entries, max_bytes=conf.prefix_cache_bytes,
            )
        else:
            self._prefix_cache = None
        # cross-replica KV reuse (serving/prefix_index.py): on a local miss
        # the migrator fetches the prefix from the replica that advertises
        # it, or the handoff from the named prefill replica. Advisory:
        # every failure is a compute miss. Needs a prefix cache
        self._kv_migrator = kv_migrator
        # speculative-decode counters: emitted / dispatches > 1 means
        # drafts are being accepted
        self.spec_stats = {"dispatches": 0, "accepted": 0, "emitted": 0}

        chunk = max(1, int(conf.prefill_chunk_tokens))
        if conf.kv_layout == "paged":
            # chunk boundaries stay on the page grid: the chunk size aligns
            # down to whole pages (at least one)
            page = conf.kv_page_size
            chunk = max(page, (chunk // page) * page)
        self._chunk_tokens = min(chunk, conf.max_seq_len)
        self._planner = StepPlanner(
            chunk_tokens=self._chunk_tokens, block_steps=self._block_steps,
            step_token_budget=self.config.step_token_budget,
            max_admissions=self.config.admission_per_step,
        )
        self.cache: llama.KVCache | None = None
        self.paged_cache: PagedKVCache | None = None
        self._init_runtime_state()

        self._by_id: dict[int, _Request] = {}  # queued + active, by request id
        self._count_lock = threading.Lock()  # guards _by_id, _next_id
        # makes submit's stop and restart checks + registration atomic with
        # stop()'s flag and warm_restart's sweep. Lock order:
        # _lifecycle_mu -> _submit_mu -> _count_lock
        self._submit_mu = threading.Lock()
        # serializes warm_restart against stop()/drain(): one of them owns
        # the teardown. Reentrant: stop() may run on a thread that already
        # holds it
        self._lifecycle_mu = threading.RLock()
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

        # the self-healing plane (serving/supervisor.py). The loop stamps a
        # monotonic heartbeat every iteration and after each host sync; the
        # watchdog reads heartbeat_age() to see a dispatch that never
        # returns
        self.heartbeat = time.monotonic()
        self._iter_t0 = self.heartbeat  # start of the running iteration's work
        self._busy_s = 0.0  # loop seconds spent working, not waiting
        self.loop_crashed = False  # the loop thread died with _running set
        self.device_poisonings = 0  # _fail_all runs that found the KV poisoned
        self._restarting = False  # warm_restart in progress: submit 503s
        self._wedged = False  # stop() could not join, or the budget is spent
        # bumped by warm_restart: a caller acting on a pre-restart view of
        # this engine is fenced off by it (the HA plane checks it)
        self.epoch = 1
        # the idempotency registry: a duplicate attaches to the live
        # request's future or replays its stored terminal; _try_resolve
        # stays the one terminal gate
        self._dedup = DedupRegistry(self.config.idem_capacity)
        # a dispatch whose signature never completed is slow but moving (on
        # the card: the kernel build, cuBLAS's first GEMM), and the
        # heartbeat cannot show it; _cold_dispatch marks it so the watchdog
        # widens its stall limit. Process knowledge: survives warm_restart
        self._warmed: set[tuple] = set()
        self._cold_key: tuple | None = None
        self._supervisor: Any = None  # EngineSupervisor backref (health)
        self.device_telemetry: Any = None  # DeviceTelemetry backref (health)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: llama.LlamaConfig,
        checkpoint_dir: str,
        *,
        step: int | None = None,
        sharding: Any = None,
        seed: int | None = None,
        device: str | torch.device | None = None,
        **kw: Any,
    ) -> "ServingEngine":
        """Warm restart: an engine whose weights are the newest committed
        checkpoint step (or ``step``) of ``checkpoint_dir``
        (``checkpoint.CheckpointManager``), restored onto ``device`` (the
        card by default). Random weights only when ``seed`` is given (a
        ``torch.Generator`` seed, the port's ``seed_key``) and no step is
        committed. A corrupt existing checkpoint raises: serving random
        weights would be worse than failing the start. ``sharding=`` takes
        a placement that splits no weight (:func:`_whole_weights`)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        from gofr_tpu_torch.checkpoint import CheckpointError, CheckpointManager

        _whole_weights(sharding)
        dev = resolve_device(device)
        mgr = CheckpointManager(checkpoint_dir)
        if mgr.latest_step() is None:  # raises on a corrupt manifest
            if seed is None:
                raise CheckpointError(
                    f"no committed checkpoints in {checkpoint_dir} "
                    "(pass seed for the random-init fallback)"
                )
            params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                                       device=dev)
        else:
            with FakeTensorMode():  # shapes and dtypes only: the port's eval_shape
                abstract = llama.init_params(cfg, device="cpu")
            params = mgr.restore(abstract, step=step, sharding=sharding, device=dev)
        return cls(cfg, params, device=dev, **kw)

    @classmethod
    def from_hf(
        cls,
        path: str,
        *,
        dtype: torch.dtype | None = None,
        sharding: Any = None,
        fs: Any = None,
        tokenizer: Any = None,
        device: str | torch.device | None = None,
        **kw: Any,
    ) -> "ServingEngine":
        """Serve an externally produced checkpoint: HF-layout safetensors
        weights (``models.hf_import.load_llama_from_hf``, on ``device``, the
        card by default) and the tokenizer asset beside them
        (``tokenizer.json`` or ``tokenizer.model``, through
        ``load_tokenizer``). With no asset there the engine keeps its
        ``ByteTokenizer``, as the reference does. ``sharding=`` takes a
        placement that splits no weight (:func:`_whole_weights`)."""
        from gofr_tpu_torch.models.hf_import import load_llama_from_hf
        from gofr_tpu_torch.tokenizer import load_tokenizer

        _whole_weights(sharding)
        cfg, params = load_llama_from_hf(path, dtype=dtype, sharding=sharding, fs=fs,
                                         device=device)
        if tokenizer is None:
            try:
                tokenizer = load_tokenizer(path, fs=fs)
            except FileNotFoundError:
                tokenizer = None  # the ByteTokenizer default
        return cls(cfg, params, tokenizer=tokenizer, device=device, **kw)

    def _make_dense_cache(self) -> llama.KVCache:
        """The one dense slot-cache constructor, shared by __init__, the
        in-place rebuild after a device loss and warm_restart."""
        conf = self.config
        return llama.KVCache.create(
            self.model_cfg, conf.max_slots, max_len=conf.max_seq_len, kv_dtype=conf.kv_dtype,
            device=self.device,
        )

    def _make_paged_cache(self) -> PagedKVCache:
        """The one page-pool constructor, shared by __init__ and
        warm_restart."""
        conf = self.config
        B, S, page = conf.max_slots, conf.max_seq_len, conf.kv_page_size
        return PagedKVCache(
            self.model_cfg, num_pages=conf.kv_num_pages or (B * S + page - 1) // page,
            page_size=page, max_slots=B, max_seq_len=S, device=self.device,
            kv_dtype=conf.kv_dtype,
        )

    def _init_runtime_state(self) -> None:
        """The engine's mutable runtime state, built here and only here so
        __init__ and warm_restart cannot drift: the KV storage, the host
        mirrors, the pipelined-dispatch queue, the device decode state and
        its generator, the chunk cursors, the preemption set and the
        scheduler. The old KV storage is released BEFORE the new one is
        allocated: a cache sized to fill the card is rebuilt without
        holding two (a quarantined thread that still holds the old one
        keeps it until it lets go)."""
        B = self.config.max_slots
        self.cache = self.paged_cache = None
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._dec_state: batch_ops.DecodeState | None = None  # None: rebuild
        if self.config.kv_layout == "paged":
            self.paged_cache = self._make_paged_cache()
        else:
            self.cache = self._make_dense_cache()
        self._cursors: dict[int, ChunkCursor] = {}  # slot -> mid-prefill cursor
        self._cursor_seq = 0  # admission order of cursors
        # host mirrors, authoritative for rebuilding the device state
        self.cache_len = np.zeros(B, np.int32)  # committed tokens per slot
        self.last_token = np.zeros(B, np.int64)
        self.temperature = np.ones(B, np.float32)
        self.top_k = np.zeros(B, np.int64)
        self.top_p = np.ones(B, np.float32)
        # each slot's LoRA table slot (0 = base): the host mirror of
        # DecodeState.adapter
        self.adapter_idx = np.zeros(B, np.int32)
        self.slots: list[_Request | None] = [None] * B
        # decode rows marked for preemption: no further block feeds them,
        # and the ladder pauses each once nothing of it is in flight
        self._preempt_pending: set[int] = set()
        # slots prefilled since the last dispatch: slot -> (first token,
        # resident length, remaining budget, stop id, adapter slot), folded
        # into the device state at the next dispatch
        self._pending_admit: dict[int, tuple[int, int, int, int, int]] = {}
        self._mask_host: np.ndarray | None = None
        self._mask_dev: torch.Tensor | None = None
        # the previous consume's time (a block's wall time runs from it);
        # None after an idle gap or a failure
        self._last_consume_t: float | None = None
        self._plan_gauges: tuple | None = None  # the step-plan gauges last set
        # the decode blocks' draws; reseeded, so a restarted engine samples
        # as a fresh one does (first tokens come from generators seeded by
        # (seed, request id) and never depended on it)
        self._rng = torch.Generator(device=self.device).manual_seed(self.seed)
        # admission: the scheduler owns the queue and which slots are
        # taken; every path that frees a slot releases it exactly once
        self._sched = Scheduler(B, self.config.max_queue, self.config.prefill_token_budget)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        if self._running:
            return
        if self._stop_requested:
            raise RuntimeError("a stopped engine does not restart")
        self.loop_crashed = False
        self._start_loop_thread()
        self._log("info", f"serving engine started: slots={self.config.max_slots} "
                          f"max_seq={self.config.max_seq_len}")

    def _log(self, level: str, message: str, **kw: Any) -> None:
        """One log line at the reference's site, level and text: on the
        app's logger when the engine has one (``kw`` as structured fields,
        e.g. ``stack``), else on the module's stdlib logger."""
        if self._logger is not None:
            getattr(self._logger, level)(message, **kw)
            return
        stdlib = {"info": log.info, "warn": log.warning, "error": log.error}[level]
        stdlib(message + (f"\n{kw['stack']}" if "stack" in kw else ""))

    def _start_loop_thread(self) -> None:
        """Spawn the loop thread, for start() and warm_restart: the
        heartbeat is stamped before the thread exists (a watchdog must not
        read a stale age), and ``_thread`` is assigned before ``_running``
        flips, so a thawing predecessor that re-checks ``me is
        self._thread`` retires instead of running an iteration it no
        longer owns."""
        self.heartbeat = time.monotonic()
        self._idle.clear()
        thread = threading.Thread(target=self._loop, name="serving-engine", daemon=True)
        self._thread = thread
        self._running = True
        thread.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        """Stop the loop thread and the detok worker, and fail every request
        not yet finished with a retriable 503. A thread that does not join
        leaves the engine WEDGED: its futures still settle, but the
        scheduler and the KV storage it may be inside are not released."""
        with self._submit_mu:
            self._stop_requested = True  # before the sweep: see submit
        with self._lifecycle_mu:  # a warm_restart in progress finishes first
            self._stop_inner(join_timeout)

    def _stop_inner(self, join_timeout: float) -> None:
        self._running = False
        self._wake.set()
        wedged = False
        if self._thread is not None:
            self._thread.join(timeout=join_timeout)
            wedged = self._thread.is_alive()
            if wedged:
                self._log("error", f"serving engine thread failed to exit within "
                                   f"{join_timeout:g}s; native resources left allocated, "
                                   "health will report WEDGED")
            else:
                self._thread = None
            # a later stop() that joins clean recovers; with no thread left
            # to join, a supervisor's park stays WEDGED
            self._wedged = wedged
        self._shutdown_host_executors()
        with self._count_lock:
            leftovers = list(self._by_id.values())
            self._by_id.clear()
        for req in leftovers:
            # the adapter registry outlives this engine: release the pins
            self._lora_release(req)
            self._settle_future(req, ErrorServiceUnavailable(
                "engine wedged; retry on another replica" if wedged
                else "engine stopped before the request was served; retry",
                retry_after=1.0,
            ))
        if not wedged:
            self._sched.close()
            if self.paged_cache is not None:
                self.paged_cache.close()

    def _shutdown_host_executors(self) -> None:
        """Stop the host-side workers taking new work; under a wedged loop
        thread these are still the engine's own. Queued settlements still
        run (wait=False drains the queue without blocking on a client's
        stream_cb); later ones run inline. Queued spills run too. The
        spill tier is matched by type: an injected cache's close() may
        mean something the engine must not invoke."""
        self._detok.shutdown(wait=False)
        if isinstance(self._prefix_cache, TieredPrefixCache):
            self._prefix_cache.close()

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
        self._log("info", f"serving engine draining (deadline {deadline_s:g}s)")
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
                self._log("warn", f"drain deadline passed with {len(remainder)} request(s) "
                                  "in flight; failed them with a retriable error")
            self._wake.set()
            # a short window for the loop to reclaim the canceled slots
            # gofrlint: disable=deadline-dropped -- post-deadline cleanup grace: the drain budget already elapsed, this constant bounds slot reclaim, not a request
            self._idle.wait(timeout=5.0)
        self.stop(join_timeout=join_timeout)
        return drained

    # ------------------------------------------------------ reclamation plane
    def reclaim_remaining_s(self) -> float | None:
        """Seconds left of a reclamation notice in progress (None when not
        reclaiming): the membership announcer puts it on the heartbeat."""
        deadline = self._reclaim_deadline
        if not self._reclaiming or deadline is None:
            return None
        return max(deadline - time.monotonic(), 0.0)

    def begin_reclaim(self, deadline_s: float | None = None, *,
                      join_timeout: float = 10.0) -> dict[str, Any]:
        """The reclamation-notice ladder: the provider takes this machine
        back in ``deadline_s`` seconds (``drain_deadline_s`` by default),
        so the budget is spent in value order:

        1. stop admitting (health reads RECLAIMING, ``submit`` answers a
           retriable 503) and bump ``epoch``;
        2. sweep batch-class work on the engine thread
           (:meth:`_reclaim_sweep`): queued rows fail retriable, running
           rows page their committed chunk spans out and fail retriable;
        3. drain what is left within ``1 - reclaim_evacuate_frac`` of the
           notice, then fail the remainder retriable (``drain``'s
           contract);
        4. push the prefix cache's committed entries to one survivor
           through the ``KVMigrator`` (:meth:`_evacuate_kv`; whole or
           nothing);
        5. stop.

        Every in-flight timeline is stamped ``reclaim``. Runs on any
        thread (the pool driver's notice thread) and returns a summary:
        ``accepted``, ``deadline_s``, ``inflight``, ``drained`` and the
        ``evacuation``'s outcome; ``accepted`` is False, touching
        nothing, when a notice, a stop or a park already owns the
        lifecycle."""
        if deadline_s is None:
            deadline_s = self.config.drain_deadline_s
        notice_t0 = time.monotonic()
        with self._lifecycle_mu:
            if self._reclaiming or self._stop_requested or self._wedged:
                return {"accepted": False, "reason": "lifecycle-owned"}
            with self._submit_mu:
                self._reclaim_deadline = notice_t0 + max(float(deadline_s), 0.0)
                self._reclaiming = True
                self._reclaim_swept = False
                # the drain gate with the notice, under the submit mutex: no
                # submit is admitted after the notice (the reference sets it
                # just before its drain wait)
                self._draining = True
                # a router acting on the pre-notice epoch is fenced off
                self.epoch += 1
        if self._metrics:
            self._metrics.increment_counter("app_replica_reclamations_total")
        self._log("warn", f"reclamation notice: {deadline_s:g}s to drain + evacuate")
        with self._count_lock:
            inflight = list(self._by_id.values())
        for req in inflight:
            if req.timeline is not None:
                req.timeline.stamp("reclaim")
        summary: dict[str, Any] = {"accepted": True, "deadline_s": float(deadline_s),
                                   "inflight": len(inflight)}
        if not self._running:
            # never started or already stopped: nothing drains, but the
            # cache may hold chains worth saving
            summary["drained"] = True
            summary["evacuation"] = self._evacuate_kv(self._reclaim_deadline - time.monotonic())
            self.stop(join_timeout=join_timeout)
            self._reclaiming = False
            self._reclaim_deadline = None
            return summary
        # the evacuation's reserve comes off the top of the notice
        evac_frac = min(max(self.config.reclaim_evacuate_frac, 0.0), 0.9)
        drain_budget = max(float(deadline_s) * (1.0 - evac_frac), 0.0)
        self._idle.clear()
        self._wake.set()
        drained = self._idle.wait(timeout=drain_budget)
        if drained:
            remaining = drain_budget - (time.monotonic() - notice_t0)
            drained = self._detok_idle.wait(timeout=max(remaining, 0.0))
        if not drained:
            with self._count_lock:
                remainder = list(self._by_id.values())
            for req in remainder:
                self._settle_future(req, ErrorServiceUnavailable(
                    "replica reclaiming; retry on another replica", retry_after=0.5,
                ))
                req.canceled = True  # the loop frees its slot and pages
                try:
                    self._sched.cancel(req.id)
                except KeyError:
                    pass
            if remainder:
                self._log("warn", f"reclaim drain budget passed with {len(remainder)} "
                                  "request(s) in flight; failed them retriable")
            self._wake.set()
            # a short window for the loop to free the canceled slots, inside
            # the notice
            # gofrlint: disable=deadline-dropped -- the bound is min(2 s, what is left of the notice's absolute deadline self._reclaim_deadline), which the rule cannot see through the attribute
            self._idle.wait(timeout=min(2.0, max(self._reclaim_deadline - time.monotonic(), 0.0)))
        summary["drained"] = drained
        summary["evacuation"] = self._evacuate_kv(self._reclaim_deadline - time.monotonic())
        self.stop(join_timeout=join_timeout)
        if self._metrics:
            self._metrics.record_histogram("app_reclaim_drain_seconds",
                                           time.monotonic() - notice_t0)
        self._reclaiming = False
        self._reclaim_deadline = None
        return summary

    def _reclaim_sweep(self) -> bool:
        """The engine thread's arm of a notice: batch-class work goes now,
        so the drain budget serves the interactive and standard streams.
        Queued batch rows fail retriable without a prefill. A running
        batch row with a block or chunk still in flight is marked in
        ``_preempt_pending``, so no later dispatch feeds it, and is paged
        out once nothing of it is in flight (``_preempt(reclaim=True)``:
        its committed chunk spans join the evacuation and it fails
        retriable). Reads host state only. ``_reclaim_swept`` is set once
        no batch row is left, and the loop stops calling it."""
        threshold = DEADLINE_CLASSES["batch"][0]
        active = {id(r) for r in self.slots if r is not None}
        with self._count_lock:
            queued = [r for r in self._by_id.values()
                      if id(r) not in active and not r.canceled and r.priority >= threshold]
            for req in queued:
                self._by_id.pop(req.id, None)
        for req in queued:
            req.canceled = True
            try:
                self._sched.cancel(req.id)  # admit drops it: it left _by_id
            except KeyError:
                pass
            self._settle_async(req, exc=ErrorServiceUnavailable(
                "replica reclaiming; retry on another replica", retry_after=0.5))
        did = bool(queued)
        left = False
        for slot, req in enumerate(self.slots):
            if req is None or req.priority < threshold or req.canceled:
                continue
            if self._row_in_flight(slot, req):
                self._preempt_pending.add(slot)  # paged out once its blocks are read
                left = True
                continue
            self._preempt_pending.discard(slot)
            self._preempt(slot, reclaim=True)
            did = True
        self._reclaim_swept = not left
        return did

    def _evacuate_kv(self, deadline: float | None) -> dict[str, Any]:
        """Push the prefix cache's committed entries (whole-prompt entries,
        chunk spans, paged-out rows; the device and host tiers) to one
        survivor through :meth:`KVMigrator.evacuate_chain`, which commits
        the batch whole or not at all. The outcome is ``skipped`` (no
        cache or no migrator), ``harvest_error``, ``empty``, ``committed``
        or ``degraded`` (no survivor took it: survivors re-prefill), each
        counted in ``app_kv_evacuations_total{outcome}``. Never raises."""
        cache, migrator = self._prefix_cache, self._kv_migrator
        out: dict[str, Any] = {"entries": 0, "committed": 0, "target": None,
                               "outcome": "skipped"}
        if cache is None or migrator is None or not hasattr(migrator, "evacuate_chain"):
            return self._count_evacuation(out)
        entries: list[tuple[Any, Any]] = []
        try:
            # a harvest reads through peek where the cache has it (the
            # tiered one: no promotion, no pop of the only host copy)
            keys = list(cache.keys()) if hasattr(cache, "keys") else []
            read = getattr(cache, "peek", None) or cache.get
            for key in keys:
                value = read(key)
                if value is not None:
                    entries.append((key, value))
        except Exception:
            out["outcome"] = "harvest_error"
            return self._count_evacuation(out)
        out["entries"] = len(entries)
        if not entries:
            out["outcome"] = "empty"
            return self._count_evacuation(out)
        try:
            committed = migrator.evacuate_chain(entries, deadline=deadline)
        except Exception:
            committed = None
        if committed:
            target, n = committed
            out.update(committed=int(n), target=target, outcome="committed")
        else:
            out["outcome"] = "degraded"
        self._log("info", f"kv evacuation: {out['outcome']} "
                          f"({out['committed']}/{out['entries']} entries"
                          + (f" -> {out['target']}" if out["target"] else "") + ")")
        return self._count_evacuation(out)

    def _count_evacuation(self, out: dict[str, Any]) -> dict[str, Any]:
        if self._metrics:
            self._metrics.increment_counter("app_kv_evacuations_total", outcome=out["outcome"])
        return out

    # ----------------------------------------------------------- self-healing
    def warm_restart(self, join_timeout: float = 5.0) -> bool:
        """Self-healing restart, driven by the supervisor when the loop
        thread hung, crashed or keeps poisoning its device state:

        - in-flight generations fail retriable (a 503 with a retry-after):
          their KV dies with the rebuilt storage;
        - requests that never emitted a token (still queued, or a chunk
          cursor mid-prefill) requeue in FIFO order with their absolute
          deadlines and their priority, and complete on the rebuilt engine;
        - every adapter pin is released (a requeued request re-acquires);
        - the scheduler and page pool are closed only when the old thread
          joined; under a thread still hung they are quarantine-leaked (a
          leak is recoverable, a use-after-free is not), and the thread
          retires itself when it thaws;
        - the KV storage, host mirrors, decode state and scheduler are
          rebuilt by ``_init_runtime_state``, the prefix cache is cleared,
          ``epoch`` is bumped and a fresh loop thread starts.

        Returns False, touching nothing, when drain() or stop() already
        owns the lifecycle. A rebuild that fails settles the requeued
        requests retriable and raises."""
        with self._lifecycle_mu:
            if self._draining or self._stop_requested or self._wedged:
                return False  # drain/stop won the race: stand down
            # under the submit mutex: a submit that registered is swept
            # below, a later one sees the flag and fails retriable without
            # touching the doomed scheduler. Bounded: a submit stuck inside
            # a hung scheduler call must not keep the healing plane out
            locked = self._submit_mu.acquire(timeout=max(join_timeout, 1.0))
            try:
                self._restarting = True
                self.epoch += 1
            finally:
                if locked:
                    self._submit_mu.release()
            requeue: list[_Request] = []
            try:
                old_thread = self._thread
                self._running = False
                self._wake.set()
                joined = True
                if old_thread is not None:
                    old_thread.join(timeout=join_timeout)
                    joined = not old_thread.is_alive()
                with self._count_lock:
                    pending = list(self._by_id.values())
                    self._by_id.clear()
                for req in pending:
                    self._lora_release(req)
                    if not req.tokens and not req.canceled:
                        requeue.append(req)  # re-prefills from chunk 0
                    else:
                        self._settle_future(req, ErrorServiceUnavailable(
                            "engine restarting; retry", retry_after=1.0,
                        ))
                if joined:
                    self._thread = None
                    self._sched.close()
                    if self.paged_cache is not None:
                        self.paged_cache.close()
                else:
                    # the hung thread may still be inside these: abandon
                    # them, never release them under it
                    self._sched.leak()
                    if self.paged_cache is not None:
                        self.paged_cache.leak()
                    self._log("error", f"engine thread failed to join within {join_timeout:g}s "
                                       "during warm restart; old scheduler/KV pool "
                                       "quarantine-leaked")
                # the old thread's cold-dispatch claim dies with it
                self._cold_key = None
                try:
                    self._init_runtime_state()
                    self._reset_prefix_cache()
                except Exception:
                    # the requeued requests live only in this list now
                    for req in requeue:
                        self._settle_future(req, ErrorServiceUnavailable(
                            "engine restart failed; retry", retry_after=1.0,
                        ))
                    raise
                for req in requeue:  # _by_id kept submission order
                    with self._count_lock:
                        self._by_id[req.id] = req
                    try:
                        self._sched.submit(req.id, len(req.prompt_ids), req.max_new_tokens,
                                           req.priority)
                    except Exception:
                        with self._count_lock:
                            self._by_id.pop(req.id, None)
                        self._settle_future(req, ErrorServiceUnavailable(
                            "engine restarting; retry", retry_after=1.0,
                        ))
                self.loop_crashed = False
            finally:
                # under the mutex: a submit sequenced after this flip sees
                # the rebuilt scheduler, never the old one
                locked = self._submit_mu.acquire(timeout=max(join_timeout, 1.0))
                try:
                    self._restarting = False
                finally:
                    if locked:
                        self._submit_mu.release()
            self._start_loop_thread()
            self._log("warn", f"engine warm restart complete: {len(requeue)} queued "
                              f"request(s) requeued, {len(pending) - len(requeue)} "
                              "in-flight failed retriable")
            return True

    @property
    def draining(self) -> bool:
        return self._draining

    def heartbeat_age(self) -> float:
        """Seconds since the loop thread last stamped its heartbeat (the
        watchdog's stall signal; meaningful while the engine runs)."""
        return time.monotonic() - self.heartbeat

    def busy_seconds(self) -> float:
        """Cumulative seconds the loop thread spent working, not waiting:
        the device-telemetry poller's duty cycle is its delta over wall
        time."""
        return self._busy_s

    def _flush_busy(self) -> None:
        """Fold the running iteration's work time into the busy counter and
        rebase. At each iteration's end and in _finish, before a settlement
        is queued: a caller that saw its request complete sees
        busy_seconds() > 0. Engine thread only."""
        now = time.monotonic()
        self._busy_s += now - self._iter_t0
        self._iter_t0 = now

    @property
    def in_cold_dispatch(self) -> bool:
        """True while the loop is inside a dispatch whose signature never
        completed before (on the card: a kernel build, cuBLAS's first
        GEMM); the watchdog widens its stall limit to compile_grace_s."""
        return self._cold_key is not None

    @contextlib.contextmanager
    def _cold_dispatch(self, *key: Any) -> Any:
        """Mark a dispatch section keyed by its signature. The key is
        warmed only when the section completes, so a dispatch that faults
        keeps its grace."""
        if key in self._warmed:
            yield
            return
        self._cold_key = key
        try:
            yield
        finally:
            # only the loop's owner clears the mark: a retired thread
            # thawing here must not strip its replacement's grace (with no
            # loop thread, a direct caller owns it)
            if self._thread is None or threading.current_thread() is self._thread:
                self._cold_key = None
        self._warmed.add(key)

    def _check_retired(self) -> None:
        """The quarantine guard: after a warm restart that could not join
        this thread, ``_thread`` names its successor, and this thread
        unwinds now, settling nothing and touching no rebuilt state."""
        if threading.current_thread() is not self._thread:
            raise _ThreadRetired()

    def health_check(self) -> dict[str, Any]:
        """``{"status": ..., "details": {...}}``. Status, first match:
        WEDGED (stop() could not join the loop thread, or the supervisor
        spent its budget), RESTARTING, DOWN (not running), RECLAIMING,
        DRAINING, SUSPECT (the supervisor's verdict), else UP. Details: slots,
        queue, scheduler, shed estimator, epoch, heartbeat age (running),
        page pool (paged, running), prefix cache, LoRA residency, tenants,
        ``request_latency`` (the flight recorder's medians over its
        completed ring), the idempotency registry's counters (``dedup``),
        the device telemetry's last sample, the supervisor's snapshot,
        ``preemptible`` (a preemptible replica) and ``reclaim`` (the
        notice's remaining ``deadline_s``, while one runs). RECLAIMING
        (a notice in progress) comes after DOWN and outranks DRAINING."""
        stats = self._sched.stats()
        details: dict[str, Any] = {
            "slots_active": sum(1 for s in self.slots if s is not None),
            "slots_total": self.config.max_slots,
            "queue_depth": stats["queue_depth"],
            "scheduler_backend": self._sched.backend,
            "total_admitted": stats["total_admitted"],
            "kv_layout": self.config.kv_layout,
            "shed": self._shed.snapshot(),
            # the fence epoch rides the heartbeat: routers fence their
            # calls on the replica's current view
            "epoch": self.epoch,
            "dedup": self._dedup.stats(),
        }
        if self._running:
            details["heartbeat_age_s"] = round(self.heartbeat_age(), 3)
        if self.paged_cache is not None and self._running:
            details["kv_pages"] = self.paged_cache.stats()
        if self._prefix_cache is not None:
            details["prefix_cache"] = self._prefix_cache.stats()
        if self._lora is not None:
            details["lora"] = self._lora.residency()
        if self._tenants is not None:
            details["tenants"] = self._tenants.snapshot()
        details["request_latency"] = self.timeline.latency_summary()
        if self.device_telemetry is not None:
            details["device"] = self.device_telemetry.last_sample()
        if self.preemptible:
            details["preemptible"] = True
        if self._reclaiming:
            remaining = self.reclaim_remaining_s()
            details["reclaim"] = {
                "deadline_s": round(remaining, 3) if remaining is not None else None,
            }
        sup = self._supervisor
        if sup is not None:
            details["supervisor"] = sup.snapshot()
        sup_state = sup.state if sup is not None else None
        if self._wedged or sup_state == "WEDGED":
            status = "WEDGED"
        elif self._restarting or sup_state == "RESTARTING":
            status = "RESTARTING"
        elif not self._running:
            status = "DOWN"
        elif self._reclaiming:
            # the same zero-new-routes contract as a drain, plus a hard
            # external deadline the router and autoscaler read off the beat
            status = "RECLAIMING"
        elif self._draining:
            status = "DRAINING"
        elif sup_state == "SUSPECT":
            status = "SUSPECT"
        else:
            status = "UP"
        return {"status": status, "details": details}

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
        tenant: str | None = None,
        adapter_id: str | None = None,
        trace_ctx: Any = None,
        prefill_only: bool = False,
        handoff_from: str | None = None,
        idempotency_key: str | None = None,
        fence_epoch: int | None = None,
    ) -> concurrent.futures.Future:
        """Thread-safe submit; the Future resolves to a GenerationResult.
        Lower ``priority`` is admitted first. ``deadline`` is the caller's
        remaining budget in seconds: a request still queued when it passes
        fails with ``ErrorDeadlineExceeded`` (504) without a prefill; one
        mid-stream retires with finish reason ``deadline_exceeded``.
        ``stream_cb(token_id, text_piece, done)`` runs on the detok worker
        for every token and once more with ``done`` at the end; if it
        raises, the request is canceled. ``tenant`` names the tenant whose
        class fills in a priority of 0 and a missing deadline and whose
        token-rate budget is charged; ``adapter_id`` names a registered
        LoRA adapter. ``trace_ctx`` is the caller's span: the request's
        spans (``engine.queue``, then prefill, decode and detok under it)
        hang off it, and its trace id lands in the request's timeline.

        The HA plane: ``fence_epoch`` is checked against ``epoch`` before
        anything else (a stale caller gets ``ErrorStaleEpoch``, 409, and
        no request id is taken). ``idempotency_key`` makes the submit
        exactly-once: a duplicate attaches to the live request's future
        (its ``stream_cb`` gets the emitted frames it has not seen, or, past
        the replay window, the live frames from now on) or replays the
        stored terminal; it never dispatches. The disaggregation plane:
        ``prefill_only`` computes the prompt's KV into the prefix cache and
        retires with ``"handoff"`` at the first token, emitting nothing;
        ``handoff_from`` names the prefill replica whose KV the engine's
        migrator fetches first.

        Raises ``ErrorServiceUnavailable`` (503) while draining or after
        stop, ``ErrorInvalidParam`` (400) for an empty prompt, a prompt id
        outside the vocabulary, a negative ``max_new_tokens``, an unknown
        adapter or one without a registry (each before a request id is
        taken), ``ErrorTooManyRequests`` (429) when shed, over the
        tenant's budget or when the queue is full."""
        # the fence first: a caller acting on a view from before a restart
        # must not read the queue, charge a tenant or take a request id
        self.check_fence(fence_epoch)
        idem_key = str(idempotency_key) if idempotency_key else None
        if idem_key:
            # a duplicate before the drain, restart and shed gates: work
            # this replica already owns is not new work
            entry = self._dedup.lookup(idem_key)
            if entry is not None:
                return self._attach_duplicate(entry, stream_cb)
        if self._draining:
            raise ErrorServiceUnavailable("server draining; retry on another replica",
                                          retry_after=1.0)
        if self._restarting:
            # the scheduler and the KV storage are being replaced; the
            # restart takes seconds
            raise ErrorServiceUnavailable("engine restarting; retry", retry_after=1.0)
        # the tenant's class first: its priority drives the scheduler and
        # the preemption ladder, its deadline fills in a missing one. A
        # request that names no tenant is untouched
        if self._tenants is not None and tenant:
            policy = self._tenants.policy(tenant)
            if priority == 0:
                priority = int(policy.priority or 0)
            if deadline is None and policy.deadline_s:
                deadline = float(policy.deadline_s)
        if adapter_id and (self._lora is None or not self._lora.known(adapter_id)):
            raise ErrorInvalidParam("adapter_id")
        # load shedding before any per-request work; with tenant classes
        # only waiters of the same or a higher class stand before this one
        # (a batch-class flood sheds batch-class requests, never an
        # interactive one it cannot delay)
        depth = shed_depth = self._sched.pending()
        if self._tenants is not None:
            active = {id(r) for r in self.slots if r is not None}
            with self._count_lock:
                shed_depth = sum(1 for r in self._by_id.values()
                                 if id(r) not in active and not r.canceled
                                 and r.priority <= priority)
        est_wait = self._shed.estimate_wait(shed_depth, self.config.max_slots)
        if self._metrics:
            self._metrics.set_gauge("app_estimated_queue_wait_seconds", est_wait)
        shed_cap = self.config.shed_max_wait_s
        missed = deadline is not None and 0 < deadline < est_wait
        if missed or (shed_cap > 0 and est_wait > shed_cap):
            if self._metrics:
                self._metrics.increment_counter("app_requests_shed_total")
            raise ErrorTooManyRequests(
                f"estimated queue wait {est_wait:.2f}s exceeds "
                + (f"request deadline {deadline:.2f}s" if missed
                   else f"shed threshold {shed_cap:.2f}s"),
                retry_after=est_wait,
            )
        prompt_ids = (
            self.tokenizer.encode(prompt) if isinstance(prompt, str) else list(prompt)
        )
        # client errors, each a 400 before a request id is taken. The
        # reference accepts an empty prompt and fails it at admission with
        # a bare IndexError, and passes a negative budget to its scheduler
        # (ROADMAP Queue C 21, 22). An out-of-vocabulary id on the card is a
        # device-side assert, which leaves the CUDA context in a sticky
        # error; the reference's gather clamps it instead
        if not prompt_ids or min(prompt_ids) < 0 or max(prompt_ids) >= self.model_cfg.vocab_size:
            raise ErrorInvalidParam("prompt")
        if max_new_tokens is not None and max_new_tokens < 0:
            raise ErrorInvalidParam("max_new_tokens")
        with self._count_lock:
            self._next_id += 1
            rid = self._next_id
        # keep the TAIL within the sequence budget; a prompt that does not
        # route chunked also keeps within the largest bucket
        max_prompt = self.config.max_seq_len - 1
        if not self._route_chunked(min(len(prompt_ids), max_prompt)):
            max_prompt = min(max_prompt, max(self._buckets()))
        prompt_ids = prompt_ids[-max_prompt:]
        budget = self.config.max_seq_len - len(prompt_ids)
        max_new = min(max_new_tokens or self.config.max_new_tokens_default, budget)
        if self._tenants is not None:
            # the token-rate budget: prompt plus requested generation
            ok, retry_after = self._tenants.admit(tenant, len(prompt_ids) + max_new)
            if not ok:
                if self._metrics:
                    self._metrics.increment_counter("app_requests_shed_total",
                                                    tenant=tenant or "default")
                raise ErrorTooManyRequests(
                    f"tenant {tenant or 'default'} over its token-rate budget",
                    retry_after=max(retry_after, 0.05),
                )
        if adapter_id:
            try:
                # after every rejection gate: the upload runs while the
                # request queues, and shed traffic never touches the table
                self._lora.prefetch(adapter_id)
            except UnknownAdapter:  # deregistered since the gate above
                raise ErrorInvalidParam("adapter_id") from None
        claim_entry: DedupEntry | None = None
        if idem_key:
            # the atomic claim, after the gates a fresh request passes: one
            # concurrent submit per key owns the dispatch, and one that
            # lost the race since the lookup above attaches to the owner
            owner, claim_entry = self._dedup.claim(idem_key)
            if not owner:
                return self._attach_duplicate(claim_entry, stream_cb)
        req: _Request | None = None
        try:
            # the timeline comes before any gate that can still refuse: a
            # request refused from here on leaves a terminal timeline too
            # (the except below settles it). Its "submitted" stamp is the
            # request's creation time
            tl = self.timeline.begin(rid, prompt_tokens=len(prompt_ids))
            tl.tenant = tenant
            req = _Request(
                rid, prompt_ids, max_new, float(temperature), int(top_k), float(top_p),
                stream_cb, stop_ids={self.tokenizer.eos_id}, priority=int(priority),
                deadline=deadline, created=tl.phases["submitted"],
            )
            if claim_entry is not None:
                # every frame (the detok worker's token frames and the done
                # frame of every settlement path) goes through the
                # seq-numbered ring, so a resume can replay what the client
                # has not seen; the caller's stream_cb still gets the plain
                # three-argument frames
                req.idem_key = idem_key
                req.replay = ReplayStream(self.config.stream_replay_tokens)
                req.stream_cb = req.replay.wrap(stream_cb)
                claim_entry.publish(rid, req.future, req.replay)
            req.prefill_only = bool(prefill_only)
            req.handoff_from = handoff_from
            req.tenant = tenant
            req.adapter_id = adapter_id or None
            req.trace_ctx = trace_ctx
            req.timeline = tl
            if self._tracer is not None:
                qspan = self._tracer.start_span("engine.queue", parent=trace_ctx,
                                                kind="internal", activate=False)
                qspan.set_attribute("request.id", rid)
                qspan.set_attribute("tokens.prompt", len(prompt_ids))
                if tenant:
                    qspan.set_attribute("tenant", tenant)
                if adapter_id:
                    qspan.set_attribute("lora.adapter", adapter_id)
                tl.open_span("queue", qspan)
            elif trace_ctx is not None:
                tl.trace_id = trace_ctx.trace_id
            # registration + enqueue are atomic with stop()'s flag and
            # warm_restart's sweep (the same mutex): either the sweep sees
            # this request, or this section sees the flag before touching
            # the scheduler that is about to be replaced. Bounded: a submit
            # stuck inside a hung scheduler call must not pile every caller up
            # gofrlint: disable=deadline-dropped -- deliberate constant: bounds a wedged-scheduler pile-up with a fast retriable 503; the request's own deadline is enforced by expired-while-queued
            if not self._submit_mu.acquire(timeout=5.0):
                raise ErrorServiceUnavailable("engine busy; retry on another replica",
                                              retry_after=1.0)
            try:
                if self._stop_requested:
                    raise ErrorServiceUnavailable("server stopped; retry on another replica",
                                                  retry_after=1.0)
                if self._restarting:
                    raise ErrorServiceUnavailable("engine restarting; retry", retry_after=1.0)
                with self._count_lock:
                    self._by_id[rid] = req
                try:
                    self._sched.submit(rid, len(prompt_ids), max_new, req.priority)
                except QueueFull:
                    with self._count_lock:
                        self._by_id.pop(rid, None)
                    if self._metrics:
                        self._metrics.increment_counter("app_requests_shed_total")
                    raise ErrorTooManyRequests(retry_after=max(est_wait, 1.0)) from None
                except RuntimeError:  # a closed scheduler: stop() won the race
                    with self._count_lock:
                        self._by_id.pop(rid, None)
                    raise ErrorServiceUnavailable("server stopped; retry on another replica",
                                                  retry_after=1.0) from None
            finally:
                self._submit_mu.release()
        except Exception as exc:
            # the caller gets the raise; the request id still owes its
            # terminal timeline, marked through the one settlement gate
            # (exactly once: a sweep that settled it first wins), which
            # also forgets a keyed request's entry. A failure before the
            # key reached the request forgets it here, so no later
            # duplicate attaches to a future that never resolves
            if req is not None:
                self._try_resolve(req, exc=exc)
            if claim_entry is not None and (req is None or req.idem_key is None):
                self._dedup.forget(idem_key)
            raise
        self._observe_queue(depth + 1)  # this request just joined the queue
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

    def cancel(self, request_id: int, *, fence_epoch: int | None = None) -> None:
        """Mark a queued or running request canceled. A running one frees
        its slot at the engine thread's next dispatch scan or token commit,
        a queued one at the next admission; nothing else changes here.
        ``fence_epoch`` refuses a stale caller (409) before anything is
        touched: a fenced router must not cancel work a current one owns."""
        self.check_fence(fence_epoch)
        with self._count_lock:
            req = self._by_id.get(request_id)
        if req is not None:
            req.canceled = True
        try:
            self._sched.cancel(request_id)  # a no-op once admitted
        except KeyError:
            pass
        self._wake.set()

    # ---------------------------------------------------------------- HA plane
    def check_fence(self, fence_epoch: int | None) -> None:
        """Refuse a caller whose fence epoch is not this engine's current
        one (``warm_restart`` bumps it). ``None``, an unfenced caller,
        always passes: fencing is the router tier's opt-in."""
        if fence_epoch is not None and int(fence_epoch) != self.epoch:
            raise ErrorStaleEpoch(
                f"fence epoch {int(fence_epoch)} != engine epoch {self.epoch}; "
                "refresh membership"
            )

    def _attach_duplicate(self, entry: DedupEntry, stream_cb: Callable | None,
                          last_seq: int = 0) -> concurrent.futures.Future:
        """A duplicate keyed submit: attach, never dispatch. A live entry
        gives the owner's future (one terminal, one settlement) and replays
        the unseen frames into ``stream_cb``; a terminal entry gives a
        resolved future and replays the stored result. A live stream whose
        suffix left the replay window attaches without a replay (a
        truncated stream, the full result through the future): a keyed
        retry dedups, it never fails; the 404 for a lost window belongs to
        ``resume``, where the client asked for a token-identical suffix.
        The owner's claim-to-publish window is closed by ``entry.ready``."""
        # bounds only the owner's admission code between its claim and its
        # publish; a failure there is a fast retriable 503
        if not entry.ready.wait(timeout=5.0) or (entry.future is None and not entry.terminal):
            # the owner is still admitting, or its admission failed and the
            # key was forgotten: the retry runs fresh
            raise ErrorServiceUnavailable("idempotent twin still admitting; retry",
                                          retry_after=0.5)
        if entry.terminal:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.request_id = entry.rid
            if stream_cb is not None:
                self._replay_result(entry, last_seq,
                                    lambda _seq, tid, piece, done: stream_cb(tid, piece, done))
            fut.set_result(entry.result)
            return fut
        if stream_cb is not None and entry.replay is not None:

            def wire(_seq: int, tid: int, piece: str, done: bool) -> None:
                stream_cb(tid, piece, done)

            try:
                entry.replay.attach(last_seq, wire)
            except ReplayGap:
                # a truncated live attach: the frames from now on reach this
                # client and the shared future still resolves with the full
                # result. A mirror future of its own carries the attach
                # point (``stream_base_seq``), so a transport can stamp the
                # engine's true sequence numbers on the truncated stream
                base = entry.replay.subscribe(wire)
                mirror: concurrent.futures.Future = concurrent.futures.Future()
                mirror.request_id = entry.rid
                mirror.stream_base_seq = base

                def _mirror(src: concurrent.futures.Future) -> None:
                    try:
                        src_exc = src.exception()
                        if src_exc is not None:
                            mirror.set_exception(src_exc)
                        else:
                            mirror.set_result(src.result())
                    except Exception:
                        pass  # the mirror settled already, or the owner was canceled

                entry.future.add_done_callback(_mirror)
                return mirror
        return entry.future

    def _replay_result(self, entry: DedupEntry, last_seq: int,
                       cb: Callable[[int, int, str, bool], None]) -> None:
        """Replay a stored terminal's token frames past ``last_seq``. Ring
        seq i+1 is token_ids[i]: the ring is fed by the one detok worker in
        emission order, stop tokens are never frames, and the terminal
        takes seq N+1. The pieces come from the entry's ring, which kept
        every emitted piece, so the replay is text-identical to the
        original stream; a per-token decode is the fallback for an entry
        without them."""
        token_ids = list(entry.result.token_ids)
        pieces: list[str] | None = None
        if entry.replay is not None and len(entry.replay.pieces) == len(token_ids):
            pieces = list(entry.replay.pieces)
        for i, tid in enumerate(token_ids):
            seq = i + 1
            if seq > last_seq:
                piece = pieces[i] if pieces is not None else self.tokenizer.decode([tid])
                cb(seq, tid, piece, False)
        done_seq = len(token_ids) + 1
        if done_seq > last_seq:
            cb(done_seq, -1, "", True)

    def resume(self, idempotency_key: str, *, last_seq: int = 0,
               stream_cb: Callable[[int, int, str, bool], None] | None = None,
               fence_epoch: int | None = None) -> concurrent.futures.Future:
        """Re-attach to a keyed request's token stream: replay every frame
        with ``seq > last_seq`` token-identically, from the bounded ring
        (live) or the stored terminal, then ride the generation still
        running. ``stream_cb`` takes the four-argument frame ``(seq,
        token_id, piece, done)``. An unknown key is a 404 (the client
        submits, which dedups anyway); a suffix the window lost is a 404
        too (a token-identical resume is impossible and the engine does not
        generate again). The ``stream.resume`` chaos point fires first."""
        chaos.maybe_fail("stream.resume")
        self.check_fence(fence_epoch)
        key = str(idempotency_key)
        entry = self._dedup.lookup(key)
        if entry is None:
            raise ErrorEntityNotFound("idempotency_key", key)
        if not entry.ready.wait(timeout=5.0) or (entry.future is None and not entry.terminal):
            raise ErrorServiceUnavailable("request still admitting; retry", retry_after=0.5)
        if entry.terminal:
            if stream_cb is not None:
                self._replay_result(entry, int(last_seq), stream_cb)
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.request_id = entry.rid
            fut.set_result(entry.result)
            return fut
        if stream_cb is not None:
            try:
                entry.replay.attach(int(last_seq), stream_cb)
            except ReplayGap:
                raise ErrorEntityNotFound("replay window", key) from None
        return entry.future

    def orphan(self, request_id: int, grace_s: float | None = None) -> None:
        """One client of a keyed request vanished mid-stream: release its
        subscription, and if it was the last, let the generation run on for
        ``grace_s`` (``stream_orphan_grace_s`` by default) awaiting a resume
        instead of canceling. A reaper then cancels it, as an unkeyed
        disconnect would, only if no subscriber is attached and no attach
        came after this orphaning; one client's disconnect never kills
        another client's generation. An unkeyed request is canceled."""
        grace = grace_s if grace_s is not None else self.config.stream_orphan_grace_s
        with self._count_lock:
            req = self._by_id.get(request_id)
        if req is None:
            return
        if req.replay is None:
            self.cancel(request_id)
            return
        if req.replay.release() > 0:
            return  # another client still rides this generation
        if grace <= 0:
            self.cancel(request_id)
            return
        attaches_at_orphan = req.replay.attaches

        def _reap() -> None:
            if req.future.done():
                return
            if req.replay.attaches > attaches_at_orphan:
                return  # someone resumed; their disconnect orphans again
            if req.replay.subscribers > 0:
                return  # a client re-attached and is still connected
            self.cancel(request_id)

        timer = threading.Timer(grace, _reap)
        timer.daemon = True
        timer.start()

    def dedup_stats(self) -> dict[str, int]:
        """The idempotency registry's counters."""
        return self._dedup.stats()

    # ------------------------------------------------------------------ loop
    def _loop(self) -> None:
        me = threading.current_thread()
        try:
            self._loop_body(me)
        except _ThreadRetired:
            return  # a quarantined thread thawed: exit, touch nothing
        except BaseException as exc:
            # an escape past the per-step recovery (the engine.step chaos
            # point sits outside it) is a crash: the flag tells the
            # watchdog "crashed" from "stopped"
            if self._running and me is self._thread:
                self.loop_crashed = True
                self._log("error", "serving engine loop thread died",
                          stack=traceback.format_exc(limit=20))
            if not isinstance(exc, Exception):
                raise  # SystemExit and KeyboardInterrupt propagate

    def _loop_body(self, me: threading.Thread) -> None:
        # the identity guard: after a warm restart that could not join
        # this thread, _thread names its successor and this one exits
        while self._running and me is self._thread:
            self.heartbeat = self._iter_t0 = time.monotonic()
            chaos.maybe_fail("engine.step")
            if not self._running or me is not self._thread:
                # stopped or replaced while hung at the chaos point: no
                # doomed iteration over a queue the restart already swept
                continue
            try:
                # the preemption ladder runs before the plan: a slot it
                # frees is admitted in this same iteration
                did = self._maybe_preempt()
                if self._reclaiming and not self._reclaim_swept:
                    # a notice sheds batch-class rows now, so the drain
                    # budget serves the interactive streams
                    did |= self._reclaim_sweep()
                plan = self._plan_step()
                did |= self._admit(plan)
                if any(s is not None for s in self.slots):
                    did |= self._decode_step(plan)
                elif self._inflight:
                    # every row of the in-flight blocks retired meanwhile
                    self._consume(self._inflight.popleft())
                    did = True
                else:
                    self._last_consume_t = None  # an idle gap is no block's time
                # the iteration so far was work; the wake wait is idle
                self._flush_busy()
                if not did:
                    if (self._draining and not self._inflight
                            and not any(s is not None for s in self.slots)
                            and self._sched.pending() == 0):
                        self._idle.set()  # drained dry: drain() waits on this
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
            except Exception as exc:  # the loop must outlive a failed step
                # a retired thread's error is noise from quarantined state:
                # it must not fail its replacement's requests
                self._check_retired()
                self._log("error", f"serving engine step error: {exc}",
                          stack=traceback.format_exc(limit=20))
                self._fail_all(exc)
                # gofrlint: disable=blocking-call -- error backoff in the
                # dedicated engine thread, bounded by idle_sleep_s
                time.sleep(self.config.idle_sleep_s)

    def _plan_step(self) -> StepPlan:
        """This iteration's step plan: decode rows reserved first, chunk
        grants for the cursors, an admission quota from what is left."""
        decode_rows = sum(
            1 for slot, req in enumerate(self.slots)
            if req is not None and slot not in self._cursors
        )
        plan = self._planner.plan(
            decode_rows=decode_rows, cursors=list(self._cursors.values()),
            free_slots=sum(1 for s in self.slots if s is None),
            queue_depth=self._sched.pending(),
        )
        if self._metrics:
            # set on a change only (the drop back to 0 at idle included):
            # the steady state costs no per-iteration writes
            snapshot = (plan.prefill_tokens, decode_rows, len(self._cursors))
            if snapshot != self._plan_gauges:
                self._plan_gauges = snapshot
                self._metrics.set_gauge("app_step_plan_prefill_tokens", plan.prefill_tokens)
                self._metrics.set_gauge("app_step_plan_decode_rows", decode_rows)
                self._metrics.set_gauge("app_step_plan_cursors", len(self._cursors))
        return plan

    def _route_chunked(self, prompt_len: int) -> bool:
        """True when a prompt prefills through a chunk cursor and the ragged
        dispatch: longer than a chunk, or longer than every bucket. Never
        under speculative decoding."""
        if not self._chunk_enabled:
            return False
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
        # a thread thawing out of a hung admit must not apply the old
        # scheduler's pairs to its replacement's state
        self._check_retired()
        for rid in canceled_ids:
            with self._count_lock:
                req = self._by_id.pop(rid, None)
            if req is not None:
                self._finish(req, "cancel")
        for rid, slot in pairs:
            with self._count_lock:
                req = self._by_id.get(rid)
            if req is None or req.canceled or req.expired(time.monotonic()):
                sched.release(slot)
                with self._count_lock:
                    self._by_id.pop(rid, None)
                if req is not None and req.canceled:
                    self._finish(req, "cancel")
                elif req is not None:
                    # expired while queued: never prefill it; the caller
                    # gets a 504
                    if self._metrics:
                        self._metrics.increment_counter("app_requests_deadline_exceeded_total")
                    self._settle_async(req, exc=ErrorDeadlineExceeded())
                continue
            # admission reached: stamp it and end the queue span (the first
            # stamp wins, so a requeue keeps its first queue wait)
            tl = req.timeline
            if tl is not None and "admitted" not in tl.phases:
                now = time.monotonic()
                tl.stamp("admitted", now)
                queue_wait = now - req.created
                qspan = tl.spans.get("queue")
                if qspan is not None:
                    qspan.set_attribute("queue.wait_s", round(queue_wait, 6))
                    qspan.end()
                if self._metrics:
                    labels = {"tenant": req.tenant} if req.tenant else {}
                    self._metrics.record_histogram("app_request_queue_wait_seconds", queue_wait,
                                                   **labels)
            try:
                if self._lora is not None and req.adapter_id:
                    # pin the adapter's table slot for the row's life; the
                    # wait is clamped to what the deadline leaves
                    budget = 5.0
                    rem = req.remaining(time.monotonic())
                    if rem is not None:
                        budget = min(budget, rem)
                    try:
                        req.adapter_slot = self._lora.acquire(req.adapter_id, timeout=budget)
                    except AdapterBusy:
                        raise _Requeue() from None
                # a resume admits the prompt plus its emitted tokens, which
                # may route chunked where the prompt did not
                if self._route_chunked(len(req.serve_ids)):
                    self._start_cursor(slot, req)
                else:
                    self._prefill_into(slot, req)
            except _Requeue:
                # pages or adapter slots short for now: back to the head of
                # its class; the rest of this round's pairs proceed
                self._check_retired()  # warm_restart already requeued it
                self._lora_release(req)
                sched.release(slot)
                self._resubmit_front(req)
            except Exception as exc:
                # a retired thread unwinds: its request was requeued or
                # settled by warm_restart, and these slots are not its own
                self._check_retired()
                self._log("error", f"prefill failed for request {rid}: {exc}")
                self._lora_release(req)
                self.slots[slot] = None
                self._cursors.pop(slot, None)
                self.cache_len[slot] = 0
                self.adapter_idx[slot] = 0
                self._free_kv(slot)
                try:
                    sched.release(slot)
                except KeyError:  # a retire inside the failed call released it
                    pass
                with self._count_lock:
                    self._by_id.pop(rid, None)
                self._settle_async(req, exc=exc)
                # a failure that took the shared KV storage with it fails
                # every row, not only this one; host-side refusals never
                # touched the device
                if not isinstance(exc, (ErrorTooManyRequests, ErrorRequestEntityTooLarge)) \
                        and self._kv_unhealthy():
                    self._fail_all(exc, kv_unhealthy=True)
        self._observe_queue()
        return bool(pairs or canceled_ids)

    def _lora_adjusted(self, req: _Request, last_logits: torch.Tensor,
                       last_token: int) -> torch.Tensor:
        """The row's adapter delta on host-path last-position logits before
        first-token sampling (monolithic prefill, whole-prompt and full
        chain hits); base rows get the logits untouched."""
        if self._lora is None or not req.adapter_slot:
            return last_logits
        factors = self._lora.slot_factors(req.adapter_slot)
        if factors is None:
            return last_logits
        return batch_ops.lora_adjust_logits(
            self.params["embedding"], factors[0], factors[1], last_token, last_logits,
        )

    def _lora_release(self, req: _Request) -> None:
        """Unpin a row's adapter table slot (nothing for a base row). Every
        path that takes a row out (retire, requeue, failed prefill,
        preempt, fail-all, stop) goes through here, so a pin never
        outlives its row."""
        if req.adapter_slot and self._lora is not None:
            self._lora.release(req.adapter_slot)
            req.adapter_slot = 0

    def _resubmit_front(self, req: _Request) -> None:
        """Requeue at the head of the request's priority class after
        transient pool pressure; a queue that will not take it fails the
        request with a 429."""
        try:
            # gofrlint: disable=retry-unbudgeted -- expiry is gated by both callers: admission checks req.expired before it admits, and _cursor_health before every pressure requeue (504)
            self._sched.submit(req.id, len(req.serve_ids), req.max_new_tokens,
                               req.priority, front=True)
        except Exception:
            with self._count_lock:
                self._by_id.pop(req.id, None)
            self._settle_async(req, exc=ErrorTooManyRequests())

    # ----------------------------------------------------------- KV reuse
    def _cache_lookup(self, key: str) -> tuple[Any, str]:
        """Prefix-cache lookup with tier attribution: ``(value, tier)``,
        tier ``device``, ``host`` or ``miss``; a single-tier cache reports
        ``device`` on a hit. A hit feeds the timeline's reuse count, which
        orders the spill tier's demotions."""
        cache = self._prefix_cache
        tiered = getattr(cache, "get_with_tier", None)
        if tiered is not None:
            value, tier = tiered(key)
        else:
            value = cache.get(key)
            tier = "device" if value is not None else "miss"
        if value is not None:
            self.timeline.observe_prefix_reuse(key)
        return value, tier

    def _record_prefix_tier(self, req: _Request, tier: str) -> None:
        """The warmest tier that served the request's cached prefix: the
        timeline's ``prefix_tier`` (the first stamp wins, so a requeue
        keeps it) and ``app_kv_prefix_hits_total{tier}`` (one per
        admission walk)."""
        tl = req.timeline
        if tl is not None and tl.prefix_tier is None:
            tl.prefix_tier = tier
        if self._metrics:
            self._metrics.increment_counter("app_kv_prefix_hits_total", tier=tier)

    def prefix_advertisement(self, limit: int = 128) -> list[list[str]] | None:
        """This replica's bounded [key, tier] advertisement for the prefix
        index (serving/prefix_index.py), carried by the membership
        heartbeat. None when the cache lists no keys (an injected cache)."""
        cache = self._prefix_cache
        if cache is None:
            return None
        advertised = getattr(cache, "advertised", None)
        if advertised is not None:
            pairs = advertised(limit)
        else:
            keys_fn = getattr(cache, "keys", None)
            if keys_fn is None:
                return None
            pairs = [(str(k), "device") for k in list(reversed(keys_fn()))[:limit]]
        return [[key, tier] for key, tier in pairs]

    def _chunk_cache_keys(self, prompt_ids: list[int],
                          adapter_id: str | None = None) -> list[tuple[int, int, str]]:
        """Chunk-prefix cache keys for every chunk boundary of a prompt:
        the chunk geometry and the digest of the WHOLE prefix up to the
        boundary, so two prompts that share a prefix share its entries and
        a change of chunk size never aliases. The adapter id ends the key:
        the same prompt under two adapters is two chains. One incremental
        blake2b pass with a snapshot per boundary (digesting each prefix
        from scratch would be quadratic in the prompt's length)."""
        arr = np.asarray(prompt_ids, np.int32)
        aid = adapter_id or "-"
        h = hashlib.blake2b(digest_size=16)
        out: list[tuple[int, int, str]] = []
        pos, total = 0, len(prompt_ids)
        while pos < total:
            end = min(pos + self._chunk_tokens, total)
            h.update(arr[pos:end].tobytes())
            out.append((pos, end, f"chunkpfx:{self._chunk_tokens}:{pos}:{end}:"
                                  f"{h.copy().hexdigest()}:{aid}"))
            pos = end
        return out

    def _start_cursor(self, slot: int, req: _Request) -> None:
        """Admit a long prompt as a chunk cursor: claim the slot, skip the
        longest chain of cached chunk prefixes, and leave the rest of the
        prompt to the planner's chunk grants. A chain that covers the whole
        prompt admits straight to decode with zero prefill dispatches. On
        the paged layout the pages of the cached chain are claimed here and
        the rest at the first grant; a prompt the whole pool can never hold
        fails with a 413, and page pressure requeues, both before the slot
        is touched."""
        pc = self.paged_cache
        ids = req.serve_ids  # the prompt plus emitted tokens on a resume
        total = len(ids)
        if pc is not None and pc.pages_needed(total) > pc.num_pages:
            raise ErrorRequestEntityTooLarge(
                f"prompt needs {pc.pages_needed(total)} KV pages; the pool has "
                f"{pc.num_pages} in total"
            )
        # the longest chain of cached chunk-boundary prefixes (each entry:
        # that chunk's K/V slab and its prefix's last-position logits); the
        # keys ride the cursor for the put at consume
        hits: list[tuple[int, int, Any]] = []
        pos = 0
        cache_keys: dict[tuple[int, int], str] | None = None
        if self._prefix_cache is not None and self._chunk_cache_enabled:
            boundaries = self._chunk_cache_keys(ids, req.adapter_id)
            cache_keys = {(a, b): k for a, b, k in boundaries}
            tiers: set[str] = set()
            for start, end, key in boundaries:
                val, tier = self._cache_lookup(key)
                if val is None:
                    break
                if end >= total and val[0].shape[-1] != self.model_cfg.vocab_size:
                    # an entry without real last-position logits (a
                    # preemption's page-out) may link a chain but never
                    # end it: the full-hit admit would sample the first
                    # token from it
                    break
                hits.append((start, end, val))
                tiers.add(tier)
                pos = end
            if pos < total and self._kv_migrator is not None:
                # the rest of the chain from another replica: the handoff
                # from the named prefill replica first (a complete,
                # contiguity-checked chain or nothing), then the longest
                # advertised chain, contiguous from pos (a torn transfer
                # keeps what it fetched and the chunk grants compute the
                # rest). Both are bounded by what the deadline leaves
                remaining = [b for b in boundaries if b[0] >= pos]
                budget = req.remaining(time.monotonic())
                fetched = []
                if req.handoff_from is not None:
                    fetched = self._kv_migrator.fetch_handoff(remaining, req.handoff_from,
                                                              deadline=budget)
                if not fetched:
                    fetched = self._kv_migrator.fetch_chain(remaining, deadline=budget)
                # a fetch can block (a remote transport): a thread retired
                # meanwhile must not put slabs into the reset cache
                self._check_retired()
                if fetched:
                    for start, end, val in fetched:
                        # a non_blocking upload (a device peer's tensors
                        # stay where they are): no sync on this thread
                        val = _to_device(val, self.device)
                        if end >= total and val[0].shape[-1] != self.model_cfg.vocab_size:
                            break  # a peer's page-out placeholder: the guard above
                        hits.append((start, end, val))
                        pos = end
                        # paid once per replica: a later request hits locally
                        self._prefix_cache.put(cache_keys[(start, end)], val)
                    tiers.add("remote")
            self._record_prefix_tier(
                req, "remote" if "remote" in tiers else "host" if "host" in tiers
                else "device" if hits else "miss")
        if hits and pc is not None:
            try:
                pc.alloc_slot(slot, seq_id=req.id, prompt_len=0, reserve_tokens=pos)
            except OutOfBlocks:
                raise _Requeue() from None
        tl = req.timeline
        if tl is not None:
            tl.stamp("prefill_start")
        for start, _end, (_logits, k_slab, v_slab) in hits:
            if pc is not None:
                pc.write_span(slot, start, k_slab, v_slab)
            else:
                self.cache.k, self.cache.v = batch_ops.insert_chunk(
                    self.cache.k, self.cache.v, k_slab, v_slab, slot, start,
                )
        if hits:
            if pc is not None:
                pc.advance_slot(slot, pos)
            if tl is not None:
                tl.chunk(0, pos, prefix_hit=True)
            if self._metrics:
                self._metrics.record_histogram("app_prefill_chunk_tokens", pos, kind="prefix_hit")
        if pos >= total:
            # the whole prompt is cached at chunk boundaries: sample the
            # first token from the last entry's logits (with the row's
            # adapter delta), as the dispatch that finishes a prompt would,
            # and admit to decode. The span closes after the sync
            span = self._req_span("prefill", "serve.prefill chunked (prefix hit)", req)
            if tl is not None:
                pspan = tl.spans.get("prefill")
                if pspan is not None:
                    pspan.set_attribute("prefill.prefix_hit", True)
                    pspan.set_attribute("prefix_tier", tl.prefix_tier or "device")
            with span:
                logits = self._lora_adjusted(req, hits[-1][2][0], ids[-1])
                first_id = self._first_token(req, logits)
            self._check_retired()
            self._commit_prefilled(slot, req, first_id, total)
            return
        cursor = ChunkCursor(req=req, slot=slot, total=total, seq=self._cursor_seq,
                             priority=req.priority)
        self._cursor_seq += 1
        cursor.cache_keys = cache_keys
        cursor.committed = cursor.dispatched = cursor.prefix_hit = pos
        cursor.chunk_index = 1 if hits else 0
        cursor.allocated = bool(hits and pc is not None)
        self.slots[slot] = req
        self.cache_len[slot] = pos
        self.last_token[slot] = 0
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self.adapter_idx[slot] = req.adapter_slot
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
        elif req.expired(time.monotonic()):
            self._retire(slot, "deadline_exceeded")
        elif cursor.blocked:
            self._log("info", f"KV pool short; request {req.id} requeues from chunk 0")
            self._cursors.pop(slot, None)
            self.slots[slot] = None
            self.cache_len[slot] = 0
            self.adapter_idx[slot] = 0
            self._lora_release(req)
            self._free_kv(slot)
            self._sched.release(slot)
            self._resubmit_front(req)

    # -------------------------------------------------------- preemption
    def _maybe_preempt(self) -> bool:
        """The preemption ladder: when a STRICTLY higher class (lower
        priority number) waits and the batch cannot take it (no free slot,
        or on the paged layout a pool that cannot cover its prompt), pause
        the lowest-class row, on a tie the one with more tokens out (its
        resume is the warmest). A row with blocks in flight is marked
        pending: no dispatch feeds it any more, and it is paused once they
        are read. Equal classes never preempt each other (a resumed row
        keeps its priority, so it never evicts what evicted it), and spec
        mode never preempts. Engine thread only."""
        if not self.config.tenant_preempt or self._tenants is None:
            return False
        if self.config.spec_tokens > 0:
            return False
        active = {id(r) for r in self.slots if r is not None}
        with self._count_lock:
            waiting = [r for r in self._by_id.values() if id(r) not in active and not r.canceled]
        if not waiting:
            self._preempt_pending.clear()
            return False
        best = min(r.priority for r in waiting)
        slot_pressure = all(s is not None for s in self.slots)
        page_pressure = False
        pc = self.paged_cache
        if not slot_pressure and pc is not None:
            need = min(pc.pages_needed(len(r.serve_ids)) for r in waiting if r.priority == best)
            page_pressure = need > pc.stats()["free_blocks"]
        if not slot_pressure and not page_pressure:
            self._preempt_pending.clear()  # the pressure passed
            return False
        for slot in sorted(self._preempt_pending):
            req = self.slots[slot]
            if req is None or req.priority <= best:
                self._preempt_pending.discard(slot)
                continue
            if self._row_in_flight(slot, req):
                return False  # draining: its blocks are read first
            self._preempt_pending.discard(slot)
            self._preempt(slot)
            return True
        victim = None
        for slot, req in enumerate(self.slots):
            if req is None or req.priority <= best:
                continue  # never an equal or higher class
            if victim is None or ((req.priority, len(req.tokens))
                                  > (self.slots[victim].priority, len(self.slots[victim].tokens))):
                victim = slot
        if victim is None:
            return False
        if self._row_in_flight(victim, self.slots[victim]):
            self._preempt_pending.add(victim)
            return False
        self._preempt(victim)
        return True

    def _row_in_flight(self, slot: int, req: _Request) -> bool:
        """A decode block or a chunk of the row is dispatched, not read."""
        cursor = self._cursors.get(slot)
        return self._slot_in_flight(slot, req) or (cursor is not None and cursor.in_flight > 0)

    def _preempt(self, slot: int, *, reclaim: bool = False) -> None:
        """Pause one row with nothing in flight: put its whole chunk spans
        below its resident length, and strictly below ``len(serve_ids)``,
        into the prefix cache (bf16 KV with the chunk cache on; int8 KV
        recomputes them at the resume), free its slot, pages and adapter
        pin, and requeue it. The resume is an ordinary admission of
        ``serve_ids`` (prompt plus emitted tokens): the chain walk finds
        the spans, the tail chunk recomputes, and the NEXT token samples
        with what is left of the budget; emitted tokens are never re-run.

        ``reclaim=True`` is a notice's variant (:meth:`_reclaim_sweep`):
        the same page-out, whose spans then ride the evacuation to a
        survivor, but the row fails retriable instead of requeueing, is
        stamped ``reclaim-preempted`` and counts no tenant preemption.
        It is not advisory: ``tenant.preempt`` does not fire."""
        req = self.slots[slot]
        if req is None:
            return
        if not reclaim:
            try:
                chaos.maybe_fail("tenant.preempt")
            except Exception:
                return  # advisory: a faulted preemption is a skipped one
        ids = req.serve_ids
        resident = int(self.cache_len[slot])
        if self._prefix_cache is not None and self._chunk_cache_enabled and not req.prefill_only:
            for start, end, key in self._chunk_cache_keys(ids, req.adapter_id):
                # the resume always computes at least the final chunk,
                # whose logits give the next token
                if end > resident or end >= len(ids):
                    break
                if self.paged_cache is not None:
                    k_slab, v_slab = self.paged_cache.read_span(slot, start, end)
                else:
                    # slices of the dense cache are views of the slot row,
                    # which its next occupant overwrites: copy them
                    k_slab = self.cache.k[:, slot, start:end].clone()
                    v_slab = self.cache.v[:, slot, start:end].clone()
                # the logits column is a placeholder: the chain walk never
                # ends on this entry (it ends before len(serve_ids))
                placeholder = torch.zeros((1, 1), dtype=torch.float32, device=self.device)
                self._prefix_cache.put(key, (placeholder, k_slab, v_slab))
        req.preemptions += 1
        if req.timeline is not None:
            req.timeline.stamp("reclaim-preempted" if reclaim else f"preempted:{req.preemptions}")
        if self._metrics and not reclaim:
            self._metrics.increment_counter("app_tenant_preemptions_total",
                                            tenant=req.tenant or "default")
        self._log("info", f"preempted request {req.id} (tenant {req.tenant or 'default'}, "
                          f"priority {req.priority}) after {len(req.tokens)} tokens; "
                          f"{resident} resident tokens paged out")
        self._cursors.pop(slot, None)
        self._pending_admit.pop(slot, None)
        self.slots[slot] = None
        self.cache_len[slot] = 0
        self.adapter_idx[slot] = 0
        # the resume's first token makes len(tokens) - 1 equal to this: no
        # step of the row is in flight then
        req.dispatched = len(req.tokens)
        self._lora_release(req)
        self._free_kv(slot)
        self._sched.release(slot)
        if reclaim:
            # a doomed replica never requeues: the router's retry lands on
            # a survivor, whose chain walk finds the evacuated spans
            req.canceled = True
            with self._count_lock:
                self._by_id.pop(req.id, None)
            self._settle_async(req, exc=ErrorServiceUnavailable(
                "replica reclaiming; retry on another replica", retry_after=0.5))
            return
        try:
            self._sched.submit(req.id, len(req.serve_ids), req.max_new_tokens, req.priority)
        except Exception:
            with self._count_lock:
                self._by_id.pop(req.id, None)
            self._settle_async(req, exc=ErrorTooManyRequests())

    def _prefill_into(self, slot: int, req: _Request) -> None:
        cfg, pc = self.model_cfg, self.paged_cache
        ids = req.serve_ids  # the prompt plus emitted tokens on a resume
        S = len(ids)
        bucket = batch_ops.pad_bucket(S, self._buckets())
        if pc is not None:
            # pages first: pool pressure requeues before any device work or
            # cache lookup
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
        cache_key = cached = prefix_tier = None
        if self._prefix_cache is not None:
            # sampling params are not in the key: the entry is the
            # pre-sampling prefill output, shared across temperatures. The
            # adapter id is: a cross-adapter hit is impossible
            digest = hashlib.blake2b(np.asarray(ids, np.int32).tobytes(), digest_size=16)
            cache_key = f"prefill:{bucket}:{S}:{digest.hexdigest()}:{req.adapter_id or '-'}"
            cached, prefix_tier = self._cache_lookup(cache_key)
            if cached is None and self._kv_migrator is not None:
                # the handoff from the named prefill replica first, then a
                # replica that advertises this prompt; either failure stays
                # a compute miss. Bounded by what the deadline leaves
                budget = req.remaining(time.monotonic())
                fetched = None
                if req.handoff_from is not None:
                    fetched = self._kv_migrator.fetch_one_handoff(
                        cache_key, req.handoff_from, deadline=budget)
                if fetched is None:
                    fetched = self._kv_migrator.fetch_one(cache_key, deadline=budget)
                # a fetch can block: a thread retired meanwhile must not put
                # slabs into the cache the restart just reset
                self._check_retired()
                if fetched is not None:
                    cached = _to_device(fetched, self.device)  # non_blocking: no sync
                    prefix_tier = "remote"
                    # paid once per replica, not once per request
                    self._prefix_cache.put(cache_key, cached)
            self._record_prefix_tier(req, prefix_tier)
        tl = req.timeline
        if tl is not None:
            tl.stamp("prefill_start")
        # the span closes after _first_token's sync, so it covers the
        # device's work and not only its enqueueing
        span = self._req_span(
            "prefill", f"serve.prefill b{bucket}" + (" (prefix hit)" if cached else ""), req)
        if tl is not None:
            pspan = tl.spans.get("prefill")
            if pspan is not None:
                pspan.set_attribute("prefill.bucket", bucket)
                pspan.set_attribute("prefill.prefix_hit", cached is not None)
                pspan.set_attribute("prefix_tier", prefix_tier or "miss")
                pspan.set_attribute("tokens.prompt", S)
        # the dense cache is bound once, before the long dispatch: after a
        # warm restart replaced this thread, self.cache is the rebuilt one
        dense = self.cache
        with span, self._cold_dispatch("prefill", bucket, cached is not None):
            if cached is not None:
                last_logits, k_slab, v_slab = cached
            else:
                tokens = np.full((1, bucket), self.tokenizer.pad_id, np.int64)
                tokens[0, :S] = ids
                last_logits, k_slab, v_slab = batch_ops.prefill_compute(
                    cfg, self.params, to_device(tokens, self.device),
                    to_device(np.array([S], np.int32), self.device),
                )
            # replaced during the compute: no writes, not even into the
            # prefix cache the restart just cleared
            self._check_retired()
            if cached is None and cache_key is not None:
                # fresh slabs that nothing writes into later: safe to keep
                self._prefix_cache.put(cache_key, (last_logits, k_slab, v_slab))
            if pc is not None:
                pc.write_prefill(slot, k_slab, v_slab)
            elif dense.quantized:
                self.cache = batch_ops.insert_slot_quantized(dense, k_slab, v_slab, slot)
            else:
                dense.k, dense.v = batch_ops.insert_slot(dense.k, dense.v, k_slab, v_slab, slot)
            # the row's delta applies at the sampling site: cached entries
            # stay base-model logits
            logits = self._lora_adjusted(req, last_logits, ids[-1])
            first_id = self._first_token(req, logits)
        self._check_retired()
        # progress: an admission of many prefills may outlast the stall
        # limit in one iteration, and a hung dispatch stamps nothing
        self.heartbeat = time.monotonic()
        self._commit_prefilled(slot, req, first_id, S)

    def _first_token(self, req: _Request, last_logits: torch.Tensor) -> int:
        """Sample a request's first token from its prompt's last-position
        logits [1, V] with a generator seeded by (engine seed, request id),
        as the dispatch that finishes a chunked prompt samples it. A host
        sync: the token is needed now."""
        gen = torch.Generator(device=self.device).manual_seed(_request_seed(self.seed, req.id))
        first = sample_logits(
            last_logits, gen, temperature=req.temperature, top_k=req.top_k, top_p=req.top_p
        )
        # gofrlint: disable=host-sync -- a prefill's sanctioned read: its first token is needed now
        return int(first[0])

    def _commit_prefilled(self, slot: int, req: _Request, first_id: int, resident: int) -> None:
        """Monolithic route: set the slot's mirrors and queue the fold into
        the device state for the next dispatch, then commit the token."""
        self.slots[slot] = req
        self.cache_len[slot] = resident
        self.temperature[slot] = req.temperature
        self.top_k[slot] = req.top_k
        self.top_p[slot] = req.top_p
        self.adapter_idx[slot] = req.adapter_slot
        # the budget folds both limits (max_new and the sequence cap, which
        # submit clamped max_new to) and counts what is left after this
        # token, so a resumed row keeps what it had left
        self._pending_admit[slot] = (
            first_id, resident, req.new_budget - 1, _stop_id(req), req.adapter_slot,
        )
        self._commit_first_token(slot, req, first_id)

    def _commit_first_token(self, slot: int, req: _Request, first_id: int) -> None:
        """The first-token commit both routes share (monolithic prefill,
        and the ragged dispatch that folded the token on the device): TTFT,
        its stamps and series, emission, the one stop/length retire chain,
        and the decode span of a row that goes on."""
        self.last_token[slot] = first_id
        now = time.monotonic()
        resumed = req.first_token_at is not None  # a resume keeps its TTFT
        if not resumed:
            req.first_token_at = now
            ttft = now - req.created
            self._shed.observe_ttft(ttft)
        tl = req.timeline
        if tl is not None:
            # the prefill's end and the first token share the commit (both
            # after the sync that read the token); the first stamp wins, so
            # a resume keeps its first token's
            tl.stamp("prefill_end", now)
            tl.stamp("first_token", now)
            tl.end_span("prefill")  # chunk spans end at their own consumes
        if self._metrics and not resumed:
            self._metrics.record_histogram("app_ttft_seconds", ttft)
            labels = {"source": "engine"}
            if req.tenant:
                labels["tenant"] = req.tenant
            self._metrics.record_histogram("app_request_ttft_seconds", ttft, **labels)
        if req.prefill_only:
            # the disaggregated prefill phase: the prompt's KV and its
            # last-position logits are in the prefix cache for the decode
            # replica's handoff, which samples this same first token from
            # them. Retire before any emission or decode step: emitting
            # here would serve the token twice
            self._retire(slot, "handoff")
            return
        self._emit(req, first_id)
        self._check_retired()
        if first_id in req.stop_ids:
            self._retire(slot, "stop")
        elif len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "length")
        elif tl is not None and self._tracer is not None:
            self._req_span("decode", "serve.decode", req)

    # ---------------------------------------------------------------- decode
    def _decode_step(self, plan: StepPlan) -> bool:
        """Dispatch the next N-step block (the unified ragged dispatch when
        the plan granted chunks), then read the oldest one still
        outstanding once more than ``decode_sync_every`` are in flight.
        Speculative mode takes its own unpipelined step."""
        self._check_retired()  # replaced during a long _admit: unwind first
        if self.config.spec_tokens > 0:
            return self._spec_step()
        inflight = self._dispatch(plan)
        if inflight is not None:
            self._inflight.append(inflight)
        did = inflight is not None
        if self._inflight and (inflight is None or len(self._inflight) > self._sync_every):
            self._consume(self._inflight.popleft())
            did = True
        return did

    def _spec_step(self) -> bool:
        """One speculative decode step: the host drafts up to K tokens per
        greedy row by prompt lookup over prompt + output, one verify
        dispatch runs every row's chunk and samples the bonus tokens, and
        the host commits each row's accepted prefix and bonus. Lossless
        for greedy rows (acceptance is exact argmax equality); sampled
        rows get no drafts and take a plain step. Unpipelined: drafting
        needs the newest tokens, and the host's mirrors are authoritative
        (the device decode state is not used)."""
        cfg = self.model_cfg
        chaos.maybe_fail("decode.dispatch")
        self._maybe_device_loss()
        # a hang at the chaos point can outlive a warm restart: re-check
        # ownership before reading slots or storage that may be rebuilt
        self._check_retired()
        K = self.config.spec_tokens
        T = K + 1
        max_seq = self.config.max_seq_len
        self._pending_admit.clear()  # the host state is authoritative here

        rows: list[tuple[int, _Request]] = []
        now = time.monotonic()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            if req.canceled:
                self._retire(slot, "cancel")
                continue
            if req.expired(now):
                self._retire(slot, "deadline_exceeded")
                continue
            if (len(req.tokens) >= req.max_new_tokens
                    or len(req.prompt_ids) + len(req.tokens) >= max_seq):
                continue  # retires at the limit checks of its last commit
            rows.append((slot, req))
        if not rows:
            return False

        B = self.config.max_slots
        chunk = np.full((B, T), -1, np.int64)
        for slot, req in rows:
            chunk[slot, 0] = self.last_token[slot]
            room = min(req.max_new_tokens - len(req.tokens),
                       max_seq - 1 - (len(req.prompt_ids) + len(req.tokens)))
            if req.temperature == 0 and room > 1:
                draft = llama._prompt_lookup_draft(
                    req.prompt_ids + req.tokens, self.config.spec_ngram, min(K, room - 1),
                )
                chunk[slot, 1:1 + len(draft)] = draft

        pc = self.paged_cache
        if pc is not None and not pc.try_reserve_chunk([s for s, _ in rows], T):
            # pool pressure: one position of coverage per row (the chunk's
            # tail goes to the trash page; no drafts still verifies
            # position 0, a plain step). A row that cannot cover even one
            # more token retires with what it has.
            kept = []
            for slot, req in rows:
                if pc.try_reserve_chunk([slot], 1):
                    chunk[slot, 1:] = -1
                    kept.append((slot, req))
                else:
                    self._log("warn", f"KV pool exhausted; retiring request {req.id} early")
                    req.kv_exhausted = True
                    self._retire(slot, "kv_exhausted")
            rows = kept
            if not rows:
                return True

        mask = np.zeros(B, bool)
        for slot, _ in rows:
            mask[slot] = True
        # counted after the pool-pressure fallback may have cleared drafts
        drafted = int((chunk[mask, 1:] >= 0).sum())
        if self._mask_host is None or not np.array_equal(mask, self._mask_host):
            self._mask_dev = to_device(mask, self.device)
            self._mask_host = mask

        def up(a: np.ndarray) -> torch.Tensor:
            return to_device(a, self.device)

        samp = (up(self.temperature), up(self.top_k), up(self.top_p), self._rng)
        chunk_d, start_d = up(chunk), up(np.maximum(self.cache_len, 1))
        dense = self.cache
        t0 = time.perf_counter()
        with self._cold_dispatch("spec", "dense" if pc is None else "paged",
                                 dense.quantized if pc is None else pc.quantized, K):
            if pc is None:
                packed, new_cache = batch_ops.verify_and_sample(
                    cfg, self.params, dense, chunk_d, start_d, *samp,
                )
            else:
                new_cache = None
                cap = np.zeros(B, np.int32)
                for slot, _ in rows:
                    cap[slot] = pc.owned_capacity(slot)
                args = (pc.tables_device(), chunk_d, start_d, self._mask_dev, up(cap), *samp)
                if pc.quantized:
                    (packed, pc.k_pool, pc.v_pool, pc.ks_pool, pc.vs_pool) = (
                        batch_ops.verify_and_sample_paged_q(cfg, self.params, *pc.pools(), *args)
                    )
                else:
                    packed, pc.k_pool, pc.v_pool = batch_ops.verify_and_sample_paged(
                        cfg, self.params, pc.k_pool, pc.v_pool, *args,
                    )
            packed_np = _block_sync(packed)  # the step's one host sync
        # a warm restart may have replaced this thread while the chunk
        # verified: commit nothing to rebuilt state then
        self._check_retired()
        if new_cache is not None:
            self.cache = new_cache
        self.heartbeat = time.monotonic()  # the sync returned: progress
        step_time = time.perf_counter() - t0
        out_np, na_np = packed_np[:, :-1], packed_np[:, -1]

        accepted = emitted = 0
        for slot, req in rows:
            accepted += int(na_np[slot])
            tl = req.timeline
            if tl is not None:
                # the block counts before its commits: a retire among them
                # queues the settlement, which copies the count into the
                # decode span on the detok worker
                tl.block(0)
            committed = 0
            for i in range(int(na_np[slot]) + 1):
                committed += 1
                self._commit_token(slot, req, int(out_np[slot, i]))
                if self.slots[slot] is not req:
                    break  # retired mid-chunk: the tail is discarded
            emitted += committed
            if tl is not None:
                tl.decode_tokens += committed
            # chunk position 0 (the token emitted last step) and the
            # accepted drafts are now resident; the bonus token becomes the
            # next chunk's position 0
            if self.slots[slot] is req:
                self.cache_len[slot] += committed
                if pc is not None:
                    pc.advance_slot(slot, committed)
        self.spec_stats["dispatches"] += 1
        self.spec_stats["accepted"] += accepted
        self.spec_stats["emitted"] += emitted
        if self._metrics:
            m = self._metrics
            m.record_histogram("app_tpot_seconds", step_time / max(emitted / len(rows), 1))
            m.record_histogram("app_decode_block_seconds", step_time)
            m.set_gauge("app_batch_occupancy", len(rows) / B)
            if drafted:
                # over the tokens drafted: sampled rows and empty lookups
                # must not dilute it
                m.set_gauge("app_spec_accept_rate", accepted / drafted)
        return True

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
            self.temperature, self.top_k, self.top_p, self._rng, self.adapter_idx,
            device=self.device,
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
            col(4, np.int32),
        )

    def _dispatch(self, plan: StepPlan) -> _Inflight | None:
        chaos.maybe_fail("decode.dispatch")
        self._maybe_device_loss()
        # a hang at the chaos point can outlive a warm restart: re-check
        # ownership before reading slots or storage that may be rebuilt
        self._check_retired()
        host_t0 = time.perf_counter()
        pc = self.paged_cache
        N = self._block_steps
        now = time.monotonic()
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
            if slot in self._preempt_pending:
                continue  # no longer fed: the ladder pauses it once drained
            # page coverage for the whole block, including the steps
            # dispatched but not yet read (the device runs ahead of the
            # committed host mirror by every block in flight); a dense slot
            # row covers max_seq_len
            in_flight = req.dispatched - (len(req.tokens) - 1)
            if pc is None or pc.try_reserve_slot(slot, in_flight + N):
                rows.append((slot, req))
                continue
            self._log("warn", f"KV pool exhausted; retiring request {req.id} early")
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
            if slot in self._preempt_pending:
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
        last_logits = None
        new_cache = self.cache
        t0 = time.perf_counter()
        if chunk_rows:
            # with no decode row the dispatch runs the chunks alone (0 steps)
            steps = N if rows else 0
            packed, last_logits, new_cache, new_state = self._dispatch_ragged(
                state, chunk_rows, steps)
        else:
            steps = N
            cfg, params = self.model_cfg, self.params
            lora = self._lora_tables()
            key = ("decode", "dense" if pc is None else "paged",
                   new_cache.quantized if pc is None else pc.quantized, N, lora is not None)
            with self._cold_dispatch(*key):
                if pc is None:
                    packed, new_cache, new_state = batch_ops.decode_block(
                        cfg, params, new_cache, state, self._mask_dev, N, lora,
                    )
                elif pc.quantized:
                    (packed, pc.k_pool, pc.v_pool, pc.ks_pool, pc.vs_pool,
                     new_state) = batch_ops.decode_block_paged_q(
                        cfg, params, *pc.pools(), state, pc.tables_device(), self._mask_dev, N,
                        lora,
                    )
                else:
                    packed, pc.k_pool, pc.v_pool, new_state = batch_ops.decode_block_paged(
                        cfg, params, pc.k_pool, pc.v_pool, state, pc.tables_device(),
                        self._mask_dev, N, lora,
                    )
        # the launch returned: the host is free again (on the card it waited
        # here only while the launch queue was full)
        host_s = time.perf_counter() - host_t0
        self._check_retired()  # commit to self only as the loop's owner
        self.cache, self._dec_state = new_cache, new_state
        prefill_rows = []
        if chunk_rows:
            if self._prefix_cache is None or not self._chunk_cache_enabled:
                last_logits = None  # nothing stores them: let the buffer go
            for row, (slot, cursor, req, start, n) in enumerate(chunk_rows):
                idx = cursor.chunk_index
                cursor.dispatched = start + n
                cursor.chunk_index += 1
                fin = start + n >= cursor.total
                prefill_rows.append((slot, req, cursor, start, n, fin, row, idx))
                if self._tracer is not None and req.timeline is not None:
                    # ends at this chunk's consume, after the block's sync
                    span = self._req_span(f"prefill_chunk:{idx}", "serve.prefill_chunk", req)
                    span.set_attribute("chunk.index", idx)
                    span.set_attribute("chunk.tokens", n)
                    span.set_attribute("chunk.start", start)
                    span.set_attribute("chunk.final", fin)
                    span.set_attribute("prefix_tier", req.timeline.prefix_tier or "miss")
        for _, req in rows:
            req.dispatched += steps
        return _Inflight(packed, rows, steps, prefill_rows, last_logits, dispatched_at=t0,
                         host_s=host_s)

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

    def _lora_tables(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The adapter tables a dispatch reads (None until the first
        upload, and without a registry)."""
        return self._lora.tables() if self._lora is not None else None

    def _dispatch_ragged(
        self, state: batch_ops.DecodeState, chunk_rows: list, steps: int,
    ) -> tuple[torch.Tensor, torch.Tensor, llama.KVCache | None, batch_ops.DecodeState]:
        """Assemble and launch ONE unified ragged dispatch: the granted
        chunks (per-row slices of their prompts in a [B, C] buffer) and the
        decode block, against the same cache or page pool. Rows whose chunk
        completes the prompt get their first token sampled on the device
        and folded into the decode state inside the dispatch. Returns
        (packed, last_logits [K, V] in ``chunk_rows`` order, the dense
        cache (the caller commits it; the paged layout's), state)."""
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
        adapters = np.zeros(B, np.int32)
        slots, seeds = [], []
        for slot, cursor, req, start_pos, n in chunk_rows:
            serve = req.serve_ids  # the prompt plus emitted tokens on a resume
            chunk[slot, :n] = serve[start_pos:start_pos + n]
            start[slot] = start_pos
            finish[slot] = start_pos + n >= cursor.total
            new_len[slot] = start_pos + n
            budgets[slot] = req.new_budget - 1
            adapters[slot] = req.adapter_slot
            stops[slot] = _stop_id(req)
            if pc is not None:
                kvcap[slot] = pc.owned_capacity(slot)
            slots.append(slot)
            seeds.append(_request_seed(self.seed, req.id))

        def up(a: np.ndarray) -> torch.Tensor:
            return to_device(a, self.device)

        lora = self._lora_tables()
        rows = up(np.array(slots, np.int64))
        tail = (up(finish), up(new_len), up(budgets), up(stops), up(self.temperature),
                up(self.top_k), up(self.top_p), seeds, self._mask_dev, steps,
                up(adapters) if lora is not None else None, lora)
        cfg, params, dense = self.model_cfg, self.params, self.cache
        key = ("ragged", "dense" if pc is None else "paged",
               dense.quantized if pc is None else pc.quantized, self._block_steps,
               lora is not None)
        with self._cold_dispatch(*key):
            if pc is None:
                packed, last_logits, dense, new_state = batch_ops.ragged_step(
                    cfg, params, dense, state, up(chunk), up(start), rows, *tail,
                )
                return packed, last_logits, dense, new_state
            args = (pc.tables_device(), up(chunk), up(start), rows, up(kvcap), *tail)
            if pc.quantized:
                (packed, last_logits, pc.k_pool, pc.v_pool, pc.ks_pool, pc.vs_pool,
                 new_state) = batch_ops.ragged_step_paged_q(cfg, params, *pc.pools(), state,
                                                             *args)
            else:
                packed, last_logits, pc.k_pool, pc.v_pool, new_state = (
                    batch_ops.ragged_step_paged(cfg, params, pc.k_pool, pc.v_pool, state, *args)
                )
        return packed, last_logits, None, new_state

    def _consume(self, rec: _Inflight) -> None:
        packed = _block_sync(rec.packed)  # the block's one host-device sync
        # a warm restart may have replaced this thread while it waited: its
        # tokens belong to requests already settled or requeued
        self._check_retired()
        self.heartbeat = time.monotonic()  # the sync returned: progress
        now = time.perf_counter()
        # the block's wall time: from the previous consume (the pipeline's
        # cadence), or from its launch after an idle gap
        step_time = now - (self._last_consume_t if self._last_consume_t is not None
                           else rec.dispatched_at)
        self._last_consume_t = now
        n_active = 0
        for slot, req in rec.rows:
            if self.slots[slot] is not req:
                continue  # retired (and maybe re-admitted) since dispatch
            n_active += 1
            n_valid = int(packed[slot, rec.steps + 1])
            device_done = bool(packed[slot, rec.steps])
            tl = req.timeline
            if tl is not None:
                # the block counts before its commits: a retire among them
                # queues the settlement, which copies the count into the
                # decode span on the detok worker (the reference counts it
                # after, and its span can miss the last block: Queue C 23)
                tl.block(0)
            committed = 0
            for i in range(n_valid):
                self._commit_token(slot, req, int(packed[slot, i]))
                committed += 1
                if self.slots[slot] is not req:
                    break  # retired mid-block: the tail is discarded
            if tl is not None:
                # the committed tokens only: a mid-block retire drops the tail
                tl.decode_tokens += committed
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
        # residency and feed the chunk-prefix cache; a row whose prompt
        # finished takes its first token from the trailing column of the
        # same packed read
        for slot, req, cursor, start, n, fin, row, idx in rec.prefill_rows:
            if self.slots[slot] is not req or self._cursors.get(slot) is not cursor:
                continue  # retired or requeued since dispatch: a stale chunk
            n_active += 1
            cursor.committed = start + n
            self.cache_len[slot] = cursor.committed
            if self.paged_cache is not None:
                self.paged_cache.advance_slot(slot, n)
            tl = req.timeline
            if tl is not None:
                tl.chunk(idx, n, prefix_hit=False, start=start)
                tl.end_span(f"prefill_chunk:{idx}")
            if self._metrics:
                self._metrics.record_histogram("app_prefill_chunk_tokens", n, kind="compute")
            # only whole-chunk spans have a precomputed key (the planner
            # grants whole chunks from a chunk boundary); a missing key
            # skips the put
            put_key = (cursor.cache_keys or {}).get((start, start + n))
            if rec.last_logits is not None and put_key is not None:
                entry = self._chunk_entry(rec.last_logits, row, slot, start, n)
                self._prefix_cache.put(put_key, entry)
            if fin:
                self._cursors.pop(slot)
                self._commit_first_token(slot, req, int(packed[slot, rec.steps + 2]))
        if self._metrics and n_active:
            self._observe_block(rec, step_time, now, n_active)

    def _observe_block(self, rec: _Inflight, step_time: float, now: float,
                       n_active: int) -> None:
        """The block's series, from host values only: its wall time, the
        host's share of it (``host_s`` and this consume after its sync),
        occupancy, resident tokens from the host mirror and the detok
        backlog."""
        m = self._metrics
        host_ms = (rec.host_s + (time.perf_counter() - now)) * 1e3
        # a chunks-only dispatch (0 decode steps) counts as one step
        steps = max(rec.steps, 1)
        m.record_histogram("app_tpot_seconds", step_time / steps)
        m.record_histogram("app_decode_block_seconds", step_time)
        m.set_gauge("app_batch_occupancy", n_active / self.config.max_slots)
        m.set_gauge("app_kv_cache_pages_used",
                    int(sum(int(self.cache_len[s]) for s, _ in rec.rows)))
        m.set_gauge("app_decode_host_ms_per_step", host_ms / steps)
        m.set_gauge("app_decode_block_size", rec.steps)
        with self._detok_mu:
            depth = self._detok_depth
        m.set_gauge("app_detok_queue_depth", depth)

    def _chunk_entry(self, last_logits: torch.Tensor, row: int, slot: int, start: int,
                     n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """A chunk-prefix cache entry (logits [1, V], k_slab, v_slab
        [L, n, Hkv, Dh]) for a chunk that just became resident: device
        reads with no sync. Every tensor is a fresh copy: a slice of the
        dense cache is a VIEW of the live slot row, which the slot's next
        admission overwrites, and a row of ``last_logits`` would keep the
        whole [K, V] buffer alive."""
        logits = last_logits[row:row + 1].clone()
        if self.paged_cache is not None:
            return (logits, *self.paged_cache.read_span(slot, start, start + n))
        return (logits, self.cache.k[:, slot, start:start + n].clone(),
                self.cache.v[:, slot, start:start + n].clone())

    # ----------------------------------------------------------- bookkeeping
    def _commit_token(self, slot: int, req: _Request, token_id: int) -> None:
        """Deliver one decoded token and run the retire chain."""
        self.last_token[slot] = token_id
        self._emit(req, token_id)
        self._check_retired()
        if req.canceled:
            self._retire(slot, "cancel")
        elif req.expired(time.monotonic()):
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
                    self._log("warn", f"stream callback of request {req.id} failed ({exc!r}); canceling it")
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
        if req is not None and req.timeline is not None:
            # the decode span's residency, from the host mirrors before the
            # slot is reclaimed
            dspan = req.timeline.spans.get("decode")
            if dspan is not None:
                resident = int(self.cache_len[slot])
                dspan.set_attribute("batch.size", sum(1 for s in self.slots if s is not None))
                dspan.set_attribute("kv.resident_tokens", resident)
                if self.paged_cache is not None:
                    page = self.config.kv_page_size
                    dspan.set_attribute("kv.pages", (resident + page - 1) // page)
        self.slots[slot] = None
        self._cursors.pop(slot, None)
        self._preempt_pending.discard(slot)
        self.cache_len[slot] = 0
        self.adapter_idx[slot] = 0
        self._free_kv(slot)
        self._sched.release(slot)
        if req is not None:
            self._lora_release(req)
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
        self._flush_busy()  # a settled request implies recorded busy time
        now = time.monotonic()
        self._shed.observe_request(now - req.created)
        if self._metrics:
            if reason == "deadline_exceeded":
                self._metrics.increment_counter("app_requests_deadline_exceeded_total")
            elif reason == "kv_exhausted":
                self._metrics.increment_counter("app_requests_kv_exhausted_total")
            labels = {"tenant": req.tenant} if req.tenant else {}
            self._metrics.record_histogram("app_request_e2e_seconds", now - req.created,
                                           **labels)
        out_ids = [t for t in req.tokens if t not in req.stop_ids]
        ttft = (req.first_token_at - req.created) if req.first_token_at else 0.0
        # the off-engine-thread tail (detokenization, the done frame, the
        # settlement); it ends at the terminal mark
        if self._tracer is not None:
            self._req_span("detok", "serve.detok", req)

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
        """The engine thread's terminal settlement on the detok worker,
        behind the request's token frames; inline once the worker has shut
        down, so a terminal state is never lost. A result (``build()``'s,
        made there) fires the done frame and then resolves the future, and
        stamps ``detok_done``; a failure (``exc``) fails the future first
        and fires the done frame after, the engine's settlement contract a
        router's stream claim reads: a dead attempt's done frame must not
        claim the stream before its failure is visible."""

        def done_frame() -> None:
            if req.stream_cb is not None:
                try:
                    req.stream_cb(-1, "", True)
                except Exception:
                    pass  # the client is gone; the future still settles

        def settle() -> None:
            value = None if build is None else build()
            if exc is None:
                done_frame()
            tl = req.timeline
            if value is not None and tl is not None:
                tl.stamp("detok_done")
            if not self._try_resolve(req, value=value, exc=exc) and tl is not None:
                # a drain or stop sweep settled it first and closed the
                # spans before this path opened its own: close them again
                tl.close_spans()
            if exc is not None:
                done_frame()

        if not self._submit_detok(settle):
            settle()

    def _try_resolve(self, req: _Request, value: Any = None,
                     exc: Exception | None = None) -> bool:
        """Resolve a request's future once; a second settler loses quietly.
        The winner, and only the winner, marks the request's timeline
        terminal and ends its open spans: every request id gets exactly
        one terminal mark, whichever path (the detok worker, a drain or
        stop sweep, a refused submit) settles it."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(value)
        except concurrent.futures.InvalidStateError:
            return False
        self._record_terminal(req, value, exc)
        # the winner, and only the winner, settles the idempotency entry: a
        # result is kept for duplicates to replay, an exception forgets the
        # key so a client's retry runs as a fresh request
        if req.idem_key is not None:
            if exc is None and value is not None:
                self._dedup.settle(req.idem_key, value)
            else:
                self._dedup.forget(req.idem_key)
        return True

    @staticmethod
    def _terminal_reason(value: Any, exc: Exception | None) -> str:
        if value is not None:
            return getattr(value, "finish_reason", "stop")
        if isinstance(exc, ErrorDeadlineExceeded):
            return "deadline_exceeded"
        if isinstance(exc, ErrorTooManyRequests):
            return "shed"
        if isinstance(exc, ErrorServiceUnavailable):
            return "unavailable"
        if isinstance(exc, ErrorRequestEntityTooLarge):
            return "too_large"
        return "error"

    def _record_terminal(self, req: _Request, value: Any, exc: Exception | None) -> None:
        tl = req.timeline
        if tl is None:
            return
        dspan = tl.spans.get("decode")
        if dspan is not None:
            dspan.set_attribute("tokens.out", len(req.tokens))
            dspan.set_attribute("decode.blocks", tl.decode_blocks)
        reason = self._terminal_reason(value, exc)
        # a snapshot: the engine thread may open a span while a sweep
        # settles (the opener closes again, in _settle_async)
        for span in list(tl.spans.values()):
            if span.end_ns is None:  # an ended span is already exported
                span.set_attribute("request.finish_reason", reason)
        self.timeline.finish(tl, reason)

    def _observe_queue(self, depth: int | None = None) -> None:
        if self._metrics:
            if depth is None:
                depth = self._sched.pending()
            self._metrics.set_gauge("app_batch_queue_depth", depth)

    def _req_span(self, key: str, name: str, req: _Request) -> Any:
        """Open a span of one request, parented on its queue span (the tree
        reads caller, ``engine.queue``, then prefill, decode and detok) or
        on the caller's span, and register it on the request's timeline so
        the terminal mark ends whatever a fault path left open. A context
        manager either way (a null one without a tracer); ``activate=False``
        leaves the engine thread's context alone."""
        if self._tracer is None:
            return contextlib.nullcontext()
        tl = req.timeline
        parent = (tl.spans.get("queue") if tl is not None else None) or req.trace_ctx
        span = self._tracer.start_span(name, parent=parent, kind="internal", activate=False)
        span.set_attribute("request.id", req.id)
        if req.tenant:
            span.set_attribute("tenant", req.tenant)
        if req.adapter_id:
            span.set_attribute("lora.adapter", req.adapter_id)
        if tl is not None:
            tl.open_span(key, span)
        return span

    def _settle_future(self, req: _Request, exc: Exception) -> None:
        """Fail a request from outside the engine thread (drain, stop), and
        wake a stream consumer with its done frame."""
        if self._try_resolve(req, exc=exc) and req.stream_cb is not None:
            try:
                req.stream_cb(-1, "", True)
            except Exception:
                pass

    # ------------------------------------------------------------ device loss
    def _reset_prefix_cache(self) -> None:
        """A device-level failure may have taken cached slabs with it: a
        cold prefix cache only costs recompute. An injected cache without
        ``clear()`` is dropped rather than kept."""
        if self._prefix_cache is None:
            return
        clear = getattr(self._prefix_cache, "clear", None)
        try:
            if clear is not None:
                clear()
            else:
                self._prefix_cache = None
        except Exception:
            self._prefix_cache = None

    def _maybe_device_loss(self) -> None:
        """The ``device.loss`` chaos point: when it fires, the KV storage
        is poisoned for real before the fault propagates, so recovery runs
        the genuine rebuild."""
        try:
            chaos.maybe_fail("device.loss")
        except Exception:
            self._poison_device()
            raise

    def _poison_device(self) -> None:
        """Release the KV storage the way a lost device leaves it: each
        tensor becomes a 0-element one on the same device. The memory goes
        back to the allocator, and every later use raises on the host
        before any launch (the kernel wrappers refuse a 0-element pool; a
        dense cache read fails its shape checks), where a kernel handed
        the released address would leave the CUDA context in a sticky
        error no restart can heal."""
        holder, names = ((self.cache, ("k", "v", "ks", "vs")) if self.cache is not None
                         else (self.paged_cache, ("k_pool", "v_pool", "ks_pool", "vs_pool")))
        if holder is None:
            return
        for name in names:
            t = getattr(holder, name)
            if t is not None:
                setattr(holder, name, t.new_empty(0))

    def _kv_unhealthy(self) -> bool:
        """True when the KV storage cannot serve another step: released (0
        elements), or a one-element probe raises (a device in an error
        state; the probe waits for the stream)."""
        arr = (self.cache.k if self.cache is not None
               else self.paged_cache.k_pool if self.paged_cache is not None else None)
        if arr is None:
            return False
        try:
            if arr.numel() == 0:
                return True
            arr.reshape(-1)[0].item()
            return False
        except Exception:
            return True

    def _rebuild_kv(self) -> None:
        """Reallocate the KV storage after a device loss, the old storage
        released first. Every slot's residency is gone: this runs only in
        _fail_all, where every active request fails."""
        if self.paged_cache is not None:
            self.paged_cache.reset_pools()
        else:
            self.cache = None
            self.cache = self._make_dense_cache()
        self._log("warn", "KV storage rebuilt after a failed dispatch deleted the donated "
                          "device buffers")

    def _fail_all(self, exc: Exception, kv_unhealthy: bool | None = None) -> None:
        """A failed step leaves the pipeline unknown: drop the in-flight
        blocks, rebuild the device state from the mirrors next time, and
        fail every active request. KV storage that the failure took with
        it (``kv_unhealthy``, probed when None) is rebuilt in place and the
        prefix cache cleared; ``device_poisonings`` counts those, and the
        supervisor escalates a storm of them to a warm restart."""
        self._inflight.clear()
        self._pending_admit.clear()
        self._cursors.clear()
        self._preempt_pending.clear()
        self._dec_state = None
        self._mask_host = self._mask_dev = None
        self._last_consume_t = None
        if kv_unhealthy is None:
            kv_unhealthy = self._kv_unhealthy()
        if kv_unhealthy:
            self.device_poisonings += 1
            try:
                self._rebuild_kv()
            except Exception as rebuild_exc:
                # the device still refuses: the next failure retries
                self._log("error", f"KV rebuild failed: {rebuild_exc}")
            self._reset_prefix_cache()
        for slot, req in enumerate(self.slots):
            if req is not None:
                self.slots[slot] = None
                self.cache_len[slot] = 0
                self.adapter_idx[slot] = 0
                self._lora_release(req)
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
