"""Token-budget step scheduling for continuous batching (a copy of
``gofr_tpu/serving/stepplan.py``; the port imports nothing of the JAX
package).

Each engine iteration a :class:`StepPlanner` assembles ONE
:class:`StepPlan` that mixes

- every live decode row (decode is reserved FIRST, the starvation
  guarantee: however much prefill work is queued, the next N-step decode
  block always dispatches), and
- up to ``prefill_chunk_tokens`` of prefill-chunk work, granted to the
  oldest partially prefilled requests (their :class:`ChunkCursor` carries
  the per-request chunk position between iterations), plus an admission
  quota for fresh requests.

The mechanism half, running the granted chunks and the decode block in one
unified ragged dispatch against the page pool, lives in
``serving/batch.py`` (``ragged_step_paged*``) and ``serving/engine.py``.

Budget policy:

- ``step_token_budget == 0`` (auto, the default) reserves the decode
  block implicitly and grants exactly ``prefill_chunk_tokens`` of prefill
  per iteration: neither side can starve the other.
- An explicit ``step_token_budget`` is a hard per-iteration token target:
  decode rows (``rows * block_steps`` tokens) are subtracted first and
  prefill chunks fill whatever remains.
- Chunk grants are whole chunks (or the prompt's final ragged tail) and go
  to cursors OLDEST FIRST, so a long prompt drains steadily; the
  admission quota never drops below one while the queue is non-empty.

Pure policy: no device work, no locks; the engine thread is the only
caller. Left out against the reference: the chaos point, tenant
priorities (grants walk admission order alone) and the cursor fields of
the prefix cache and the timelines, which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class ChunkCursor:
    """Per-request chunked-prefill carry: which prefix of the prompt is
    committed to KV, and how far ahead dispatched but unconsumed chunk work
    runs (the device writes ahead of the committed host mirror by the
    in-flight ragged dispatches, like decode's dispatched-ahead gap)."""

    req: Any  # the engine's _Request
    slot: int
    total: int  # prompt tokens to prefill
    seq: int  # admission order (FIFO grant order)
    committed: int = 0  # tokens confirmed resident at a consume
    dispatched: int = 0  # tokens handed to a ragged dispatch
    allocated: bool = False  # slot pages claimed
    blocked: bool = False  # KV-pool pressure: requeue once not in flight

    @property
    def remaining(self) -> int:
        return self.total - self.dispatched

    @property
    def in_flight(self) -> int:
        return self.dispatched - self.committed

    @property
    def done(self) -> bool:
        return self.committed >= self.total


@dataclasses.dataclass
class StepPlan:
    """One iteration's work assignment, assembled before any dispatch."""

    decode_rows: int  # live rows the block serves
    decode_tokens: int  # rows * block_steps (reserved)
    prefill_budget: int  # chunk + admission tokens granted
    grants: list[tuple[int, int]]  # (slot, tokens) chunk grants
    admit_cap: int  # fresh admissions this step
    budget_left: int  # after chunk grants

    @property
    def prefill_tokens(self) -> int:
        return sum(n for _, n in self.grants)


class StepPlanner:
    """Assembles one :class:`StepPlan` per engine iteration."""

    def __init__(
        self,
        *,
        chunk_tokens: int,
        block_steps: int,
        step_token_budget: int = 0,
        max_admissions: int = 4,
    ) -> None:
        if chunk_tokens <= 0:
            raise ValueError("prefill_chunk_tokens must be positive")
        self.chunk_tokens = int(chunk_tokens)
        self.block_steps = max(1, int(block_steps))
        self.step_token_budget = max(0, int(step_token_budget))
        self.max_admissions = max(1, int(max_admissions))

    def plan(
        self,
        *,
        decode_rows: int,
        cursors: list[ChunkCursor],
        free_slots: int,
        queue_depth: int,
    ) -> StepPlan:
        """Decode first, then chunk grants oldest cursor first, then an
        admission quota out of the leftover budget."""
        decode_tokens = decode_rows * self.block_steps
        if self.step_token_budget:
            prefill_budget = max(0, self.step_token_budget - decode_tokens)
        else:
            # auto: decode is implicitly reserved (the block dispatches
            # regardless); prefill gets one chunk budget per iteration
            prefill_budget = self.chunk_tokens
        budget = prefill_budget
        grants: list[tuple[int, int]] = []
        for cur in sorted(cursors, key=lambda c: c.seq):
            if budget <= 0:
                break
            if cur.blocked or cur.remaining <= 0:
                continue
            # grants are WHOLE chunks (or the prompt's final ragged tail),
            # never budget-truncated partials, so chunk boundaries stay on
            # the page grid; a cursor whose next chunk does not fit the
            # remaining budget waits an iteration
            grant = min(self.chunk_tokens, cur.remaining)
            if grant > budget:
                continue
            grants.append((cur.slot, grant))
            budget -= grant
        # fresh admissions scale with leftover budget and free slots; the
        # quota never drops below one while the queue is non-empty, so a
        # saturated batch cannot strand the queue
        admit_cap = 0
        if queue_depth > 0:
            admit_cap = 1
            if free_slots > 0 and budget > 0:
                admit_cap = min(self.max_admissions, max(free_slots, 1))
        return StepPlan(
            decode_rows=decode_rows,
            decode_tokens=decode_tokens,
            prefill_budget=prefill_budget,
            grants=grants,
            admit_cap=admit_cap,
            budget_left=budget,
        )
