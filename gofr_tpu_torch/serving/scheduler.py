"""Priority + FIFO admission scheduler with a prefill token budget (a copy
of ``PyScheduler`` in ``gofr_tpu/native/fallback.py``, the semantics of the
reference's native scheduler; the port imports nothing of the JAX package).

Requests queue by priority class, lower first, FIFO within a class; a
requeue after transient pressure goes to the front of its class. Cancel is
a flag that resolves at admission: ``admit`` hands canceled ids back
beside the (request, slot) pairs it admits, each into the lowest free
slot. A later prompt longer than what is left of ``prefill_token_budget``
waits for the next round. The engine owns the slots' state; the scheduler
only knows which are taken, and ``release`` of a free slot raises.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque


class QueueFull(RuntimeError):
    """The queue holds ``max_queue`` requests."""


class Scheduler:
    """Priority + FIFO admission scheduler with a prefill token budget."""

    def __init__(self, max_slots: int, max_queue: int, prefill_token_budget: int) -> None:
        if max_slots <= 0 or max_queue <= 0 or prefill_token_budget <= 0:
            raise ValueError("all scheduler sizes must be positive")
        self.max_slots = max_slots
        self.max_queue = max_queue
        self.prefill_token_budget = prefill_token_budget
        self._slots: list[int | None] = [None] * max_slots
        self._queues: OrderedDict[int, deque] = OrderedDict()
        self._meta: dict[int, dict] = {}
        self._total_admitted = 0
        self._total_canceled = 0
        self._mu = threading.Lock()

    def submit(self, req_id: int, prompt_len: int, max_new_tokens: int,
               priority: int = 0, front: bool = False) -> None:
        with self._mu:
            if req_id in self._meta:
                raise KeyError(f"request {req_id} exists")
            if sum(len(q) for q in self._queues.values()) >= self.max_queue:
                raise QueueFull()
            meta = {"prompt_len": prompt_len, "max_new": max_new_tokens,
                    "priority": priority, "canceled": False}
            self._meta[req_id] = meta
            q = self._queues.setdefault(priority, deque())
            q.appendleft(req_id) if front else q.append(req_id)
            # keep the classes sorted, lower priority first
            self._queues = OrderedDict(sorted(self._queues.items()))

    def cancel(self, req_id: int) -> None:
        """Flag a queued request; ``KeyError`` when it is not queued."""
        with self._mu:
            self._meta[req_id]["canceled"] = True
            self._total_canceled += 1

    def pending(self) -> int:
        """Queued requests, canceled ones included (they resolve only
        through ``admit``)."""
        with self._mu:
            return sum(len(q) for q in self._queues.values())

    def admit(self, cap: int) -> tuple[list[tuple[int, int]], list[int]]:
        """Returns ([(req_id, slot)...], [canceled_req_ids...])."""
        with self._mu:
            admitted: list[tuple[int, int]] = []
            canceled: list[int] = []
            budget = self.prefill_token_budget
            for priority in list(self._queues):
                q = self._queues[priority]
                while q and len(admitted) < cap:
                    rid = q[0]
                    meta = self._meta[rid]
                    if meta["canceled"]:
                        canceled.append(rid)
                        del self._meta[rid]
                        q.popleft()
                        continue
                    if admitted and meta["prompt_len"] > budget:
                        break  # the next class may hold shorter prompts
                    try:
                        slot = self._slots.index(None)
                    except ValueError:
                        return admitted, canceled
                    self._slots[slot] = rid
                    admitted.append((rid, slot))
                    budget -= meta["prompt_len"]
                    self._total_admitted += 1
                    del self._meta[rid]
                    q.popleft()
                    if budget <= 0:
                        return admitted, canceled
                if len(admitted) >= cap:
                    break
            return admitted, canceled

    def release(self, slot: int) -> None:
        with self._mu:
            if self._slots[slot] is None:
                raise KeyError(f"slot {slot} already free")
            self._slots[slot] = None

    def stats(self) -> dict[str, int]:
        with self._mu:
            return {
                "queue_depth": sum(len(q) for q in self._queues.values()),
                "busy_slots": sum(1 for s in self._slots if s is not None),
                "max_slots": self.max_slots,
                "total_admitted": self._total_admitted,
                "total_canceled": self._total_canceled,
            }
