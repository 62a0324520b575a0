"""StubReplicaEngine: an in-process engine replica double for router
tests (a copy of ``gofr_tpu/testutil/replica.py`` that raises the port's
``ErrorServiceUnavailable``, so a port router's failover takes its
refusals as retriable; the port's router tests drive it).

Implements the ``ServingEngine`` submit surface — ``submit(prompt,
deadline=, stream_cb=) -> Future``, ``cancel``, ``drain``,
``health_check`` — with a worker thread per request emitting tokens at a
fixed cadence, plus the fault controls the chaos tier drives:

- ``kill()``: the replica process dies — in-flight requests fail with
  the warm-restart contract (503 retriable + Retry-After), new
  submits are refused retriable;
- ``wedge()``: the engine stops making progress; after
  ``supervisor_detect_s`` the (simulated) supervisor fails in-flight
  requests retriable and parks the replica WEDGED;
- ``drain()``: in-flight streams run to completion, new submits are
  refused retriable (the DRAINING contract);
- ``revive()``: back to UP (heartbeat-partition scenarios, where the
  replica was never actually unhealthy).

Every request's terminal transition is recorded in ``terminals`` and a
double settlement (the invariant violation the router chaos suite hunts)
is captured in ``double_terminals`` instead of racing an assert inside a
worker thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable

from gofr_tpu_torch.errors import ErrorServiceUnavailable

UP = "UP"
DRAINING = "DRAINING"
WEDGED = "WEDGED"
DOWN = "DOWN"


@dataclasses.dataclass
class StubResult:
    """GenerationResult-shaped terminal payload."""

    request_id: int
    text: str
    token_ids: list[int]
    prompt_tokens: int
    completion_tokens: int
    finish_reason: str
    ttft_s: float
    duration_s: float


class _StubRequest:
    def __init__(self, rid: int, prompt: Any, max_new: int,
                 deadline_abs: float | None, stream_cb: Any) -> None:
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_abs = deadline_abs
        self.stream_cb = stream_cb
        self.future: Any = Future()
        self.future.request_id = rid
        self.canceled = threading.Event()
        self.tokens: list[int] = []


class StubReplicaEngine:
    def __init__(
        self,
        replica_id: str = "replica",
        *,
        tokens: int = 4,
        token_interval_s: float = 0.002,
        first_token_delay_s: float = 0.0,
        supervisor_detect_s: float = 0.05,
    ) -> None:
        self.replica_id = replica_id
        self.tokens = tokens
        self.token_interval_s = token_interval_s
        self.first_token_delay_s = first_token_delay_s
        self.supervisor_detect_s = supervisor_detect_s
        self.state = UP
        self._mu = threading.Lock()
        self._next_rid = 0
        self._live: dict[int, _StubRequest] = {}
        self._killed = threading.Event()
        self._wedged = threading.Event()
        # test-visible bookkeeping
        self.submissions: list[dict[str, Any]] = []
        self.terminals: dict[int, str] = {}
        self.double_terminals: list[int] = []
        self.cancels: list[int] = []
        # knobs tests poke to shape heartbeats (spill / least-wait tests)
        self.report_queue_wait_s = 0.0
        self.report_queue_depth = 0
        self.slots_total = 4

    # -- engine surface --------------------------------------------------------
    def submit(self, prompt: Any, *, max_new_tokens: int | None = None,
               deadline: float | None = None,
               stream_cb: Callable[[int, str, bool], None] | None = None,
               **kw: Any) -> Any:
        with self._mu:
            if self.state in (DOWN, WEDGED):
                raise ErrorServiceUnavailable(
                    f"replica {self.replica_id} {self.state.lower()}; retry "
                    "on another replica", retry_after=0.1,
                )
            if self.state == DRAINING:
                raise ErrorServiceUnavailable(
                    f"replica {self.replica_id} draining; retry on another "
                    "replica", retry_after=1.0,
                )
            self._next_rid += 1
            rid = self._next_rid
            deadline_abs = (
                time.monotonic() + deadline
                if deadline is not None and deadline > 0 else None
            )
            req = _StubRequest(
                rid, prompt, max_new_tokens or self.tokens, deadline_abs,
                stream_cb,
            )
            self._live[rid] = req
            self.submissions.append({
                "rid": rid, "prompt": prompt, "deadline": deadline,
                "t": time.monotonic(),
            })
        worker = threading.Thread(
            target=self._run, args=(req,), daemon=True,
            name=f"stub-{self.replica_id}-{rid}",
        )
        worker.start()
        return req.future

    def cancel(self, request_id: int) -> None:
        with self._mu:
            req = self._live.get(request_id)
            self.cancels.append(request_id)
        if req is not None:
            req.canceled.set()

    def drain(self, deadline_s: float | None = None) -> None:
        with self._mu:
            if self.state == UP:
                self.state = DRAINING

    def health_check(self) -> dict[str, Any]:
        with self._mu:
            live = len(self._live)
            depth = self.report_queue_depth
            wait = self.report_queue_wait_s
        # the announcer computes queue_wait = depth/slots × ewma; report
        # depth == slots so the hint passes through unchanged
        return {
            "status": self.state,
            "details": {
                "slots_total": self.slots_total,
                "slots_active": min(live, self.slots_total),
                "queue_depth": depth if depth else (self.slots_total if wait else 0),
                "shed": {"ewma_request_s": wait, "ewma_ttft_s": 0.0},
                "kv_pages": {"free_blocks": 64, "total_blocks": 64},
            },
        }

    # -- fault controls --------------------------------------------------------
    def kill(self) -> None:
        """Abrupt death: in-flight requests fail retriable NOW (the
        warm-restart 503 contract), new submits are refused."""
        with self._mu:
            self.state = DOWN
        self._killed.set()

    def wedge(self) -> None:
        """Progress stops; after ``supervisor_detect_s`` the simulated
        supervisor fails in-flight retriable and parks the replica."""
        with self._mu:
            self.state = WEDGED
        timer = threading.Timer(self.supervisor_detect_s, self._wedged.set)
        timer.daemon = True
        timer.start()

    def revive(self) -> None:
        with self._mu:
            self.state = UP
        self._killed.clear()
        self._wedged.clear()

    # -- worker ----------------------------------------------------------------
    def _record_terminal(self, req: _StubRequest, reason: str) -> bool:
        with self._mu:
            self._live.pop(req.rid, None)
            if req.rid in self.terminals:
                self.double_terminals.append(req.rid)
                return False
            self.terminals[req.rid] = reason
            return True

    def _settle_result(self, req: _StubRequest, reason: str,
                       started: float) -> None:
        if not self._record_terminal(req, reason):
            return
        if req.stream_cb is not None:
            req.stream_cb(0, "", True)
        req.future.set_result(StubResult(
            request_id=req.rid,
            text="tok" * len(req.tokens),
            token_ids=list(req.tokens),
            prompt_tokens=len(str(req.prompt)),
            completion_tokens=len(req.tokens),
            finish_reason=reason,
            ttft_s=self.first_token_delay_s,
            duration_s=time.monotonic() - started,
        ))

    def _settle_error(self, req: _StubRequest, exc: Exception,
                      reason: str) -> None:
        if not self._record_terminal(req, reason):
            return
        # mirror ServingEngine._settle_future's contract: the future
        # fails FIRST, the stream's terminal frame fires after — the
        # router must not let that trailing done-frame claim the stream
        # for a dead attempt (it would cancel the failover re-route)
        req.future.set_exception(exc)
        if req.stream_cb is not None:
            req.stream_cb(-1, "", True)

    def _run(self, req: _StubRequest) -> None:
        started = time.monotonic()
        if self.first_token_delay_s:
            self._interruptible_wait(req, self.first_token_delay_s)
        emitted = 0
        while True:
            if self._killed.is_set():
                self._settle_error(req, ErrorServiceUnavailable(
                    f"replica {self.replica_id} restarting; retry",
                    retry_after=0.1,
                ), "failed_retriable")
                return
            if self._wedged.is_set():
                self._settle_error(req, ErrorServiceUnavailable(
                    f"replica {self.replica_id} wedged; retry on another "
                    "replica", retry_after=1.0,
                ), "failed_retriable")
                return
            if req.canceled.is_set():
                self._settle_result(req, "cancel", started)
                return
            if (req.deadline_abs is not None
                    and time.monotonic() > req.deadline_abs):
                self._settle_result(req, "deadline_exceeded", started)
                return
            if self.state == WEDGED:
                # wedged but not yet detected: no progress, just wait
                self._interruptible_wait(req, self.token_interval_s)
                continue
            if emitted >= req.max_new:
                self._settle_result(req, "length", started)
                return
            token_id = 100 + emitted
            req.tokens.append(token_id)
            emitted += 1
            if req.stream_cb is not None:
                req.stream_cb(token_id, "tok", False)
            self._interruptible_wait(req, self.token_interval_s)

    def _interruptible_wait(self, req: _StubRequest, seconds: float) -> None:
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if (req.canceled.is_set() or self._killed.is_set()
                    or self._wedged.is_set()):
                return
            remaining = deadline - time.monotonic()
            req.canceled.wait(min(0.005, max(remaining, 0.0)))
