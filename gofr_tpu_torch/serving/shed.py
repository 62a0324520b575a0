"""Load shedding: an EWMA queue-wait estimator for admission control (a
copy of ``gofr_tpu/serving/shed.py``; the port imports nothing of the JAX
package).

Rejecting early costs microseconds; admitting a request that will wait
past its deadline costs a 504 after seconds of queueing. The estimate is
two EWMAs updated on the engine thread and one multiply on the submit
path:

    wait ≈ (queue_depth / max_slots) × EWMA(request service time)

An empty queue estimates 0.0: an idle engine never sheds. Before the first
completed request the service time falls back to the TTFT EWMA, then to
``cold_prior_s`` (0.0 by default, so a cold engine sheds nothing).
"""

from __future__ import annotations

import threading


class QueueWaitEstimator:
    """Thread-safe EWMA estimator of queue wait for a slot-based engine."""

    def __init__(self, alpha: float = 0.25, cold_prior_s: float = 0.0) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if cold_prior_s < 0.0:
            raise ValueError("cold_prior_s must be >= 0")
        self.alpha = alpha
        self.cold_prior_s = cold_prior_s
        self._mu = threading.Lock()
        self._ttft_s: float | None = None
        self._req_s: float | None = None

    def _blend(self, prev: float | None, obs: float) -> float:
        if prev is None:
            return obs
        return prev + self.alpha * (obs - prev)

    def observe_ttft(self, seconds: float) -> None:
        with self._mu:
            self._ttft_s = self._blend(self._ttft_s, max(0.0, seconds))

    def observe_request(self, seconds: float) -> None:
        """One completed request's total service time (submit → terminal)."""
        with self._mu:
            self._req_s = self._blend(self._req_s, max(0.0, seconds))

    def estimate_wait(self, queue_depth: int, max_slots: int) -> float:
        """Predicted seconds a request submitted now waits behind the
        ``queue_depth`` requests ahead of it; 0.0 at an empty queue."""
        with self._mu:
            req_s = self._req_s
            ttft_s = self._ttft_s
        if queue_depth <= 0:
            return 0.0
        if req_s is None:
            req_s = max(ttft_s if ttft_s is not None else 0.0, self.cold_prior_s)
            if req_s <= 0.0:
                return 0.0
        waves = queue_depth / max(max_slots, 1)
        return waves * req_s

    def snapshot(self) -> dict[str, float]:
        with self._mu:
            return {
                "ewma_ttft_s": self._ttft_s or 0.0,
                "ewma_request_s": self._req_s or 0.0,
                "cold_prior_s": self.cold_prior_s,
            }
