"""Per-tenant SLO classes: priority, deadline classes, token-rate budgets
(a copy of ``gofr_tpu/serving/tenancy.py``; the port imports nothing of the
JAX package).

This module is the policy half of the multi-tenant plane; the enforcement
lives at three layers of the engine:

1. **shed/admission** (``ServingEngine.submit``): a tenant over its
   token-rate budget is rejected in microseconds with 429 + Retry-After,
   and a request with no explicit deadline inherits its class default so
   the expired-while-queued drop and mid-stream retire work for every
   tenant;
2. **step planning** (``serving/stepplan.py``): decode rows stay reserved
   first, and chunk-prefill grants walk cursors by (priority, FIFO), so a
   batch-class long prompt cannot absorb the chunk budget ahead of an
   interactive prompt;
3. **preemption** (``serving/engine.py`` ``_maybe_preempt``): when a
   higher class waits and the batch is full (slots or KV pages), the
   lowest-priority decode row is PAUSED: its committed KV spans page out
   through the prefix-cache tier, the row requeues, and it resumes warm
   through the chunk-boundary cache with its emitted tokens intact.

Deadline classes:

===========  ========  ======================================
class        priority  default deadline
===========  ========  ======================================
interactive  0         ``TPU_TENANT_INTERACTIVE_DEADLINE_S`` (2s)
standard     1         ``TPU_TENANT_STANDARD_DEADLINE_S`` (10s)
batch        2         ``TPU_TENANT_BATCH_DEADLINE_S`` (60s)
===========  ========  ======================================

Pure host policy: no device work; the registry lock is leaf-only.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any

__all__ = [
    "TenantPolicy", "TenantRegistry", "TokenBucket", "DEADLINE_CLASSES",
    "DEFAULT_TENANT",
]

# class name -> (priority, default deadline seconds). Priority is the
# scheduler's convention throughout the stack: LOWER runs first.
DEADLINE_CLASSES: dict[str, tuple[int, float]] = {
    "interactive": (0, 2.0),
    "standard": (1, 10.0),
    "batch": (2, 60.0),
}

DEFAULT_TENANT = "default"


@dataclasses.dataclass
class TenantPolicy:
    """One tenant's SLO class: scheduling priority, the deadline its
    requests inherit when they carry none, and a token-rate budget
    (prompt + generation tokens per second; 0 = unmetered)."""

    name: str = DEFAULT_TENANT
    deadline_class: str = "standard"
    priority: int | None = None   # None = the class's priority
    deadline_s: float | None = None  # None = the class's default
    token_rate: float = 0.0       # tokens/second; 0 = unmetered
    burst_tokens: float = 0.0     # bucket size; 0 = 2s worth of rate

    def __post_init__(self) -> None:
        if self.deadline_class not in DEADLINE_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: deadline_class "
                f"{self.deadline_class!r} not in {sorted(DEADLINE_CLASSES)}"
            )
        cls_prio, cls_deadline = DEADLINE_CLASSES[self.deadline_class]
        if self.priority is None:
            self.priority = cls_prio
        if self.deadline_s is None:
            self.deadline_s = cls_deadline
        if self.token_rate > 0 and self.burst_tokens <= 0:
            self.burst_tokens = 2.0 * self.token_rate


class TokenBucket:
    """Classic token bucket, thread-safe. ``take(n)`` returns
    ``(ok, retry_after_s)`` — retry_after is how long until the bucket
    holds ``n`` tokens again, the number the 429's Retry-After carries."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = float(rate)
        self.burst = float(burst)
        self._level = float(burst)
        # lazily anchored to the FIRST take's clock, so callers driving
        # an explicit test clock (take(now=...)) get exact refill math
        self._t: float | None = None
        self._mu = threading.Lock()

    def take(self, n: float, now: float | None = None) -> tuple[bool, float]:
        with self._mu:
            now = time.monotonic() if now is None else now
            if self._t is None:
                self._t = now
            self._level = min(
                self.burst, self._level + (now - self._t) * self.rate
            )
            self._t = now
            if n <= self._level:
                self._level -= n
                return True, 0.0
            deficit = n - self._level
            retry = deficit / self.rate if self.rate > 0 else 60.0
            return False, retry

    def level(self) -> float:
        with self._mu:
            return self._level


class TenantRegistry:
    """Tenant → policy + live rate bucket. Unknown tenants get the
    default policy (and, when it is metered, a per-tenant bucket of the
    default's rate — ten unknown tenants are ten budgets, not one)."""

    def __init__(self, default: TenantPolicy | None = None,
                 classes: dict[str, tuple[int, float]] | None = None) -> None:
        self._mu = threading.Lock()
        self._policies: dict[str, TenantPolicy] = {}
        self._buckets: dict[str, TokenBucket] = {}
        # per-registry class table: env overrides must not leak into the
        # module global (tests build many registries per process)
        self.classes = dict(classes or DEADLINE_CLASSES)
        self.default = default or TenantPolicy()
        self.rejections: dict[str, int] = {}

    @classmethod
    def from_config(cls, config: Any) -> "TenantRegistry":
        """Env wiring: ``TPU_TENANT_POLICIES`` is a semicolon list of
        ``name:class[:token_rate]`` entries, e.g.
        ``gold:interactive;bulk:batch:500``. Class deadline defaults are
        overridable via ``TPU_TENANT_<CLASS>_DEADLINE_S``."""
        classes = dict(DEADLINE_CLASSES)
        for name in classes:
            raw = config.get(f"TPU_TENANT_{name.upper()}_DEADLINE_S")
            if raw:
                prio, _ = classes[name]
                classes[name] = (prio, float(raw))
        reg = cls(
            default=TenantPolicy(deadline_s=classes["standard"][1]),
            classes=classes,
        )
        spec = config.get_or_default("TPU_TENANT_POLICIES", "")
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(
                    f"TPU_TENANT_POLICIES entry {entry!r}: want "
                    "name:class[:token_rate]"
                )
            rate = float(parts[2]) if len(parts) > 2 else 0.0
            if parts[1] not in classes:
                raise ValueError(
                    f"TPU_TENANT_POLICIES entry {entry!r}: class "
                    f"{parts[1]!r} not in {sorted(classes)}"
                )
            reg.set_policy(TenantPolicy(
                name=parts[0], deadline_class=parts[1],
                deadline_s=classes[parts[1]][1], token_rate=rate,
            ))
        return reg

    def set_policy(self, policy: TenantPolicy) -> None:
        with self._mu:
            self._policies[policy.name] = policy
            self._buckets.pop(policy.name, None)  # rate changed: rebuild

    def policy(self, tenant: str | None) -> TenantPolicy:
        if not tenant:
            return self.default
        with self._mu:
            return self._policies.get(tenant, self.default)

    def admit(self, tenant: str | None, tokens: int) -> tuple[bool, float]:
        """Charge ``tokens`` (prompt + requested generation) against the
        tenant's rate budget. Returns ``(ok, retry_after_s)``; unmetered
        tenants always admit. Called on the submit path — one lock, one
        bucket update, microseconds."""
        name = tenant or DEFAULT_TENANT
        pol = self.policy(tenant)
        if pol.token_rate <= 0:
            return True, 0.0
        with self._mu:
            bucket = self._buckets.get(name)
            if bucket is None:
                bucket = TokenBucket(pol.token_rate, pol.burst_tokens)
                self._buckets[name] = bucket
        ok, retry = bucket.take(float(tokens))
        if not ok:
            with self._mu:
                self.rejections[name] = self.rejections.get(name, 0) + 1
        return ok, retry

    def snapshot(self) -> dict[str, Any]:
        with self._mu:
            return {
                "policies": {
                    name: {
                        "deadline_class": p.deadline_class,
                        "priority": p.priority,
                        "deadline_s": p.deadline_s,
                        "token_rate": p.token_rate,
                    }
                    for name, p in self._policies.items()
                },
                "rejections": dict(self.rejections),
                "bucket_levels": {
                    name: round(b.level(), 1)
                    for name, b in self._buckets.items()
                },
            }
