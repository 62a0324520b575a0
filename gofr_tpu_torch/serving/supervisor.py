"""Engine supervision: the watchdog and the self-healing warm-restart plane
(a copy of ``gofr_tpu/serving/supervisor.py``; the port imports nothing of
the JAX package).

An engine whose loop thread hangs in a dispatch, or dies, stays dead until
the process is replaced unless something watches it. :class:`EngineSupervisor`
owns a :class:`~gofr_tpu_torch.serving.engine.ServingEngine`'s lifecycle:
detect, restart with a budget, park loudly when the budget is spent.

Detection: the engine loop stamps a monotonic heartbeat every iteration
and after each host sync; the watchdog thread reads three signals:

- **stall**: ``heartbeat_age() > TPU_ENGINE_STALL_S``, a dispatch that
  will never return (no exception will ever surface; only time can tell).
  While the engine reports ``in_cold_dispatch`` (a dispatch signature's
  first run: on the card, the kernel build and cuBLAS's first GEMM) the
  limit widens to ``TPU_ENGINE_COMPILE_GRACE_S``;
- **crash**: the loop thread died with ``_running`` still set;
- **poison storm**: ``device_poisonings`` grew by ``poison_threshold``
  since the last restart, so the in-place KV rebuild is not sticking.

States ``UP -> SUSPECT -> RESTARTING -> (UP | WEDGED)`` surface through the
engine's ``health_check`` (which embeds ``snapshot()``) and, given a
``metrics`` object with ``set_gauge``/``increment_counter``, three
metrics: ``app_engine_restarts_total``, ``app_engine_heartbeat_age_seconds``
and ``app_engine_supervisor_state`` (0 UP / 1 SUSPECT / 2 RESTARTING /
3 WEDGED). The port registers no metric itself yet.

Restart budget with earn-back: up to ``TPU_ENGINE_RESTART_BUDGET``
consecutive restarts; ``TPU_ENGINE_RESTART_RESET_S`` of healthy running
earns the budget back. One more detection past the budget parks the
engine WEDGED (stopped, loud in health, never flapping). A sticky CUDA
error (an illegal address, a device-side assert) poisons the whole
process's CUDA context: no in-process restart heals it, every rebuild
fails, and the budget ends in WEDGED; the process must be replaced.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any

UP = "UP"
SUSPECT = "SUSPECT"
RESTARTING = "RESTARTING"
WEDGED = "WEDGED"

# gauge encoding for app_engine_supervisor_state
STATE_VALUES = {UP: 0, SUSPECT: 1, RESTARTING: 2, WEDGED: 3}

DEFAULT_STALL_S = 5.0
DEFAULT_COMPILE_GRACE_S = 120.0
DEFAULT_RESTART_BUDGET = 3
DEFAULT_RESTART_RESET_S = 60.0
DEFAULT_POISON_THRESHOLD = 3


def _knob(config: Any, key: str, default: float) -> float:
    if config is None:
        return default
    return float(config.get_or_default(key, str(default)))


class EngineSupervisor:
    """Owns a :class:`ServingEngine`'s lifecycle: start it, watch it,
    warm-restart it, park it WEDGED when restarts stop helping.

    ``start()``/``drain()``/``stop()`` are the lifecycle surface to call
    instead of the engine's own: the watchdog stands down FIRST on the way
    out, so a deliberate drain is never "detected" as a stall mid-teardown.
    """

    def __init__(
        self,
        engine: Any,
        *,
        config: Any = None,
        metrics: Any = None,
        logger: Any = None,
        stall_s: float | None = None,
        compile_grace_s: float | None = None,
        restart_budget: int | None = None,
        restart_reset_s: float | None = None,
        poison_threshold: int | None = None,
        poll_s: float | None = None,
        join_timeout: float = 5.0,
    ) -> None:
        self.engine = engine
        self._metrics = metrics if metrics is not None else getattr(engine, "_metrics", None)
        self._logger = logger if logger is not None else logging.getLogger(__name__)
        self.stall_s = (
            stall_s if stall_s is not None
            else _knob(config, "TPU_ENGINE_STALL_S", DEFAULT_STALL_S)
        )
        # a dispatch signature's first run (the kernel build, cuBLAS's first
        # GEMM) is silence that IS progress. While the engine reports
        # in_cold_dispatch the stall threshold widens to this: a hang there
        # is still caught, on the compile budget instead of stall_s.
        self.compile_grace_s = (
            compile_grace_s if compile_grace_s is not None
            else _knob(config, "TPU_ENGINE_COMPILE_GRACE_S",
                       DEFAULT_COMPILE_GRACE_S)
        )
        self.restart_budget = int(
            restart_budget if restart_budget is not None
            else _knob(config, "TPU_ENGINE_RESTART_BUDGET", DEFAULT_RESTART_BUDGET)
        )
        self.restart_reset_s = (
            restart_reset_s if restart_reset_s is not None
            else _knob(config, "TPU_ENGINE_RESTART_RESET_S", DEFAULT_RESTART_RESET_S)
        )
        self.poison_threshold = int(
            poison_threshold if poison_threshold is not None
            else _knob(config, "TPU_ENGINE_POISON_THRESHOLD", DEFAULT_POISON_THRESHOLD)
        )
        # poll often enough that detection latency stays well inside the
        # stall budget, without busy-spinning on tiny test thresholds
        self.poll_s = (
            poll_s if poll_s is not None else max(self.stall_s / 4.0, 0.01)
        )
        self.join_timeout = join_timeout

        self.state = UP
        self.restarts = 0  # completed warm restarts, lifetime
        self.failed_restarts = 0
        self.last_reason: str | None = None
        self._consecutive = 0
        self._last_restart_t: float | None = None
        self._poison_mark = engine.device_poisonings
        self._poison_seen = engine.device_poisonings
        self._last_poison_t: float | None = None
        self._retry_pending = False  # a failed restart left the engine down
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        engine._supervisor = self  # health backref (engine.health_check)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Start the engine (if needed) and the watchdog thread."""
        self.engine.start()
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self.state = UP
        self._thread = threading.Thread(
            target=self._watch, name="engine-supervisor", daemon=True
        )
        self._thread.start()

    def stop(self, join_timeout: float = 10.0) -> None:
        self._halt_watchdog()
        self.engine.stop(join_timeout=join_timeout)

    def drain(self, deadline_s: float | None = None, *,
              join_timeout: float = 10.0) -> bool:
        """Watchdog stands down first, then the engine drains: the drain's
        deliberate quiet period must not read as a stall."""
        self._halt_watchdog()
        return self.engine.drain(deadline_s, join_timeout=join_timeout)

    def _halt_watchdog(self) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10.0)
        # the watchdog may have died between claiming SUSPECT/RESTARTING
        # and standing down (e.g. a failed restart left the retry pending
        # when stop()/drain() interrupted) — health ranks those claims
        # above the engine's own DOWN/DRAINING, so a stale one would
        # report a cleanly stopped engine as RESTARTING forever
        self._stand_down()

    # ------------------------------------------------------------- inspection
    def snapshot(self) -> dict[str, Any]:
        return {
            "state": self.state,
            "restarts": self.restarts,
            "failed_restarts": self.failed_restarts,
            "consecutive_restarts": self._consecutive,
            "restart_budget": self.restart_budget,
            "stall_s": self.stall_s,
            "compile_grace_s": self.compile_grace_s,
            "last_reason": self.last_reason,
        }

    def health_check(self) -> dict[str, Any]:
        """The engine's health (which embeds this supervisor's snapshot and
        lets WEDGED/RESTARTING/SUSPECT outrank its own states)."""
        return self.engine.health_check()

    # ------------------------------------------------------------- watchdog
    def _transition(self, state: str) -> None:
        if state != self.state:
            self.state = state
            if self._logger:
                self._logger.warning(f"engine supervisor: {state}"
                                     + (f" ({self.last_reason})"
                                        if self.last_reason and state != UP else ""))
        if self._metrics:
            self._metrics.set_gauge(
                "app_engine_supervisor_state", float(STATE_VALUES[state])
            )

    def _detect(self) -> str | None:
        """The SUSPECT verdict: which signal (if any) says the engine is no
        longer making progress."""
        eng = self.engine
        if eng.loop_crashed:
            return "loop thread died"
        if self._retry_pending:
            return "previous restart attempt failed"
        if not eng._running:
            return None  # stopped deliberately elsewhere; nothing to heal
        if eng.device_poisonings - self._poison_mark >= self.poison_threshold:
            return (
                f"device poisoned {eng.device_poisonings - self._poison_mark}"
                f" time(s) since last restart"
            )
        age = eng.heartbeat_age()
        limit = self.stall_s
        if getattr(eng, "in_cold_dispatch", False):
            limit = max(limit, self.compile_grace_s)
        if age > limit:
            return f"heartbeat stale {age:.2f}s (> {limit:g}s)"
        return None

    def _stand_down(self) -> None:
        """The engine's own lifecycle (drain/stop/wedge) owns the verdict
        now: mirror a wedge, otherwise drop any SUSPECT/RESTARTING claim
        so health reads the engine's DOWN/DRAINING directly."""
        if self.engine._wedged:
            self._transition(WEDGED)
        elif self.state in (SUSPECT, RESTARTING):
            self._transition(UP)

    def _watch(self) -> None:
        eng = self.engine
        while not self._stop.wait(self.poll_s):
            if eng._draining or eng._stop_requested or eng._wedged:
                # lifecycle owned elsewhere: the watchdog stands down. A
                # stale SUSPECT/RESTARTING must not outlive it — health
                # ranks those above the engine's own DOWN/DRAINING, so a
                # cleanly drained engine would report RESTARTING forever.
                self._stand_down()
                return
            if self._metrics and eng._running:
                self._metrics.set_gauge(
                    "app_engine_heartbeat_age_seconds", eng.heartbeat_age()
                )
            # poison-count decay: only a STORM (repeated poisonings with no
            # quiet window) means the in-place KV rebuild is not sticking.
            # Isolated, fully-healed poisonings spread over days must not
            # accumulate into a spurious restart of a healthy engine, so a
            # restart_reset_s of quiet rebases the mark — mirroring the
            # consecutive-restart earn-back.
            poisonings = eng.device_poisonings
            if poisonings != self._poison_seen:
                self._poison_seen = poisonings
                self._last_poison_t = time.monotonic()
            elif (
                self._last_poison_t is not None
                and time.monotonic() - self._last_poison_t
                >= self.restart_reset_s
            ):
                self._poison_mark = poisonings
            reason = self._detect()
            if reason is None:
                if self.state != UP:
                    self._transition(UP)
                elif self._metrics:
                    self._metrics.set_gauge("app_engine_supervisor_state", 0.0)
                if (
                    self._consecutive
                    and self._last_restart_t is not None
                    and time.monotonic() - self._last_restart_t
                    >= self.restart_reset_s
                ):
                    self._consecutive = 0  # healthy run earns the budget back
                continue
            self.last_reason = reason
            self._transition(SUSPECT)
            if self._consecutive >= self.restart_budget:
                self._park(reason)
                return  # parked: never flap
            self._restart(reason)

    def _restart(self, reason: str) -> None:
        eng = self.engine
        self._transition(RESTARTING)
        self._consecutive += 1
        self._last_restart_t = time.monotonic()
        if self._logger:
            self._logger.error(
                f"engine supervisor restarting ({reason}); attempt "
                f"{self._consecutive}/{self.restart_budget}"
            )
        try:
            ok = eng.warm_restart(join_timeout=self.join_timeout)
        except Exception as exc:
            ok = False
            if self._logger:
                self._logger.error(f"engine warm restart failed: {exc}")
        self._poison_mark = eng.device_poisonings
        if ok:
            self._retry_pending = False
            self.restarts += 1
            if self._metrics:
                self._metrics.increment_counter("app_engine_restarts_total")
            self._transition(UP)
        elif eng._draining or eng._stop_requested or eng._wedged:
            # drain/stop won the race mid-restart — exactly one winner;
            # clear the RESTARTING claim so health falls through to the
            # engine's own DOWN/DRAINING/WEDGED verdict
            self._stand_down()
            self._stop.set()
        else:
            self.failed_restarts += 1
            # the engine may be down with no crash flag now: remember that
            # the next tick must retry instead of reading "cleanly stopped"
            self._retry_pending = True

    def _park(self, reason: str) -> None:
        """Budget spent: stop the engine (native frees are skipped under a
        live thread, exactly like stop()'s wedge path), pin health to
        WEDGED, and stand down. A process manager replaces WEDGED
        replicas; the supervisor's job here is to be loud and still."""
        eng = self.engine
        if self._logger:
            self._logger.error(
                f"engine supervisor restart budget "
                f"({self.restart_budget}) spent ({reason}); parking WEDGED"
            )
        try:
            eng.stop(join_timeout=self.join_timeout)
        except Exception:
            pass
        eng._wedged = True  # even a clean join parks: restarts stopped helping
        self._transition(WEDGED)
