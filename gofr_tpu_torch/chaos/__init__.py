"""Deterministic chaos tier of the port: seed-driven fault injection at
the request path's seams (a copy of ``gofr_tpu/chaos``)."""

from gofr_tpu_torch.chaos.injector import (
    POINTS,
    ChaosFault,
    ChaosInjector,
    DeviceLost,
    FaultSchedule,
    ScheduledFault,
    active,
    hang_factory,
    install,
    maybe_fail,
    uninstall,
)

__all__ = [
    "POINTS",
    "ChaosFault",
    "ChaosInjector",
    "DeviceLost",
    "FaultSchedule",
    "ScheduledFault",
    "active",
    "hang_factory",
    "install",
    "maybe_fail",
    "uninstall",
]
