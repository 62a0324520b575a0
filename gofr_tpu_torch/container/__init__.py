"""Container: the DI hub of the port's app (a copy of the part of
``gofr_tpu/container`` that serving uses)."""

from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.container.health import aggregate_health

__all__ = ["Container", "aggregate_health"]
