"""Metrics of the port: the instrument registry and its Prometheus
exposition (a copy of ``gofr_tpu/metrics``: the same ``Manager``, kinds,
buckets and text format), and ``promlint`` to check an exposition. The
serving catalog that registers every series the port's engine emits is
``gofr_tpu_torch.serving.metrics_catalog``; the app's metrics port, which
serves ``/metrics``, is ``metrics/server.py``."""

from gofr_tpu_torch.metrics.promlint import lint_exposition
from gofr_tpu_torch.metrics.register import Manager, new_metrics_manager
from gofr_tpu_torch.metrics.store import MetricsError

__all__ = ["Manager", "MetricsError", "lint_exposition", "new_metrics_manager"]
