"""Test doubles and helpers of the port (copies of ``gofr_tpu/testutil``
modules that raise the port's errors, free ports, and an app runner)."""

from gofr_tpu_torch.testutil.apps import fetch, start_app, stop_app, wait_ready
from gofr_tpu_torch.testutil.ports import ServerConfigs, get_free_port, new_server_configs

__all__ = ["ServerConfigs", "fetch", "get_free_port", "new_server_configs", "start_app",
           "stop_app", "wait_ready"]
