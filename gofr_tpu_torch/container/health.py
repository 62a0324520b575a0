"""Aggregated health (a copy of ``gofr_tpu/container/health.py``; reference:
pkg/gofr/container/health.go:8-98).

Walks every datasource, the topic consumers of the subscription manager,
the serving engine and every registered downstream service; overall status is UP when all report UP, DEGRADED otherwise,
DRAINING while the app drains and DEGRADED for a WEDGED engine. Served at
``/.well-known/health``. The engine's ``health_check`` carries the card in
its device telemetry (``serving/device_telemetry.py``).
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.container.datasources import iter_health_checkers


def aggregate_health(container: Any) -> dict[str, Any]:
    details: dict[str, Any] = iter_health_checkers(container.datasource_pairs())

    manager = getattr(container, "subscription_manager", None)
    if manager is not None and getattr(manager, "subscriptions", None):
        try:
            details["pubsub_consumers"] = manager.health()
        except Exception as exc:
            details["pubsub_consumers"] = {"status": "DOWN", "error": str(exc)}

    serving = getattr(container, "serving", None)
    if serving is not None and hasattr(serving, "health_check"):
        try:
            details["serving"] = serving.health_check()
        except Exception as exc:
            details["serving"] = {"status": "DOWN", "error": str(exc)}

    services: dict[str, Any] = {}
    for name, svc in container.services.items():
        check = getattr(svc, "health_check", None)
        if callable(check):
            try:
                services[name] = check()
            except Exception as exc:
                services[name] = {"status": "DOWN", "error": str(exc)}
    if services:
        details["services"] = services

    def _is_up(node: Any) -> bool:
        if isinstance(node, dict):
            status = node.get("status")
            if status is not None and str(status).upper() not in ("UP", "OK", "HEALTHY"):
                return False
            return all(_is_up(v) for k, v in node.items() if k != "status")
        return True

    serving_status = str(
        (details.get("serving") or {}).get("status", "")
    ).upper()
    if serving_status == "WEDGED":
        # a wedged engine outranks even a deliberate drain: the process
        # needs REPLACING, and a soothing "DRAINING" would hide that from
        # the orchestrator watching this endpoint
        overall = "DEGRADED"
    elif getattr(container, "draining", False):
        # drain outranks everything else: the LB must stop routing here,
        # whatever the datasources say
        overall = "DRAINING"
    else:
        overall = "UP" if all(_is_up(v) for v in details.values()) else "DEGRADED"
    return {
        "status": overall,
        "name": container.app_name,
        "version": container.app_version,
        "details": details,
    }
