"""The serving metrics catalog: every series the port's serving modules emit,
registered on a :class:`~gofr_tpu_torch.metrics.Manager` with the name, kind,
description and buckets of the reference's registration (the framework
container, ``gofr_tpu/container/container.py``). The app's container
registers it whole, beside the datasource series it keeps for dashboards
(``container/container.py``).

The names stay the reference's, ``tpu`` included (``app_tpu_hbm_*``): a
dashboard built on the reference reads the port unchanged. On the card
``app_tpu_hbm_used_bytes`` is ``torch.cuda.memory_allocated`` and
``app_tpu_hbm_limit_bytes`` the card's total memory
(``serving/device_telemetry.py``).

Usage::

    manager = new_metrics_manager()
    register_serving_metrics(manager)
    engine = ServingEngine(cfg, params, conf, metrics=manager, tracer=tracer)
    text = manager.expose_prometheus()
"""

from __future__ import annotations

from typing import Any

# the reference's bucket sets for the histograms that do not take the default
TPOT_BUCKETS = (0.001, 0.0025, 0.005, 0.0075, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5)
CHUNK_TOKEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30)
BLOCK_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5)
RECLAIM_BUCKETS = (0.1, 0.25, 0.5, 1, 2, 5, 10, 30, 60, 120)

# (kind, name, description, buckets or None for the default) of every
# series the port emits, by emitter
SERVING_METRICS: tuple[tuple[str, str, str, tuple | None], ...] = (
    # the engine (serving/engine.py)
    ("gauge", "app_batch_queue_depth", "Requests waiting for batch admission", None),
    ("gauge", "app_batch_occupancy", "Fraction of batch slots occupied", None),
    ("gauge", "app_kv_cache_pages_used", "Paged KV-cache pages in use", None),
    ("counter", "app_kv_prefix_hits_total",
     "Prefix-cache admission lookups by warmest serving tier "
     "(label tier=device|host|remote|miss)", None),
    ("histogram", "app_ttft_seconds", "Time to first token", None),
    ("histogram", "app_tpot_seconds", "Time per output token", TPOT_BUCKETS),
    ("gauge", "app_spec_accept_rate",
     "Speculative-decode draft acceptance rate over drafted tokens", None),
    ("gauge", "app_decode_host_ms_per_step",
     "Host-side time per decode step (dispatch bookkeeping + block "
     "consume, excluding the device sync wait), milliseconds", None),
    ("gauge", "app_decode_block_size",
     "Decode steps fused per device dispatch (TPU_BATCH_MULTI_STEP)", None),
    ("gauge", "app_detok_queue_depth",
     "Detokenization/stream emissions queued behind the off-engine-"
     "thread executor", None),
    ("histogram", "app_prefill_chunk_tokens",
     "Prompt tokens per committed prefill chunk (label "
     "kind=compute|prefix_hit)", CHUNK_TOKEN_BUCKETS),
    ("gauge", "app_step_plan_prefill_tokens",
     "Prefill-chunk tokens granted by the latest step plan", None),
    ("gauge", "app_step_plan_decode_rows",
     "Decode rows reserved first by the latest step plan", None),
    ("gauge", "app_step_plan_cursors",
     "Partially-prefilled requests carrying a live chunk cursor", None),
    ("counter", "app_requests_shed_total",
     "Requests rejected by admission control (queue full or "
     "estimated wait past deadline/threshold)", None),
    ("counter", "app_requests_deadline_exceeded_total",
     "Requests whose deadline passed before completion", None),
    ("gauge", "app_estimated_queue_wait_seconds",
     "EWMA-estimated queue wait for a newly submitted request", None),
    ("counter", "app_requests_kv_exhausted_total",
     "Rows retired mid-decode by KV-pool exhaustion (finish_reason "
     "kv_exhausted) — pool pressure, not a legitimate max-tokens stop", None),
    ("histogram", "app_request_ttft_seconds",
     "Time to first token per request (label source=engine|router)", TTFT_BUCKETS),
    ("histogram", "app_request_queue_wait_seconds",
     "Submit-to-admission queue wait per request", TTFT_BUCKETS),
    ("histogram", "app_request_e2e_seconds",
     "Submit-to-terminal end-to-end latency per request", None),
    ("histogram", "app_decode_block_seconds",
     "Wall time of one fused N-step decode block (dispatch to sync)", BLOCK_BUCKETS),
    ("counter", "app_tenant_preemptions_total",
     "Decode rows paused by the preemption ladder so a higher "
     "class could run (label tenant = the PREEMPTED tenant)", None),
    # the supervisor (serving/supervisor.py)
    ("counter", "app_engine_restarts_total", "Completed self-healing engine warm restarts", None),
    ("gauge", "app_engine_heartbeat_age_seconds",
     "Seconds since the engine loop last stamped its heartbeat", None),
    ("gauge", "app_engine_supervisor_state",
     "Engine supervisor state: 0 UP, 1 SUSPECT, 2 RESTARTING, 3 WEDGED", None),
    # device telemetry (serving/device_telemetry.py)
    ("gauge", "app_tpu_hbm_used_bytes", "HBM bytes in use per device", None),
    ("gauge", "app_tpu_hbm_limit_bytes", "HBM capacity per device", None),
    ("gauge", "app_tpu_hbm_bytes", "Device HBM bytes (labels: device, kind=used|limit)", None),
    ("gauge", "app_tpu_hbm_util", "Fraction of device HBM in use, per device", None),
    ("gauge", "app_engine_duty_cycle",
     "Fraction of wall time the engine loop spent doing work "
     "(heartbeat-derived, over the telemetry poll interval)", None),
    # the adapter registry (serving/lora.py) and the spill tier (serving/kv_spill.py)
    ("gauge", "app_lora_adapter_residency", "LoRA adapters resident in the device factor tables",
     None),
    ("gauge", "app_kv_spill_bytes", "Bytes resident in the host-RAM KV spill tier", None),
    # the KV migrator (serving/prefix_index.py)
    ("counter", "app_kv_migrations_total",
     "Warm KV prefix migrations fetched from another replica", None),
    ("counter", "app_kv_handoffs_total",
     "Prefill→decode KV handoff chains admitted complete "
     "(contiguity-audited; a torn handoff re-prefills instead)", None),
    # the reclamation plane (the engine's begin_reclaim and _evacuate_kv)
    ("counter", "app_replica_reclamations_total",
     "Reclamation notices accepted by this replica's drain ladder", None),
    ("counter", "app_kv_evacuations_total",
     "KV evacuation batches pushed to survivors during reclaim "
     "(label outcome = committed|failed|skipped)", None),
    ("histogram", "app_reclaim_drain_seconds",
     "Wall time from reclamation notice to engine stop", RECLAIM_BUCKETS),
    # the router (serving/router.py)
    ("gauge", "app_router_replica_state",
     "Router's view of each replica: 0 UP, 1 SUSPECT, 2 RESTARTING, "
     "3 DRAINING, 4 WEDGED, 5 DOWN", None),
    ("counter", "app_router_failovers_total",
     "Requests re-routed to another replica after a retriable "
     "pre-first-token failure", None),
    ("counter", "app_router_hedges_total",
     "Prefill admissions hedged on a second replica after the "
     "p99-based delay", None),
    ("counter", "app_router_last_resort_routes_total",
     "Routes dispatched into a SUSPECT-only candidate pool (no UP "
     "replica anywhere: best-effort routing, the tier is coasting)", None),
    ("gauge", "app_router_queue_wait_seconds",
     "Mean reported queue-wait EWMA across live replicas (the "
     "tier-level autoscaling signal)", None),
    # the in-memory broker the heartbeats ride (pubsub/memory.py)
    ("counter", "app_pubsub_publish_total_count", "Number of total publish operations", None),
    ("counter", "app_pubsub_publish_success_count", "Number of successful publish operations",
     None),
    # the autoscaler (serving/autoscaler.py)
    ("gauge", "app_autoscaler_replicas",
     "Autoscaler's current replica count per pool (label role)", None),
    ("counter", "app_autoscaler_scale_events_total",
     "Autoscaler scale actions taken (label direction=up|down)", None),
    # the app plane: the container (container/container.py), the HTTP
    # metrics middleware (http/middleware/core.py) and the service client
    # with its circuit breaker (service/)
    ("gauge", "app_info", "Info for app_name and app_version", None),
    ("histogram", "app_http_response", "Response time of HTTP requests in seconds", None),
    ("histogram", "app_http_service_response",
     "Response time of HTTP service requests in seconds", None),
    ("gauge", "app_service_breaker_state",
     "Circuit-breaker state per downstream service address: 0 closed, 1 open", None),
)


def register_serving_metrics(manager: Any) -> Any:
    """Register every series of :data:`SERVING_METRICS` on ``manager`` and
    return it. A name already registered raises (or is logged, on a
    manager built with a logger), as the Manager does."""
    for kind, name, description, buckets in SERVING_METRICS:
        if kind == "histogram" and buckets is not None:
            manager.new_histogram(name, description, buckets=buckets)
        elif kind == "histogram":
            manager.new_histogram(name, description)
        elif kind == "counter":
            manager.new_counter(name, description)
        else:
            manager.new_gauge(name, description)
    return manager
