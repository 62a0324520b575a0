"""``examples_torch/using-analytics`` booted whole on the CPU through its
``build_app`` (a tiny Llama on the port's engine, ``CLICKHOUSE_FAKE=1``: the
port's ClickHouse fake, and the embedded graph): jobs of two tenants posted
over HTTP, each job's tokens equal to the same prompt through
``engine.submit`` alone, ``GET /usage`` equal to the engine's token counts
per tenant, ``GET /lineage/{tenant}`` listing each tenant's jobs and
results, and the tenant's graph node made once."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_example_meters_and_links_jobs_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "using_analytics_app", ROOT / "examples_torch" / "using-analytics" / "main.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    port = get_free_port()
    app = example.build_app(MapConfig({
        "SERVE_MODEL": "tiny", "SERVE_DEVICE": "cpu", "TPU_BATCH_MAX_TOKENS": "128",
        "CLICKHOUSE_FAKE": "1", "HTTP_HOST": "127.0.0.1", "HTTP_PORT": str(port),
        "METRICS_PORT": str(get_free_port()), "LOG_LEVEL": "FATAL"}, use_env=False))
    engine = app.container.serving
    thread = start_app(app, timeout=60)
    base = f"http://127.0.0.1:{port}"
    jobs = {"j1": ([5, 6, 7], "acme"), "j2": ([9, 8, 7, 6], "globex"), "j3": ([11, 3], "acme")}
    try:
        replies = {}
        for job, (prompt, tenant) in jobs.items():
            status, _, body = fetch(f"{base}/jobs/{job}", "POST",
                                    json.dumps({"prompt": prompt, "tenant": tenant}).encode(),
                                    {"Content-Type": "application/json"}, 120)
            assert status == 201, body
            replies[job] = json.loads(body)["data"]
        for job, (prompt, _) in jobs.items():
            alone = engine.submit(prompt, max_new_tokens=32, temperature=0.0).result(120)
            assert replies[job]["tokens"] == list(alone.token_ids)
        usage = json.loads(fetch(f"{base}/usage", timeout=60)[2])["data"]
        want = {}
        for job, (_, tenant) in jobs.items():
            want.setdefault(tenant, {"new_tokens": 0, "jobs": 0})
            want[tenant]["new_tokens"] += replies[job]["completion_tokens"]
            want[tenant]["jobs"] += 1
        assert usage == want
        lineage = json.loads(fetch(f"{base}/lineage/acme", timeout=60)[2])["data"]
        assert [(j["job"], j["results"]) for j in lineage["jobs"]] == [("j1", ["j1"]),
                                                                       ("j3", ["j3"])]
        graph = app.container.extra_datasources["graph"]
        assert len(graph.query(func={"has": "tenant"})) == 2
    finally:
        stop_app(app, thread)
