"""The port's metrics package against the JAX package's, on the CPU:

- two Managers fed the same seeded operation sequence (counters, up-down
  counters, gauges with ``observe_with``, histograms with labels) give
  byte-identical ``expose_prometheus`` text and equal ``snapshot`` and
  ``percentile`` for every series;
- ``promlint.lint_exposition`` gives the same findings on the reference's
  fixture expositions and on each Manager's own text;
- ``register_serving_metrics`` registers each name with the kind,
  description and buckets of the reference's framework container;
- an AST scan of ``gofr_tpu_torch/`` finds every emitted ``app_*`` name in
  the catalog, and every catalog name emitted somewhere.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from gofr_tpu.metrics import new_metrics_manager as jnew_manager  # noqa: E402
from gofr_tpu.metrics.promlint import lint_exposition as jlint  # noqa: E402
from gofr_tpu_torch.metrics import Manager, lint_exposition, new_metrics_manager  # noqa: E402
from gofr_tpu_torch.metrics.register import Counter, Gauge, Histogram, UpDownCounter  # noqa: E402
from gofr_tpu_torch.serving.metrics_catalog import (  # noqa: E402
    SERVING_METRICS,
    register_serving_metrics,
)

ROOT = Path(__file__).resolve().parent.parent
LABELS = [{}, {"tenant": "gold"}, {"tenant": "bulk"}, {"tier": "device", "kind": "x"},
          {"device": "0", "kind": "used"}, {"q": 'a "quoted"\nvalue\\'}]


def _drive(manager, seed: int, ops: int = 400) -> None:
    """A seeded sequence of registrations and recordings, the same on
    either Manager."""
    rng = np.random.default_rng(seed)
    manager.new_counter("c_total", "a counter")
    manager.new_updown_counter("ud", "an up-down counter")
    manager.new_gauge("g", "a gauge")
    manager.new_gauge("g_cb", "a gauge with a scrape-time callback")
    manager.new_histogram("h_seconds", "default buckets")
    manager.new_histogram("h_tokens", "explicit buckets", buckets=(16, 1, 4, 64, 256))
    manager.get("g_cb").observe_with(lambda: {(("device", "0"),): 3.5, (("device", "1"),): 7.0})
    for _ in range(ops):
        op = int(rng.integers(0, 6))
        labels = LABELS[int(rng.integers(0, len(LABELS)))]
        value = float(rng.choice([0.0, 1.0, 2.5, 1e-4, 0.3, 7.0, 123.456, 1e9]))
        if op == 0:
            manager.increment_counter("c_total", **labels)
        elif op == 1:
            manager.delta_updown_counter("ud", value * (1 if rng.random() < 0.5 else -1), **labels)
        elif op == 2:
            manager.set_gauge("g", value, **labels)
        elif op == 3:
            manager.delete_gauge("g", **labels)
        elif op == 4:
            manager.record_histogram("h_seconds", value * rng.random(), **labels)
        else:
            manager.record_histogram("h_tokens", float(rng.integers(0, 300)), *sum(
                ([k, v] for k, v in labels.items()), []))
    # unknown names and wrong kinds are ignored by both
    manager.increment_counter("never_registered")
    manager.set_gauge("c_total", 1.0)
    manager.record_histogram("g", 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_seeded_operations_give_identical_exposition(seed):
    ref, port = jnew_manager(), new_metrics_manager()
    _drive(ref, seed)
    _drive(port, seed)
    text = port.expose_prometheus()
    assert text == ref.expose_prometheus()
    for name in ("h_seconds", "h_tokens"):
        for labels in LABELS:
            assert port.get(name).snapshot(labels) == ref.get(name).snapshot(labels)
            for q in (0.0, 0.5, 0.9, 0.99, 1.0):
                a, b = port.get(name).percentile(q, labels), ref.get(name).percentile(q, labels)
                assert (math.isnan(a) and math.isnan(b)) or a == b
    for labels in LABELS:
        for name in ("c_total", "ud", "g"):
            a, b = port.get(name).value(labels), ref.get(name).value(labels)
            assert (math.isnan(a) and math.isnan(b)) or a == b
    assert lint_exposition(text) == jlint(text) == []


def test_percentile_window_and_duplicate_registration():
    """The recent-observation window keeps the last 512 values, and a
    second registration of a name raises on both."""
    ref, port = jnew_manager(), new_metrics_manager()
    for m in (ref, port):
        m.new_histogram("w", "window")
        for v in range(1000):
            m.record_histogram("w", float(v))
    assert port.get("w").percentile(0.0) == ref.get("w").percentile(0.0) == 488.0
    assert port.get("w").snapshot() == ref.get("w").snapshot() == (499500.0, 1000)
    with pytest.raises(Exception) as port_exc:
        port.new_counter("w")
    with pytest.raises(Exception) as ref_exc:
        ref.new_counter("w")
    assert str(port_exc.value) == str(ref_exc.value)
    assert isinstance(port, Manager)


# the reference's fixtures (tests/test_observability.py) and a few more
FIXTURES = {
    "orphan": "orphan_metric 1\n",
    "duplicate": '# HELP x d\n# TYPE x counter\nx{a="1"} 1\nx{a="1"} 2\n',
    "not_cumulative": ('# HELP h d\n# TYPE h histogram\n'
                       'h_bucket{le="0.1"} 5\nh_bucket{le="1"} 3\nh_bucket{le="+Inf"} 3\n'
                       'h_sum 1\nh_count 3\n'),
    "inf_vs_count": ('# HELP h d\n# TYPE h histogram\n'
                     'h_bucket{le="+Inf"} 3\nh_sum 1\nh_count 4\n'),
    "late_help": "# TYPE y gauge\ny 1\n# HELP y d\n",
    "clean": ('# HELP h d\n# TYPE h histogram\n'
              'h_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 2\nh_sum 0.6\nh_count 2\n'),
    "no_inf": '# HELP h d\n# TYPE h histogram\nh_bucket{le="0.1"} 1\nh_sum 0.1\nh_count 1\n',
    "bad_type": "# HELP z d\n# TYPE z sometype\nz 1\n",
    "double_type": "# HELP z d\n# TYPE z gauge\n# TYPE z gauge\nz 1\n",
    "non_numeric": "# HELP z d\n# TYPE z gauge\nz abc\n",
    "unparseable": "# HELP z d\n# TYPE z gauge\n{bad} 1\n",
    "malformed_type": "# HELP z d\n# TYPE z\nz 1\n",
    "bucket_without_le": '# HELP h d\n# TYPE h histogram\nh_bucket{x="1"} 1\nh_count 1\n',
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_promlint_findings_match(name):
    text = FIXTURES[name]
    assert lint_exposition(text) == jlint(text)
    assert bool(lint_exposition(text)) == (name != "clean")


@pytest.fixture(scope="module")
def container_manager():
    from gofr_tpu.config import MapConfig
    from gofr_tpu.container.container import Container

    container = Container(MapConfig({"LOG_LEVEL": "ERROR"}, use_env=False))
    yield container.metrics_manager
    container.close()


def _spec(inst) -> tuple:
    kind = {Counter: "counter", UpDownCounter: "updown", Gauge: "gauge", Histogram: "histogram"}
    name = next(v for k, v in kind.items() if type(inst).__name__ == k.__name__)
    return name, inst.description, getattr(inst, "buckets", None)


@pytest.mark.parametrize("name", [n for _, n, _, _ in SERVING_METRICS])
def test_catalog_matches_reference_registration(container_manager, name):
    port = register_serving_metrics(new_metrics_manager())
    ref_inst = container_manager.get(name)
    assert ref_inst is not None, f"{name} is not in the reference's catalog"
    assert _spec(port.get(name)) == _spec(ref_inst)


def test_catalog_registers_each_name_once():
    names = [n for _, n, _, _ in SERVING_METRICS]
    assert len(names) == len(set(names))
    m = register_serving_metrics(new_metrics_manager())
    with pytest.raises(Exception):
        register_serving_metrics(m)  # a second registration raises


RECORDERS = {"set_gauge", "increment_counter", "record_histogram", "delta_updown_counter",
             "delete_gauge"}


def _emitted_names() -> dict[str, list[str]]:
    """Every literal ``app_*`` name passed first to a Manager recording
    call in the port's package, with where."""
    found: dict[str, list[str]] = {}
    for path in sorted((ROOT / "gofr_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in RECORDERS and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                found.setdefault(node.args[0].value, []).append(
                    f"{path.relative_to(ROOT)}:{node.lineno}")
    return found


def test_every_emitted_name_is_in_the_catalog():
    emitted = _emitted_names()
    catalog = {n for _, n, _, _ in SERVING_METRICS}
    assert emitted, "the scan found no emitter"
    missing = {n: where for n, where in emitted.items() if n not in catalog}
    assert not missing, missing
    assert all(n.startswith("app_") for n in emitted)
    unused = catalog - set(emitted)
    assert not unused, f"registered but never emitted: {sorted(unused)}"
