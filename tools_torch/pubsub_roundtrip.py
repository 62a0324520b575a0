"""A job's round trip through the port's ``App`` over each networked
Pub/Sub backend, on the CPU against the port's in-process fakes: a user
client publishes a job, the app's subscriber hands it to a handler that
publishes a result at once, and the user client reads the result.

    python3 tools_torch/pubsub_roundtrip.py [--jobs 15] [--fake-nodelay off]
        [--client-nodelay] [KAFKA NATS MQTT EVENTHUB]

Prints one line per backend: the round trip (publish to result read) p50
and max, and the broker's share (publish to handler entry) p50, in ms.
``--fake-nodelay off`` drops the fakes' ``TCP_NODELAY`` (as the JAX
package's fakes run); ``--client-nodelay`` sets it on every client socket,
which no driver does, to show what the clients' own small back-to-back
sends cost under Nagle's algorithm. No card is needed.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _patch_sockets(fake_nodelay: bool, client_nodelay: bool) -> None:
    if not fake_nodelay:
        real_setsockopt = socket.socket.setsockopt

        def setsockopt(self, level, opt, value, *rest):
            if level == socket.IPPROTO_TCP and opt == socket.TCP_NODELAY:
                return None
            return real_setsockopt(self, level, opt, value, *rest)

        socket.socket.setsockopt = setsockopt
    if client_nodelay:
        real_connect = socket.create_connection

        def create_connection(*args, **kwargs):
            sock = real_connect(*args, **kwargs)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock

        socket.create_connection = create_connection


def run(backend: str, jobs: int) -> str:
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import MapConfig
    from gofr_tpu_torch.pubsub.eventhub import EventHubClient
    from gofr_tpu_torch.pubsub.kafka import KafkaClient
    from gofr_tpu_torch.pubsub.mqtt import MQTTClient
    from gofr_tpu_torch.pubsub.nats import NatsClient
    from gofr_tpu_torch.testutil import (MiniEventHubServer, MiniKafkaBroker, MiniMQTTBroker,
                                         MiniNatsBroker, get_free_port, start_app, stop_app)

    conf = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
            "HTTP_HOST": "127.0.0.1", "LOG_LEVEL": "FATAL", "PUBSUB_BACKEND": backend}
    if backend == "KAFKA":
        fake = MiniKafkaBroker()
        conf.update(PUBSUB_BROKER=fake.address, CONSUMER_ID="app")
        user = KafkaClient(fake.address, consumer_group="user")
    elif backend == "NATS":
        fake = MiniNatsBroker(ack_wait=30.0)
        conf.update(NATS_SERVER=fake.address)
        user = NatsClient(fake.address, consumer_group="user")
    elif backend == "MQTT":
        fake = MiniMQTTBroker().start()
        conf.update(MQTT_HOST="127.0.0.1", MQTT_PORT=str(fake.port), MQTT_CLIENT_ID="app")
        user = MQTTClient("127.0.0.1", fake.port, client_id="user")
    elif backend == "EVENTHUB":
        fake = MiniEventHubServer().start()
        conf.update(EVENTHUB_HOST="127.0.0.1", EVENTHUB_PORT=str(fake.port),
                    EVENTHUB_NAME="hub")
        user = EventHubClient(host="127.0.0.1", port=fake.port, eventhub_name="hub",
                              consumer_group="user")
    else:
        raise SystemExit(f"unknown backend {backend}")
    user.connect()
    user.subscribe("results")  # NATS and MQTT drop what no one subscribed to
    app = App(MapConfig(conf, use_env=False))
    entered: dict[int, float] = {}

    def handler(ctx):
        job = json.loads(ctx.request.value)
        entered[job["k"]] = time.perf_counter()
        ctx.get_publisher().publish("results", ctx.request.value)

    app.subscribe("jobs", handler)
    thread = start_app(app)
    try:
        trips, shares = [], []
        for k in range(jobs):
            t0 = time.perf_counter()
            user.publish("jobs", json.dumps({"k": k}).encode())
            msg = None
            while msg is None:
                msg = user.subscribe("results")
            msg.commit()
            trips.append((time.perf_counter() - t0) * 1e3)
            shares.append((entered[k] - t0) * 1e3)
    finally:
        stop_app(app, thread)
        user.close()
        (fake.stop if backend == "MQTT" else fake.close)()
    trips.sort()
    shares.sort()
    return (f"{backend:8s} round trip p50 {trips[len(trips) // 2]:.2f} ms max {trips[-1]:.2f} "
            f"ms, broker share p50 {shares[len(shares) // 2]:.2f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("backends", nargs="*", default=["KAFKA", "NATS", "MQTT", "EVENTHUB"])
    ap.add_argument("--jobs", type=int, default=15)
    nodelay = ap.add_mutually_exclusive_group()  # "off" drops every TCP_NODELAY
    nodelay.add_argument("--fake-nodelay", choices=("port", "off"), default="port")
    nodelay.add_argument("--client-nodelay", action="store_true")
    args = ap.parse_args()
    _patch_sockets(args.fake_nodelay == "port", args.client_nodelay)
    for backend in args.backends:
        print(run(backend.upper(), args.jobs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
