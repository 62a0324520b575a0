"""The port's coordination plane (``gofr_tpu_torch/distributed``, over the
port's typed gRPC) held to the JAX package's (``tests/test_multihost.py``),
on the CPU.

Two real worker processes (``python -m gofr_tpu_torch.distributed.worker_main
--device cpu``, or the JAX package's ``worker_main``), each serving a tiny
Llama engine over gRPC, register with an in-process leader; requests routed
by the leader reach every shard; one worker is SIGKILLed; the leader marks it
SUSPECT then DEAD, bumps the epoch and renumbers the shards over the
survivor, which keeps serving. The leader and the workers come from either
package: port with port, the JAX package's grpcio leader with the port's
workers, and the port's leader with the JAX package's workers. Then the
membership logic without processes, call for call against the reference's
``ClusterState``."""

import asyncio
import os
import signal
import subprocess
import sys
import time

import pytest

pytest.importorskip("grpc")

from gofr_tpu.config import MapConfig as RMapConfig  # noqa: E402
from gofr_tpu.distributed import ClusterState as RClusterState  # noqa: E402
from gofr_tpu.distributed import CoordinationService as RCoordinationService  # noqa: E402
from gofr_tpu.grpcx import GRPCServer as RGRPCServer  # noqa: E402
from gofr_tpu.testutil import new_mock_container as rmock  # noqa: E402

from gofr_tpu_torch.config import MapConfig as TMapConfig  # noqa: E402
from gofr_tpu_torch.distributed import ClusterState, CoordinationService  # noqa: E402
from gofr_tpu_torch.distributed import coordination_gofr as pb  # noqa: E402
from gofr_tpu_torch.grpcx import GRPCServer, InferenceClient  # noqa: E402
from gofr_tpu_torch.testutil import get_free_port, new_mock_container  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_worker(side: str, leader_port: int, worker_port: int, host_id: str):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)  # workers need no virtual mesh; faster boot
    module = "gofr_tpu.distributed.worker_main" if side == "ref" \
        else "gofr_tpu_torch.distributed.worker_main"
    args = [sys.executable, "-m", module, "--leader", f"127.0.0.1:{leader_port}",
            "--port", str(worker_port), "--host-id", host_id]
    if side == "port":
        args += ["--device", "cpu"]
    return subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True)


async def _wait_members(client, pred, timeout_s: float, procs=()):
    deadline = time.monotonic() + timeout_s
    last = None
    while time.monotonic() < deadline:
        last = await client.Members(pb.MembersRequest(), timeout=5)
        if pred(last):
            return last
        if any(p.poll() is not None for p in procs):
            raise AssertionError("a worker exited before the condition held")
        await asyncio.sleep(0.1)
    raise AssertionError(f"membership condition not reached; last: {last}")


@pytest.mark.parametrize("leader_side,worker_side", [("port", "port"), ("ref", "port"),
                                                     ("port", "ref")])
def test_two_process_cluster_survives_host_drop(leader_side, worker_side):
    leader_port = get_free_port()
    w_ports = [get_free_port(), get_free_port()]
    if leader_side == "ref":
        container, _ = rmock()
        state = RClusterState(heartbeat_interval_s=0.3, heartbeat_deadline_s=1.2)
        leader = RGRPCServer(container, leader_port, RMapConfig({}, use_env=False))
        leader.register(RCoordinationService(state))
    else:
        container, _ = new_mock_container()
        state = ClusterState(heartbeat_interval_s=0.3, heartbeat_deadline_s=1.2)
        leader = GRPCServer(container, leader_port, TMapConfig({}, use_env=False))
        leader.register(CoordinationService(state))
    procs = []

    async def scenario():
        await leader.start()
        procs.extend(_spawn_worker(worker_side, leader_port, p, f"w{i}")
                     for i, p in enumerate(w_ports))
        client = pb.CoordinationGofrClient(f"127.0.0.1:{leader_port}")
        try:
            members = await _wait_members(
                client, lambda r: len(r.members) == 2 and all(m.state == "UP" for m in r.members),
                timeout_s=180, procs=procs)
            assert members.status == "UP"
            assert sorted(m.shard_index for m in members.members) == [0, 1]
            epoch_before = members.epoch

            # health fan-in: worker heartbeats carry container.health()
            await _wait_members(client, lambda r: all(m.health_json for m in r.members),
                                timeout_s=30, procs=procs)

            # requests via leader routing reach every UP shard
            served = set()
            for _ in range(4):
                m = state.pick()
                assert m is not None
                icl = InferenceClient(m.address)
                result = await asyncio.wait_for(icl.generate("hello", max_tokens=3), 60)
                assert result["usage"]["completion_tokens"] >= 1
                await icl.close()
                served.add(m.host_id)
            assert served == {"w0", "w1"}

            # kill one host (simulated machine loss, not graceful exit)
            procs[0].send_signal(signal.SIGKILL)
            members = await _wait_members(
                client, lambda r: any(m.state == "DEAD" for m in r.members)
                and any(m.state == "UP" for m in r.members), timeout_s=30)
            assert members.status == "DEGRADED"
            assert members.epoch > epoch_before
            dead = next(m for m in members.members if m.state == "DEAD")
            live = next(m for m in members.members if m.state == "UP")
            assert dead.host_id == "w0"
            assert dead.shard_index == -1 and live.shard_index == 0

            # serving continues on the survivor through leader routing
            for _ in range(3):
                m = state.pick()
                assert m is not None and m.host_id == "w1"
                icl = InferenceClient(m.address)
                result = await asyncio.wait_for(icl.generate("again", max_tokens=3), 60)
                assert result["usage"]["completion_tokens"] >= 1
                await icl.close()
        finally:
            await client.close()
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            for p in procs:
                try:
                    p.wait(timeout=20)
                except subprocess.TimeoutExpired:
                    p.kill()
            await leader.shutdown(grace=0.2)

    asyncio.run(scenario())
    if worker_side == "port":
        out = procs[1].stdout.read()
        assert "WORKER_READY w1" in out and "WORKER_LAUNCHES" in out


def _membership_trace(cls) -> list:
    """The reference test's ClusterState script, recording each answer."""
    st = cls(heartbeat_interval_s=0.01, heartbeat_deadline_s=0.05)
    rec = []
    st.register("a", "h:1", 1)
    st.register("b", "h:2", 1, {"zone": "z1"})
    rec.append((st.status(), [m.host_id for m in st.assignment()], st.epoch))
    time.sleep(0.12)
    st.heartbeat("a", '{"status": "UP"}')
    st.sweep()
    rec.append((st.status(), [m.host_id for m in st.assignment()], st.epoch))
    rec.append(st.heartbeat("b"))  # a DEAD host must re-register
    st.register("b", "h:2", 1)
    st.heartbeat("b", "not json")
    rec.append((st.status(), len(st.assignment()), st.epoch))
    time.sleep(0.06)
    st.sweep()
    rec.append(st.status())  # both SUSPECT
    st.heartbeat("a")
    st.heartbeat("b")
    rec.append((st.status(), st.epoch))
    rec.append(sorted(st.pick().host_id for _ in range(4)))
    rec.append(sorted((m.host_id, m.state, m.shard_index, m.health, m.labels)
                      for m in st.members()))
    return rec


def test_cluster_state_unit():
    """Pure membership logic: sweep transitions, reassignment and the
    zombie re-register, the same answers as the reference's."""
    port = _membership_trace(ClusterState)
    assert port == _membership_trace(RClusterState)
    assert port[0][0] == "UP" and port[1][0] == "DEGRADED" and port[2] is False
    assert port[4] == "DOWN" and port[5][0] == "UP"


def test_coordination_service_over_both_wires():
    """The typed service answers the same to the port's client and to the
    reference's grpc.aio client: Register, a Heartbeat with a stale epoch
    piggybacks the assignment, an unknown host is told to re-register."""
    from gofr_tpu.distributed import coordination_gofr as rpb

    async def scenario(mod):
        port = get_free_port()
        container, _ = new_mock_container()
        server = GRPCServer(container, port, TMapConfig({"HTTP_HOST": "127.0.0.1"},
                                                        use_env=False))
        server.register(CoordinationService(ClusterState(heartbeat_interval_s=0.5,
                                                         heartbeat_deadline_s=5.0)))
        await server.start()
        client = mod.CoordinationGofrClient(f"127.0.0.1:{port}")
        try:
            reg = await client.Register(mod.RegisterRequest(
                host_id="h", address="a:1", n_devices=1, labels={"k": "v"}), timeout=10)
            hb = await client.Heartbeat(mod.HeartbeatRequest(host_id="h", epoch=0), timeout=10)
            unknown = await client.Heartbeat(mod.HeartbeatRequest(host_id="zz", epoch=0),
                                             timeout=10)
            members = await client.Members(mod.MembersRequest(), timeout=10)
            return [reg.SerializeToString(), hb.SerializeToString(),
                    unknown.SerializeToString(),
                    [(m.host_id, m.state, m.shard_index) for m in members.members]]
        finally:
            await client.close()
            await server.shutdown(grace=0.1)

    assert asyncio.run(scenario(pb)) == asyncio.run(scenario(rpb))
