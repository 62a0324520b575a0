"""Cluster leader: membership, heartbeat sweep, shard assignment, health
fan-in (a copy of ``gofr_tpu/distributed/coordinator.py``).

The coordination plane runs over the framework's own typed gRPC
(distributed/coordination.proto → coordination_gofr.py, generated by the
port's grpcx/codegen.py, on the port's own wire) — mirroring how the
reference's distribution story is its own service layer
(pkg/gofr/service/, pkg/gofr/grpc.go:21-197). It touches no mesh and no
collective: it coordinates processes, each serving on its own card.

Design: workers Register then Heartbeat on an interval the leader
dictates; the leader sweeps ages on every RPC (no hidden timer thread —
deterministic under test), marking members SUSPECT past one deadline
and DEAD past two, and renumbers dp shards over the UP set on every
membership change (epoch bump). Heartbeat responses piggyback the
assignment when the worker's epoch is stale, so reshard propagation
needs no watch channel. A DEAD worker that heartbeats again is told to
re-register (``ok=false``).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from gofr_tpu_torch.distributed import coordination_gofr as pb


@dataclass
class MemberInfo:
    host_id: str
    address: str
    n_devices: int
    labels: dict[str, str] = field(default_factory=dict)
    state: str = "UP"  # UP | SUSPECT | DEAD
    last_heartbeat: float = field(default_factory=time.monotonic)
    health: dict | None = None
    shard_index: int = -1


class ClusterState:
    """Thread-safe membership + assignment. Separate from the servicer so
    in-process components (routers, health aggregation, tests) can share
    it without going through gRPC."""

    def __init__(
        self,
        heartbeat_interval_s: float = 2.0,
        heartbeat_deadline_s: float = 6.0,
    ) -> None:
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_deadline_s = heartbeat_deadline_s
        self._lock = threading.Lock()
        self._members: dict[str, MemberInfo] = {}
        self._epoch = 0
        self._rr = 0  # round-robin cursor for pick()

    # -- membership --------------------------------------------------------
    def register(self, host_id: str, address: str, n_devices: int,
                 labels: dict[str, str] | None = None) -> int:
        with self._lock:
            self._members[host_id] = MemberInfo(
                host_id, address, n_devices, dict(labels or {})
            )
            self._reassign_locked()
            return self._epoch

    def heartbeat(self, host_id: str, health_json: str = "") -> bool:
        """Returns False when the host must re-register (unknown or
        already declared DEAD — a zombie must not silently rejoin with a
        stale shard)."""
        with self._lock:
            m = self._members.get(host_id)
            if m is None or m.state == "DEAD":
                return False
            m.last_heartbeat = time.monotonic()
            if m.state == "SUSPECT":
                m.state = "UP"
                self._reassign_locked()
            if health_json:
                try:
                    m.health = json.loads(health_json)
                except json.JSONDecodeError:
                    m.health = {"raw": health_json}
            return True

    def sweep(self) -> None:
        """Age out silent members: SUSPECT past one deadline, DEAD past
        two. Called on every coordination RPC."""
        now = time.monotonic()
        with self._lock:
            changed = False
            for m in self._members.values():
                age = now - m.last_heartbeat
                if m.state == "UP" and age > self.heartbeat_deadline_s:
                    m.state = "SUSPECT"
                    changed = True
                if m.state in ("UP", "SUSPECT") and age > 2 * self.heartbeat_deadline_s:
                    m.state = "DEAD"
                    changed = True
            if changed:
                self._reassign_locked()

    def _reassign_locked(self) -> None:
        self._epoch += 1
        up = sorted(
            (m for m in self._members.values() if m.state == "UP"),
            key=lambda m: m.host_id,
        )
        for m in self._members.values():
            m.shard_index = -1
        for i, m in enumerate(up):
            m.shard_index = i

    # -- views -------------------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def members(self) -> list[MemberInfo]:
        with self._lock:
            return [
                MemberInfo(
                    m.host_id, m.address, m.n_devices, dict(m.labels), m.state,
                    m.last_heartbeat, m.health, m.shard_index,
                )
                for m in self._members.values()
            ]

    def status(self) -> str:
        """Cluster health fan-in: UP / DEGRADED / DOWN."""
        with self._lock:
            states = [m.state for m in self._members.values()]
        if not states:
            return "DOWN"
        up = states.count("UP")
        if up == len(states):
            return "UP"
        return "DEGRADED" if up else "DOWN"

    def assignment(self) -> list[MemberInfo]:
        with self._lock:
            return sorted(
                (
                    MemberInfo(m.host_id, m.address, m.n_devices, dict(m.labels),
                               m.state, m.last_heartbeat, m.health, m.shard_index)
                    for m in self._members.values()
                    if m.shard_index >= 0
                ),
                key=lambda m: m.shard_index,
            )

    def pick(self) -> MemberInfo | None:
        """Round-robin over UP members — the leader-side request router
        (failover: a dead shard simply stops being picked)."""
        self.sweep()
        with self._lock:
            up = sorted(
                (m for m in self._members.values() if m.state == "UP"),
                key=lambda m: m.host_id,
            )
            if not up:
                return None
            m = up[self._rr % len(up)]
            self._rr += 1
            return m


class CoordinationService(pb.CoordinationGofrServicer):
    """The typed gRPC surface over :class:`ClusterState`; register on a
    GRPCServer (container injected like any servicer)."""

    def __init__(self, state: ClusterState | None = None) -> None:
        super().__init__()
        self.state = state or ClusterState()

    def _assignment_proto(self) -> pb.Assignment:
        shards = self.state.assignment()
        a = pb.Assignment(epoch=self.state.epoch)
        n = len(shards)
        for m in shards:
            a.shards.add(
                host_id=m.host_id, address=m.address,
                shard_index=m.shard_index, n_shards=n, role="serving",
            )
        return a

    async def Register(self, ctx: Any, request: pb.RegisterRequest) -> pb.RegisterResponse:
        self.state.sweep()
        epoch = self.state.register(
            request.host_id, request.address, request.n_devices, dict(request.labels)
        )
        if self.container is not None:
            self.container.logger.info(
                f"cluster: registered {request.host_id} at {request.address} "
                f"(epoch {epoch})"
            )
        return pb.RegisterResponse(
            accepted=True,
            epoch=epoch,
            assignment=self._assignment_proto(),
            heartbeat_interval_s=self.state.heartbeat_interval_s,
            heartbeat_deadline_s=self.state.heartbeat_deadline_s,
        )

    async def Heartbeat(self, ctx: Any, request: pb.HeartbeatRequest) -> pb.HeartbeatResponse:
        self.state.sweep()
        ok = self.state.heartbeat(request.host_id, request.health_json)
        resp = pb.HeartbeatResponse(ok=ok, epoch=self.state.epoch)
        if ok and request.epoch < self.state.epoch:
            resp.assignment.CopyFrom(self._assignment_proto())
        return resp

    async def Members(self, ctx: Any, request: pb.MembersRequest) -> pb.MembersResponse:
        self.state.sweep()
        now = time.monotonic()
        resp = pb.MembersResponse(status=self.state.status(), epoch=self.state.epoch)
        for m in self.state.members():
            resp.members.add(
                host_id=m.host_id, address=m.address, state=m.state,
                last_heartbeat_age_s=now - m.last_heartbeat,
                shard_index=m.shard_index,
                health_json=json.dumps(m.health) if m.health else "",
            )
        return resp
