"""Worker-side cluster agent: register with the leader, heartbeat with
local health, track shard assignment (a copy of
``gofr_tpu/distributed/worker.py``).

Runs as an asyncio task beside the worker's own servers. The leader
dictates heartbeat cadence (RegisterResponse); assignment changes arrive
piggybacked on heartbeat responses and fire ``on_assignment``. If the
leader declares us unknown/DEAD (``ok=false`` — e.g. after a network
partition outlived the deadline), the agent re-registers rather than
zombie-heartbeating a stale shard.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Callable

from gofr_tpu_torch.distributed import coordination_gofr as pb


class WorkerAgent:
    def __init__(
        self,
        leader_address: str,
        host_id: str,
        address: str,
        n_devices: int = 1,
        labels: dict[str, str] | None = None,
        health_fn: Callable[[], dict] | None = None,
        on_assignment: Callable[[list], None] | None = None,
        logger: Any = None,
    ) -> None:
        self.leader_address = leader_address
        self.host_id = host_id
        self.address = address
        self.n_devices = n_devices
        self.labels = dict(labels or {})
        self.health_fn = health_fn
        self.on_assignment = on_assignment
        self.logger = logger
        self.epoch = 0
        self.shards: list[pb.ShardAssignment] = []
        self.heartbeat_interval_s = 2.0
        self._client: pb.CoordinationGofrClient | None = None
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    # -- lifecycle ----------------------------------------------------------
    async def start(self, register_timeout_s: float = 30.0) -> None:
        self._client = pb.CoordinationGofrClient(self.leader_address)
        deadline = asyncio.get_event_loop().time() + register_timeout_s
        backoff = 0.2
        while True:
            try:
                await self._register()
                break
            except Exception as exc:
                if asyncio.get_event_loop().time() + backoff > deadline:
                    raise RuntimeError(
                        f"could not register with leader {self.leader_address}: {exc}"
                    ) from exc
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 2.0)
        self._task = asyncio.ensure_future(self._heartbeat_loop())

    async def stop(self) -> None:
        self._stopped.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
        if self._client is not None:
            await self._client.close()

    # -- protocol -----------------------------------------------------------
    async def _register(self) -> None:
        resp = await self._client.Register(
            pb.RegisterRequest(
                host_id=self.host_id, address=self.address,
                n_devices=self.n_devices, labels=self.labels,
            )
        )
        if not resp.accepted:
            raise RuntimeError("leader rejected registration")
        self.heartbeat_interval_s = resp.heartbeat_interval_s or 2.0
        self._apply(resp.epoch, resp.assignment)
        if self.logger is not None:
            self.logger.info(
                f"cluster: {self.host_id} registered with {self.leader_address} "
                f"(epoch {self.epoch}, shard "
                f"{self.shard_index if self.shard_index is not None else '-'})"
            )

    def _apply(self, epoch: int, assignment: pb.Assignment) -> None:
        self.epoch = epoch
        if assignment.epoch:
            self.shards = list(assignment.shards)
            if self.on_assignment is not None:
                self.on_assignment(self.shards)

    @property
    def shard_index(self) -> int | None:
        for s in self.shards:
            if s.host_id == self.host_id:
                return s.shard_index
        return None

    async def _heartbeat_loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.heartbeat_interval_s)
            health = ""
            if self.health_fn is not None:
                try:
                    health = json.dumps(self.health_fn())
                except Exception:
                    health = ""
            try:
                resp = await self._client.Heartbeat(
                    pb.HeartbeatRequest(
                        host_id=self.host_id, epoch=self.epoch, health_json=health
                    )
                )
            except Exception as exc:
                if self.logger is not None:
                    self.logger.warn(f"cluster: heartbeat to leader failed: {exc}")
                continue  # leader may be restarting; keep trying
            if not resp.ok:
                try:
                    await self._register()  # we were aged out — rejoin
                except Exception as exc:
                    if self.logger is not None:
                        self.logger.warn(f"cluster: re-register failed: {exc}")
                continue
            if resp.epoch > self.epoch:
                self._apply(resp.epoch, resp.assignment)
