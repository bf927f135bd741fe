"""Heartbeat membership for elastic worker pools.

Liveness tracking is NOT a lease problem (the paper is explicit that only an
owner knows its lease), so workers send plain heartbeat messages to control
nodes; a worker unheard-of for ``suspect_after`` is suspected. The master
uses this to size shard targets; actual shard safety never depends on it —
that's what the leases are for. A copy of ``repro.cluster.membership`` on the
port's ``sim/``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..sim.env import SimEnv


@dataclass(frozen=True)
class Heartbeat:
    worker_id: int
    load: float = 0.0


class MembershipTracker:
    def __init__(self, env: SimEnv, addr: str, *, suspect_after: float = 5.0) -> None:
        self.env = env
        self.addr = addr
        self.suspect_after = suspect_after
        self.last_seen: dict[int, float] = {}
        self.loads: dict[int, float] = {}

    def on_heartbeat(self, hb: Heartbeat) -> None:
        self.last_seen[hb.worker_id] = self.env.now
        self.loads[hb.worker_id] = hb.load

    def live_workers(self) -> list[int]:
        t = self.env.now
        return sorted(w for w, ts in self.last_seen.items() if t - ts < self.suspect_after)

    def suspected(self) -> list[int]:
        t = self.env.now
        return sorted(w for w, ts in self.last_seen.items() if t - ts >= self.suspect_after)


class HeartbeatSender:
    def __init__(self, env: SimEnv, addr: str, worker_id: int, targets: list[str],
                 *, period: float = 1.0) -> None:
        self.env = env
        self.addr = addr
        self.worker_id = worker_id
        self.targets = targets
        self.period = period
        self.stopped = False
        self._tick()

    def stop(self) -> None:
        self.stopped = True

    def _tick(self) -> None:
        if self.stopped:
            return
        for t in self.targets:
            self.env.send(self.addr, t, Heartbeat(self.worker_id))
        self.env.set_timer(self.addr, self.period, self._tick)
