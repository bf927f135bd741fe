"""SimEnv: what a node is allowed to see.

PaxosLease assumes no synchronized clocks: nodes get (a) a local timer whose
rate may drift from true time by a bounded factor, (b) best-effort messaging,
(c) a tiny stable store (proposers persist only their restart counter — the
acceptors are the diskless part). Global time exists only for the network,
the scheduler and the invariant monitor.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Optional

from .events import Scheduler, TimerHandle
from .network import NetConfig, Network


class StableStore:
    """Per-node durable dict that survives crash/restart (proposer restart
    counters only — acceptors never touch it; that is the paper's point)."""

    def __init__(self) -> None:
        self._data: dict[str, dict] = {}
        self.sync_count = 0  # "disk writes" — benchmarked against classic Paxos

    def load(self, node: str) -> dict:
        return dict(self._data.get(node, {}))

    def store(self, node: str, key: str, value) -> None:
        d = self._data.setdefault(node, {})
        if key in d and d[key] == value:
            return  # idempotent re-store: no disk sync happens
        d[key] = value
        self.sync_count += 1


@dataclass
class NodeClock:
    rate: float = 1.0  # local seconds per global second

    def local_duration_to_global(self, d: float) -> float:
        return d / self.rate

    def global_duration_to_local(self, d: float) -> float:
        return d * self.rate


class SimEnv:
    def __init__(self, *, seed: int = 0, net: Optional[NetConfig] = None) -> None:
        self.sched = Scheduler()
        self.network = Network(self.sched, net or NetConfig(), seed=seed)
        self.stable = StableStore()
        self.rng = random.Random(seed + 1)
        self.clocks: dict[str, NodeClock] = {}

    # -- node registration ---------------------------------------------------
    def add_node(self, addr: str, handler: Callable, *, clock_rate: float = 1.0) -> None:
        self.clocks[addr] = NodeClock(clock_rate)
        self.network.register(addr, handler)

    # -- node-visible API ----------------------------------------------------
    def send(self, src: str, dst: str, msg) -> None:
        self.network.send(src, dst, msg)

    def set_timer(self, node: str, local_delay: float, fn: Callable) -> TimerHandle:
        g = self.clocks[node].local_duration_to_global(local_delay)
        return self.sched.after(g, fn)

    def local_now(self, node: str) -> float:
        """The node's own drifted clock reading — the same clock its timers
        run on, never global time (PaxosLease assumes no synchronized
        clocks; a local monotonic read is the same power as a local timer).
        """
        return self.clocks[node].global_duration_to_local(self.sched.now)

    def random_backoff(self, lo: float, hi: float) -> float:
        return self.rng.uniform(lo, hi)

    # -- global (monitor / harness only) --------------------------------------
    @property
    def now(self) -> float:
        return self.sched.now

    def run_until(self, t: float) -> None:
        self.sched.run_until(t)
