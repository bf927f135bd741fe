"""Elastic shard-target controller.

The coordinator (master-lease holder) watches heartbeat membership and
re-publishes per-worker shard targets so the pool always covers ``n_shards``:
workers joining lowers everyone's target, workers going silent raises the
survivors'. Safety never depends on this — targets only steer how many
leases a worker *tries* to hold; actual ownership is always decided by the
PaxosLease rounds, and a dead worker's shards migrate by expiry regardless.
A copy of ``repro.cluster.autoscale`` on the port's ``core/`` and
``ShardLeaseManager``.
"""
from __future__ import annotations

import math

from ..core.cell import Cell, LeaseNode
from .coordinator import MASTER_RESOURCE
from .membership import MembershipTracker
from .shards import ShardLeaseManager


class AutoscaleController:
    def __init__(
        self,
        cell: Cell,
        mgr: ShardLeaseManager,
        tracker: MembershipTracker,
        *,
        master_node: LeaseNode,
        period: float = 2.0,
        headroom: int = 0,  # extra leases each worker may chase (work stealing)
    ) -> None:
        self.cell = cell
        self.mgr = mgr
        self.tracker = tracker
        self.master_node = master_node
        self.period = period
        self.headroom = headroom
        self.decisions: list[tuple[float, dict]] = []
        self._tick()

    def _tick(self) -> None:
        # Only the master steers (it alone knows it holds the master lease —
        # §3: ownership is local knowledge). A deposed master stops steering.
        if self.master_node.proposer is not None and self.master_node.proposer.is_owner(
            MASTER_RESOURCE
        ):
            live = [w for w in self.tracker.live_workers() if w in self.mgr.workers]
            if live:
                per = math.ceil(self.mgr.n_shards / len(live)) + self.headroom
                targets = {}
                for wid, w in self.mgr.workers.items():
                    w.target = per if wid in live else 0
                    targets[wid] = w.target
                self.decisions.append((self.cell.env.now, targets))
        self.cell.env.set_timer(self.master_node.addr, self.period, self._tick)
