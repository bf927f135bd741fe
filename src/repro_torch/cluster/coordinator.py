"""Cluster coordinator election — the paper's own deployment story (§9):
PaxosLease negotiates the *master lease* exactly as in Keyspace/ScalienDB,
here for a training cluster. The master drives checkpoint cadence, publishes
data-shard assignment and admits elastic workers. Mastership is just lease
ownership on the reserved resource ``master``; renewal (§6) keeps a healthy
master in place, expiry (no disk, no clock sync needed) replaces a dead one
within ~T + backoff. A copy of ``repro.cluster.coordinator`` on the port's
``core/`` and ``configs/``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..configs.paxoslease_cell import CellConfig
from ..core.cell import Cell, LeaseNode, build_cell

MASTER_RESOURCE = "master"
CKPT_RESOURCE = "ckpt-writer"


@dataclass
class CoordinatorEvents:
    gained: list = field(default_factory=list)  # (t, node_id)
    lost: list = field(default_factory=list)


class CoordinatorService:
    """Wraps a lease cell; every control node runs one of these. Callbacks
    fire on LOCAL mastership transitions (only the owner knows — §3)."""

    def __init__(self, cell: Cell, *, lease_timespan: Optional[float] = None) -> None:
        self.cell = cell
        self.events = CoordinatorEvents()
        self._on_gain: dict[int, Callable] = {}
        self._on_lose: dict[int, Callable] = {}
        self._wrap_monitors()
        self.T = lease_timespan or cell.cfg.lease_timespan

    def _wrap_monitors(self) -> None:
        mon = self.cell.monitor
        orig_acq, orig_lose = mon.on_acquire, mon.on_lose

        def on_acquire(pid: int, resource: str) -> None:
            orig_acq(pid, resource)
            if resource == MASTER_RESOURCE:
                self.events.gained.append((self.cell.env.now, pid))
                cb = self._on_gain.get(pid)
                if cb:
                    cb()

        def on_lose(pid: int, resource: str) -> None:
            orig_lose(pid, resource)
            if resource == MASTER_RESOURCE:
                self.events.lost.append((self.cell.env.now, pid))
                cb = self._on_lose.get(pid)
                if cb:
                    cb()

        mon.on_acquire, mon.on_lose = on_acquire, on_lose

    # ------------------------------------------------------------------ API
    def campaign(self, node: LeaseNode, *, on_gain: Callable = None, on_lose: Callable = None) -> None:
        """Node volunteers for mastership (it keeps campaigning forever)."""
        if on_gain:
            self._on_gain[node.node_id] = on_gain
        if on_lose:
            self._on_lose[node.node_id] = on_lose
        node.proposer.acquire(MASTER_RESOURCE, timespan=self.T, renew=True)

    def abdicate(self, node: LeaseNode) -> None:
        node.proposer.release(MASTER_RESOURCE)

    def master(self) -> Optional[int]:
        """Global-observer view (harness/tests only — real nodes can't ask)."""
        return self.cell.monitor.owner_of(MASTER_RESOURCE)

    def failover_times(self) -> list[float]:
        """Gaps between a master loss and the next gain (bench_failover)."""
        gaps = []
        for t_lost, _pid in self.events.lost:
            nxt = [t for t, _ in self.events.gained if t >= t_lost]
            if nxt:
                gaps.append(min(nxt) - t_lost)
        return gaps


def build_coordinated_cluster(
    cfg: CellConfig,
    *,
    n_workers: int,
    seed: int = 0,
    net=None,
) -> tuple[Cell, CoordinatorService]:
    """Standard production topology: cfg.n_acceptors control nodes (acceptor
    + proposer) and ``n_workers`` elastic proposer-only worker nodes."""
    cell = build_cell(cfg, n_proposers=cfg.n_acceptors + n_workers, seed=seed, net=net)
    return cell, CoordinatorService(cell)
