"""Data-shard ownership via fine-grained leases (§8: leases for many
resources) — the framework's straggler mitigation and elastic-scaling
mechanism. A copy of ``repro.cluster.shards`` on the port's ``core/`` and
``configs/``, whose array path is the port's ``LeaseArrayDirectory``.

Every data shard is an independent PaxosLease instance (``shard:<k>``).
A worker holds leases on the shards it is processing and renews them while
healthy. A straggling/stalled/dead worker simply stops renewing: the lease
expires after T without any fencing or coordinator intervention, and another
worker acquires the shard. Workers are proposers — PaxosLease allows any
number of them (§2), so the pool can grow/shrink freely (elasticity).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..configs.paxoslease_cell import CellConfig
from ..core.cell import Cell, LeaseNode


def shard_resource(k: int) -> str:
    return f"shard:{k}"


@dataclass
class ShardWorker:
    node: LeaseNode
    target: int  # how many shards this worker tries to hold
    owned: set = field(default_factory=set)
    stalled: bool = False
    processed: dict = field(default_factory=dict)  # shard -> batches done


class ShardLeaseManager:
    """Runs on top of an existing cell. Scan-based acquisition: each worker
    periodically tries to top up to its target with unowned shards (it can't
    see the global owner map — it just proposes and loses quickly if someone
    holds the lease; a reject costs one round)."""

    def __init__(
        self,
        cell: Cell,
        n_shards: int,
        *,
        shard_timespan: Optional[float] = None,
        scan_period: float = 1.0,
    ) -> None:
        self.cell = cell
        self.n_shards = n_shards
        self.T = shard_timespan or cell.cfg.lease_timespan
        self.scan_period = scan_period
        self.workers: dict[int, ShardWorker] = {}
        self._wrap_monitor()

    def _wrap_monitor(self) -> None:
        mon = self.cell.monitor
        orig_acq, orig_lose = mon.on_acquire, mon.on_lose

        def on_acquire(pid: int, resource: str) -> None:
            orig_acq(pid, resource)
            w = self.workers.get(pid)
            if w is not None and resource.startswith("shard:"):
                w.owned.add(int(resource.split(":")[1]))

        def on_lose(pid: int, resource: str) -> None:
            orig_lose(pid, resource)
            w = self.workers.get(pid)
            if w is not None and resource.startswith("shard:"):
                w.owned.discard(int(resource.split(":")[1]))

        mon.on_acquire, mon.on_lose = on_acquire, on_lose

    # ------------------------------------------------------------------ API
    def add_worker(self, node: LeaseNode, target: int) -> ShardWorker:
        w = ShardWorker(node, target)
        self.workers[node.node_id] = w
        self._schedule_scan(w, first=True)
        return w

    def stall(self, node_id: int) -> None:
        """Straggler injection: the worker stops renewing (and scanning) but
        does NOT crash — its leases silently expire after T."""
        w = self.workers[node_id]
        w.stalled = True
        for k in list(w.owned):
            # stop renewal without sending Release (a true straggler says nothing)
            st = w.node.proposer._state(shard_resource(k))
            st.want = False
            if st.renew_timer is not None:
                st.renew_timer.cancel()
                st.renew_timer = None

    def unstall(self, node_id: int) -> None:
        self.workers[node_id].stalled = False

    def drain(self, node_id: int) -> None:
        """Graceful scale-down: release all shards immediately (§7)."""
        w = self.workers[node_id]
        w.target = 0
        for k in list(w.owned):
            w.node.proposer.release(shard_resource(k))

    # ------------------------------------------------------------ internals
    def _schedule_scan(self, w: ShardWorker, first: bool = False) -> None:
        delay = self.cell.env.random_backoff(0.0, self.scan_period) if first else self.scan_period
        self.cell.env.set_timer(w.node.addr, delay, lambda: self._scan(w))

    def _scan(self, w: ShardWorker) -> None:
        if not w.node.crashed and not w.stalled:
            # shed excess when the target was lowered (elastic rebalancing):
            # §7 release + hints means waiters pick these up within ~2 RTT
            excess = len(w.owned) - w.target
            for k in sorted(w.owned, reverse=True)[:max(excess, 0)]:
                w.node.proposer.release(shard_resource(k))
            deficit = w.target - len(w.owned)
            if deficit > 0:
                # prefer shards by (worker_id + i) stride to reduce collisions
                start = (w.node.node_id * 7919) % self.n_shards
                tried = 0
                for i in range(self.n_shards):
                    k = (start + i) % self.n_shards
                    res = shard_resource(k)
                    st = w.node.proposer._state(res)
                    if k not in w.owned and not st.want:
                        w.node.proposer.acquire(res, timespan=self.T, renew=True)
                        tried += 1
                        if tried >= deficit:
                            break
            # abandon pursuit of shards we failed to win (someone owns them)
            for k in range(self.n_shards):
                res = shard_resource(k)
                st = w.node.proposer._state(res)
                if st.want and not st.owner and k not in w.owned and len(w.owned) >= w.target:
                    st.want = False
        self._schedule_scan(w)

    # --------------------------------------------------------------- queries
    def coverage(self) -> float:
        """Fraction of shards currently owned by someone (global observer)."""
        owned = sum(
            1 for k in range(self.n_shards)
            if self.cell.monitor.owner_of(shard_resource(k)) is not None
        )
        return owned / max(self.n_shards, 1)

    def owner_map(self) -> dict[int, int]:
        out = {}
        for k in range(self.n_shards):
            o = self.cell.monitor.owner_of(shard_resource(k))
            if o is not None:
                out[k] = o
        return out


# --------------------------------------------------------------------------
# Fast path: at thousands of shards the per-object event sim is message-bound
# (§8 note + the Paxos-in-the-cloud per-message-overhead result), so large
# planes run on the dense lease_array engine instead — one batched array step
# advances every shard cell per tick.

ARRAY_DIRECTORY_MIN_SHARDS = 1024


def build_shard_manager(
    n_shards: int,
    *,
    cell: Optional[Cell] = None,
    cfg: Optional[CellConfig] = None,
    backend: str = "auto",
    shard_timespan: Optional[float] = None,
    scan_period: float = 1.0,
    **array_kwargs,
):
    """Pick the shard-lease backend.

    ``backend="event"`` -> :class:`ShardLeaseManager` over an existing
    :class:`Cell` (faithful per-message simulation; needs ``cell``).
    ``backend="array"`` -> :class:`~repro_torch.lease_array.directory.LeaseArrayDirectory`
    (vectorized plane; thousands of shards per batched step; its
    ``device``, the card by default, rides in ``array_kwargs``).
    ``backend="auto"`` -> array when ``n_shards >= ARRAY_DIRECTORY_MIN_SHARDS``
    or when no cell was supplied.
    """
    if backend == "auto":
        backend = (
            "array"
            if cell is None or n_shards >= ARRAY_DIRECTORY_MIN_SHARDS
            else "event"
        )
    if backend == "array":
        from ..lease_array.directory import LeaseArrayDirectory

        c = cfg or (cell.cfg if cell is not None else None)
        if c is not None:
            array_kwargs.setdefault("n_acceptors", c.n_acceptors)
            # one directory tick ~ one scan period of the event manager, so
            # the configured timespan carries over as lease_ticks
            t = shard_timespan if shard_timespan is not None else c.lease_timespan
            array_kwargs.setdefault(
                "lease_ticks", max(int(round(t / scan_period)), 1)
            )
        return LeaseArrayDirectory(n_shards, **array_kwargs)
    if backend != "event":
        raise ValueError(f"unknown shard-lease backend {backend!r}")
    if cell is None:
        raise ValueError("event backend needs a built Cell")
    return ShardLeaseManager(
        cell, n_shards, shard_timespan=shard_timespan, scan_period=scan_period
    )
