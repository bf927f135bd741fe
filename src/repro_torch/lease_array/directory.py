"""LeaseArrayDirectory: shard-ownership on the vectorized lease plane, the
port of ``repro.lease_array.directory`` on the port's engine (the card
unless ``device="cpu"``; every tick one ``engine.step``, on the card one
launch of the unbatched delayed window kernel once link delay or a first
extend has put the engine on the delayed model).

The event-driven ``cluster.shards.ShardLeaseManager`` tops out at a few
hundred resources (every lease is Python objects trading one message at a
time); this directory drives *thousands* of shard cells through one batched
array step per tick. Same operational surface: workers with a target shard
count, stall (straggler: leases silently expire), drain (graceful §7
release), elastic retargeting, coverage/owner queries.

Policy per tick (host-side numpy; the protocol itself runs in the array,
whose owner row and ``ticks_left`` come to the host in one copy a tick):
  - active owners whose lease is inside the renew margin extend in-flight
    (§6, the ``extends`` plane: a fresh round gated on the live belief),
  - draining or over-target workers release their extra shards,
  - unowned cells are attempted by workers with a deficit, spread
    round-robin with a per-worker stride to reduce collisions.

The renew margin must clear the worst-case round trip: an extend is a
full fresh round (§6) — prepares out, promises back, proposes out,
accepts back — so its accepts land up to ``4·max_delay + 1`` ticks after
it is sent. A margin below that (a ``lease_ticks // 2`` margin ignores link
delay entirely; the half-trip ``2·max_delay+1`` covers one leg pair only)
lets every lease lapse mid-renewal — the renewal-collapse geometry the
regression tests pin (owned_frac 0.05 instead of ≥ 0.95).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .engine import LeaseArrayEngine
from .scenario import make_tick
from .state import NO_PROPOSER


@dataclass
class ArrayWorker:
    slot: int  # proposer index inside the array plane
    target: int
    stalled: bool = False
    draining: bool = False


class LeaseArrayDirectory:
    def __init__(
        self,
        n_shards: int,
        *,
        n_acceptors: int = 5,
        lease_ticks: int = 6,
        renew_margin: int | None = None,
        max_workers: int = 32,
        max_delay_ticks: int = 0,
        device="cuda",
    ) -> None:
        self.n_shards = n_shards
        self.max_workers = max_workers
        self.max_delay_ticks = int(max_delay_ticks)
        # an extend is a FULL fresh round (§6): prepares + promises +
        # proposes + accepts, up to 4·max_delay + 1 ticks end to end.
        # Renewals scheduled any later than that before expiry can NEVER
        # land in time (the half-trip 2·max_delay+1 looks plausible but
        # only covers one leg pair — it still collapses at delay ≥ 2).
        rtt = 4 * self.max_delay_ticks + 1
        if rtt >= lease_ticks:
            raise ValueError(
                f"a {lease_ticks}-tick lease cannot be renewed over links "
                f"with up to {max_delay_ticks}-tick legs (extend round "
                f"{rtt} >= lease); lengthen the lease or shorten the links"
            )
        if renew_margin is None:
            renew_margin = max(lease_ticks // 2, rtt, 1)
        elif renew_margin < rtt:
            raise ValueError(
                f"renew_margin={renew_margin} is below the worst-case "
                f"extend round ({rtt} ticks at max_delay_ticks="
                f"{max_delay_ticks}): every renewal would start too late "
                f"to land before expiry"
            )
        self.renew_margin = renew_margin
        self.engine = LeaseArrayEngine(
            n_shards,
            n_acceptors=n_acceptors,
            n_proposers=max_workers,
            lease_ticks=lease_ticks,
            device=device,
            # the abandon deadline must outlive a full prepare+propose
            # round over the slowest links, or no round ever completes
            round_ticks=4 * self.max_delay_ticks + 1,
        )
        self.workers: dict[int, ArrayWorker] = {}
        self._owners = np.full(n_shards, NO_PROPOSER, np.int32)
        # the engine's ticks_left() as of the last step (a fresh engine
        # owns nothing)
        self._ticks_left = np.zeros(n_shards, np.int32)
        # per-cell pacing: an attempt/extend OVERWRITES any open round
        # (netplane phase 3), so re-issuing every tick livelocks at
        # delay ≥ 1. Hold off a full prepare+propose round trip
        # (4·delay + 1 ticks) before re-driving a cell.
        self._round_trip = rtt
        self._cooldown = np.zeros(n_shards, np.int32)

    # ------------------------------------------------------------------ API
    def add_worker(self, worker_id: int, target: int) -> ArrayWorker:
        if worker_id in self.workers:
            raise ValueError(f"worker {worker_id} already registered")
        if len(self.workers) >= self.max_workers:
            raise ValueError(f"plane sized for {self.max_workers} workers")
        slot = len(self.workers)
        w = ArrayWorker(slot=slot, target=target)
        self.workers[worker_id] = w
        return w

    def set_target(self, worker_id: int, target: int) -> None:
        self.workers[worker_id].target = target

    def stall(self, worker_id: int) -> None:
        """Straggler: stops renewing; its leases expire after the timespan."""
        self.workers[worker_id].stalled = True

    def unstall(self, worker_id: int) -> None:
        self.workers[worker_id].stalled = False

    def drain(self, worker_id: int) -> None:
        """Graceful scale-down: release everything over the next tick (§7)."""
        w = self.workers[worker_id]
        w.draining = True
        w.target = 0

    # ------------------------------------------------------------ the tick
    def tick(self, n: int = 1) -> np.ndarray:
        for _ in range(n):
            self._owners = self._tick_once()
        return self._owners

    def _tick_once(self) -> np.ndarray:
        attempt = np.full(self.n_shards, NO_PROPOSER, np.int32)
        release = np.full(self.n_shards, NO_PROPOSER, np.int32)
        extend = np.full(self.n_shards, NO_PROPOSER, np.int32)
        owners = self._owners
        self._cooldown = np.maximum(self._cooldown - 1, 0)
        ticks_left = self._ticks_left
        by_slot = {w.slot: w for w in self.workers.values()}
        counts = np.bincount(
            owners[owners >= 0], minlength=self.engine.n_proposers
        )

        deficits: dict[int, int] = {}
        for w in self.workers.values():
            if w.stalled:
                continue  # a true straggler says nothing — leases just lapse
            owned = int(counts[w.slot])
            if w.draining or owned > w.target:
                mine = np.flatnonzero(owners == w.slot)
                n_shed = owned if w.draining else owned - w.target
                release[mine[len(mine) - n_shed:]] = w.slot  # shed highest k
            if owned < w.target:
                deficits[w.slot] = w.target - owned

        # owners inside the renew margin extend in-flight (§6: the extends
        # plane re-proposes under the live belief; stalled/draining don't)
        for cell in np.flatnonzero(
            (owners >= 0)
            & (ticks_left <= self.renew_margin)
            & (self._cooldown == 0)
        ):
            w = by_slot.get(int(owners[cell]))
            if w is not None and not w.stalled and not w.draining:
                if release[cell] != w.slot:  # not shedding this one
                    extend[cell] = w.slot
                    self._cooldown[cell] = self._round_trip

        # spread unowned cells over deficit workers round-robin (vectorized:
        # the per-cell Python loop would rival the batched step itself)
        if deficits:
            slots = np.array(sorted(deficits), np.int32)
            wants = np.array([deficits[int(s)] for s in slots])
            rank = np.concatenate([np.arange(w) for w in wants])
            seq = np.repeat(slots, wants)[np.argsort(rank, kind="stable")]
            free = np.flatnonzero(
                (owners < 0) & (attempt < 0) & (self._cooldown == 0)
            )
            k = min(len(seq), len(free))
            attempt[free[:k]] = seq[:k]
            self._cooldown[free[:k]] = self._round_trip
        planes = dict(attempts=attempt, releases=release, extends=extend)
        if self.max_delay_ticks:
            planes["delay"] = np.full(
                self.engine.n_acceptors, self.max_delay_ticks, np.int32
            )
        tick = make_tick(
            n_cells=self.engine.n_cells, n_acceptors=self.engine.n_acceptors,
            n_proposers=self.engine.n_proposers, **planes,
        )
        owners = self.engine.step(tick)
        # the owner row and the next tick's ticks_left: one copy to the host
        owners, self._ticks_left = torch.stack(
            [owners, self.engine.ticks_left()]).cpu().numpy()
        return owners

    # -------------------------------------------------------------- queries
    def coverage(self) -> float:
        return float((self._owners >= 0).mean()) if self.n_shards else 0.0

    def owner_map(self) -> dict[int, int]:
        slot_to_id = {w.slot: wid for wid, w in self.workers.items()}
        return {
            int(k): slot_to_id[int(s)]
            for k, s in enumerate(self._owners)
            if s >= 0 and int(s) in slot_to_id
        }

    def owned_count(self, worker_id: int) -> int:
        return int((self._owners == self.workers[worker_id].slot).sum())
