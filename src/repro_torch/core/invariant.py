"""Lease-invariant monitor (§2): "at any given time, there is no more than
one proposer which holds the lease."

Proposers report their LOCAL ownership transitions; the monitor timestamps
them with GLOBAL simulation time (which nodes themselves never see) and
checks that ownership intervals of different proposers never overlap.
This is the referee for every property test — it encodes exactly the claim
proved in §4.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Interval:
    proposer_id: int
    start: float
    end: Optional[float] = None  # None = still owner


class LeaseInvariantViolation(AssertionError):
    pass


class LeaseMonitor:
    def __init__(self, env, *, strict: bool = True) -> None:
        self.env = env
        self.strict = strict
        self.history: dict[str, list[Interval]] = {}
        self.current: dict[str, Interval] = {}
        self.violations: list[str] = []
        self.acquire_times: list[float] = []

    def on_acquire(self, proposer_id: int, resource: str) -> None:
        t = self.env.now
        cur = self.current.get(resource)
        if cur is not None and cur.proposer_id != proposer_id:
            msg = (
                f"LEASE INVARIANT VIOLATED on {resource!r} at t={t:.6f}: "
                f"proposer {proposer_id} acquired while proposer "
                f"{cur.proposer_id} still holds (since t={cur.start:.6f})"
            )
            self.violations.append(msg)
            if self.strict:
                raise LeaseInvariantViolation(msg)
        iv = Interval(proposer_id, t)
        self.current[resource] = iv
        self.history.setdefault(resource, []).append(iv)
        self.acquire_times.append(t)

    def on_lose(self, proposer_id: int, resource: str) -> None:
        t = self.env.now
        cur = self.current.get(resource)
        if cur is not None and cur.proposer_id == proposer_id:
            cur.end = t
            del self.current[resource]
        else:
            # a proposer may lose an ownership the monitor already closed
            for iv in reversed(self.history.get(resource, [])):
                if iv.proposer_id == proposer_id and iv.end is None:
                    iv.end = t
                    break

    # ------------------------------------------------------------- queries
    def owner_of(self, resource: str) -> Optional[int]:
        cur = self.current.get(resource)
        return cur.proposer_id if cur else None

    def total_owned_time(self, resource: str) -> float:
        t = self.env.now
        return sum((iv.end if iv.end is not None else t) - iv.start
                   for iv in self.history.get(resource, []))

    def handoffs(self, resource: str) -> int:
        hist = self.history.get(resource, [])
        return sum(
            1 for a, b in zip(hist, hist[1:]) if a.proposer_id != b.proposer_id
        )

    def assert_clean(self) -> None:
        if self.violations:
            raise LeaseInvariantViolation("\n".join(self.violations))
