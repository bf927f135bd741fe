"""The paper's own configuration: a PaxosLease cell (§2) and its timing knobs.

This mirrors the deployment described in §9 (Keyspace/ScalienDB master lease):
a small fixed acceptor ensemble, any number of proposers, a globally known
maximal lease time M, and leases always acquired for T < M.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CellConfig:
    n_acceptors: int = 5
    max_lease_time: float = 60.0  # M — globally known; acceptors wait M on restart
    lease_timespan: float = 15.0  # T — always < M (§2)
    renew_fraction: float = 0.5  # extend the lease after T * renew_fraction (§6)
    backoff_min: float = 0.5  # randomized retry backoff (§5 liveness workaround)
    backoff_max: float = 2.0
    rtt_estimate: float = 0.05  # informational; algorithm never relies on it
    round_timeout: float = 0.0  # give up on a round after this; 0 = 8x RTT estimate
    clock_drift_bound: float = 0.0  # ε: |rate-1| ≤ ε for every local clock
    drift_guard: bool = False  # proposer discounts own timer to T/(1+2ε) when True

    def __post_init__(self) -> None:
        if self.lease_timespan >= self.max_lease_time:
            raise ValueError("PaxosLease requires T < M (paper §2)")
        if self.n_acceptors < 1:
            raise ValueError("need at least one acceptor")

    @property
    def majority(self) -> int:
        return self.n_acceptors // 2 + 1


DEFAULT_CELL = CellConfig()

# Keyspace-style master-lease cell: 3 replicas, aggressive renewal.
MASTER_CELL = CellConfig(
    n_acceptors=3,
    max_lease_time=30.0,
    lease_timespan=7.0,
    renew_fraction=0.4,
)
