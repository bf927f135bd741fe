"""Cluster services on PaxosLease, the port of ``repro.cluster``: the §9
master lease (``coordinator``), heartbeat membership (``membership``), the
elastic shard-target controller the master runs (``autoscale``) and shard
ownership by fine-grained leases (``shards``), on the port's event-driven
engine (``core/``) or, at thousands of shards, its lease-array directory."""
from .autoscale import AutoscaleController
from .coordinator import CoordinatorService
from .membership import MembershipTracker
from .shards import ShardLeaseManager, ShardWorker, build_shard_manager

__all__ = [
    "AutoscaleController",
    "CoordinatorService",
    "MembershipTracker",
    "ShardLeaseManager",
    "ShardWorker",
    "build_shard_manager",
]
