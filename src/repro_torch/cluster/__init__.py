"""Cluster services on PaxosLease, the port of ``repro.cluster``: shard
ownership by fine-grained leases (``shards.py``), on the port's event-driven
engine (``core/``) or, at thousands of shards, its lease-array directory.
``autoscale``, ``coordinator`` and ``membership`` are not ported yet."""
from .shards import ShardLeaseManager, ShardWorker, build_shard_manager

__all__ = ["ShardLeaseManager", "ShardWorker", "build_shard_manager"]
