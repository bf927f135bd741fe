"""Synthetic token streams and the lease-driven sharded loader: numpy
copies of ``repro.data`` (the port imports nothing of the reference), so
that any (seed, shard, step) gives the reference's batch byte for byte."""
from .loader import ShardedLoader
from .synthetic import SyntheticTokens

__all__ = ["ShardedLoader", "SyntheticTokens"]
