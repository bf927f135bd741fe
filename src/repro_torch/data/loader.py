"""Sharded loader whose shard set can be lease-driven.

``owned_shards`` is a callable so it can be wired straight to a
``ShardWorker.owned`` set from the lease control plane: the loader only
emits batches from shards this worker currently holds, and a shard that
expires mid-epoch simply stops contributing (its new owner resumes it from
the step counter — streams are stateless, see data.synthetic)."""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from .synthetic import SyntheticTokens


class ShardedLoader:
    def __init__(
        self,
        gen: SyntheticTokens,
        n_shards: int,
        batch_size: int,
        *,
        owned_shards: Optional[Callable[[], Iterable[int]]] = None,
    ) -> None:
        self.gen = gen
        self.n_shards = n_shards
        self.batch_size = batch_size
        self.owned_shards = owned_shards or (lambda: range(n_shards))
        self.step_per_shard: dict[int, int] = {k: 0 for k in range(n_shards)}

    def next_batch(self) -> dict:
        owned = sorted(self.owned_shards())
        if not owned:
            raise RuntimeError("worker owns no shards (lease-starved)")
        per = max(1, self.batch_size // len(owned))
        parts = []
        for k in owned:
            b = self.gen.batch(k, self.step_per_shard[k], per)
            self.step_per_shard[k] += 1
            parts.append(b)
            if sum(p["tokens"].shape[0] for p in parts) >= self.batch_size:
                break
        out = {
            key: np.concatenate([p[key] for p in parts], axis=0)[: self.batch_size]
            for key in parts[0]
        }
        return out
