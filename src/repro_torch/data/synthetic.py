"""Deterministic synthetic token streams.

Tokens are generated by a counter-based hash (stateless — any (shard, step)
batch can be regenerated anywhere, which is what makes lease-based shard
handoff trivially exactly-once-ish: the new owner re-derives the stream from
the committed step). A learnable structure (repeating Markov-ish pattern) is
mixed in so small models show a decreasing loss curve."""
from __future__ import annotations

import numpy as np


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0, pattern_order: int = 3) -> None:
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        rng = np.random.default_rng(seed)
        # fixed random "grammar": next token = f(prev) with noise
        self.table = rng.integers(0, vocab_size, size=(pattern_order, vocab_size), dtype=np.int64)

    def batch(self, shard: int, step: int, batch_size: int) -> dict:
        """Returns {tokens, labels} with labels = next-token shift."""
        ss = np.random.SeedSequence([self.seed, shard, step])
        rng = np.random.default_rng(ss)
        toks = np.empty((batch_size, self.seq + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch_size)
        noise = rng.random((batch_size, self.seq))
        jumps = rng.integers(0, self.vocab, size=(batch_size, self.seq))
        for t in range(1, self.seq + 1):
            fol = self.table[t % self.table.shape[0], toks[:, t - 1]]
            toks[:, t] = np.where(noise[:, t - 1] < 0.85, fol, jumps[:, t - 1])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
