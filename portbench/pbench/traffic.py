"""Traffic: the training rows and the prompts, made from the seed.

Training rows are what the program's own loader serves (its synthetic
token stream over its shards). This is a frozen copy of that arithmetic, so
the reference builds the same rows itself and a change to the loader's
output shows as a wrong loss. Prompts are a fixed set of lengths,
log-spaced over the mix's range, that every seed shares; the seed draws
their order and their token ids (uniform over the vocabulary, on the
device, in one call).
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: the loader's grammar: order of the table of follow-on tokens, and the
#: share of positions that follow it rather than jump
PATTERN_ORDER = 3
FOLLOW = 0.85


def synthetic_rows(vocab: int, seq: int, seed: int, shard: int, step: int, rows: int) -> dict:
    """``rows`` rows of shard ``shard`` at its step ``step``: tokens and
    next-token labels, int32 (B, seq)."""
    table = np.random.default_rng(seed).integers(0, vocab, size=(PATTERN_ORDER, vocab),
                                                 dtype=np.int64)
    rng = np.random.default_rng(np.random.SeedSequence([seed, shard, step]))
    toks = np.empty((rows, seq + 1), dtype=np.int64)
    toks[:, 0] = rng.integers(0, vocab, size=rows)
    noise = rng.random((rows, seq))
    jumps = rng.integers(0, vocab, size=(rows, seq))
    for t in range(1, seq + 1):
        fol = table[t % PATTERN_ORDER, toks[:, t - 1]]
        toks[:, t] = np.where(noise[:, t - 1] < FOLLOW, fol, jumps[:, t - 1])
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def train_batch(vocab: int, seq: int, seed: int, n_shards: int, batch: int, step: int) -> dict:
    """The loader's ``step``-th global batch (from 0): every shard in turn,
    ``batch // n_shards`` rows each (at least one), cut to ``batch`` rows."""
    per = max(1, batch // n_shards)
    parts, have = [], 0
    for shard in range(n_shards):
        parts.append(synthetic_rows(vocab, seq, seed, shard, step, per))
        have += per
        if have >= batch:
            break
    return {k: np.concatenate([p[k] for p in parts])[:batch] for k in parts[0]}


def prompt_lengths(mix: dict) -> list:
    """The mix's fixed lengths: ``n_lengths`` points at the middles of equal
    steps of log length over [min_len, max_len], rounded to ``len_multiple``."""
    lo, hi, n, q = mix["min_len"], mix["max_len"], mix["n_lengths"], mix["len_multiple"]
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (i + 0.5) / n * (math.log(hi) - math.log(lo)))
        out.append(min(hi, max(lo, q * round(x / q))))
    return out


def prompts(mix: dict, vocab: int, seed: int, device) -> list:
    """The requests of one pass, in the seed's order: [(length, tokens (S,) int32)]."""
    lengths = prompt_lengths(mix)
    order = np.random.default_rng(np.random.SeedSequence([seed, 1])).permutation(len(lengths))
    # a stream of its own, apart from the weights' (which take the seed itself)
    stream = int(np.random.SeedSequence([seed, 3]).generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(stream)
    ids = torch.randint(0, vocab, (sum(lengths),), generator=gen, device=device, dtype=torch.int64)
    ids = ids.to(torch.int32)
    out, at = [], 0
    for i in order:
        out.append((lengths[i], ids[at:at + lengths[i]]))
        at += lengths[i]
    return out


def sample(n_requests: int, k: int, longest: int, seed: int) -> list:
    """``k`` request indices drawn from the seed, the longest among them."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    rest = [i for i in rng.permutation(n_requests).tolist() if i != longest]
    return sorted([longest] + rest[:k - 1])
