"""Greedy minimizer for violating scenarios (the survivor triage step).

Hypothesis-style shrinking, specialized to scenario planes: repeatedly
try simplifications that keep the §4 violation alive — truncate trailing
ticks, then reset plane entries to their registered defaults in halving
blocks (delta debugging), finishing with single-entry passes. Each probe
is one single-scenario summary ``engine.sweep`` (read-only, so one engine
serves every probe): one launch of a batched lease kernel on the card
(the delayed one, or the sync one for a zero-delay fault-free probe) and
one host read of its verdict. A copy of ``repro.lease_array.falsify.
shrink``: the same probes in the same order, so the same result.

The result is the smallest scenario this pass ladder reaches: fewer
nonzero fault entries and fewer ticks, same violation — the form to
check into ``falsify/corpus/`` or to replay through the event-sim
referee (``trace.trace_from_scenario``) for triage.
"""
from __future__ import annotations

import numpy as np

from ..engine import LeaseArrayEngine
from ..scenario import PLANES, Scenario

__all__ = ["shrink"]


def _violates(eng: LeaseArrayEngine, planes: dict) -> bool:
    res = eng.sweep(
        Scenario({k: v[None] for k, v in planes.items()}), verify=False,
    )
    return bool(res.max_owner_count[0] > 1)


def shrink(
    scenario: Scenario,
    engine: LeaseArrayEngine,
    *,
    budget: int = 200,
    log=None,
) -> Scenario:
    """Minimize ``scenario`` while ``engine.sweep`` still reports a §4
    violation for it. Deterministic (no randomness — pass order is plane
    registry order); returns the original scenario unchanged if it does
    not violate to begin with. ``budget`` caps the number of sweep
    probes; ``log`` is an optional ``callable(str)``."""
    planes = {k: np.array(v, np.int32) for k, v in scenario.planes.items()}
    probes = 0

    def spend(p: dict) -> bool:
        nonlocal probes
        if probes >= budget:
            return False
        probes += 1
        return _violates(engine, p)

    if not spend(planes):
        return scenario

    # pass 1: truncate trailing ticks by halving (logarithmic)
    T = planes["attempts"].shape[0]
    while T > 1:
        t2 = max(1, T // 2)
        cut = {k: v[:t2] for k, v in planes.items()}
        if spend(cut):
            planes, T = {k: np.array(v) for k, v in cut.items()}, t2
        else:
            break
    if log is not None:
        log(f"shrink: {T} ticks after truncation")

    # pass 2: per plane, reset entries to the registered default in
    # halving tick-blocks, then singly (fixed T)
    for name, spec in PLANES.items():
        arr = planes[name]
        default = spec.default
        block = T
        while block >= 1:
            t = 0
            while t < T:
                sl = slice(t, min(t + block, T))
                if not (arr[sl] == default).all():
                    trial = dict(planes)
                    cand = np.array(arr)
                    cand[sl] = default
                    trial[name] = cand
                    if spend(trial):
                        planes, arr = trial, cand
                t += block
            block //= 2
            if probes >= budget:
                break
        if probes >= budget:
            break
    if log is not None:
        nz = sum(
            int((planes[k] != s.default).sum()) for k, s in PLANES.items()
        )
        log(f"shrink: {nz} non-default entries after {probes} probes")
    return Scenario(planes)
