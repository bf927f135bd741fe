"""Structure-aware mutation operators over stacked scenario planes (numpy,
a copy of ``repro.lease_array.falsify.mutate``: one seed, the same mutants).

A population is the ``Scenario.stack`` form: a dict of ``[B, T, ...]``
int32 numpy planes. Every operator edits ONE structural feature of each
assigned member — move an attempt by a tick, nudge one node's clock rate,
drop one leg of a quorum — rather than resampling noise, so offspring
stay in the neighborhood their parent's margin score was earned in.

All operators are vectorized over the members they are assigned to
(fancy-indexed writes, no per-member Python loop: mutation must not be
the bottleneck of a million-scenario search) and are **closed under
``Scenario.validate``**: writes are clipped to each plane's registered
floors (delays >= 0, clock rates >= 1 via ``MutationSpace.rate_lo``),
proposer ids stay in ``[-1, P)``, masks stay 0/1. Determinism: the only
randomness is the caller's ``np.random.Generator`` — one seed, one
mutant batch, bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..scenario import CORRUPTION_PLANES, EXTEND_PLANES, RESTART_PLANES
from ..state import DEFAULT_RATE, I32, MAX_RESTARTS, NO_PROPOSER, resolve_device

__all__ = ["MUTATION_OPS", "MutationSpace", "default_rate_planes", "mutate"]


@dataclass(frozen=True)
class MutationSpace:
    """The bounds mutants must stay inside: the scenario geometry plus the
    fault-plane ranges the search explores. ``rate_lo >= 1`` and
    ``delay_hi >= 0`` keep every operator closed under
    ``Scenario.validate`` (the registry's ``min_value`` floors)."""

    n_ticks: int
    n_cells: int
    n_acceptors: int
    n_proposers: int
    delay_hi: int = 2      # per-leg delay ceiling (whole ticks)
    rate_lo: int = 3       # clock-rate floor (>= 1; 3..5 bounds eps=0.25)
    rate_hi: int = 5       # clock-rate ceiling
    corrupt: bool = False  # also mutate the acc_stale/acc_equiv planes
    restart: bool = False  # also mutate the acc_restart/prop_restart planes
    extend: bool = False   # also mutate the §6 extends plane
    #: per-proposer restart ceiling (the packed ballot's RESTART_SHIFT
    #: carve); crash inserts that would overflow it are dropped, keeping
    #: every mutant inside check_pack_budget's refusal boundary
    max_restarts: int = MAX_RESTARTS
    lease_ticks: int = 2   # M in whole ticks — the deaf-boundary reach

    def op_names(self) -> tuple[str, ...]:
        cor, rst = set(CORRUPTION_PLANES), set(RESTART_PLANES)
        ext = set(EXTEND_PLANES)
        names = tuple(
            n for n, (_, planes) in MUTATION_OPS.items()
            if not set(planes) & (cor | rst | ext)
        )
        if self.corrupt:
            names += tuple(
                n for n, (_, planes) in MUTATION_OPS.items()
                if set(planes) & cor
            )
        if self.restart:
            names += tuple(
                n for n, (_, planes) in MUTATION_OPS.items()
                if set(planes) & rst
            )
        if self.extend:
            names += tuple(
                n for n, (_, planes) in MUTATION_OPS.items()
                if set(planes) & ext
            )
        return names


def _coords(rng: np.random.Generator, b: np.ndarray, *sizes: int):
    """One random coordinate per member of ``b`` along each extra axis."""
    return tuple(rng.integers(0, s, b.size) for s in sizes)


# every operator: fn(planes, b, rng, space) mutating planes in place for
# the member indices ``b`` (planes are already this generation's copies)
def _op_shift_attempt(planes, b, rng, sp):
    """Move one cell's attempt by ±1 tick (the classic delivery nudge)."""
    t, n = _coords(rng, b, sp.n_ticks, sp.n_cells)
    t2 = np.clip(t + rng.choice((-1, 1), b.size), 0, sp.n_ticks - 1)
    a = planes["attempts"]
    v = a[b, t, n].copy()
    a[b, t, n] = NO_PROPOSER
    a[b, t2, n] = v


def _op_flip_attempt(planes, b, rng, sp):
    """Retarget one (tick, cell) attempt slot: new proposer id or none."""
    t, n = _coords(rng, b, sp.n_ticks, sp.n_cells)
    planes["attempts"][b, t, n] = rng.integers(
        NO_PROPOSER, sp.n_proposers, b.size
    )


def _op_flip_release(planes, b, rng, sp):
    """Retarget one (tick, cell) release slot: new proposer id or none."""
    t, n = _coords(rng, b, sp.n_ticks, sp.n_cells)
    planes["releases"][b, t, n] = rng.integers(
        NO_PROPOSER, sp.n_proposers, b.size
    )


def _op_nudge_prop_rate(planes, b, rng, sp):
    """±1 quarter-tick on one proposer's clock step at one tick."""
    t, p = _coords(rng, b, sp.n_ticks, sp.n_proposers)
    r = planes["prop_rate"]
    r[b, t, p] = np.clip(
        r[b, t, p] + rng.choice((-1, 1), b.size), sp.rate_lo, sp.rate_hi
    )


def _op_nudge_acc_rate(planes, b, rng, sp):
    """±1 quarter-tick on one acceptor's clock step at one tick."""
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    r = planes["acc_rate"]
    r[b, t, a] = np.clip(
        r[b, t, a] + rng.choice((-1, 1), b.size), sp.rate_lo, sp.rate_hi
    )


def _op_shift_delay(planes, b, rng, sp):
    """±1 tick on one (tick, proposer, acceptor) link leg's delay."""
    t, p, a = _coords(rng, b, sp.n_ticks, sp.n_proposers, sp.n_acceptors)
    d = planes["delay"]
    d[b, t, p, a] = np.clip(
        d[b, t, p, a] + rng.choice((-1, 1), b.size), 0, sp.delay_hi
    )


def _op_drop_leg(planes, b, rng, sp):
    """Toggle loss of one (tick, proposer, acceptor) link leg — drop (or
    restore) one leg of a quorum."""
    t, p, a = _coords(rng, b, sp.n_ticks, sp.n_proposers, sp.n_acceptors)
    d = planes["drop"]
    d[b, t, p, a] = 1 - d[b, t, p, a]


def _op_flip_acc_up(planes, b, rng, sp):
    """Toggle one acceptor's reachability at one tick."""
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    u = planes["acc_up"]
    u[b, t, a] = 1 - u[b, t, a]


def _op_flip_stale(planes, b, rng, sp):
    """Toggle one acceptor's stale-ballot injection at one tick
    (corruption negative control only)."""
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    s = planes["acc_stale"]
    s[b, t, a] = 1 - s[b, t, a]


def _op_flip_equiv(planes, b, rng, sp):
    """Toggle one acceptor's equivocating response at one tick
    (corruption negative control only)."""
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    e = planes["acc_equiv"]
    e[b, t, a] = 1 - e[b, t, a]


def _op_flip_extend(planes, b, rng, sp):
    """Retarget one (tick, cell) §6 extend slot: new proposer id or none.
    Most writes are inert (the gate requires the LIVE owner); the hits
    probe a renewal round against everything else in flight."""
    t, n = _coords(rng, b, sp.n_ticks, sp.n_cells)
    planes["extends"][b, t, n] = rng.integers(
        NO_PROPOSER, sp.n_proposers, b.size
    )


def _op_shift_extend(planes, b, rng, sp):
    """Move one cell's extend by ±1 tick — the renewal round slides
    against expiry ties, releases and deaf windows."""
    t, n = _coords(rng, b, sp.n_ticks, sp.n_cells)
    t2 = np.clip(t + rng.choice((-1, 1), b.size), 0, sp.n_ticks - 1)
    e = planes["extends"]
    v = e[b, t, n].copy()
    e[b, t, n] = NO_PROPOSER
    e[b, t2, n] = v


def _op_crash_insert(planes, b, rng, sp):
    """Toggle one node restart (crash/restart plane operators only join
    the pool when MutationSpace.restart is set): an acceptor — blank +
    deaf for M — or a proposer — restart-counter bump. Proposer toggles
    stay closed under the RESTART_SHIFT carve: an insert that would push
    that proposer past ``sp.max_restarts`` total restarts is dropped."""
    acc = rng.random(b.size) < 0.5
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    t2, p = _coords(rng, b, sp.n_ticks, sp.n_proposers)
    ra = planes["acc_restart"]
    ba, ta, aa = b[acc], t[acc], a[acc]
    ra[ba, ta, aa] = 1 - ra[ba, ta, aa]
    rp = planes["prop_restart"]
    bp, tp, pp = b[~acc], t2[~acc], p[~acc]
    rp[bp, tp, pp] = 1 - rp[bp, tp, pp]
    over = rp[bp].sum(axis=1)[np.arange(bp.size), pp] > sp.max_restarts
    rp[bp[over], tp[over], pp[over]] = 0


def _op_crash_shift(planes, b, rng, sp):
    """Move one acceptor-restart slot by ±1 tick — the whole deaf window
    slides against the quorum traffic around it."""
    t, a = _coords(rng, b, sp.n_ticks, sp.n_acceptors)
    t2 = np.clip(t + rng.choice((-1, 1), b.size), 0, sp.n_ticks - 1)
    r = planes["acc_restart"]
    v = r[b, t, a].copy()
    r[b, t, a] = 0
    r[b, t2, a] |= v


def _op_deaf_boundary_nudge(planes, b, rng, sp):
    """Plant one acceptor restart so its M-long deaf window expires right
    around a random (tick, cell) attempt slot (±1 tick of jitter) — the
    §4-critical boundary where an acceptor rejoins, blank, exactly as a
    foreign quorum wants its vote."""
    t, _, a = _coords(rng, b, sp.n_ticks, sp.n_cells, sp.n_acceptors)
    jitter = rng.integers(-1, 2, b.size)
    t0 = np.clip(t - sp.lease_ticks + jitter, 0, sp.n_ticks - 1)
    planes["acc_restart"][b, t0, a] = 1


#: name -> (operator, planes it writes); corruption-plane operators join
#: the pool only when MutationSpace.corrupt is set, restart-plane
#: operators only when MutationSpace.restart is set
MUTATION_OPS = {
    "shift_attempt": (_op_shift_attempt, ("attempts",)),
    "flip_attempt": (_op_flip_attempt, ("attempts",)),
    "flip_release": (_op_flip_release, ("releases",)),
    "nudge_prop_rate": (_op_nudge_prop_rate, ("prop_rate",)),
    "nudge_acc_rate": (_op_nudge_acc_rate, ("acc_rate",)),
    "shift_delay": (_op_shift_delay, ("delay",)),
    "drop_leg": (_op_drop_leg, ("drop",)),
    "flip_acc_up": (_op_flip_acc_up, ("acc_up",)),
    "flip_stale": (_op_flip_stale, ("acc_stale",)),
    "flip_equiv": (_op_flip_equiv, ("acc_equiv",)),
    "flip_extend": (_op_flip_extend, ("extends",)),
    "shift_extend": (_op_shift_extend, ("extends",)),
    "crash_insert": (_op_crash_insert, ("acc_restart", "prop_restart")),
    "crash_shift": (_op_crash_shift, ("acc_restart",)),
    "deaf_boundary_nudge": (_op_deaf_boundary_nudge, ("acc_restart",)),
}


def mutate(
    planes: dict,
    rng: np.random.Generator,
    space: MutationSpace,
) -> tuple[dict, np.ndarray]:
    """One mutation per population member: each of the B members draws one
    operator uniformly from ``space.op_names()`` and applies it at a
    random coordinate. Returns ``(mutant_planes, op_index)`` — a NEW dict
    (mutated planes copied, untouched planes shared) plus the per-member
    operator index into ``space.op_names()`` for lineage tags.
    """
    names = space.op_names()
    B = planes["attempts"].shape[0]
    op_idx = rng.integers(0, len(names), B)
    touched = set()
    for i in range(len(names)):
        touched.update(MUTATION_OPS[names[i]][1])
    out = {
        k: (np.array(v, np.int32) if k in touched else np.asarray(v))
        for k, v in planes.items()
    }
    for i, name in enumerate(names):
        b = np.flatnonzero(op_idx == i)
        if b.size:
            MUTATION_OPS[name][0](out, b, rng, space)
    return out, op_idx


def default_rate_planes(B: int, T: int, P: int, A: int, *, device="cuda") -> dict:
    """Drift-free [B, T, P]/[B, T, A] rate planes (the DEFAULT_RATE fill), as
    int32 tensors on ``device``."""
    device = resolve_device(device)
    return {
        "prop_rate": torch.full((B, T, P), DEFAULT_RATE, dtype=I32, device=device),
        "acc_rate": torch.full((B, T, A), DEFAULT_RATE, dtype=I32, device=device),
    }
