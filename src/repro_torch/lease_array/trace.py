"""Fault/timing traces for the lease plane.

A trace is the *entire* timing of the world — which proposer attempts which
cell at which tick, who releases, which acceptors are unreachable, and (in
the delayed model) how long every message leg takes and which legs are
lost, how fast each node's clock runs, who crashes, who renews. A
:class:`Trace` converts to the engine's :class:`Scenario` via
:meth:`Trace.scenario`.

``random_trace`` draws from ``numpy.random.default_rng(seed)`` in the same
order as the reference generator, so one seed gives the same planes in both
packages. The construction keeps replays exact (see the reference's
``lease_array/trace.py``): one attempting proposer per (cell, tick); in
delayed traces attempts on one cell are spaced ``> 4 * max_delay`` ticks
apart and releases ``> max_delay`` apart, so an in-flight slot is never
overwritten while its message still matters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .scenario import PLANES, Scenario, _coerce_plane, _dim_sizes
from .state import DEFAULT_RATE, MAX_RESTARTS, NO_PROPOSER

#: drifted clock-rate steps an event-driven referee can replay exactly
#: (every timer lands at a fraction m/r into a tick, with r <= 9 clear of
#: its sampling offsets); random_trace caps drifted rates here
MAX_REFEREE_RATE = 9


@dataclass
class Trace:
    n_cells: int
    n_acceptors: int
    n_proposers: int
    lease_ticks: int
    attempts: np.ndarray  # [T, N] int32: proposer attempting (or -1)
    releases: np.ndarray  # [T, N] int32: proposer releasing (or -1)
    acc_up: np.ndarray    # [T, A] bool: acceptor reachability
    #: per-leg delay in whole ticks: asymmetric [T, P, A], or the symmetric
    #: per-acceptor [T, A] special case (broadcast over P)
    delay: Optional[np.ndarray] = None
    drop: Optional[np.ndarray] = None   # [T, P, A] or [T, A] bool: per-leg loss
    round_ticks: int = 1  # proposer abandons a round after this many ticks
    #: constant per-node clock-rate steps (local quarter-ticks per global
    #: tick; 4 = rate 1.0)
    prop_rate: Optional[np.ndarray] = None  # [P] int
    acc_rate: Optional[np.ndarray] = None   # [A] int
    drift_eps: float = 0.0  # ε the proposers' drift guard assumes
    #: crash/restart schedules (§2's diskless failure model)
    acc_restarts: Optional[np.ndarray] = None   # [T, A] 0/1
    prop_restarts: Optional[np.ndarray] = None  # [T, P] 0/1
    #: §6 owner-extension schedule (-1 = none; non-owner extends are no-ops)
    extends: Optional[np.ndarray] = None        # [T, N] int32

    @property
    def n_ticks(self) -> int:
        return self.attempts.shape[0]

    @property
    def delayed(self) -> bool:
        """True if the trace carries a nonzero delay or drop plane."""
        return bool(
            (self.delay is not None and self.delay.any())
            or (self.drop is not None and self.drop.any())
        )

    @property
    def restarted(self) -> bool:
        """True if the trace carries any crash/restart event."""
        return bool(
            (self.acc_restarts is not None and self.acc_restarts.any())
            or (self.prop_restarts is not None and self.prop_restarts.any())
        )

    @property
    def extended(self) -> bool:
        """True if the trace schedules any §6 owner extension."""
        return bool(
            self.extends is not None and (self.extends != NO_PROPOSER).any()
        )

    @property
    def drifted(self) -> bool:
        """True if any node's clock departs from the drift-free rate."""
        return bool(
            (self.prop_rate is not None
             and (self.prop_rate != DEFAULT_RATE).any())
            or (self.acc_rate is not None
                and (self.acc_rate != DEFAULT_RATE).any())
        )

    def rate_planes(self) -> tuple[np.ndarray, np.ndarray]:
        """The constant per-node rates as [T, P]/[T, A] scenario planes."""
        T = self.n_ticks
        pr = (
            np.full(self.n_proposers, DEFAULT_RATE, np.int32)
            if self.prop_rate is None
            else np.asarray(self.prop_rate, np.int32)
        )
        ar = (
            np.full(self.n_acceptors, DEFAULT_RATE, np.int32)
            if self.acc_rate is None
            else np.asarray(self.acc_rate, np.int32)
        )
        return (
            np.broadcast_to(pr[None, :], (T, self.n_proposers)).copy(),
            np.broadcast_to(ar[None, :], (T, self.n_acceptors)).copy(),
        )

    def scenario(self) -> Scenario:
        """The trace's fault planes as one Scenario (defaulted, validated,
        [T, A] forms broadcast to [T, P, A])."""
        prop_rate, acc_rate = self.rate_planes()
        return Scenario.build(
            self.n_ticks,
            n_cells=self.n_cells,
            n_acceptors=self.n_acceptors,
            n_proposers=self.n_proposers,
            attempts=self.attempts,
            releases=self.releases,
            acc_up=self.acc_up,
            delay=self.delay,
            drop=self.drop,
            prop_rate=prop_rate,
            acc_rate=acc_rate,
            acc_restart=self.acc_restarts,
            prop_restart=self.prop_restarts,
            extends=self.extends,
        )

    def link_planes(self) -> tuple[np.ndarray, np.ndarray]:
        """Canonical [T, P, A] (delay, drop) link matrices, zero-defaulted."""
        sizes = _dim_sizes(self.n_cells, self.n_acceptors, self.n_proposers)
        lead = (self.n_ticks,)
        return (
            _coerce_plane(PLANES["delay"], self.delay, sizes, lead, "trace"),
            _coerce_plane(PLANES["drop"], self.drop, sizes, lead, "trace"),
        )


def random_trace(
    seed: int,
    *,
    n_ticks: int = 200,
    n_cells: int = 16,
    n_acceptors: int = 5,
    n_proposers: int = 4,
    lease_ticks: int = 3,
    p_attempt: float = 0.35,
    p_release: float = 0.05,
    p_down_flip: float = 0.02,
    max_delay_ticks: int = 0,
    p_drop: float = 0.0,
    asymmetric: bool = False,
    round_ticks: Optional[int] = None,
    drift_eps: float = 0.0,
    restarts: float = 0.0,
    renew: float = 0.0,
) -> Trace:
    """Randomized trace: per (tick, cell) at most one attempting proposer;
    releases name a random proposer (a no-op unless it owns); acceptor
    up/down flips as a Markov chain so outages are sticky.

    ``max_delay_ticks``/``p_drop`` add lossy/laggy link schedules (uniform
    delays in [0, max_delay_ticks]; ``asymmetric`` draws per-(proposer,
    acceptor) [T, P, A] planes, else the symmetric [T, A] form), with the
    slot-isolation spacing of attempts and releases; ``round_ticks``
    defaults to ``max_delay_ticks + 1``. ``drift_eps`` gives every node a
    constant drifted clock with integer rate steps in
    ``[⌈4(1-ε)⌉, ⌊4(1+ε)⌋]`` (capped at MAX_REFEREE_RATE). ``restarts``
    adds crash/restart schedules (acceptors at that rate per tick,
    proposers at half of it, at most MAX_RESTARTS per proposer). ``renew``
    adds a §6 extends schedule: the attempting proposer re-proposes every
    ``max(4·max_delay + 1, round(lease_ticks·renew))`` ticks until its next
    attempt or release touches the cell.
    """
    rng = np.random.default_rng(seed)
    prop_rate = acc_rate = None
    if drift_eps > 0.0:
        lo = max(1, int(np.ceil(DEFAULT_RATE * (1.0 - drift_eps))))
        hi = min(MAX_REFEREE_RATE, int(DEFAULT_RATE * (1.0 + drift_eps)))
        prop_rate = rng.integers(lo, hi + 1, n_proposers).astype(np.int32)
        acc_rate = rng.integers(lo, hi + 1, n_acceptors).astype(np.int32)
    attempts = np.where(
        rng.random((n_ticks, n_cells)) < p_attempt,
        rng.integers(0, n_proposers, (n_ticks, n_cells)),
        NO_PROPOSER,
    ).astype(np.int32)
    releases = np.where(
        rng.random((n_ticks, n_cells)) < p_release,
        rng.integers(0, n_proposers, (n_ticks, n_cells)),
        NO_PROPOSER,
    ).astype(np.int32)
    acc_up = np.empty((n_ticks, n_acceptors), bool)
    up = np.ones(n_acceptors, bool)
    for t in range(n_ticks):
        up ^= rng.random(n_acceptors) < p_down_flip
        acc_up[t] = up
    delay = drop = None
    link_shape = (
        (n_ticks, n_proposers, n_acceptors) if asymmetric
        else (n_ticks, n_acceptors)
    )
    if round_ticks is None:
        round_ticks = max_delay_ticks + 1
    if max_delay_ticks > 0:
        delay = rng.integers(0, max_delay_ticks + 1, link_shape).astype(np.int32)

        def space(rows: np.ndarray, gap: int) -> None:
            # slot isolation: keep same-cell events farther apart than the
            # lifetime of the in-flight messages they generate
            last = np.full(n_cells, -gap, np.int64)
            for t in range(n_ticks):
                ok = (rows[t] >= 0) & (t - last >= gap)
                rows[t] = np.where(ok, rows[t], NO_PROPOSER)
                last = np.where(ok, t, last)

        # a round's messages leave the network within 4 * max_delay ticks;
        # a release's discard legs within max_delay
        space(attempts, 4 * max_delay_ticks + 1)
        space(releases, max_delay_ticks + 1)
    if p_drop > 0.0:
        drop = rng.random(link_shape) < p_drop
    extends = None
    if renew > 0.0:
        gap = 4 * max_delay_ticks + 1
        interval = max(gap, int(round(lease_ticks * renew)), 1)
        extends = np.full((n_ticks, n_cells), NO_PROPOSER, np.int32)
        # next attempt at-or-after each tick, per cell (backward scan): an
        # extend too close before a future attempt would have its in-flight
        # round slots overwritten — suppress it instead
        INF = np.int64(1) << 60
        next_att = np.full((n_ticks + 1, n_cells), INF, np.int64)
        for t in range(n_ticks - 1, -1, -1):
            next_att[t] = np.where(attempts[t] >= 0, t, next_att[t + 1])
        last_prop = np.full(n_cells, NO_PROPOSER, np.int64)
        next_ext = np.full(n_cells, INF, np.int64)
        for t in range(n_ticks):
            hit = attempts[t] >= 0
            # a fresh attempt restarts the cadence from its own tick ...
            last_prop = np.where(hit, attempts[t], last_prop)
            next_ext = np.where(hit, t + interval, next_ext)
            # ... its own release ends it (the owner stops wanting it)
            quit_ = (releases[t] >= 0) & (releases[t] == last_prop)
            last_prop = np.where(quit_, NO_PROPOSER, last_prop)
            due = (
                (last_prop >= 0) & (t >= next_ext) & ~hit
                & (next_att[t + 1] - t >= gap)
            )
            extends[t] = np.where(due, last_prop, NO_PROPOSER)
            next_ext = np.where(due, t + interval, next_ext)
    acc_restarts = prop_restarts = None
    if restarts > 0.0:
        acc_restarts = (
            rng.random((n_ticks, n_acceptors)) < restarts
        ).astype(np.int32)
        prop_restarts = (
            rng.random((n_ticks, n_proposers)) < restarts / 2
        ).astype(np.int32)
        # the ballot carve holds MAX_RESTARTS per proposer: keep the first
        # MAX_RESTARTS draws, drop the rest (the engine refuses overflows)
        for p in range(n_proposers):
            hits = np.flatnonzero(prop_restarts[:, p])
            prop_restarts[hits[MAX_RESTARTS:], p] = 0
    return Trace(
        n_cells, n_acceptors, n_proposers, lease_ticks,
        attempts, releases, acc_up,
        delay=delay, drop=drop, round_ticks=int(round_ticks),
        prop_rate=prop_rate, acc_rate=acc_rate, drift_eps=float(drift_eps),
        acc_restarts=acc_restarts, prop_restarts=prop_restarts,
        extends=extends,
    )
