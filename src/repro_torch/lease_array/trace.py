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

The differential referee: :func:`replay_event_sim` replays a trace through
the event-driven engine (``core/`` and ``sim/``, copies of the reference's,
pure Python) with every message leg's timing pinned to the trace, and
:func:`replay_array` through the vectorized plane (``"torch"`` or the CUDA
kernels). Both give the same owners [T, N] at every tick on traces built
as above. Why the pinning is exact (quarter-tick lease spans, the
DELIVER_EPS/REL_EPS/ABANDON_EPS offsets, ballots pinned to the tick, drift
as NodeClock rates r/4) is set out in the reference's ``trace.py``; the
arithmetic here is the same, line for line.
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace
from typing import Optional

import numpy as np

from ..configs.paxoslease_cell import CellConfig
from ..core.cell import build_cell
from ..core.messages import (
    PrepareRequest,
    PrepareResponse,
    ProposeRequest,
    ProposeResponse,
    Release,
)
from ..sim.network import NetConfig
from .engine import LeaseArrayEngine
from .scenario import PLANES, Scenario, _coerce_plane, _dim_sizes
from .state import (
    DEFAULT_RATE,
    MAX_RESTARTS,
    NO_PROPOSER,
    guarded_lease_q4,
    lease_quarters,
)

#: drifted clock-rate steps the referee can replay exactly: a node at rate
#: ``r`` quarter-ticks per tick places every timer landing at a fraction
#: ``m/r`` into a tick; with r <= 9 any nonzero fraction is >= 1/9, clear
#: of the DELIVER_EPS/TICK_EPS sampling offsets below (m/r == 0 ties are
#: resolved by the scheduler's insertion-order heap exactly like the array
#: step's expiries-before-deliveries order)
MAX_REFEREE_RATE = 9

TICK_EPS = 0.1  # sample offset into a tick; < 0.25 so no expiry slips in
DELIVER_EPS = 0.05  # phase messages land here within their delivery tick
REL_EPS = 0.03  # §7 discards land here: after abandons, before phase legs
ABANDON_EPS = 0.02  # round timer fires here: before deliveries, after attempts

#: messages governed by the trace's delay/drop planes (every protocol leg;
#: LearnHints stay out-of-band — advisory, never authoritative)
PHASE_MESSAGES = (PrepareRequest, PrepareResponse, ProposeRequest, ProposeResponse)
PLANE_MESSAGES = PHASE_MESSAGES + (Release,)


def cell_resource(n: int) -> str:
    return f"cell:{n}"


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


def trace_from_scenario(
    scenario: Scenario,
    *,
    lease_ticks: int,
    round_ticks: int = 1,
    drift_eps: float = 0.0,
) -> Trace:
    """A falsification survivor as a referee-replayable :class:`Trace`
    (the triage hook: shrink a violating scenario, convert, and hand it
    to :func:`replay_event_sim` to see what the reference implementation
    does with the same world). The engine knobs (``lease_ticks``,
    ``round_ticks``, ``drift_eps``) travel outside the Scenario pytree, so
    they are passed explicitly — use the falsifier config's values.

    Two scenario features have no event-sim pin and raise here:
    per-tick *varying* clock rates (``NodeClock`` holds one constant rate
    per node) and nonzero acc_stale/acc_equiv corruption planes (the
    reference acceptors cannot be made Byzantine). Crash/restart planes DO
    convert — ``LeaseNode.crash``/``restart`` pin them exactly — as long
    as they are binary and stay under the per-proposer restart-counter
    carve (checked below). Note the exactness
    caveat: a survivor that re-attempts a cell while that cell's previous
    round is still in flight overwrites the array plane's slot (loss the
    protocol tolerates), which the event sim does not reproduce — the
    cross-engine equality tests only cover traces obeying the spacing
    construction above. Triage agreement on §4 is still the point: the
    referee monitor independently checks at-most-one-owner."""
    p = scenario.planes
    for name in ("acc_stale", "acc_equiv"):
        arr = np.asarray(p[name])
        if arr.any():
            raise ValueError(
                f"scenario carries a nonzero {name} corruption plane; the "
                "event-sim referee has no Byzantine acceptors — triage "
                "honest survivors only"
            )
    rates = []
    for name in ("prop_rate", "acc_rate"):
        arr = np.asarray(p[name], np.int32)
        if (arr != arr[:1]).any():
            raise ValueError(
                f"scenario {name} varies over ticks; the event-sim "
                "NodeClock holds one constant rate per node — constant "
                "rate columns are required for an exact replay"
            )
        rates.append(arr[0].copy())
    prop_rate, acc_rate = rates
    # crash/restart planes convert faithfully — but only 0/1 schedules:
    # a plane value > 1 would mean several restarts of one node inside a
    # single tick, which the event-sim referee replays as one (its crash/
    # restart calls are tick-granular), so refuse rather than mis-pin
    restart_planes = []
    for name in ("acc_restart", "prop_restart"):
        arr = np.asarray(p[name], np.int32)
        if arr.max(initial=0) > 1:
            raise ValueError(
                f"scenario {name} plane carries a value > 1 (several "
                "restarts of one node in one tick); the event-sim referee "
                "is tick-granular — binary restart schedules only"
            )
        restart_planes.append(arr.copy() if arr.any() else None)
    acc_restarts, prop_restarts = restart_planes
    if prop_restarts is not None and (
        prop_restarts.sum(axis=0).max(initial=0) > MAX_RESTARTS
    ):
        raise ValueError(
            f"scenario prop_restart plane restarts one proposer more than "
            f"MAX_RESTARTS={MAX_RESTARTS} times; the packed ballot "
            "restart-counter carve cannot replay it"
        )
    ext = np.asarray(p["extends"], np.int32)
    return Trace(
        scenario.n_cells, scenario.n_acceptors, scenario.n_proposers,
        int(lease_ticks),
        np.asarray(p["attempts"], np.int32),
        np.asarray(p["releases"], np.int32),
        np.asarray(p["acc_up"]) > 0,
        delay=np.asarray(p["delay"], np.int32),
        drop=np.asarray(p["drop"]) > 0,
        round_ticks=int(round_ticks),
        prop_rate=prop_rate, acc_rate=acc_rate,
        drift_eps=float(drift_eps),
        acc_restarts=acc_restarts, prop_restarts=prop_restarts,
        extends=ext.copy() if (ext != NO_PROPOSER).any() else None,
    )


def replay_array(
    trace: Trace, *, backend: str = None, netplane: Optional[bool] = None,
    restart_guard: bool = True, device="cuda",
):
    """Owners [T, N] + per-tick owner counts via the vectorized plane, as
    int32 tensors on ``device``.

    ``device``/``backend`` follow the engine's rule: the CUDA kernels on
    the card by default (raising without one), the plain ``"torch"``
    version with ``device="cpu"``. ``netplane=None`` picks the model
    automatically: the delayed in-flight plane iff the trace carries
    nonzero delay/drop/restart/extends planes, else the synchronous
    zero-delay step (they agree bit-for-bit on zero-delay traces;
    ``netplane=True`` forces the delayed path to prove it).
    ``restart_guard=False`` disables the post-restart deaf window — the
    chaos suite's negative control proving the §3 M-wait necessary.
    """
    eng = LeaseArrayEngine(
        trace.n_cells,
        n_acceptors=trace.n_acceptors,
        n_proposers=trace.n_proposers,
        lease_ticks=trace.lease_ticks,
        round_ticks=trace.round_ticks,
        drift_eps=trace.drift_eps,
        backend=backend,
        restart_guard=restart_guard,
        device=device,
    )
    return eng.run_trace(trace.scenario(), netplane=netplane)


def _pin_network_to_trace(
    net, trace: Trace, acc_index: dict[str, int], prop_index: dict[str, int]
) -> None:
    """Install deterministic delay/drop policies replaying the trace's
    planes: a protocol message sent at tick ``t`` on the (p, a) link is
    dropped iff ``drop[t, p, a]`` and otherwise delivered at
    ``t + delay[t, p, a]`` — phase legs at ``+ DELIVER_EPS``, §7 release
    legs at ``+ REL_EPS`` (the array tick delivers due discards before any
    phase message). Anything else (LearnHints) stays instantaneous and
    loss-free.

    Crash/restart pin: an acceptor restart physically destroys that
    node's un-sent state, which in the array plane blanks its in-flight
    *response* slots. The network here holds responses outside the node,
    so the drop policy replays the blanking: a response leg from acceptor
    ``a`` sent at ``t_s``, due at ``t_d = t_s + delay``, is dropped iff a
    restart of ``a`` falls in ``(t_s, t_d]`` (the blank at phase 1.5 of
    tick ``t_r`` precedes the delivery phase, so ``t_r == t_d`` still
    kills the leg; a leg minted the restart tick itself cannot exist —
    the acceptor is already deaf). Request legs TOWARD a restarting
    acceptor survive in the network and die at delivery iff it is still
    deaf, exactly like ``acc_up`` downtime."""
    delay, dropm = trace.link_planes()
    arst = trace.acc_restarts
    last = trace.n_ticks - 1

    def leg(src: str, dst: str) -> tuple[int, int]:
        a = acc_index.get(dst)
        if a is not None:  # proposer -> acceptor: requests, releases
            return prop_index[src], a
        return prop_index[dst], acc_index[src]  # acceptor -> proposer

    def tick_of(now: float) -> int:
        return min(int(now + 1e-9), last)

    def delay_policy(src, dst, msg, now):
        if not isinstance(msg, PLANE_MESSAGES):
            return 0.0  # out-of-band (hints): deliver at the send instant
        p, a = leg(src, dst)
        t = tick_of(now)
        eps = REL_EPS if isinstance(msg, Release) else DELIVER_EPS
        return (t + int(delay[t, p, a])) + eps - now

    def drop_policy(src, dst, msg, now):
        if not isinstance(msg, PLANE_MESSAGES):
            return False
        p, a = leg(src, dst)
        t = tick_of(now)
        if bool(dropm[t, p, a]):
            return True
        if arst is not None and isinstance(
            msg, (PrepareResponse, ProposeResponse)
        ):
            t_d = t + int(delay[t, p, a])
            if arst[t + 1:t_d + 1, a].any():
                return True  # the sender restarts before this leg lands
        return False

    net.set_delay_policy(delay_policy)
    net.set_drop_policy(drop_policy)


def replay_event_sim(trace: Trace, *, strict_monitor: bool = True) -> np.ndarray:
    """Owners [T, N] by replaying the trace through the event-driven core/
    engine (dedicated acceptor ensemble + detached proposer fleet, message
    timing pinned to the trace's delay/drop planes). The trace is the only
    source of timing: renewal is disabled, autonomous retries are quiesced
    after every tick, and rounds are abandoned by the round timer exactly
    ``round_ticks`` ticks after they start.

    Drift: the trace's per-node rate steps become ``NodeClock`` rates
    (``r/4`` local seconds per global second) so every local timer — the
    acceptors' lease expiries, the proposers' round-abandon horizons and
    guarded own timers — stretches or shrinks in global time exactly as
    the array plane's accumulated local clocks do (see the construction
    notes above). The proposers' drift-guard discount is pinned to the
    array's floor-quantized ``guarded_lease_q4`` local quarters — the
    cross-engine discount regression test asserts the two arithmetics
    agree to the quarter-tick, making this a timing pin, not a semantic
    change."""
    for name, rates in (("prop_rate", trace.prop_rate),
                        ("acc_rate", trace.acc_rate)):
        if rates is not None and np.asarray(rates).size:
            lo, hi = int(np.min(rates)), int(np.max(rates))
            if lo < 1 or hi > MAX_REFEREE_RATE:
                raise ValueError(
                    f"trace {name} entries must lie in "
                    f"[1, {MAX_REFEREE_RATE}] for an exact event-sim "
                    f"replay; got [{lo}, {hi}]"
                )
    cfg = CellConfig(
        n_acceptors=trace.n_acceptors,
        max_lease_time=trace.lease_ticks + 10.0,
        lease_timespan=trace.lease_ticks + 0.25,
        round_timeout=trace.round_ticks + ABANDON_EPS,
        clock_drift_bound=trace.drift_eps,
        drift_guard=trace.drift_eps > 0.0,
    )
    acc_base = 1000  # build_cell's detached-acceptor node-id offset
    clock_rates = {}
    if trace.prop_rate is not None:
        clock_rates.update(
            (p, float(r) / DEFAULT_RATE)
            for p, r in enumerate(trace.prop_rate)
        )
    if trace.acc_rate is not None:
        clock_rates.update(
            (acc_base + a, float(r) / DEFAULT_RATE)
            for a, r in enumerate(trace.acc_rate)
        )
    cell = build_cell(
        cfg,
        n_proposers=trace.n_proposers,
        seed=0,
        net=NetConfig(delay_min=0.0, delay_max=0.0),
        clock_rates=clock_rates,
        strict_monitor=strict_monitor,
        combined_roles=False,
    )
    acc_nodes = [n for n in cell.nodes if n.acceptor is not None]
    acc_addrs = [n.addr for n in acc_nodes]
    prop_nodes = {n.node_id: n for n in cell.nodes if n.proposer is not None}
    props = {i: n.proposer for i, n in prop_nodes.items()}
    # Crash/restart pins (§2/§3): an acceptor's deaf window is a maximal
    # lease span on ITS clock — lease_q4 local quarters = lease_q4/r
    # global seconds (LeaseNode.restart waits cfg.max_lease_time global
    # seconds, so pin it per node; the fraction lease_q4/r mod 1 is either
    # 0 — the rejoin fires at the tick boundary, before that tick's
    # flips/attempts, the array's deaf-expiry-first order — or >= 1/r >=
    # 1/MAX_REFEREE_RATE > TICK_EPS, landing the rejoin strictly after
    # the tick's sampling, i.e. the NEXT tick processes requests, exactly
    # the array's ceil(lease_q4/r) deaf span). Proposers have no deaf
    # rule: they rejoin instantly (handled in the loop below).
    lease_q4 = lease_quarters(trace.lease_ticks)
    for a, node in enumerate(acc_nodes):
        r = DEFAULT_RATE if trace.acc_rate is None else int(trace.acc_rate[a])
        # lease_timespan is dead weight on a pure-acceptor node (spans ride
        # in the Propose messages); zero it so the T < M validator accepts
        # the exact quantized deaf wait, which can undercut the global T
        node.cfg = _dc_replace(
            cfg, max_lease_time=lease_q4 / r, lease_timespan=0.0
        )
    for node in prop_nodes.values():
        node.skip_restart_wait = True
    # Pin the §4 guard to the array plane's quarter-tick quantization: the
    # proposer's own timer runs guard_q4 local quarters. The timer STARTS
    # at the majority-open delivery instant (tick + DELIVER_EPS), so its
    # pinned duration is shortened by DELIVER_EPS *global* seconds
    # (= DELIVER_EPS·r/4 local): the belief then ends at global
    # ``u + guard_q4/r`` exactly — mid-tick when guard_q4/r has a
    # fractional part (>= 1/MAX_REFEREE_RATE > TICK_EPS, so sampling and
    # boundary releases see the same liveness the array does), and at the
    # tick boundary when it divides evenly, where the earlier-scheduled
    # timer fires before that tick's releases/attempts/deliveries — the
    # array step's expiries-first order.
    guard_q4 = guarded_lease_q4(
        lease_quarters(trace.lease_ticks), trace.drift_eps
    )
    for pid, p in props.items():
        r = (
            DEFAULT_RATE if trace.prop_rate is None
            else int(trace.prop_rate[pid])
        )
        p._guarded_timespan = lambda t, g=(guard_q4 - DELIVER_EPS * r) / 4.0: g
    _pin_network_to_trace(
        cell.env.network, trace,
        {addr: a for a, addr in enumerate(acc_addrs)},
        {n.addr: n.node_id for n in cell.nodes if n.proposer is not None},
    )
    owners = np.full((trace.n_ticks, trace.n_cells), NO_PROPOSER, np.int32)

    for t in range(trace.n_ticks):
        cell.env.run_until(float(t))  # in-between expiries + rejoins fire here
        for a, node in enumerate(acc_nodes):
            # re-assert reachability every tick: a deaf-window rejoin may
            # have just un-downed a node the plane still wants unreachable
            cell.env.network.set_down(
                node.addr, bool(not trace.acc_up[t, a]) or node.crashed
            )
        # crash/restart injection: after reachability flips, before
        # releases/attempts — the array tick's phase 1.5
        if trace.acc_restarts is not None:
            for a in np.flatnonzero(trace.acc_restarts[t]):
                node = acc_nodes[int(a)]
                node.crash()
                node.restart()  # blank + deaf; re-restarts extend the window
        if trace.prop_restarts is not None:
            for pid in np.flatnonzero(trace.prop_restarts[t]):
                node = prop_nodes[int(pid)]
                node.crash()  # belief dropped, timers cancelled, monitor told
                node.restart()  # stable restart counter bumped, RAM gone
                # instant rejoin: the attempt calls below are synchronous,
                # so the zero-wait rejoin event must be flushed by hand
                node.crashed = False
                cell.env.network.set_down(node.addr, False)
        # releases strictly before attempts (same order as the array step)
        for n in np.flatnonzero(trace.releases[t] >= 0):
            props[int(trace.releases[t, n])].release(cell_resource(n))
        # §6 extends after releases (a same-tick release already cleared
        # st.owner, so the extend is a no-op — the array's phase-3 gate
        # evaluated after phase 2a), before attempts; a colliding attempt
        # takes precedence exactly like the array's ``ext_ok`` requires
        # ``att < 0``, and a non-owner extend is a no-op in both engines
        if trace.extends is not None:
            for n in np.flatnonzero(trace.extends[t] >= 0):
                if trace.attempts[t, n] >= 0:
                    continue
                p = props[int(trace.extends[t, n])]
                st = p._state(cell_resource(n))
                if not st.owner:
                    continue
                st.want, st.renew, st.timespan = (
                    True, False, cfg.lease_timespan
                )
                st.round = None
                p.ballots.run = t  # next() -> run = t+1, like an attempt
                p._start_round(cell_resource(n))
        for n in np.flatnonzero(trace.attempts[t] >= 0):
            p = props[int(trace.attempts[t, n])]
            st = p._state(cell_resource(n))
            st.want, st.renew, st.timespan = True, False, cfg.lease_timespan
            st.round = None  # overwrite any open round; no ballot jumps
            p.ballots.run = t  # next() -> run = t+1: (tick, pid) ballot order
            p._start_round(cell_resource(n))
        # drain this tick: round timers (+0.02), release discards (+0.03),
        # then phase deliveries (+0.05)
        cell.env.run_until(t + TICK_EPS)
        for n in range(trace.n_cells):
            o = cell.monitor.owner_of(cell_resource(n))
            owners[t, n] = NO_PROPOSER if o is None else o
        # quiesce: the trace owns all timing — no backoff retries, no renews
        for p in props.values():
            for st in p._res.values():
                st.want = False
                p._cancel(st, "retry_timer")
                p._cancel(st, "renew_timer")
    return owners
