"""Dense state of a vectorized lease plane: N independent PaxosLease cells
x A acceptors x P proposers as int32 tensors (§8: "leases for many
resources").

Layout: ``[A, N]`` acceptor planes and ``[P, N]`` proposer planes, the cell
axis N last, so a CUDA thread per cell reads neighbouring addresses when its
neighbours read theirs.

Time is integer *quarter-ticks*: protocol rounds run at integer ticks
(``t4 = 4*t``) while lease expiries land at ``t4 + 4*L + 1`` — strictly
between ticks, so "expired at tick boundary" is never ambiguous.

Ballot numbers are globally unique and totally ordered by (tick, proposer):
``ballot(t, p) = (t+1)*P + p``. 0 means "no ballot".

Packed compute layout: every hot path runs on a *packed* view of this state
in which each (deadline-quarter-tick, ballot) pair lives in ONE int32 —
``packed = q4 << PACK_SHIFT | ballot`` — so liveness is a single compare on
a single plane, and the at-most-one-owner §4 invariant collapses the three
``[P, N]`` owner planes to an ``owner_id``/``owner_lease`` pair of ``[1, N]``
rows (a would-be second believer surfaces as an owner count of 2 at the
tick it appears). ``LeaseArrayState`` is the at-rest format;
``pack_state``/``unpack_state`` convert at the boundary of every driver.
The packing budget bounds the clock: ``ballot <= PACK_MASK`` and
``q4 <= MAX_PACK_Q4`` (see ``max_pack_tick``).

torch sums of int32 tensors return int64; every reduction here passes
``dtype=torch.int32`` so the packed planes keep the int32 wrap-around
semantics of the kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

NO_PROPOSER = -1  # "no owner / no attempt" sentinel in proposer-id arrays
QUARTERS = 4  # quarter-ticks per tick

#: a drift-free local clock advances QUARTERS local quarter-ticks per global
#: tick; a drifted node's rate plane holds its own integer step instead
DEFAULT_RATE = QUARTERS

PACK_SHIFT = 15  # low bits: ballot; high bits: a quarter-tick deadline
PACK_MASK = (1 << PACK_SHIFT) - 1  # max packable ballot (32767)
MAX_PACK_Q4 = (2**31 - 1) >> PACK_SHIFT  # max packable quarter-tick (65535)

#: restart-mode ballot carve (diskless proposer restarts, paper §2): the
#: ballot's run field is shifted left by RESTART_SHIFT and the low bits of
#: the upper word hold a per-proposer restart counter:
#: ``ballot = (((t+1) << RESTART_SHIFT) | rc) * P + p``. The carve spends
#: ballot-budget bits, so ``max_pack_tick`` shrinks in restart mode.
RESTART_SHIFT = 2
MAX_RESTARTS = (1 << RESTART_SHIFT) - 1  # restart counters must stay below the carve

I32 = torch.int32


class LeaseArrayState(NamedTuple):
    """One lease plane. All tensors int32 on one device."""

    highest_promised: torch.Tensor  # [A, N] highest promised ballot (0 = none)
    accepted_ballot: torch.Tensor   # [A, N] ballot of the accepted proposal (0 = none)
    accepted_proposer: torch.Tensor  # [A, N] proposer id of the accepted lease (-1 = none)
    lease_expiry: torch.Tensor      # [A, N] LOCAL quarter-tick (acceptor a's clock) the accepted lease expires
    owner_mask: torch.Tensor        # [P, N] 1 where proposer p believes it owns cell n
    owner_expiry: torch.Tensor      # [P, N] LOCAL quarter-tick (proposer p's clock) that belief expires
    owner_ballot: torch.Tensor      # [P, N] ballot the ownership was won under

    @property
    def n_acceptors(self) -> int:
        return self.highest_promised.shape[0]

    @property
    def n_proposers(self) -> int:
        return self.owner_mask.shape[0]

    @property
    def n_cells(self) -> int:
        return self.highest_promised.shape[1]


def init_state(
    n_cells: int, n_acceptors: int, n_proposers: int, *, device="cuda"
) -> LeaseArrayState:
    device = resolve_device(device)
    za = torch.zeros((n_acceptors, n_cells), dtype=I32, device=device)
    zp = torch.zeros((n_proposers, n_cells), dtype=I32, device=device)
    return LeaseArrayState(
        highest_promised=za,
        accepted_ballot=za.clone(),
        accepted_proposer=torch.full_like(za, NO_PROPOSER),
        lease_expiry=za.clone(),
        owner_mask=zp,
        owner_expiry=zp.clone(),
        owner_ballot=zp.clone(),
    )


def lease_quarters(lease_ticks: int) -> int:
    """Lease timespan in quarter-ticks: L ticks + 1 quarter."""
    return QUARTERS * int(lease_ticks) + 1


def guarded_lease_q4(lease_q4: int, drift_eps: float) -> int:
    """The §4 drift guard on the packed time base: the proposer's own lease
    timer, discounted to T·(1-ε)/(1+ε) and floored to a whole local
    quarter-tick. Flooring only ever *shortens* the proposer's belief, so
    the discount stays safe after quantization. ε = 0 is the exact no-drift
    case (no discount at all)."""
    if not 0.0 <= drift_eps < 1.0:
        raise ValueError(f"drift_eps must be in [0, 1); got {drift_eps}")
    if drift_eps == 0.0:
        return int(lease_q4)
    guarded = int(lease_q4 * (1.0 - drift_eps) / (1.0 + drift_eps))
    if guarded < 1:
        raise ValueError(
            f"the drift discount collapses a {lease_q4}-quarter lease to "
            f"{guarded} quarter-ticks at eps={drift_eps}: the proposer "
            f"could never believe it owns; lengthen the lease or lower eps"
        )
    return guarded


def rate1_clock(t: int, rows: int, *, device="cuda") -> torch.Tensor:
    """``[rows]`` int32: the drift-free local-clock reading ``4t`` on every
    node — the default-clock definition."""
    return torch.full((rows,), QUARTERS * int(t), dtype=I32, device=device)


def tick_value(t):
    """The tick number the tick math computes with: a tensor as it is (a
    0-d int32 tensor keeps ``t`` a graph input when the tick core is traced,
    ``analysis.staticcheck.intervals``), anything else as a Python int. The
    arithmetic on it is int32 either way, so both give the same bits."""
    return t if isinstance(t, torch.Tensor) else int(t)


def clock_select(clk: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-cell local-clock gather: ``clk`` is a per-proposer column
    ``[P, 1|bn]``, ``ids`` a proposer-id row ``[1, bn]``; returns each
    cell's named proposer's clock reading ``[1, bn]``. A P-loop of selects:
    out-of-range ids (the NO_PROPOSER sentinel) read 0, and every use is
    gated by its own ballot/owner mask. The CUDA kernels read the same
    value with a bounds-checked shared-memory load."""
    v = torch.zeros(torch.broadcast_shapes(ids.shape, clk[0:1].shape),
                    dtype=clk.dtype, device=ids.device)
    for p in range(clk.shape[0]):
        v = torch.where(ids == p, clk[p], v)
    return v


def ballot_of(t, proposer, n_proposers: int, restart_counter=None):
    """Globally unique ballot for an attempt by ``proposer`` at tick ``t``.

    With ``restart_counter`` (restart mode) the run field is carved as
    ``(t+1) << RESTART_SHIFT | rc``; the proposer stays the low mod-P field
    either way, so ``ballot_proposer`` needs no mode switch."""
    if restart_counter is None:
        return (t + 1) * n_proposers + proposer
    upper = ((t + 1) << RESTART_SHIFT) | restart_counter
    return upper * n_proposers + proposer


# ---------------------------------------------------------------------------
# packed compute layout
# ---------------------------------------------------------------------------
def pack_pair(q4, ballot):
    """One int32 carrying (deadline quarter-tick, ballot); 0 = empty."""
    return (q4 << PACK_SHIFT) | ballot


def ballot_proposer(ballot, n_proposers: int):
    """The proposer a ballot belongs to (``ballot % P``, strength-reduced
    to a mask when P is a power of two — ballots are nonnegative)."""
    if n_proposers & (n_proposers - 1) == 0:
        return ballot & (n_proposers - 1)
    return ballot % n_proposers


def packed_ballot(packed):
    return packed & PACK_MASK


def packed_q4(packed):
    return packed >> PACK_SHIFT


def max_pack_tick(
    n_proposers: int,
    lease_q4: int,
    max_delay_ticks: int = 0,
    max_rate: int = QUARTERS,
    clk_slack: int = 0,
    max_restarts: int = 0,
) -> int:
    """Highest tick the packed layout can represent: the last attempt's
    ballot must fit in PACK_SHIFT bits and the latest deadline any tick can
    mint (send at t4 + delay, then a full lease) in the remaining bits.

    Fast clocks mint local deadlines at up to ``max_rate`` per tick;
    ``clk_slack`` is how far ahead of ``max_rate * t`` an engine's clocks
    already run. ``max_restarts > 0`` charges the restart-mode ballot carve
    (RESTART_SHIFT bits of the run field)."""
    upper_budget = (PACK_MASK - (n_proposers - 1)) // n_proposers
    if max_restarts:
        by_ballot = ((upper_budget - int(max_restarts)) >> RESTART_SHIFT) - 1
    else:
        by_ballot = upper_budget - 1
    rate = max(int(max_rate), QUARTERS)  # deliver-at slots tick at QUARTERS
    by_q4 = (
        MAX_PACK_Q4 - lease_q4 - QUARTERS * max_delay_ticks - int(clk_slack)
    ) // rate
    return min(by_ballot, by_q4)


def check_pack_budget(
    t_end: int,
    n_proposers: int,
    lease_q4: int,
    max_delay_ticks: int = 0,
    max_rate: int = QUARTERS,
    clk_slack: int = 0,
    max_restarts: int = 0,
) -> None:
    """Raise if ticking through ``t_end`` would overflow the packed layout
    (a ballot or deadline minted past :func:`max_pack_tick` silently
    corrupts neighbouring fields — never let one form)."""
    if max_restarts > MAX_RESTARTS:
        raise ValueError(
            f"{max_restarts} restarts of one proposer exceed the "
            f"{RESTART_SHIFT}-bit restart-counter carve (max {MAX_RESTARTS}); "
            f"split the schedule across engine epochs"
        )
    limit = max_pack_tick(
        n_proposers, lease_q4, max_delay_ticks, max_rate, clk_slack,
        max_restarts,
    )
    if t_end > limit:
        raise ValueError(
            f"tick {t_end} exceeds the packed int32 layout's budget "
            f"({limit} ticks at P={n_proposers}, lease_q4={lease_q4}, "
            f"max delay {max_delay_ticks}, max clock rate {max_rate}/4, "
            f"max restarts {max_restarts}); "
            f"split the workload across engines or shorten the trace"
        )


class PackedLeaseState(NamedTuple):
    """The compute-format lease plane. All int32.

    ``acc_lease`` packs the accepted (expiry, ballot) pair; the accepted
    proposer is derived (``ballot % P``), not stored. The owner plane is a
    single believed-owner row — legal PaxosLease histories never hold two
    concurrent beliefs (§4), and the tick math flags the overwrite if an
    illegal history ever would.
    """

    promised: torch.Tensor     # [A, N] highest promised ballot (0 = none)
    acc_lease: torch.Tensor    # [A, N] expiry_q4 << PACK_SHIFT | ballot (0 = none)
    owner_id: torch.Tensor     # [1, N] believed owner (-1 = none)
    owner_lease: torch.Tensor  # [1, N] expiry_q4 << PACK_SHIFT | ballot (0 = none)


def pack_state(state: LeaseArrayState) -> PackedLeaseState:
    """Public -> compute format. With >1 owner bit per cell (an illegal
    state) the highest proposer id wins, like ``ref.owner_row``."""
    acc_on = state.accepted_ballot > 0
    acc_lease = torch.where(
        acc_on, pack_pair(state.lease_expiry, state.accepted_ballot), 0
    )
    P = state.owner_mask.shape[0]
    p_ids = torch.arange(P, dtype=I32, device=state.owner_mask.device)[:, None]
    own = state.owner_mask > 0
    owner_id = torch.where(own, p_ids, NO_PROPOSER).amax(dim=0, keepdim=True)
    top = own & (p_ids == owner_id)
    owner_lease = torch.where(
        top, pack_pair(state.owner_expiry, state.owner_ballot), 0
    ).sum(dim=0, keepdim=True, dtype=I32)
    return PackedLeaseState(
        promised=state.highest_promised.to(I32),
        acc_lease=acc_lease.to(I32),
        owner_id=owner_id.to(I32),
        owner_lease=owner_lease,
    )


def unpack_state(packed: PackedLeaseState, n_proposers: int) -> LeaseArrayState:
    """Compute -> public format (acc_prop rederived as ``ballot % P``)."""
    acc_b = packed_ballot(packed.acc_lease)
    acc_on = acc_b > 0
    p_ids = torch.arange(
        n_proposers, dtype=I32, device=packed.promised.device
    )[:, None]
    own = (p_ids == packed.owner_id) & (packed.owner_lease > 0)
    return LeaseArrayState(
        highest_promised=packed.promised,
        accepted_ballot=acc_b,
        accepted_proposer=torch.where(
            acc_on, ballot_proposer(acc_b, n_proposers), NO_PROPOSER
        ),
        lease_expiry=torch.where(acc_on, packed_q4(packed.acc_lease), 0),
        owner_mask=own.to(I32),
        owner_expiry=torch.where(own, packed_q4(packed.owner_lease), 0),
        owner_ballot=torch.where(own, packed_ballot(packed.owner_lease), 0),
    )
