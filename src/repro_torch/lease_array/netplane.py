"""In-flight message plane: the multi-tick delay/loss network model of the
vectorized lease engine, on int32 tensors.

PaxosLease's claim (§1) is safety under message loss, reordering and
in-transit delay. This module holds them as dense state:

  - five in-flight planes, one per protocol phase plus §7 releases
    (``prepare / prepare-response / propose / propose-response / rel``),
    each an ``[A, N]`` slot tensor. A slot packs the message's ballot and
    its delivery quarter-tick into ONE int32 — ``deliver_q4 << PACK_SHIFT |
    ballot`` (0 = empty slot) — so "is this slot due at t?" is two compares
    (``0 < slot < (t4+1) << PACK_SHIFT``);
  - a proposer *round* plane of ``[1, N]`` rows: open ballot, phase, the
    proposer's guarded own timer, a timeout-and-abandon deadline, and
    per-acceptor response *bitmasks* (bit ``a`` = acceptor ``a``'s vote
    counted) so duplicate deliveries never double-count a quorum.

Every message leg sent at tick ``t`` on the link between proposer ``p`` and
acceptor ``a`` takes ``delay[p, a]`` whole ticks and is lost iff
``drop[p, a]``; both arrive fused into one ``[P, A]`` link matrix
(``pack_link``: ``delay << 1 | drop``) indexed per leg by the proposer the
leg involves. Reachability (``acc_up``) is checked when a *request* is
delivered. §7 release discards ride the ``rel`` slots.

With all-zero delay/drop every message is generated and consumed inside
one tick and the step equals the synchronous ``ref.sync_tick_math``.

``delayed_tick_math`` is the plain version of one tick: the CUDA window
kernel (``csrc/lease_window.cu``) runs the same phases in the same order,
one thread per cell, and is held bit-exact against it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .state import (
    I32,
    NO_PROPOSER,
    PACK_MASK,
    PACK_SHIFT,
    QUARTERS,
    RESTART_SHIFT,
    ballot_proposer,
    clock_select,
    pack_pair,
    packed_ballot,
    packed_q4,
    resolve_device,
    tick_value,
)

# round phases
R_IDLE, R_PREPARING, R_PROPOSING = 0, 1, 2

MAX_VOTE_ACCEPTORS = PACK_SHIFT  # vote bitmasks must stay positive int32


def pack_slot(ballot, deliver_q4):
    """One in-flight message as one int32 (0 = empty slot)."""
    return pack_pair(deliver_q4, ballot)


def pack_link(delay, drop):
    """Fuse (delay ticks, drop mask) into the one-plane link matrix."""
    delay = torch.as_tensor(delay).to(I32)
    drop = torch.as_tensor(drop).to(I32)
    return (delay << 1) | (drop & 1)


class NetPlaneState(NamedTuple):
    """In-flight messages + open proposer rounds. All tensors int32.

    Slot planes are ``[A, N]`` packed ``deliver_q4 << PACK_SHIFT | ballot``
    ints (0 = empty). ``presp_pay`` is the prepare response's payload: the
    acceptor's accepted proposer at grant time (NO_PROPOSER = open). Round
    rows are ``[1, N]``; ``rnd_open_bits``/``rnd_acc_bits`` are
    per-acceptor bitmasks. The unpacked views (``preq_b``/``preq_at``/…,
    ``rnd_open``/``rnd_acc`` as [A, N] 0/1 masks) are properties.
    """

    preq: torch.Tensor          # [A, N] prepare requests in flight (packed)
    presp: torch.Tensor         # [A, N] prepare responses (grants only, packed)
    presp_pay: torch.Tensor     # [A, N] accepted proposer payload (-1 = open)
    poreq: torch.Tensor         # [A, N] propose requests in flight (packed)
    poresp: torch.Tensor        # [A, N] propose responses (accepts only, packed)
    rel: torch.Tensor           # [A, N] §7 release messages in flight (packed)
    rnd_ballot: torch.Tensor    # [1, N] open round's ballot (0 = no round)
    rnd_phase: torch.Tensor     # [1, N] R_IDLE / R_PREPARING / R_PROPOSING
    rnd_expiry: torch.Tensor    # [1, N] LOCAL quarter-tick (round owner's clock) its guarded timer expires
    rnd_deadline: torch.Tensor  # [1, N] LOCAL quarter-tick (round owner's clock) the round is abandoned
    rnd_open_bits: torch.Tensor  # [1, N] bitmask of acceptors whose open counted
    rnd_acc_bits: torch.Tensor   # [1, N] bitmask of acceptors whose accept counted

    @property
    def n_acceptors(self) -> int:
        return self.preq.shape[0]

    @property
    def n_cells(self) -> int:
        return self.preq.shape[1]

    # ------------------------------------------------- unpacked views
    def _bits_mask(self, bits: torch.Tensor) -> torch.Tensor:
        a_ids = torch.arange(
            self.preq.shape[0], dtype=I32, device=bits.device
        )[:, None]
        return ((bits >> a_ids) & 1).expand(self.preq.shape)

    @property
    def rnd_open(self) -> torch.Tensor:
        """[A, N] 0/1: acceptors whose open response counted."""
        return self._bits_mask(self.rnd_open_bits)

    @property
    def rnd_acc(self) -> torch.Tensor:
        """[A, N] 0/1: acceptors whose accept counted."""
        return self._bits_mask(self.rnd_acc_bits)


def _slot_views(name: str):
    def ballot_view(self) -> torch.Tensor:
        return packed_ballot(getattr(self, name))

    def at_view(self) -> torch.Tensor:
        return packed_q4(getattr(self, name))

    return property(ballot_view), property(at_view)


for _slot in ("preq", "presp", "poreq", "poresp", "rel"):
    _b, _at = _slot_views(_slot)
    setattr(NetPlaneState, f"{_slot}_b", _b)
    setattr(NetPlaneState, f"{_slot}_at", _at)


def init_netplane(n_cells: int, n_acceptors: int, *, device="cuda") -> NetPlaneState:
    if n_acceptors > MAX_VOTE_ACCEPTORS:
        raise ValueError(
            f"netplane vote bitmasks support at most {MAX_VOTE_ACCEPTORS} "
            f"acceptors; got {n_acceptors}"
        )
    device = resolve_device(device)

    def za():
        return torch.zeros((n_acceptors, n_cells), dtype=I32, device=device)

    def zr():
        return torch.zeros((1, n_cells), dtype=I32, device=device)

    return NetPlaneState(
        preq=za(),
        presp=za(),
        presp_pay=torch.full((n_acceptors, n_cells), NO_PROPOSER, dtype=I32,
                             device=device),
        poreq=za(), poresp=za(),
        rel=za(),
        rnd_ballot=zr(), rnd_phase=zr(), rnd_expiry=zr(), rnd_deadline=zr(),
        rnd_open_bits=zr(), rnd_acc_bits=zr(),
    )


# ---------------------------------------------------------------------------
# per-leg link indexing: [P, A] link matrix -> ([A, bn] delay_q4, drop) rows
# for the proposer each column's leg involves. ``prop`` is an int32
# proposer-id tensor, either [1, bn] (one sender per cell: attempts, open
# rounds, releases) or [A, bn] (per-slot: the in-flight ballot's proposer
# on response legs). Ids outside [0, P) — the no-attempt sentinel — give a
# zero row (select) or the clipped row (gather); every such leg is gated
# off by its own send/due mask, so the two agree wherever it matters.
# ---------------------------------------------------------------------------
def legs_select(link: torch.Tensor, prop: torch.Tensor):
    """P-loop of selects; an out-of-range id reads a zero row (delay 0,
    not lost) — what the CUDA kernel's bounds-checked load gives."""
    P, A = link.shape
    v = torch.zeros((A,) + tuple(prop.shape[1:]), dtype=link.dtype,
                    device=prop.device)
    for p in range(P):
        v = torch.where(prop == p, link[p][:, None], v)
    return QUARTERS * (v >> 1), (v & 1) > 0


def legs_gather(link: torch.Tensor, prop: torch.Tensor):
    """One row gather with clipped ids (the reference's jnp strategy).
    Equal to `legs_select` on every in-range id."""
    P, A = link.shape
    idx = prop.clamp(0, P - 1).long()
    if idx.shape[0] == 1:
        idx = idx.expand((A,) + tuple(idx.shape[1:]))
    v = torch.gather(link.T, 1, idx)
    return QUARTERS * (v >> 1), (v & 1) > 0


def legs_columns(link: torch.Tensor, prop: torch.Tensor):
    """`legs_gather` over per-column links: ``link`` is [P, A, bn], column
    j its own [P, A] matrix (the margin scan folds a batch of scenarios
    into the cell axis, each scenario's link repeated over its cells)."""
    P, A, bn = link.shape
    idx = prop.clamp(0, P - 1).long().expand(A, bn)
    v = torch.gather(link, 0, idx[None])[0]
    return QUARTERS * (v >> 1), (v & 1) > 0


def _votes(bits: torch.Tensor, n_acceptors: int) -> torch.Tensor:
    """Popcount over the A vote bits."""
    n = bits & 1
    for a in range(1, n_acceptors):
        n = n + ((bits >> a) & 1)
    return n


def delayed_tick_math(
    lease: tuple,      # PackedLeaseState fields, [A, bn] / [1, bn] blocks
    net: tuple,        # NetPlaneState fields, [A, bn] / [1, bn] blocks
    t,                 # tick: a Python int or a 0-d int32 tensor
    attempt,           # [1, bn] int32 proposer id attempting (-1 = none)
    release,           # [1, bn] int32 proposer id releasing (-1 = none)
    up,                # [A, 1|bn] int32 acceptor reachability this tick
    pclk,              # [P, 1|bn] int32 proposer local clocks (quarter-ticks)
    aclk,              # [A, 1|bn] int32 acceptor local clocks (quarter-ticks)
    link,              # [P, A] int32 fused link matrix (delay << 1 | drop)
    *,
    majority: int,
    lease_q4: int,     # lease timespan in quarter-ticks
    round_q4: int,     # timeout-and-abandon horizon in quarter-ticks
    n_proposers: int,
    guard_q4: int = None,  # proposer's guarded own timer (default: no drift)
    legs=legs_gather,  # per-leg link strategy
    extend=None,       # [1, bn] int32 proposer id extending its own lease (§6)
    stale=None,        # [A, 1|bn] adversarial: honor below-promise ballots
    equiv=None,        # [A, 1|bn] adversarial: report a live lease as open
    acc_restart=None,  # [A, 1|bn] diskless acceptor crash+restart this tick
    acc_deaf=None,     # [A, 1|bn] acceptor inside its post-restart deaf window
    prop_restart=None,  # [P, 1|bn] proposer crash+restart this tick
    prop_rc=None,       # [P, 1|bn] accumulated per-proposer restart counters
) -> tuple[tuple, tuple, torch.Tensor]:
    """One tick of the delayed model on the packed layout. Returns
    (lease', net', owner_count[1, bn]).

    Within-tick order: expiries fired before the tick boundary, then
    restarts, releases/attempts/extends issued at the boundary, the
    round-abandon timer, then deliveries in causal phase order (a
    zero-delay message cascades through all four phases inside the tick).
    ``owner_count`` is 0/1 from the believed-owner row, plus 1 at any tick
    a win would overwrite a live *other* belief — the §4 alarm.

    Message deliver-ats are GLOBAL quarter-ticks; every node-side timer is
    minted from and compared against that node's LOCAL clock
    (``pclk``/``aclk``; per-cell rows read the relevant proposer's entry
    via `state.clock_select`).

    ``extend`` is the §6 owner-extension row, gated on the proposer's own
    belief AFTER this tick's expiry/restart/release phases; an explicit
    attempt on the same cell takes precedence. ``stale``/``equiv`` are the
    adversarial corruption masks. ``acc_restart``/``acc_deaf``/
    ``prop_restart``/``prop_rc`` are the crash/restart inputs (they arrive
    together or not at all). ``None`` for any of them runs no work for it.
    """
    promised, acc_lease, own_id, ownp = lease
    (preq, presp, presp_pay, poreq, poresp, rel_s,
     rnd_ballot, rnd_phase, rnd_expiry, rnd_deadline,
     rnd_open_bits, rnd_acc_bits) = net

    A = promised.shape[0]
    P = n_proposers
    if guard_q4 is None:
        guard_q4 = lease_q4
    t = tick_value(t)
    t4 = QUARTERS * t
    live_min = (t4 + 1) << PACK_SHIFT  # GLOBAL time base: slot due iff <
    a_bit = (1 << torch.arange(A, dtype=I32, device=promised.device))[:, None]
    up = up > 0
    stale_b = None if stale is None else stale > 0
    equiv_b = None if equiv is None else equiv > 0

    def due(slot):
        return (slot > 0) & (slot < live_min)

    # -- 1. expiry (each node's own local clock) ---------------------------
    acc_lease = torch.where(acc_lease >= ((aclk + 1) << PACK_SHIFT), acc_lease, 0)
    own_clk = clock_select(pclk, own_id)                           # [1, bn]
    own_live = ownp >= ((own_clk + 1) << PACK_SHIFT)
    ownp = torch.where(own_live, ownp, 0)
    own_id = torch.where(own_live, own_id, NO_PROPOSER)

    # -- 1.5 crash/restart injection (§2: the diskless failure model) ------
    if acc_restart is not None:
        # a diskless acceptor comes back BLANK: promises, accepted lease and
        # its own not-yet-delivered responses are gone; requests in flight
        # TO it live in the network and survive
        rst_a = acc_restart > 0                                    # [A, bn]
        promised = torch.where(rst_a, 0, promised)
        acc_lease = torch.where(rst_a, 0, acc_lease)
        presp = torch.where(rst_a, 0, presp)
        presp_pay = torch.where(rst_a, NO_PROPOSER, presp_pay)
        poresp = torch.where(rst_a, 0, poresp)
    if acc_deaf is not None:
        # ... and stays deaf (unreachable) for a maximal lease span on its
        # own clock, precomputed by the ops layer
        up = up & ~(acc_deaf > 0)
    if prop_restart is not None:
        # a restarted proposer loses its volatile owner belief NOW (its open
        # round is abandoned in phase 3)
        own_rst = clock_select(prop_restart, own_id) > 0           # [1, bn]
        ownp = torch.where(own_rst, 0, ownp)
        own_id = torch.where(own_rst, NO_PROPOSER, own_id)

    # -- 2. release (§7, routed through the network) -----------------------
    # 2a. the local action: the releasing owner stops believing NOW
    rel = release                                                   # [1, bn]
    has_rel = rel >= 0
    rel_owner = has_rel & (own_id == rel)
    rel_ballot = torch.where(rel_owner, ownp & PACK_MASK, 0)
    ownp = torch.where(rel_owner, 0, ownp)
    own_id = torch.where(rel_owner, NO_PROPOSER, own_id)
    # 2b. then the discard messages ride the in-flight plane
    dq4, lost = legs(link, rel)                                     # [A, bn]
    send_rel = (rel_ballot > 0) & ~lost
    rel_s = torch.where(send_rel, pack_slot(rel_ballot, t4 + dq4), rel_s)
    # 2c. deliver due releases: discard iff reachable and the accepted
    #     ballot matches
    rel_due = due(rel_s)
    discard = rel_due & up & ((acc_lease & PACK_MASK) == (rel_s & PACK_MASK))
    acc_lease = torch.where(discard, 0, acc_lease)
    rel_s = torch.where(rel_due, 0, rel_s)

    # -- 3. round lifecycle ------------------------------------------------
    # a release wipes the releasing proposer's open round; a timed-out
    # round is abandoned; a new attempt overwrites whatever round was open
    rnd_prop = ballot_proposer(rnd_ballot, P)                       # [1, bn]
    rel_kills = (rnd_ballot > 0) & has_rel & (rnd_prop == rel)
    if prop_restart is not None:
        rel_kills = rel_kills | (
            (rnd_ballot > 0) & (clock_select(prop_restart, rnd_prop) > 0)
        )
    # the abandon timer fires once the round OWNER's local clock advanced
    # round_q4 past the attempt
    rnd_clk = clock_select(pclk, rnd_prop)                          # [1, bn]
    timed_out = (rnd_ballot > 0) & (rnd_clk >= rnd_deadline)
    att = attempt                                                   # [1, bn]
    if extend is not None:
        # §6: an extend is a fresh round started by the live owner, gated on
        # the belief AFTER expiry/restart/release above
        ext_ok = (att < 0) & (extend >= 0) & (own_id == extend) & (ownp > 0)
        att = torch.where(ext_ok, extend, att)
    has_att = att >= 0
    att_clk = clock_select(pclk, att)                               # [1, bn]
    if prop_rc is None:
        new_ballot = torch.where(has_att, (t + 1) * P + att, 0)
    else:
        # restart mode: the attempting proposer's restart counter is carved
        # into the ballot's upper word (state.RESTART_SHIFT)
        rc_att = clock_select(prop_rc, att)                         # [1, bn]
        upper = ((t + 1) << RESTART_SHIFT) | rc_att
        new_ballot = torch.where(has_att, upper * P + att, 0)
    keep = (rnd_ballot > 0) & ~timed_out & ~rel_kills & ~has_att
    rnd_ballot = torch.where(
        has_att, new_ballot, torch.where(keep, rnd_ballot, 0)
    )
    rnd_phase = torch.where(
        has_att, R_PREPARING, torch.where(keep, rnd_phase, R_IDLE)
    )
    rnd_expiry = torch.where(keep, rnd_expiry, 0)
    rnd_deadline = torch.where(
        has_att, att_clk + round_q4, torch.where(keep, rnd_deadline, 0)
    )
    fresh = has_att | ~keep                                         # [1, bn]
    rnd_open_bits = torch.where(fresh, 0, rnd_open_bits)
    rnd_acc_bits = torch.where(fresh, 0, rnd_acc_bits)

    # -- 4a. broadcast prepare requests for new attempts -------------------
    dq4, lost = legs(link, att)
    send_preq = has_att & ~lost                                     # [A, bn]
    preq = torch.where(send_preq, pack_slot(new_ballot, t4 + dq4), preq)

    # -- 4b. deliver prepare requests at acceptors (§3.2) ------------------
    preq_due = due(preq)
    preq_b = preq & PACK_MASK
    if stale_b is None:
        grant = preq_due & up & (preq_b >= promised)
        promised = torch.where(grant, preq_b, promised)
    else:
        # stale-ballot injection: the corrupted acceptor grants below its
        # promise too (the promise itself still only ratchets upward)
        grant = preq_due & up & ((preq_b >= promised) | stale_b)
        promised = torch.where(grant, torch.maximum(promised, preq_b), promised)
    # the response leg belongs to the REQUESTER's link
    dq4, lost = legs(link, ballot_proposer(preq_b, P))
    send_presp = grant & ~lost
    acc_b = acc_lease & PACK_MASK                                   # [A, bn]
    acc_prop = torch.where(acc_b > 0, ballot_proposer(acc_b, P), NO_PROPOSER)
    if equiv_b is not None:
        # equivocation: the corrupted acceptor claims it holds no lease
        acc_prop = torch.where(equiv_b, NO_PROPOSER, acc_prop)
    presp = torch.where(send_presp, pack_slot(preq_b, t4 + dq4), presp)
    presp_pay = torch.where(send_presp, acc_prop, presp_pay)
    preq = torch.where(preq_due, 0, preq)

    # -- 4c. deliver prepare responses at proposers (§3.3) -----------------
    presp_due = due(presp)
    rnd_prop = ballot_proposer(rnd_ballot, P)  # recompute: round changed above
    rnd_clk = clock_select(pclk, rnd_prop)     # the round owner's clock
    match_prep = (
        presp_due & ((presp & PACK_MASK) == rnd_ballot)
        & (rnd_phase == R_PREPARING)
    )
    # §6 extend: a response carrying our own proposal counts as open only
    # while we still believe we own (checked at ARRIVAL)
    rnd_prop_owns = (own_id == rnd_prop) & (ownp > 0)               # [1, bn]
    is_open = match_prep & (
        (presp_pay == NO_PROPOSER) | ((presp_pay == rnd_prop) & rnd_prop_owns)
    )
    # set-union via the vote bitmask: duplicate-proof
    rnd_open_bits = rnd_open_bits | torch.where(is_open, a_bit, 0).sum(
        dim=0, keepdim=True, dtype=I32
    )
    opens = _votes(rnd_open_bits, A)                                # [1, bn]
    to_propose = (
        (rnd_ballot > 0) & (rnd_phase == R_PREPARING) & (opens >= majority)
    )
    # majority open: start OUR timer first, then broadcast the proposal —
    # the ordering the §4 proof depends on (guarded local timespan)
    rnd_phase = torch.where(to_propose, R_PROPOSING, rnd_phase)
    rnd_expiry = torch.where(to_propose, rnd_clk + guard_q4, rnd_expiry)
    dq4, lost = legs(link, rnd_prop)
    send_poreq = to_propose & ~lost                                 # [A, bn]
    poreq = torch.where(send_poreq, pack_slot(rnd_ballot, t4 + dq4), poreq)
    presp = torch.where(presp_due, 0, presp)
    presp_pay = torch.where(presp_due, NO_PROPOSER, presp_pay)

    # -- 4d. deliver propose requests at acceptors (§3.4) ------------------
    poreq_due = due(poreq)
    poreq_b = poreq & PACK_MASK
    accept = poreq_due & up & (poreq_b >= promised)
    if stale_b is not None:
        accept = poreq_due & up & ((poreq_b >= promised) | stale_b)
    # each accepting acceptor restarts the full-length timer on ITS clock
    acc_lease = torch.where(
        accept, pack_pair(aclk + lease_q4, poreq_b), acc_lease
    )
    dq4, lost = legs(link, ballot_proposer(poreq_b, P))
    send_poresp = accept & ~lost
    poresp = torch.where(send_poresp, pack_slot(poreq_b, t4 + dq4), poresp)
    poreq = torch.where(poreq_due, 0, poreq)

    # -- 4e. deliver propose responses at proposers (§3.5) -----------------
    poresp_due = due(poresp)
    match_prop = (
        poresp_due & ((poresp & PACK_MASK) == rnd_ballot)
        & (rnd_phase == R_PROPOSING)
    )
    rnd_acc_bits = rnd_acc_bits | torch.where(match_prop, a_bit, 0).sum(
        dim=0, keepdim=True, dtype=I32
    )
    accs = _votes(rnd_acc_bits, A)
    # the timer started in 4c bounds the claim (§3 step 5), on the round
    # owner's clock
    win = (
        (rnd_ballot > 0) & (rnd_phase == R_PROPOSING)
        & (accs >= majority) & (rnd_expiry > rnd_clk)
    )
    # a win that would overwrite a live OTHER belief is the §4 alarm
    viol = win & (ownp > 0) & (own_id != rnd_prop)
    own_id = torch.where(win, rnd_prop, own_id)
    ownp = torch.where(win, pack_pair(rnd_expiry, rnd_ballot), ownp)
    rnd_ballot = torch.where(win, 0, rnd_ballot)
    rnd_phase = torch.where(win, R_IDLE, rnd_phase)
    rnd_expiry = torch.where(win, 0, rnd_expiry)
    rnd_deadline = torch.where(win, 0, rnd_deadline)
    rnd_open_bits = torch.where(win, 0, rnd_open_bits)
    rnd_acc_bits = torch.where(win, 0, rnd_acc_bits)
    poresp = torch.where(poresp_due, 0, poresp)

    lease_out = (promised, acc_lease, own_id, ownp)
    net_out = (preq, presp, presp_pay, poreq, poresp, rel_s,
               rnd_ballot, rnd_phase, rnd_expiry, rnd_deadline,
               rnd_open_bits, rnd_acc_bits)
    owner_count = ownp.gt(0).to(I32) + viol.to(I32)
    return lease_out, net_out, owner_count
