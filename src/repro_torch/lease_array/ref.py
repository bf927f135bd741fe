"""Plain PyTorch tick bodies of the vectorized lease plane.

Semantics of a synchronous tick (all N cells in lockstep, a zero-delay
network):

  1. expiry     — accepted proposals and ownership beliefs whose quarter-tick
                  deadline has passed are cleared (acceptor timers run even
                  while the acceptor is unreachable).
  2. release    — §7: a releasing proposer first stops believing it owns,
                  then *reachable* acceptors discard iff the accepted ballot
                  matches the ballot the lease was won under.
  3. prepare    — §3 step 2: each attempting proposer gets a promise from
                  every reachable acceptor with ``ballot >= highest_promised``.
                  A response counts as *open* iff the acceptor holds no
                  lease, or holds this proposer's own lease while the
                  proposer still believes it owns (§6 extend).
  4. propose    — §3 step 4: with a majority of opens, every granting
                  acceptor accepts and restarts its lease timer; the
                  proposer starts its own (guarded) timer and becomes owner.

``sync_tick_math`` runs on the PACKED layout (`state.PackedLeaseState`) and
is the plain version the CUDA sync window kernel is held against;
``lease_step_ref``/``lease_step_delayed_ref`` wrap one tick of either model
in the public `LeaseArrayState` format. Node timers live in each node's
LOCAL quarter-ticks (§4: clocks may drift); with every clock at
DEFAULT_RATE the clock columns equal ``4t``.
"""
from __future__ import annotations

import torch

from .netplane import NetPlaneState, delayed_tick_math, pack_link
from .state import (
    I32,
    NO_PROPOSER,
    PACK_MASK,
    PACK_SHIFT,
    LeaseArrayState,
    PackedLeaseState,
    ballot_proposer,
    clock_select,
    pack_pair,
    pack_state,
    rate1_clock,
    tick_value,
    unpack_state,
)


def sync_tick_math(
    lease: tuple,     # PackedLeaseState fields, [A, bn] / [1, bn] blocks
    t,                # tick: a Python int or a 0-d int32 tensor
    attempt,          # [1, bn] int32 proposer id attempting (-1 = none)
    release,          # [1, bn] int32 proposer id releasing (-1 = none)
    up,               # [A, 1|bn] int32 acceptor reachability this tick
    pclk,             # [P, 1|bn] int32 proposer local clocks (quarter-ticks)
    aclk,             # [A, 1|bn] int32 acceptor local clocks (quarter-ticks)
    *,
    majority: int,
    lease_q4: int,
    n_proposers: int,
    guard_q4: int = None,  # proposer's guarded own timer (default: no drift)
) -> tuple[tuple, torch.Tensor]:
    """One synchronous tick on the packed layout; returns
    (lease', owner_count[1, bn]). ``owner_count`` is 0/1 plus 1 at any tick
    a win would overwrite a live *other* belief — the §4 alarm."""
    promised, acc_lease, own_id, ownp = lease
    P = n_proposers
    if guard_q4 is None:
        guard_q4 = lease_q4
    t = tick_value(t)
    up = up > 0

    # -- 1. expiry (each node's own local clock) ---------------------------
    acc_lease = torch.where(acc_lease >= ((aclk + 1) << PACK_SHIFT), acc_lease, 0)
    own_clk = clock_select(pclk, own_id)                           # [1, bn]
    own_live = ownp >= ((own_clk + 1) << PACK_SHIFT)
    ownp = torch.where(own_live, ownp, 0)
    own_id = torch.where(own_live, own_id, NO_PROPOSER)

    # -- 2. release (§7) ---------------------------------------------------
    rel = release
    rel_owner = (rel >= 0) & (own_id == rel)
    rel_ballot = torch.where(rel_owner, ownp & PACK_MASK, 0)       # [1, bn]
    ownp = torch.where(rel_owner, 0, ownp)
    own_id = torch.where(rel_owner, NO_PROPOSER, own_id)
    acc_b = acc_lease & PACK_MASK                                  # [A, bn]
    discard = up & (rel_ballot > 0) & (acc_b == rel_ballot)
    acc_lease = torch.where(discard, 0, acc_lease)
    acc_b = torch.where(discard, 0, acc_b)

    # -- 3. prepare (§3.2) -------------------------------------------------
    att = attempt
    has_att = att >= 0
    ballot = torch.where(has_att, (t + 1) * P + att, 0)       # [1, bn]
    att_owns = has_att & (own_id == att)
    grant = up & has_att & (ballot >= promised)
    is_open = grant & (
        (acc_b == 0) | ((ballot_proposer(acc_b, P) == att) & att_owns)
    )
    opens = is_open.sum(dim=0, keepdim=True, dtype=I32)
    won = opens >= majority
    promised = torch.where(grant, ballot, promised)

    # -- 4. propose (§3.4) + proposer update -------------------------------
    # acceptor timers restart on THEIR clocks; the winner's own belief runs
    # the guarded (discounted) timespan on ITS clock — the §4 drift guard
    accept = grant & won
    acc_lease = torch.where(
        accept, pack_pair(aclk + lease_q4, ballot), acc_lease
    )
    att_clk = clock_select(pclk, att)                              # [1, bn]
    viol = won & (ownp > 0) & (own_id != att)  # would-be second believer
    own_id = torch.where(won, att, own_id)
    ownp = torch.where(won, pack_pair(att_clk + guard_q4, ballot), ownp)

    lease_out = (promised, acc_lease, own_id, ownp)
    owner_count = ownp.gt(0).to(I32) + viol.to(I32)
    return lease_out, owner_count


def _col(x, rows: int, device) -> torch.Tensor:
    """A per-node input ([rows] array or tensor) as an int32 column."""
    return torch.as_tensor(x).to(device=device, dtype=I32).reshape(rows, 1)


def _row(x, n: int, device) -> torch.Tensor:
    """A per-cell input ([N] array or tensor) as an int32 row."""
    return torch.as_tensor(x).to(device=device, dtype=I32).reshape(1, n)


def lease_step_ref(
    state: LeaseArrayState,
    t: int,
    attempt,          # [N] int32 proposer id attempting each cell (-1 = none)
    release,          # [N] int32 proposer id releasing each cell (-1 = none)
    acc_up,           # [A] bool/int32 acceptor reachability this tick
    *,
    majority: int,
    lease_q4: int,    # lease timespan in quarter-ticks
    guard_q4: int = None,  # drift-guarded proposer timespan (default lease_q4)
    pclk=None,        # [P] int32 proposer local clocks (default: 4t, no drift)
    aclk=None,        # [A] int32 acceptor local clocks (default: 4t, no drift)
) -> tuple[LeaseArrayState, torch.Tensor]:
    """Advance every cell one tick; returns (new_state, owner_count[N]).
    Public-format wrapper over `sync_tick_math` (packs, ticks, unpacks)."""
    A, N = state.highest_promised.shape
    P = state.n_proposers
    dev = state.highest_promised.device
    lease, count = sync_tick_math(
        tuple(pack_state(state)), t,
        _row(attempt, N, dev), _row(release, N, dev), _col(acc_up, A, dev),
        _col(rate1_clock(t, P, device=dev) if pclk is None else pclk, P, dev),
        _col(rate1_clock(t, A, device=dev) if aclk is None else aclk, A, dev),
        majority=majority, lease_q4=lease_q4, n_proposers=P,
        guard_q4=guard_q4,
    )
    return unpack_state(PackedLeaseState(*lease), P), count.reshape(-1)


def link_matrix(m, n_proposers: int, n_acceptors: int) -> torch.Tensor:
    """Normalize a delay/drop input to the canonical [P, A] link matrix:
    the asymmetric ``[P, A]`` form, or the symmetric per-acceptor ``[A]``
    form broadcast over P."""
    m = torch.as_tensor(m).to(I32)
    if m.ndim == 1:
        m = m[None, :].expand(n_proposers, n_acceptors)
    if tuple(m.shape) != (n_proposers, n_acceptors):
        raise ValueError(
            f"delay/drop must be [A]={n_acceptors} or "
            f"[P, A]=({n_proposers}, {n_acceptors}); got {tuple(m.shape)}"
        )
    return m


def lease_step_delayed_ref(
    state: LeaseArrayState,
    net: NetPlaneState,
    t: int,
    attempt,          # [N] int32 proposer id attempting each cell (-1 = none)
    release,          # [N] int32 proposer id releasing each cell (-1 = none)
    acc_up,           # [A] bool/int32 acceptor reachability this tick
    delay,            # [P, A] (or [A]) int32 link delays for sends this tick
    drop,             # [P, A] (or [A]) bool/int32 link drop masks
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,    # timeout-and-abandon horizon in quarter-ticks
    guard_q4: int = None,  # drift-guarded proposer timespan (default lease_q4)
    pclk=None,        # [P] int32 proposer local clocks (default: 4t, no drift)
    aclk=None,        # [A] int32 acceptor local clocks (default: 4t, no drift)
    extend=None,      # [N] int32 proposer id extending its own lease (§6)
    acc_restart=None,  # [A] 0/1: blank this acceptor (diskless crash+restart)
    acc_deaf=None,     # [A] 0/1: acceptor inside its post-restart M-wait
    prop_restart=None,  # [P] 0/1: bump this proposer's restart counter
    prop_rc=None,      # [P] running restart counters (the ballot carve's rc)
) -> tuple[LeaseArrayState, NetPlaneState, torch.Tensor]:
    """One tick of the delayed (in-flight message) model in the public
    format. Returns (new_state, new_net, owner_count[N]). Giving any of the
    four restart inputs threads all four (absent ones as zeros, a bit-exact
    no-op)."""
    A, N = state.highest_promised.shape
    P = state.n_proposers
    dev = state.highest_promised.device
    adv = {}
    if extend is not None:
        adv["extend"] = _row(extend, N, dev)
    rst = dict(acc_restart=(acc_restart, A), acc_deaf=(acc_deaf, A),
               prop_restart=(prop_restart, P), prop_rc=(prop_rc, P))
    if any(x is not None for x, _ in rst.values()):
        # update, not replace: the reference (ref.py:258) rebuilds the dict
        # here and so drops an extend row given together with restarts
        adv.update({
            k: (torch.zeros((rows, 1), dtype=I32, device=dev) if x is None
                else _col(x, rows, dev))
            for k, (x, rows) in rst.items()
        })
    lease, netp, count = delayed_tick_math(
        tuple(pack_state(state)), tuple(net), t,
        _row(attempt, N, dev), _row(release, N, dev), _col(acc_up, A, dev),
        _col(rate1_clock(t, P, device=dev) if pclk is None else pclk, P, dev),
        _col(rate1_clock(t, A, device=dev) if aclk is None else aclk, A, dev),
        pack_link(link_matrix(delay, P, A), link_matrix(drop, P, A)).to(dev),
        majority=majority, lease_q4=lease_q4, round_q4=round_q4,
        n_proposers=P, guard_q4=guard_q4, **adv,
    )
    return (
        unpack_state(PackedLeaseState(*lease), P),
        NetPlaneState(*netp),
        count.reshape(N),
    )


def owner_row(state: LeaseArrayState) -> torch.Tensor:
    """Per-cell owner id (or NO_PROPOSER). With the at-most-one-owner
    invariant intact there is at most one set bit per column."""
    p_ids = torch.arange(
        state.n_proposers, dtype=I32, device=state.owner_mask.device
    )[:, None]
    return torch.where(state.owner_mask > 0, p_ids, NO_PROPOSER).amax(dim=0)
