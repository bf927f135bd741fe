"""Proposer (§3 steps 1, 3, 5 + §6 extend + §7 release).

Faithfulness notes:

- The proposer starts its own lease timer at the moment a majority of empty
  prepare responses is in hand, BEFORE broadcasting propose requests — the
  ordering the §4 proof depends on (Fig. 2).
- Votes are counted as *sets of acceptor ids*, not counters, so duplicated
  messages (UDP-style transport) can't double-count.
- Extending (§6) counts a prepare response as "open" also when it carries
  this proposer's own proposal — but only while the proposer still believes
  it is the owner (a restarted proposer lost its timer state and must win a
  fully-empty majority again).
- Only the owner knows it owns the lease. ``on_acquire``/``on_lose`` fire on
  the local transitions; LearnHints are strictly advisory (§3).
- Optional drift guard (beyond-paper, see DESIGN.md): with clock-rate drift
  bounded by eps, the proposer discounts its own timer to T*(1-eps)/(1+eps)
  so it never outlives the acceptors' timers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ..configs.paxoslease_cell import CellConfig
from .ballot import Ballot, BallotGenerator
from .messages import (
    Answer,
    DEFAULT_RESOURCE,
    LearnHint,
    Lease,
    PrepareRequest,
    PrepareResponse,
    Proposal,
    ProposeRequest,
    ProposeResponse,
    Release,
)

IDLE, PREPARING, PROPOSING, DONE = "idle", "preparing", "proposing", "done"


@dataclass
class _Round:
    ballot: Ballot
    round_id: int
    phase: str = PREPARING
    open_from: set = field(default_factory=set)
    rejects: set = field(default_factory=set)
    accepts: set = field(default_factory=set)
    highest_seen: Optional[Ballot] = None
    lease_timer: object = None
    round_timer: object = None
    lease_deadline: Optional[float] = None  # local clock, guarded (§3 step 3)


@dataclass
class _ResState:
    want: bool = False
    renew: bool = True
    timespan: float = 0.0
    round: Optional[_Round] = None
    owner: bool = False
    owner_round_id: int = -1
    last_success_ballot: Optional[Ballot] = None
    owner_deadline: Optional[float] = None  # local clock, guarded expiry
    renew_timer: object = None
    retry_timer: object = None


class Proposer:
    def __init__(
        self,
        node_id: int,
        acceptor_addrs: list[str],
        cfg: CellConfig,
        *,
        set_timer: Callable,
        send: Callable,
        random_backoff: Callable[[float, float], float],
        restart_counter: int = 0,
        monitor=None,
        hint_addrs: Optional[list[str]] = None,
        local_now: Optional[Callable[[], float]] = None,
    ) -> None:
        self.node_id = node_id
        self.acceptors = list(acceptor_addrs)
        self.cfg = cfg
        self._set_timer = set_timer
        self._send = send
        self._backoff = random_backoff
        # optional LOCAL clock read (same drifted clock the timers run on);
        # used only to keep failed-extend retries inside the lease window
        self._local_now = local_now
        self.ballots = BallotGenerator(node_id, restart_counter)
        self.monitor = monitor
        self.hint_addrs = hint_addrs or []
        self._res: dict[str, _ResState] = {}
        self._round_seq = 0
        self.stats = {"rounds": 0, "acquired": 0, "extended": 0, "released": 0, "aborted": 0}

    # ------------------------------------------------------------------ API
    def acquire(self, resource: str = DEFAULT_RESOURCE, timespan: Optional[float] = None,
                renew: bool = True) -> None:
        """Try (and keep trying) to hold the lease on ``resource``."""
        st = self._state(resource)
        st.want = True
        st.renew = renew
        st.timespan = timespan or self.cfg.lease_timespan
        assert st.timespan < self.cfg.max_lease_time, "requires T < M (§2)"
        idle = st.round is None or st.round.phase in (IDLE, DONE)
        if idle and not st.owner and st.retry_timer is None:
            self._start_round(resource)

    def release(self, resource: str = DEFAULT_RESOURCE) -> None:
        """§7: switch to non-owner FIRST, then tell acceptors to discard."""
        st = self._state(resource)
        st.want = False
        self._cancel(st, "renew_timer")
        self._cancel(st, "retry_timer")
        if st.owner:
            self._set_owner(resource, st, False)
            self.stats["released"] += 1
            if st.last_success_ballot is not None:
                for a in self.acceptors:
                    self._send(a, Release(resource, st.last_success_ballot))
                self._hint(resource, "released")
        st.round = None

    def is_owner(self, resource: str = DEFAULT_RESOURCE) -> bool:
        return self._state(resource).owner

    # ------------------------------------------------------------ round flow
    def _state(self, resource: str) -> _ResState:
        return self._res.setdefault(resource, _ResState())

    def _cancel(self, st, attr: str) -> None:
        h = getattr(st, attr)
        if h is not None:
            h.cancel()
            setattr(st, attr, None)

    def _start_round(self, resource: str) -> None:  # §3 step 1
        st = self._state(resource)
        if not st.want:
            return
        self._round_seq += 1
        ballot = self.ballots.next(
            at_least=st.round.highest_seen if st.round else None
        )
        rnd = _Round(ballot=ballot, round_id=self._round_seq)
        st.round = rnd
        self.stats["rounds"] += 1
        rt = self.cfg.round_timeout or max(8 * self.cfg.rtt_estimate, 0.2)
        rnd.round_timer = self._set_timer(rt, lambda r=resource, i=rnd.round_id: self._on_round_timeout(r, i))
        for a in self.acceptors:
            self._send(a, PrepareRequest(resource, ballot))

    def _guarded_timespan(self, t: float) -> float:
        if self.cfg.drift_guard and self.cfg.clock_drift_bound > 0:
            eps = self.cfg.clock_drift_bound
            return t * (1 - eps) / (1 + eps)
        return t

    def on_prepare_response(self, msg: PrepareResponse, src: str) -> None:  # §3 step 3
        st = self._state(msg.resource)
        rnd = st.round
        if rnd is None or rnd.phase != PREPARING or msg.ballot != rnd.ballot:
            return  # some other proposal
        if msg.answer == Answer.REJECT:
            rnd.rejects.add(src)
            if msg.promised is not None:
                rnd.highest_seen = max(rnd.highest_seen or msg.promised, msg.promised)
            if len(rnd.rejects) >= self.cfg.majority:
                self._abort_round(msg.resource)
            return
        counts_as_open = msg.accepted is None or (
            st.owner and msg.accepted.lease.proposer_id == self.node_id  # §6 extend
        )
        if counts_as_open:
            rnd.open_from.add(src)
        if len(rnd.open_from) < self.cfg.majority:
            return
        # majority open: start OUR timer first, then broadcast the proposal
        rnd.phase = PROPOSING
        t_own = self._guarded_timespan(st.timespan)
        if self._local_now is not None:
            rnd.lease_deadline = self._local_now() + t_own
        rnd.lease_timer = self._set_timer(
            t_own, lambda r=msg.resource, i=rnd.round_id: self._on_lease_timeout(r, i)
        )
        proposal = Proposal(rnd.ballot, Lease(self.node_id, st.timespan))
        for a in self.acceptors:
            self._send(a, ProposeRequest(msg.resource, rnd.ballot, proposal))

    def on_propose_response(self, msg: ProposeResponse, src: str) -> None:  # §3 step 5
        st = self._state(msg.resource)
        rnd = st.round
        if rnd is None or rnd.phase != PROPOSING or msg.ballot != rnd.ballot:
            return
        if msg.answer == Answer.REJECT:
            rnd.rejects.add(src)
            return
        rnd.accepts.add(src)
        if len(rnd.accepts) < self.cfg.majority:
            return
        # majority accepted: we hold the lease until OUR timer (started in
        # step 3) expires.
        rnd.phase = DONE  # ignore further (duplicated) accepts
        self._cancel(rnd, "round_timer")
        st.owner_round_id = rnd.round_id
        st.last_success_ballot = rnd.ballot
        st.owner_deadline = rnd.lease_deadline
        was_owner = st.owner
        if not was_owner:
            self._set_owner(msg.resource, st, True)
            self.stats["acquired"] += 1
            self._hint(msg.resource, "acquired")
        else:
            self.stats["extended"] += 1
        if st.renew:
            self._cancel(st, "renew_timer")
            st.renew_timer = self._set_timer(
                st.timespan * self.cfg.renew_fraction,
                lambda r=msg.resource: self._renew(r),
            )

    # ----------------------------------------------------------- timeouts
    def _on_lease_timeout(self, resource: str, round_id: int) -> None:
        """Proposer::OnTimeout — this round's lease window has passed."""
        st = self._state(resource)
        if st.owner and st.owner_round_id == round_id:
            self._set_owner(resource, st, False)
            st.owner_deadline = None
            if st.want:
                self._schedule_retry(resource)
        elif (
            st.round is not None
            and st.round.round_id == round_id
            and st.round.phase == PROPOSING
        ):
            # our own lease window elapsed before a majority accepted: any
            # late accepts must not make us owner — the timer started in
            # step 3 bounds the ownership claim (§3 step 5)
            st.round.phase = DONE

    def _on_round_timeout(self, resource: str, round_id: int) -> None:
        st = self._state(resource)
        if st.round is not None and st.round.round_id == round_id:
            self._abort_round(resource)

    def _abort_round(self, resource: str) -> None:
        """No majority (§5): back off a random amount, retry with a higher
        ballot — the paper's dynamic-deadlock workaround."""
        st = self._state(resource)
        if st.round is not None:
            self._cancel(st.round, "round_timer")
            hs = st.round.highest_seen
            st.round = _Round(  # keep highest_seen for the ballot jump
                ballot=st.round.ballot, round_id=-1, phase=IDLE, highest_seen=hs
            )
        self.stats["aborted"] += 1
        if st.want and not st.owner:
            self._schedule_retry(resource)
        elif st.want and st.owner:
            # failed extend: retry promptly; our lease is still ticking
            self._schedule_retry(resource, fast=True)

    def _schedule_retry(self, resource: str, fast: bool = False) -> None:
        st = self._state(resource)
        if st.retry_timer is not None:
            return
        lo, hi = self.cfg.backoff_min, self.cfg.backoff_max
        if fast:
            lo, hi = lo / 4, hi / 4
        delay = self._backoff(lo, hi)
        if fast and self._local_now is not None and st.owner_deadline is not None:
            # a failed-extend retry landing after the guarded expiry turns
            # the extend into a cold acquire and a handoff; retry no later
            # than halfway into what's left of our own lease window
            remaining = st.owner_deadline - self._local_now()
            delay = min(delay, max(remaining / 2, 0.0))
        st.retry_timer = self._set_timer(delay, lambda r=resource: self._retry(r))

    def _retry(self, resource: str) -> None:
        st = self._state(resource)
        st.retry_timer = None
        if st.want and (st.round is None or st.round.phase in (IDLE, DONE)):
            self._start_round(resource)

    def _renew(self, resource: str) -> None:  # §6
        st = self._state(resource)
        st.renew_timer = None
        if st.want and st.owner:
            self._start_round(resource)

    # ----------------------------------------------------------- plumbing
    def _set_owner(self, resource: str, st: _ResState, owner: bool) -> None:
        st.owner = owner
        if self.monitor is not None:
            if owner:
                self.monitor.on_acquire(self.node_id, resource)
            else:
                self.monitor.on_lose(self.node_id, resource)

    def _hint(self, resource: str, event: str) -> None:
        for addr in self.hint_addrs:
            self._send(addr, LearnHint(resource, self.node_id, event))

    def on_hint(self, msg: LearnHint, src: str) -> None:
        """§7: release hints are advisory — NEVER authoritative for ownership
        — but a 'released' hint for a resource we want lets us retry NOW
        instead of sleeping out the backoff (faster handoff, same safety:
        the prepare/propose round still decides)."""
        if msg.event != "released":
            return
        st = self._res.get(msg.resource)
        if st is not None and st.want and not st.owner:
            self._cancel(st, "retry_timer")
            if st.round is None or st.round.phase in (IDLE, DONE):
                self._start_round(msg.resource)

    def handle(self, msg, src: str) -> bool:
        if isinstance(msg, PrepareResponse):
            self.on_prepare_response(msg, src)
        elif isinstance(msg, ProposeResponse):
            self.on_propose_response(msg, src)
        elif isinstance(msg, LearnHint):
            self.on_hint(msg, src)
        else:
            return False
        return True
