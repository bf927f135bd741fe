"""Acceptor (§3 steps 2 & 4): entirely RAM-resident, per-resource state.

State per resource:
  - highest ballot number promised  (never reset except by restart)
  - accepted proposal               (expires after its lease timespan T)

Disklessness: ``restart()`` wipes everything. Safety across restarts is the
node wrapper's job (wait M before rejoining — see ``core.cell.LeaseNode``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from .ballot import Ballot
from .messages import (
    Answer,
    PrepareRequest,
    PrepareResponse,
    Proposal,
    ProposeRequest,
    ProposeResponse,
    Release,
)


@dataclass
class _ResState:
    highest_promised: Optional[Ballot] = None
    accepted: Optional[Proposal] = None
    timer: object = None  # TimerHandle for lease expiry


class Acceptor:
    """``set_timer(local_delay, fn) -> handle`` and ``send(dst, msg)`` are
    injected so the same class runs under simulation or a real transport."""

    def __init__(
        self,
        node_id: int,
        *,
        set_timer: Callable,
        send: Callable,
        send_rejects: bool = True,
    ) -> None:
        self.node_id = node_id
        self._set_timer = set_timer
        self._send = send
        self.send_rejects = send_rejects
        self._res: dict[str, _ResState] = {}

    def _state(self, resource: str) -> _ResState:
        return self._res.setdefault(resource, _ResState())

    # ------------------------------------------------------------------ §3.2
    def on_prepare_request(self, msg: PrepareRequest, src: str) -> None:
        st = self._state(msg.resource)
        if st.highest_promised is not None and msg.ballot < st.highest_promised:
            if self.send_rejects:
                self._send(src, PrepareResponse(
                    msg.resource, msg.ballot, Answer.REJECT, None, promised=st.highest_promised
                ))
            return
        st.highest_promised = msg.ballot
        self._send(src, PrepareResponse(msg.resource, msg.ballot, Answer.ACCEPT, st.accepted))

    # ------------------------------------------------------------------ §3.4
    def on_propose_request(self, msg: ProposeRequest, src: str) -> None:
        st = self._state(msg.resource)
        if st.highest_promised is not None and msg.ballot < st.highest_promised:
            if self.send_rejects:
                self._send(src, ProposeResponse(msg.resource, msg.ballot, Answer.REJECT))
            return
        # Accept: discard any previous proposal, (re)start the expiry timer
        # BEFORE sending the response — the order the §4 proof relies on.
        if st.timer is not None:
            st.timer.cancel()
        st.accepted = msg.proposal
        st.timer = self._set_timer(
            msg.proposal.lease.timespan, lambda r=msg.resource, b=msg.ballot: self._on_timeout(r, b)
        )
        self._send(src, ProposeResponse(msg.resource, msg.ballot, Answer.ACCEPT))

    def _on_timeout(self, resource: str, ballot: Ballot) -> None:
        st = self._state(resource)
        if st.accepted is not None and st.accepted.ballot == ballot:
            st.accepted = None
            st.timer = None
        # highest_promised is NEVER reset (except by restart)

    # -------------------------------------------------------------------- §7
    def on_release(self, msg: Release, src: str) -> None:
        st = self._state(msg.resource)
        if st.accepted is not None and st.accepted.ballot == msg.ballot:
            if st.timer is not None:
                st.timer.cancel()
            st.accepted = None
            st.timer = None
        # otherwise do nothing (paper §7)

    # ------------------------------------------------------------- restarts
    def restart(self) -> None:
        """Diskless restart: blank state (the M-wait happens in the node)."""
        for st in self._res.values():
            if st.timer is not None:
                st.timer.cancel()
        self._res.clear()

    # ------------------------------------------------------------- plumbing
    def handle(self, msg, src: str) -> bool:
        if isinstance(msg, PrepareRequest):
            self.on_prepare_request(msg, src)
        elif isinstance(msg, ProposeRequest):
            self.on_propose_request(msg, src)
        elif isinstance(msg, Release):
            self.on_release(msg, src)
        else:
            return False
        return True

    def memory_bytes(self) -> int:
        """Rough per-instance RAM accounting for the §8 benchmark."""
        import sys

        total = 0
        for k, st in self._res.items():
            total += sys.getsizeof(k) + sys.getsizeof(st.highest_promised) + sys.getsizeof(st.accepted)
        return total
