"""Protocol messages (§2). A proposal = (ballot, lease); a lease =
(proposer id, timespan T). Only *timespans* are ever transmitted — never
absolute times — which is why no clock synchrony is needed."""
from __future__ import annotations

import enum
import sys
from dataclasses import dataclass
from typing import Optional

from .ballot import Ballot

DEFAULT_RESOURCE = "R"


class Answer(enum.IntEnum):
    ACCEPT = 0
    REJECT = 1


@dataclass(frozen=True)
class Lease:
    proposer_id: int
    timespan: float  # T — always < M


@dataclass(frozen=True)
class Proposal:
    ballot: Ballot
    lease: Lease


@dataclass(frozen=True)
class PrepareRequest:
    resource: str
    ballot: Ballot


@dataclass(frozen=True)
class PrepareResponse:
    resource: str
    ballot: Ballot
    answer: Answer
    accepted: Optional[Proposal]  # None == 'empty'
    promised: Optional[Ballot] = None  # piggybacked on rejects (liveness aid)


@dataclass(frozen=True)
class ProposeRequest:
    resource: str
    ballot: Ballot
    proposal: Proposal


@dataclass(frozen=True)
class ProposeResponse:
    resource: str
    ballot: Ballot
    answer: Answer


@dataclass(frozen=True)
class Release:
    """§7: release the lease early; acceptors discard state iff the accepted
    ballot matches."""

    resource: str
    ballot: Ballot


@dataclass(frozen=True)
class LearnHint:
    """§3/§7: optional hint ('node i (may have) acquired/released R').
    NEVER authoritative — receivers may use it to wake up or back off, but
    ownership is only ever known to the owner."""

    resource: str
    proposer_id: int
    event: str  # "acquired" | "released"


def message_size_bytes(msg) -> int:
    """Wire-size estimate used by the §8 memory/throughput benchmarks."""
    return sys.getsizeof(msg)
