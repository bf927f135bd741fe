"""PaxosLease — the paper's contribution (Trencseni, Gazso, Reinhardt 2012):
diskless Paxos-style lease negotiation with no clock-synchrony assumption.

The event-driven engine (proposers, acceptors, cells, the §4 monitor): a
copy of ``repro.core``, which the port may not import. It is the
differential referee the vectorized plane and its CUDA kernels are held
against (``lease_array.trace.replay_event_sim``). Pure Python."""
from .acceptor import Acceptor
from .ballot import Ballot, BallotGenerator
from .cell import Cell, LeaseNode, build_cell
from .invariant import LeaseInvariantViolation, LeaseMonitor
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
from .proposer import Proposer

__all__ = [
    "Acceptor", "Answer", "Ballot", "BallotGenerator", "Cell", "DEFAULT_RESOURCE",
    "LearnHint", "Lease", "LeaseInvariantViolation", "LeaseMonitor", "LeaseNode",
    "PrepareRequest", "PrepareResponse", "Proposal", "ProposeRequest",
    "ProposeResponse", "Proposer", "Release", "build_cell",
]
