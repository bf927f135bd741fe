"""Ballot numbers (§2): globally unique, monotonically increasing per
proposer. Composed of (run counter | restart counter | proposer id) with the
run counter at the most significant end; the restart counter is persisted to
stable storage by *proposers* (the only disk touch in the whole protocol —
acceptors are diskless)."""
from __future__ import annotations

from dataclasses import dataclass
from functools import total_ordering


@total_ordering
@dataclass(frozen=True)
class Ballot:
    run: int
    restart: int
    proposer_id: int

    def _key(self):
        return (self.run, self.restart, self.proposer_id)

    def __lt__(self, other: "Ballot") -> bool:
        return self._key() < other._key()

    def __eq__(self, other) -> bool:
        return isinstance(other, Ballot) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return f"B({self.run}.{self.restart}.{self.proposer_id})"


class BallotGenerator:
    """NextBallotNumber(). ``restart`` comes from stable storage; ``run``
    resets on restart — uniqueness holds because restart strictly grows."""

    def __init__(self, proposer_id: int, restart_counter: int) -> None:
        self.proposer_id = proposer_id
        self.restart = restart_counter
        self.run = 0

    def next(self, at_least: "Ballot | None" = None) -> Ballot:
        self.run += 1
        if at_least is not None and at_least.run >= self.run:
            # jump past a higher ballot observed in a reject (liveness aid)
            self.run = at_least.run + 1
        return Ballot(self.run, self.restart, self.proposer_id)
