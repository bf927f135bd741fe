"""Discrete-event scheduler: the global clock of the simulation.

Nodes never read this clock directly (PaxosLease assumes no synchronized
clocks); only the invariant monitor and the network use global time. Nodes
see time exclusively through their drifted local clocks (``sim.env``).
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class TimerHandle:
    fire_at: float
    seq: int
    fn: Optional[Callable] = None
    cancelled: bool = False

    def cancel(self) -> None:
        self.cancelled = True
        self.fn = None


class Scheduler:
    def __init__(self) -> None:
        self._q: list[tuple[float, int, TimerHandle]] = []
        self._seq = itertools.count()
        self.now: float = 0.0

    def at(self, t: float, fn: Callable) -> TimerHandle:
        assert t >= self.now - 1e-12, (t, self.now)
        h = TimerHandle(t, next(self._seq), fn)
        heapq.heappush(self._q, (t, h.seq, h))
        return h

    def after(self, delay: float, fn: Callable) -> TimerHandle:
        return self.at(self.now + max(delay, 0.0), fn)

    def run_until(self, t_end: float) -> None:
        while self._q and self._q[0][0] <= t_end:
            t, _, h = heapq.heappop(self._q)
            self.now = max(self.now, t)
            if not h.cancelled and h.fn is not None:
                fn, h.fn = h.fn, None
                fn()
        self.now = max(self.now, t_end)

    def run_while(self, cond: Callable[[], bool], t_max: float) -> None:
        while self._q and cond() and self._q[0][0] <= t_max:
            t, _, h = heapq.heappop(self._q)
            self.now = max(self.now, t)
            if not h.cancelled and h.fn is not None:
                fn, h.fn = h.fn, None
                fn()

    @property
    def pending(self) -> int:
        return sum(1 for _, _, h in self._q if not h.cancelled)
