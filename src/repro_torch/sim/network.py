"""Best-effort message transport with loss, duplication, reordering,
variable delay and partitions — the failure model PaxosLease claims to
tolerate (§1: node restarts, splits, loss/reordering, in-transit delays).

Delays and drops are randomized by default; a *policy* hook can pin them
per message instead (``set_delay_policy`` / ``set_drop_policy``), which is
how the lease_array differential referee replays a trace's exact delay/drop
planes through this transport (see ``lease_array.trace.replay_event_sim``).
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from .events import Scheduler


@dataclass
class NetConfig:
    delay_min: float = 0.01
    delay_max: float = 0.05
    loss: float = 0.0  # P(drop)
    duplicate: float = 0.0  # P(deliver twice)
    jitter_tail: float = 0.0  # P(huge straggler delay)
    tail_delay: float = 5.0  # straggler delay upper bound


#: loss causes tracked by Network. send-side: the source was crashed, the
#: pair was partitioned, a drop policy said so, or random loss hit.
#: delivery-side: the destination was crashed (or partitioned) mid-flight,
#: or nothing was registered at the address.
DROP_CAUSES = (
    "src_down", "partition", "policy", "loss", "dst_down", "no_handler",
)


class Network:
    def __init__(self, scheduler: Scheduler, cfg: NetConfig, seed: int = 0) -> None:
        self.sched = scheduler
        self.cfg = cfg
        self.rng = random.Random(seed)
        self._handlers: dict[str, Callable] = {}
        self._partitions: set[frozenset] = set()
        self._down: set[str] = set()
        self.sent = 0  # send() calls, whether or not anything got through
        self.delivered = 0  # handler invocations (duplicates count twice)
        self.dropped = {cause: 0 for cause in DROP_CAUSES}
        # (src, dst, msg, now) -> delay in sim-seconds, or None = randomize
        self.delay_policy: Optional[Callable] = None
        # (src, dst, msg, now) -> True to drop at send time
        self.drop_policy: Optional[Callable] = None

    def register(self, addr: str, handler: Callable) -> None:
        self._handlers[addr] = handler

    def set_down(self, addr: str, down: bool = True) -> None:
        (self._down.add if down else self._down.discard)(addr)

    def partition(self, group_a: set[str], group_b: set[str]) -> None:
        for a in group_a:
            for b in group_b:
                self._partitions.add(frozenset((a, b)))

    def heal(self) -> None:
        self._partitions.clear()

    def set_delay_policy(self, fn: Optional[Callable]) -> None:
        """Pin per-message delays: ``fn(src, dst, msg, now) -> float | None``
        (None falls back to the randomized draw)."""
        self.delay_policy = fn

    def set_drop_policy(self, fn: Optional[Callable]) -> None:
        """Pin per-message loss: ``fn(src, dst, msg, now) -> bool``."""
        self.drop_policy = fn

    def _blocked(self, src: str, dst: str) -> bool:
        return frozenset((src, dst)) in self._partitions

    def send(self, src: str, dst: str, msg) -> None:
        self.sent += 1
        if src in self._down:
            self.dropped["src_down"] += 1
            return  # crashed nodes don't speak
        if self._blocked(src, dst):
            self.dropped["partition"] += 1
            return
        if self.drop_policy is not None and self.drop_policy(src, dst, msg, self.sched.now):
            self.dropped["policy"] += 1
            return
        if self.rng.random() < self.cfg.loss:
            self.dropped["loss"] += 1
            return
        if self.delay_policy is not None:
            pinned = self.delay_policy(src, dst, msg, self.sched.now)
            if pinned is not None:  # exactly one copy, deterministic delay
                self.sched.after(
                    pinned, lambda d=dst, s=src, m=msg: self._deliver(s, d, m)
                )
                return
        n_copies = 2 if self.rng.random() < self.cfg.duplicate else 1
        for _ in range(n_copies):
            if self.cfg.jitter_tail and self.rng.random() < self.cfg.jitter_tail:
                delay = self.rng.uniform(self.cfg.delay_max, self.cfg.tail_delay)
            else:
                delay = self.rng.uniform(self.cfg.delay_min, self.cfg.delay_max)
            self.sched.after(delay, lambda d=dst, s=src, m=msg: self._deliver(s, d, m))

    def _deliver(self, src: str, dst: str, msg) -> None:
        if dst in self._down:
            self.dropped["dst_down"] += 1
            return  # crashed mid-flight
        if self._blocked(src, dst):
            self.dropped["partition"] += 1
            return  # partitioned while in transit
        h = self._handlers.get(dst)
        if h is None:
            self.dropped["no_handler"] += 1
            return
        self.delivered += 1
        h(msg, src)

    def stats(self) -> dict:
        """Accounting that distinguishes loss causes. ``sent`` counts send()
        calls; ``delivered`` counts handler invocations (a duplicated message
        can deliver twice, and a message still in the scheduler counts in
        neither ``delivered`` nor ``dropped`` yet)."""
        dropped_total = sum(self.dropped.values())
        return {
            "sent": self.sent,
            "delivered": self.delivered,
            "dropped": dict(self.dropped),
            "dropped_total": dropped_total,
        }
