"""The naive majority-vote lease algorithm from §1 — the paper's baseline.

Proposers start a local timer for T and ask every acceptor; an acceptor with
empty state grants and locks up for T, otherwise rejects. Correct (majority
+ timer ordering) but it BLOCKS: with k proposers racing, acceptors split
and nobody reaches majority until the timers expire — and then they likely
split again. ``benchmarks/bench_contention.py`` measures exactly this
against PaxosLease. A copy of ``repro.core.naive`` on the port's ``sim/``,
``core/invariant.py`` and ``configs/``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..configs.paxoslease_cell import CellConfig
from ..sim.env import SimEnv
from .invariant import LeaseMonitor


@dataclass(frozen=True)
class NaiveRequest:
    req_id: int
    timespan: float


@dataclass(frozen=True)
class NaiveResponse:
    req_id: int
    granted: bool


class NaiveAcceptor:
    def __init__(self, set_timer: Callable, send: Callable) -> None:
        self._set_timer = set_timer
        self._send = send
        self.locked_by: Optional[int] = None
        self._timer = None

    def on_request(self, msg: NaiveRequest, src: str) -> None:
        if self.locked_by is None:
            self.locked_by = msg.req_id
            self._timer = self._set_timer(msg.timespan, self._expire)
            self._send(src, NaiveResponse(msg.req_id, True))
        else:
            self._send(src, NaiveResponse(msg.req_id, False))

    def _expire(self) -> None:
        self.locked_by = None
        self._timer = None


class NaiveProposer:
    def __init__(
        self, node_id: int, acceptors: list[str], cfg: CellConfig, *,
        set_timer: Callable, send: Callable, random_backoff: Callable, monitor=None,
    ) -> None:
        self.node_id = node_id
        self.acceptors = acceptors
        self.cfg = cfg
        self._set_timer = set_timer
        self._send = send
        self._backoff = random_backoff
        self.monitor = monitor
        self._req_seq = node_id * 1_000_000
        self._cur_req: Optional[int] = None
        self._grants: set[str] = set()
        self._rejects: set[str] = set()
        self.owner = False
        self.want = False
        self.stats = {"attempts": 0, "acquired": 0, "blocked_rounds": 0}

    def acquire(self) -> None:
        self.want = True
        self._try()

    def _try(self) -> None:
        if not self.want or self.owner:
            return
        self._req_seq += 1
        self._cur_req = self._req_seq
        self._grants, self._rejects = set(), set()
        self.stats["attempts"] += 1
        # start local timer BEFORE sending (same safety ordering as PaxosLease)
        self._set_timer(self.cfg.lease_timespan, lambda rid=self._cur_req: self._expire(rid))
        self._owned_req: Optional[int] = None
        for a in self.acceptors:
            self._send(a, NaiveRequest(self._cur_req, self.cfg.lease_timespan))
        self._set_timer(max(4 * self.cfg.rtt_estimate, 0.1), lambda rid=self._cur_req: self._round_check(rid))

    def on_response(self, msg: NaiveResponse, src: str) -> None:
        if msg.req_id != self._cur_req or self.owner:
            return
        (self._grants if msg.granted else self._rejects).add(src)
        if len(self._grants) >= self.cfg.majority:
            self.owner = True
            self._owned_req = msg.req_id
            self.stats["acquired"] += 1
            if self.monitor:
                self.monitor.on_acquire(self.node_id, "R")

    def _round_check(self, rid: int) -> None:
        if self.owner or self._cur_req != rid:
            return
        # blocked: no majority. The naive algorithm can only wait out the
        # acceptors' T timers — there is no overwrite mechanism.
        self.stats["blocked_rounds"] += 1
        self._cur_req = None
        if self.want:
            self._set_timer(self._backoff(self.cfg.backoff_min, self.cfg.backoff_max) +
                            self.cfg.lease_timespan, self._try)

    def _expire(self, rid: int) -> None:
        if self.owner and self._owned_req == rid:
            self.owner = False
            if self.monitor:
                self.monitor.on_lose(self.node_id, "R")
            if self.want:
                self._try()


def build_naive_cell(cfg: CellConfig, *, n_proposers: int, seed: int = 0, net=None):
    env = SimEnv(seed=seed, net=net)
    monitor = LeaseMonitor(env)
    acc_addrs = [f"nacc{i}" for i in range(cfg.n_acceptors)]
    acceptors = []
    for i, addr in enumerate(acc_addrs):
        acc = NaiveAcceptor(
            set_timer=lambda d, fn, a=addr: env.set_timer(a, d, fn),
            send=lambda dst, m, a=addr: env.send(a, dst, m),
        )
        env.add_node(addr, lambda m, s, acc=acc: acc.on_request(m, s))
        acceptors.append(acc)
    proposers = []
    for j in range(n_proposers):
        addr = f"nprop{j}"
        p = NaiveProposer(
            j, acc_addrs, cfg,
            set_timer=lambda d, fn, a=addr: env.set_timer(a, d, fn),
            send=lambda dst, m, a=addr: env.send(a, dst, m),
            random_backoff=env.random_backoff,
            monitor=monitor,
        )
        env.add_node(addr, lambda m, s, p=p: p.on_response(m, s))
        proposers.append(p)
    return env, monitor, acceptors, proposers
