"""A PaxosLease *cell* (§2): n acceptors + any number of proposers, wired
over a SimEnv (or any object with the same interface).

``LeaseNode`` realizes the practical deployment of §2 ("nodes often act as
proposers and acceptors") and enforces the two restart rules:
  - acceptor role: blank RAM + deaf for M seconds before rejoining (§3)
  - proposer role: restart counter incremented on stable storage (§2)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..configs.paxoslease_cell import CellConfig
from ..sim.env import SimEnv
from .acceptor import Acceptor
from .invariant import LeaseMonitor
from .messages import PrepareRequest, ProposeRequest, Release
from .proposer import Proposer


def acceptor_addr(i: int) -> str:
    return f"acc{i}"


def node_addr(i: int) -> str:
    return f"node{i}"


class LeaseNode:
    def __init__(
        self,
        env: SimEnv,
        node_id: int,
        cfg: CellConfig,
        *,
        monitor: Optional[LeaseMonitor] = None,
        is_acceptor: bool = True,
        is_proposer: bool = True,
        clock_rate: float = 1.0,
        acceptor_addrs: Optional[list[str]] = None,
        hint_addrs: Optional[list[str]] = None,  # §7 release hints to peers
        skip_restart_wait: bool = False,  # for the test PROVING M-wait necessity
    ) -> None:
        self.env = env
        self.node_id = node_id
        self.cfg = cfg
        self.addr = node_addr(node_id)
        self.crashed = False
        self.rejoin_deadline = 0.0  # global; enforced via deafness below
        self.skip_restart_wait = skip_restart_wait
        env.add_node(self.addr, self._on_message, clock_rate=clock_rate)

        set_timer = lambda d, fn: env.set_timer(self.addr, d, fn)
        send = lambda dst, msg: env.send(self.addr, dst, msg)

        self.acceptor = (
            Acceptor(node_id, set_timer=set_timer, send=send) if is_acceptor else None
        )
        self.proposer = None
        if is_proposer:
            persisted = env.stable.load(self.addr)
            restart = persisted.get("restart_counter", 0)
            env.stable.store(self.addr, "restart_counter", restart)  # ensure present
            self.proposer = Proposer(
                node_id,
                acceptor_addrs or [],
                cfg,
                set_timer=set_timer,
                send=send,
                random_backoff=env.random_backoff,
                restart_counter=restart,
                monitor=monitor,
                hint_addrs=[a for a in (hint_addrs or []) if a != self.addr],
                local_now=lambda: env.local_now(self.addr),
            )

    # ---------------------------------------------------------------- faults
    def crash(self) -> None:
        """Stop processing; RAM state is lost on restart (diskless).

        A crashed proposer no longer *believes* anything — its ownership
        intervals end here (the monitor is told so the §4 bookkeeping
        reflects reality; the node itself could never act on it anyway)."""
        self.crashed = True
        self.env.network.set_down(self.addr, True)
        if self.proposer is not None:
            for res, st in list(self.proposer._res.items()):
                st.want = False
                for attr in ("renew_timer", "retry_timer"):
                    self.proposer._cancel(st, attr)
                if st.round is not None:
                    self.proposer._cancel(st.round, "round_timer")
                    self.proposer._cancel(st.round, "lease_timer")
                if st.owner:
                    self.proposer._set_owner(res, st, False)

    def restart(self) -> None:
        """Blank acceptor state; deaf for M before rejoining (§3). The
        proposer role persists only its restart counter."""
        assert self.crashed
        if self.acceptor is not None:
            self.acceptor.restart()
        if self.proposer is not None:
            persisted = self.env.stable.load(self.addr)
            rc = persisted.get("restart_counter", 0) + 1
            self.env.stable.store(self.addr, "restart_counter", rc)
            self.proposer.ballots.restart = rc
            self.proposer.ballots.run = 0
            self.proposer._res.clear()  # RAM state gone; ownership forgotten
        wait = 0.0 if self.skip_restart_wait else self.cfg.max_lease_time
        self.rejoin_deadline = self.env.now + wait
        self.env.set_timer(self.addr, 0.0, lambda: None)  # keep scheduler moving

        def rejoin() -> None:
            if self.env.now + 1e-9 < self.rejoin_deadline:
                return  # a later restart extended the deaf window
            self.crashed = False
            self.env.network.set_down(self.addr, False)

        self.env.sched.at(self.rejoin_deadline, rejoin)

    # -------------------------------------------------------------- dispatch
    def _on_message(self, msg, src: str) -> None:
        if self.crashed:
            return
        if isinstance(msg, (PrepareRequest, ProposeRequest, Release)):
            if self.acceptor is not None:
                self.acceptor.handle(msg, src)
            return
        if self.proposer is not None:
            self.proposer.handle(msg, src)


@dataclass
class Cell:
    env: SimEnv
    cfg: CellConfig
    nodes: list[LeaseNode]
    monitor: LeaseMonitor

    @property
    def proposers(self) -> list[LeaseNode]:
        return [n for n in self.nodes if n.proposer is not None]

    def node(self, i: int) -> LeaseNode:
        return self.nodes[i]


def build_cell(
    cfg: CellConfig,
    *,
    n_proposers: Optional[int] = None,
    seed: int = 0,
    net=None,
    clock_rates: Optional[dict[int, float]] = None,
    strict_monitor: bool = True,
    combined_roles: bool = True,
) -> Cell:
    """Standard topology: ``n_acceptors`` combined nodes (acceptor+proposer)
    plus optional extra pure proposers (elastic workers)."""
    env = SimEnv(seed=seed, net=net)
    monitor = LeaseMonitor(env, strict=strict_monitor)
    rates = clock_rates or {}
    nodes: list[LeaseNode] = []
    n_prop = n_proposers if n_proposers is not None else cfg.n_acceptors
    if combined_roles:
        acc_addrs = [node_addr(i) for i in range(cfg.n_acceptors)]
        prop_addrs = [node_addr(i) for i in range(n_prop)]
        for i in range(max(cfg.n_acceptors, n_prop)):
            nodes.append(
                LeaseNode(
                    env, i, cfg,
                    monitor=monitor,
                    is_acceptor=i < cfg.n_acceptors,
                    is_proposer=i < n_prop,
                    clock_rate=rates.get(i, 1.0),
                    acceptor_addrs=acc_addrs,
                    hint_addrs=prop_addrs,
                )
            )
    else:  # dedicated acceptor ensemble + detached proposer fleet
        acc_base = 1000
        acc_addrs = [node_addr(acc_base + i) for i in range(cfg.n_acceptors)]
        for i in range(cfg.n_acceptors):
            nodes.append(
                LeaseNode(
                    env, acc_base + i, cfg,
                    monitor=monitor,
                    is_acceptor=True,
                    is_proposer=False,
                    clock_rate=rates.get(acc_base + i, 1.0),
                )
            )
        for i in range(n_prop):
            nodes.append(
                LeaseNode(
                    env, i, cfg,
                    monitor=monitor,
                    is_acceptor=False,
                    is_proposer=True,
                    clock_rate=rates.get(i, 1.0),
                    acceptor_addrs=acc_addrs,
                )
            )
    return Cell(env, cfg, nodes, monitor)
