"""The port's naive majority baseline (``repro_torch.core.naive``, §1)
against the reference's, from the same seeds.

The three cases of ``tests/test_naive_vs_paxos.py`` run on ``repro`` and on
``repro_torch``: the same deadlocked seeds, the same owners, the same
proposer stats and monitor records; and ``bench_contention.py``'s loop at
8 seeds gives equal counts (naive deadlocks at 10 s, PaxosLease's time to
its first owner). The reference test's own assertions are checked on the
port's run. Pure Python.
"""
import importlib
from types import SimpleNamespace

import pytest


def _ns(pkg):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return SimpleNamespace(
        build_naive_cell=mod("core.naive").build_naive_cell,
        build_cell=mod("core.cell").build_cell,
        CellConfig=mod("configs.paxoslease_cell").CellConfig,
        NetConfig=mod("sim.network").NetConfig,
    )


REF, PORT = _ns("repro"), _ns("repro_torch")


def _cfg(ns, n_acceptors=3):
    return ns.CellConfig(n_acceptors=n_acceptors, max_lease_time=60.0,
                         lease_timespan=15.0, backoff_min=0.05, backoff_max=0.3)


def _net(ns):
    return ns.NetConfig(delay_min=0.01, delay_max=0.02)


def naive_runs(ns, n_proposers, seeds, until, n_acceptors=3):
    """Per seed: the owner, each proposer's stats and ownership, the
    monitor's acquisitions and violations."""
    out = []
    for seed in seeds:
        env, monitor, _, props = ns.build_naive_cell(
            _cfg(ns, n_acceptors), n_proposers=n_proposers, seed=seed,
            net=_net(ns))
        for p in props:
            p.acquire()
        env.run_until(until)
        out.append(dict(owner=monitor.owner_of("R"),
                        stats=[dict(p.stats) for p in props],
                        owners=[p.owner for p in props],
                        acquired=list(monitor.acquire_times),
                        violations=len(monitor.violations)))
    return out


def paxos_runs(ns, n_proposers, seeds, n_acceptors=3):
    out = []
    for seed in seeds:
        cell = ns.build_cell(_cfg(ns, n_acceptors), n_proposers=n_proposers,
                             seed=seed, net=_net(ns))
        for p in cell.proposers:
            p.proposer.acquire()
        cell.env.run_until(10.0)
        cell.monitor.assert_clean()
        out.append(dict(owner=cell.monitor.owner_of("R"),
                        acquired=list(cell.monitor.acquire_times)))
    return out


def test_naive_blocks_with_three_contenders():
    got = naive_runs(PORT, 3, range(20), 10.0)
    assert got == naive_runs(REF, 3, range(20), 10.0)
    deadlocked = [r for r in got if r["owner"] is None]
    assert deadlocked, "naive majority should fully deadlock for some seed"
    for r in deadlocked:
        assert sum(s["blocked_rounds"] for s in r["stats"]) >= 3


def test_paxoslease_acquires_under_same_contention():
    got = paxos_runs(PORT, 3, range(8))
    assert got == paxos_runs(REF, 3, range(8))
    assert all(r["owner"] is not None for r in got)


def test_naive_is_at_least_safe():
    got = naive_runs(PORT, 4, range(5), 120.0)
    assert got == naive_runs(REF, 4, range(5), 120.0)
    assert all(r["violations"] == 0 for r in got)


def contention(ns, n_prop, seeds):
    """``benchmarks/bench_contention.py``'s loop for ``n_prop`` proposers
    (on A 3 for 3, A 5 for 5): the naive deadlocks at 10 s and
    PaxosLease's time to its first owner, per seed."""
    a = 3 if n_prop == 3 else 5
    naive = naive_runs(ns, n_prop, seeds, 10.0, n_acceptors=a)
    paxos = paxos_runs(ns, n_prop, seeds, n_acceptors=a)
    return dict(blocked=sum(r["owner"] is None for r in naive),
                t_first=[r["acquired"][0] if r["acquired"] else float("inf")
                         for r in paxos])


@pytest.mark.parametrize("n_prop", [3, 5])
def test_bench_contention_loop_equals_reference(n_prop):
    got = contention(PORT, n_prop, range(8))
    assert got == contention(REF, n_prop, range(8))
    assert all(t < 10.0 for t in got["t_first"])  # PaxosLease never blocks
