"""The port's cluster services (``repro_torch.cluster``: coordinator,
membership, autoscale, shards) against the reference's, from the same
seeds.

Each scenario of ``tests/test_cluster.py`` and ``tests/test_autoscale.py``
runs twice, once on ``repro`` and once on ``repro_torch``, and must give
the same values: the coordinator's gained/lost events (times and ids),
``failover_times()``, ``master()``, the shard owners, membership's
``live_workers()``/``suspected()`` and the autoscaler's decisions. The
reference test's own assertions are then checked on the port's run.
``bench_failover.py``'s loop runs at 5 seeds with equal gaps. Pure Python.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest


def _ns(pkg):
    mods = {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "cluster.autoscale", "cluster.coordinator", "cluster.membership",
        "cluster.shards", "configs.paxoslease_cell", "sim.env", "sim.network")}
    return SimpleNamespace(
        AutoscaleController=mods["cluster.autoscale"].AutoscaleController,
        build_coordinated_cluster=mods["cluster.coordinator"].build_coordinated_cluster,
        HeartbeatSender=mods["cluster.membership"].HeartbeatSender,
        MembershipTracker=mods["cluster.membership"].MembershipTracker,
        ShardLeaseManager=mods["cluster.shards"].ShardLeaseManager,
        CellConfig=mods["configs.paxoslease_cell"].CellConfig,
        MASTER_CELL=mods["configs.paxoslease_cell"].MASTER_CELL,
        SimEnv=mods["sim.env"].SimEnv,
        NetConfig=mods["sim.network"].NetConfig,
    )


REF, PORT = _ns("repro"), _ns("repro_torch")


def _cfg(ns, **kw):
    return ns.CellConfig(n_acceptors=3, max_lease_time=30.0, **kw)


def _net(ns, delay_max=0.05, **kw):
    return ns.NetConfig(delay_min=0.005, delay_max=delay_max, **kw)


def _coord_view(coord):
    return dict(gained=list(coord.events.gained), lost=list(coord.events.lost),
                failover=coord.failover_times(), master=coord.master())


def master_election_and_failover(ns):
    cfg = _cfg(ns, lease_timespan=6.0, backoff_min=0.1, backoff_max=0.5)
    cell, coord = ns.build_coordinated_cluster(cfg, n_workers=0, seed=1,
                                               net=_net(ns))
    gained = []
    for n in cell.proposers:
        coord.campaign(n, on_gain=lambda i=n.node_id: gained.append(i))
    cell.env.run_until(5.0)
    first = coord.master()
    cell.nodes[first].crash()
    t_crash = cell.env.now
    cell.env.run_until(t_crash + cfg.lease_timespan + 3.0)
    cell.monitor.assert_clean()
    return dict(_coord_view(coord), first=first, callbacks=gained)


def abdication_hands_over_quickly(ns):
    cfg = _cfg(ns, lease_timespan=6.0, backoff_min=0.1, backoff_max=0.5)
    cell, coord = ns.build_coordinated_cluster(cfg, n_workers=0, seed=2,
                                               net=_net(ns))
    for n in cell.proposers:
        coord.campaign(n)
    cell.env.run_until(5.0)
    first = coord.master()
    coord.abdicate(cell.nodes[first])
    cell.env.run_until(cell.env.now + 3.0)
    return dict(_coord_view(coord), first=first)


def shard_straggler_reassignment(ns):
    cfg = _cfg(ns, lease_timespan=6.0, backoff_min=0.1, backoff_max=0.5)
    cell, coord = ns.build_coordinated_cluster(cfg, n_workers=3, seed=3,
                                               net=_net(ns))
    mgr = ns.ShardLeaseManager(cell, n_shards=6, shard_timespan=4.0,
                               scan_period=0.5)
    workers = [mgr.add_worker(cell.proposers[3 + i], target=2) for i in range(3)]
    cell.env.run_until(20.0)
    before = dict(coverage=mgr.coverage(), owners=mgr.owner_map(),
                  victim_owned=sorted(workers[0].owned))
    mgr.stall(workers[0].node.node_id)
    for w in workers[1:]:
        w.target = 3
    cell.env.run_until(45.0)
    cell.monitor.assert_clean()
    return dict(_coord_view(coord), before=before, coverage=mgr.coverage(),
                owners=mgr.owner_map(), victim=workers[0].node.node_id,
                owned=[sorted(w.owned) for w in workers])


def elastic_scale_down_via_release(ns):
    cfg = _cfg(ns, lease_timespan=6.0, backoff_min=0.1, backoff_max=0.5)
    cell, coord = ns.build_coordinated_cluster(cfg, n_workers=2, seed=4,
                                               net=_net(ns))
    mgr = ns.ShardLeaseManager(cell, n_shards=4, shard_timespan=5.0,
                               scan_period=0.5)
    w0 = mgr.add_worker(cell.proposers[3], target=4)
    cell.env.run_until(15.0)
    owned_mid = sorted(w0.owned)
    w1 = mgr.add_worker(cell.proposers[4], target=4)
    mgr.drain(w0.node.node_id)
    cell.env.run_until(30.0)
    cell.monitor.assert_clean()
    return dict(_coord_view(coord), owned_mid=owned_mid,
                owned=[sorted(w0.owned), sorted(w1.owned)],
                owners=mgr.owner_map())


def membership_tracker_suspects_silent_worker(ns):
    env = ns.SimEnv(seed=0, net=_net(ns))
    tracker = ns.MembershipTracker(env, "ctl", suspect_after=3.0)
    env.add_node("ctl", lambda m, s: tracker.on_heartbeat(m))
    env.add_node("w1", lambda m, s: None)
    env.add_node("w2", lambda m, s: None)
    ns.HeartbeatSender(env, "w1", 1, ["ctl"], period=1.0)
    hb2 = ns.HeartbeatSender(env, "w2", 2, ["ctl"], period=1.0)
    env.run_until(5.0)
    early = (tracker.live_workers(), tracker.suspected())
    hb2.stop()
    env.run_until(10.0)
    return dict(early=early, live=tracker.live_workers(),
                suspected=tracker.suspected(),
                last_seen=dict(tracker.last_seen))


def _settle(cell, cond, t_max):
    while cell.env.now < t_max and not cond():
        cell.env.run_until(cell.env.now + 1.0)


def autoscale_rebalances_on_join_and_silence(ns):
    cfg = _cfg(ns, lease_timespan=4.0, backoff_min=0.1, backoff_max=0.4)
    cell, coord = ns.build_coordinated_cluster(
        cfg, n_workers=3, seed=5, net=_net(ns, delay_max=0.03))
    master_node = cell.nodes[0]
    coord.campaign(master_node)
    mgr = ns.ShardLeaseManager(cell, n_shards=6, shard_timespan=3.0,
                               scan_period=0.4)
    tracker = ns.MembershipTracker(cell.env, master_node.addr, suspect_after=4.0)
    hb = master_node.addr + ":hb"
    cell.env.network._handlers[hb] = lambda m, s: tracker.on_heartbeat(m)
    workers, senders = [], []
    for i in range(2):
        node = cell.proposers[3 + i]
        workers.append(mgr.add_worker(node, target=0))
        senders.append(ns.HeartbeatSender(cell.env, node.addr, node.node_id,
                                          [hb], period=1.0))
    ctl = ns.AutoscaleController(cell, mgr, tracker, master_node=master_node,
                                 period=1.0)
    marks = []
    _settle(cell, lambda: mgr.coverage() == 1.0, 30.0)
    marks.append((cell.env.now, mgr.coverage(), [w.target for w in workers]))
    node3 = cell.proposers[5]
    w3 = mgr.add_worker(node3, target=0)
    senders.append(ns.HeartbeatSender(cell.env, node3.addr, node3.node_id,
                                      [hb], period=1.0))
    _settle(cell, lambda: len(w3.owned) >= 1 and mgr.coverage() == 1.0,
            cell.env.now + 40.0)
    marks.append((cell.env.now, mgr.coverage(),
                  [w.target for w in (*workers, w3)], sorted(w3.owned)))
    senders[0].stop()
    mgr.stall(workers[0].node.node_id)
    _settle(cell, lambda: mgr.coverage() == 1.0 and not workers[0].owned,
            cell.env.now + 60.0)
    cell.monitor.assert_clean()
    return dict(_coord_view(coord), marks=marks, decisions=ctl.decisions,
                coverage=mgr.coverage(), w0_target=workers[0].target,
                w0_owned=sorted(workers[0].owned),
                live=tracker.live_workers(), suspected=tracker.suspected())


def _check_master_election(r):
    assert r["first"] is not None and r["callbacks"][0] == r["first"]
    assert r["master"] is not None and r["master"] != r["first"]
    assert r["failover"], "failover gap should be recorded"


def _check_abdication(r):
    assert r["master"] is not None and r["master"] != r["first"]


def _check_straggler(r):
    assert r["before"]["coverage"] == 1.0 and r["before"]["victim_owned"]
    assert not r["owned"][0] or r["coverage"] == 1.0
    for k in r["before"]["victim_owned"]:
        assert r["owners"].get(k) not in (None, r["victim"])


def _check_scale_down(r):
    assert len(r["owned_mid"]) == 4
    assert r["owned"][0] == [] and len(r["owned"][1]) == 4


def _check_membership(r):
    assert r["early"] == ([1, 2], [])
    assert r["live"] == [1] and r["suspected"] == [2]


def _check_autoscale(r):
    assert r["marks"][0][1] == 1.0 and r["marks"][0][2] == [3, 3]
    assert r["marks"][1][1] == 1.0 and r["marks"][1][2] == [2, 2, 2]
    assert r["marks"][1][3]
    assert r["w0_target"] == 0 and r["coverage"] == 1.0 and not r["w0_owned"]
    assert r["decisions"]


SCENARIOS = {
    "master_election_and_failover": (master_election_and_failover,
                                     _check_master_election),
    "abdication_hands_over_quickly": (abdication_hands_over_quickly,
                                      _check_abdication),
    "shard_straggler_reassignment": (shard_straggler_reassignment,
                                     _check_straggler),
    "elastic_scale_down_via_release": (elastic_scale_down_via_release,
                                       _check_scale_down),
    "membership_tracker_suspects_silent_worker": (
        membership_tracker_suspects_silent_worker, _check_membership),
    "autoscale_rebalances_on_join_and_silence": (
        autoscale_rebalances_on_join_and_silence, _check_autoscale),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_reference(name):
    run, check = SCENARIOS[name]
    got = run(PORT)
    assert got == run(REF)
    check(got)


def failover_gaps(ns, seeds):
    """``benchmarks/bench_failover.py``'s loop: the master crashes at
    5 + seed % 7 and the run goes on for 4 T; every gap and master."""
    cfg = ns.MASTER_CELL
    net = ns.NetConfig(delay_min=0.005, delay_max=0.03, loss=0.02)
    gaps, masters = [], []
    for seed in seeds:
        cell, coord = ns.build_coordinated_cluster(cfg, n_workers=0, seed=seed,
                                                   net=net)
        for n in cell.proposers:
            coord.campaign(n)
        cell.env.run_until(5.0)
        if coord.master() is None:
            masters.append(None)
            continue
        t_crash = 5.0 + (seed % 7)
        cell.env.run_until(t_crash)
        masters.append(coord.master())
        if coord.master() is not None:
            cell.nodes[coord.master()].crash()
        cell.env.run_until(t_crash + 4 * cfg.lease_timespan)
        cell.monitor.assert_clean()
        gaps.extend(coord.failover_times())
    return gaps, masters


def test_bench_failover_loop_equals_reference():
    got = failover_gaps(PORT, range(5))
    assert got == failover_gaps(REF, range(5))
    gaps = np.array(got[0])
    assert len(gaps) >= 5 and np.all(gaps > 0)
    # the bench's bound: the remaining T plus a backoff and round trips
    assert np.median(gaps) <= PORT.MASTER_CELL.lease_timespan + 3.0


def test_names_match_the_reference():
    ref, port = (importlib.import_module(f"{p}.cluster.coordinator")
                 for p in ("repro", "repro_torch"))
    assert (port.MASTER_RESOURCE, port.CKPT_RESOURCE) == (
        ref.MASTER_RESOURCE, ref.CKPT_RESOURCE)
    ref, port = (importlib.import_module(f"{p}.cluster")
                 for p in ("repro", "repro_torch"))
    assert set(ref.__all__) <= set(port.__all__)
