"""The port's shard directory (``repro_torch.lease_array.directory``) and
shard manager (``repro_torch.cluster.shards``) against the reference's.

The reference's own directory tests run on the port (``device="cpu"``:
every tick one ``engine.step`` through the plain tick), and the port's
owner rows must equal ``repro``'s ``LeaseArrayDirectory``'s tick for tick
through warm-up, a stall, retargets and a drain, at delay 0 and 2; the
bench's failover handoff (1024 shards, 8 workers, delay <= 2) must hand a
stalled worker's shards over in the reference's 31 ticks. The card runs
the same directory in ``tests/test_torch_falsify_cuda.py`` and
``chip_smoke.py`` phase 21.
"""
import numpy as np
import pytest

from repro.lease_array.directory import LeaseArrayDirectory as RefDirectory
from repro_torch.cluster import ShardLeaseManager, build_shard_manager
from repro_torch.configs.paxoslease_cell import CellConfig
from repro_torch.core import build_cell
from repro_torch.lease_array import LeaseArrayDirectory
from repro_torch.sim.network import NetConfig


def _directory(n_shards, **kw):
    return LeaseArrayDirectory(n_shards, device="cpu", **kw)


def test_directory_coverage_failover_drain_retarget():
    d = _directory(512, n_acceptors=3, lease_ticks=4, max_workers=8)
    for i in range(4):
        d.add_worker(i, 128)
    d.tick(3)
    assert d.coverage() == 1.0
    assert all(d.owned_count(i) == 128 for i in range(4))

    d.stall(0)  # straggler: stops renewing, says nothing
    d.tick(d.engine.lease_ticks + 2)
    assert d.owned_count(0) == 0
    for i in range(1, 4):
        d.set_target(i, 512 // 3 + 1)
    d.tick(3)
    assert d.coverage() == 1.0

    d.drain(1)  # graceful §7 release -> redistributed, not expired
    for i in (2, 3):
        d.set_target(i, 256)
    d.tick(4)
    assert d.owned_count(1) == 0
    assert d.coverage() == 1.0
    m = d.owner_map()
    assert len(m) == 512 and set(m.values()) <= {2, 3}


def test_build_shard_manager_backend_dispatch():
    d = build_shard_manager(4096, max_workers=4, device="cpu")
    assert isinstance(d, LeaseArrayDirectory)
    cfg = CellConfig(n_acceptors=3, max_lease_time=30.0, lease_timespan=5.0)
    d = build_shard_manager(2048, cfg=cfg, max_workers=4, device="cpu")
    assert isinstance(d, LeaseArrayDirectory)
    assert d.engine.n_acceptors == 3  # inherited from the cell config
    assert d.engine.lease_ticks == 5  # the timespan over the scan period
    cell = build_cell(cfg, seed=0, net=NetConfig(delay_min=0.001, delay_max=0.002))
    m = build_shard_manager(64, cell=cell)
    assert isinstance(m, ShardLeaseManager)
    with pytest.raises(ValueError):
        build_shard_manager(64, backend="event")  # event path needs a Cell
    with pytest.raises(ValueError, match="unknown shard-lease backend"):
        build_shard_manager(64, backend="jnp")


def test_event_shard_manager_reassigns_a_stragglers_shards():
    """The event-driven manager (the reference's ``test_cluster.py``
    straggler case) on the port's core: every shard owned, a stalled
    worker's shards taken over by the others, §4 clean."""
    cfg = CellConfig(n_acceptors=3, max_lease_time=30.0, lease_timespan=6.0,
                     backoff_min=0.1, backoff_max=0.5)
    cell = build_cell(cfg, n_proposers=6, seed=3,
                      net=NetConfig(delay_min=0.005, delay_max=0.05))
    mgr = build_shard_manager(6, cell=cell, shard_timespan=4.0,
                              scan_period=0.5)
    assert isinstance(mgr, ShardLeaseManager)
    workers = [mgr.add_worker(cell.proposers[3 + i], target=2) for i in range(3)]
    cell.env.run_until(20.0)
    assert mgr.coverage() == 1.0, f"all shards owned, got {mgr.owner_map()}"
    victim = workers[0]
    owned_before = set(victim.owned)
    assert owned_before
    mgr.stall(victim.node.node_id)
    for w in workers[1:]:
        w.target = 3
    cell.env.run_until(45.0)
    omap = mgr.owner_map()
    for k in owned_before:
        assert omap.get(k) is not None and omap[k] != victim.node.node_id
    cell.monitor.assert_clean()


def _healthy(directory, max_delay_ticks, lease_ticks=12, **kw):
    d = directory(128, n_acceptors=3, lease_ticks=lease_ticks, max_workers=4,
                  max_delay_ticks=max_delay_ticks, **kw)
    for i in range(4):
        d.add_worker(i, 32)
    return d


@pytest.mark.parametrize("max_delay_ticks,lease_ticks",
                         [(0, 12), (2, 12), (4, 24)])
def test_directory_sustains_renewals_under_link_delay(max_delay_ticks,
                                                      lease_ticks):
    """With the full-round renew margin, round-trip pacing and a round
    deadline sized to the links, >= 95 % of the shards stay owned through
    many lease generations."""
    d = _healthy(_directory, max_delay_ticks, lease_ticks)
    d.tick(8 * max_delay_ticks + 10)
    assert d.coverage() == 1.0
    fracs = []
    for _ in range(6 * d.engine.lease_ticks):
        d.tick(1)
        fracs.append(d.coverage())
    assert min(fracs) >= 0.95, f"renewal collapse: min owned_frac {min(fracs)}"


def test_directory_delay_blind_margin_and_redrive_collapse():
    """Negative control: re-driving every cell every tick overwrites the
    open extend rounds (netplane phase 3) and collapses coverage."""
    d = _healthy(_directory, 4, 24)
    d.tick(50)
    assert d.coverage() == 1.0
    d._round_trip = 1
    d._cooldown[:] = 0
    d.tick(6 * d.engine.lease_ticks)
    assert d.coverage() <= 0.5, "per-tick re-drive should livelock renewals"


def test_directory_rejects_unservable_renewal_geometry():
    with pytest.raises(ValueError, match="cannot be renewed"):
        _directory(8, n_acceptors=3, lease_ticks=2, max_delay_ticks=2)
    # the half-trip fallacy: 2·4+1 = 9 < 12, but a full extend round is 17
    with pytest.raises(ValueError, match="cannot be renewed"):
        _directory(8, n_acceptors=3, lease_ticks=12, max_delay_ticks=4)
    with pytest.raises(ValueError, match="below the worst-case"):
        _directory(8, n_acceptors=3, lease_ticks=24, max_delay_ticks=4,
                   renew_margin=12)


def _script(d, ticks: list):
    """Warm up, stall worker 0, retarget, drain worker 1; the owner row of
    every tick."""
    def run(n):
        for _ in range(n):
            ticks.append(np.array(d.tick(1)))

    for i in range(4):
        d.add_worker(i, 32)
    run(20)
    d.stall(0)
    for i in range(1, 4):
        d.set_target(i, 43)
    run(d.engine.lease_ticks + 6)
    d.drain(1)
    for i in (2, 3):
        d.set_target(i, 64)
    run(12)
    d.unstall(0)
    d.set_target(0, 16)
    run(10)


@pytest.mark.parametrize("max_delay_ticks,lease_ticks", [(0, 6), (2, 12)])
def test_directory_owners_match_reference_tick_for_tick(max_delay_ticks,
                                                        lease_ticks):
    rows, ref_rows = [], []
    kw = dict(n_acceptors=3, lease_ticks=lease_ticks, max_workers=4,
              max_delay_ticks=max_delay_ticks)
    d = _directory(128, **kw)
    _script(d, rows)
    _script(RefDirectory(128, **kw), ref_rows)
    assert len(rows) == len(ref_rows)
    for t, (got, want) in enumerate(zip(rows, ref_rows)):
        np.testing.assert_array_equal(got, want, err_msg=f"tick {t}")
    assert d.coverage() >= 0.95 and d.owned_count(1) == 0


def _handoff(d):
    """The bench's failover handoff: 40 warm-up ticks, stall worker 0,
    retarget the other 7, tick until worker 0 owns nothing and coverage is
    back to >= 0.95. Returns (handoff ticks, owner rows)."""
    for i in range(8):
        d.add_worker(i, 128)
    rows = [np.array(d.tick(1)) for _ in range(40)]
    assert d.coverage() == 1.0
    d.stall(0)
    for i in range(1, 8):
        d.set_target(i, 1024 // 7 + 1)
    ticks = 0
    while (d.owned_count(0) > 0 or d.coverage() < 0.95) and ticks < 400:
        rows.append(np.array(d.tick(1)))
        ticks += 1
    return ticks, np.stack(rows)


def test_failover_handoff_matches_reference():
    kw = dict(n_acceptors=5, lease_ticks=24, max_workers=8, max_delay_ticks=2)
    ticks, rows = _handoff(_directory(1024, **kw))
    ref_ticks, ref_rows = _handoff(RefDirectory(1024, **kw))
    assert ticks == ref_ticks == 31  # BENCH_lease_array.json's handoff
    np.testing.assert_array_equal(rows, ref_rows)
