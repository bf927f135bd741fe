"""LeaseArrayEngine.sweep of the port against the reference's, and its
contract: a stacked batch of scenarios in one dispatch, each replayed from
the engine's current state, the engine left as it is.

The port runs ``device="cpu"`` here (the plain ``"torch"`` backend: the
window loop scenario by scenario); the reference runs as
``tests/test_sweep.py`` runs it. Owners, counts, max owner counts and final
owners are bit-exact; ``owned_frac`` is held within one float32 ulp. The
batched CUDA kernels are held against the same plain path on the card by
``tests/test_torch_sweep_kernel.py`` and ``chip_smoke.py`` phase 19.
"""
import numpy as np
import pytest
import torch

from repro.lease_array import LeaseArrayEngine as RefEngine
from repro.lease_array import Scenario as RefScenario
from repro.lease_array import random_trace as ref_random_trace
from repro.lease_array.engine import _scenario_scanner as ref_scanner
from repro_torch.lease_array import (
    LeaseArrayEngine,
    Scenario,
    engine_to_arrays,
    random_trace,
)
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.engine import _scenario_scanner
from repro_torch.lease_array.state import MAX_RESTARTS
from repro_torch.lease_array.scenario import (
    CORRUPTION_PLANES,
    EXTEND_PLANES,
    RESTART_PLANES,
    plane_digest,
)

GEOM = dict(n_cells=8, n_acceptors=3, n_proposers=4)


def _traces(n, n_ticks=12, delayed=False, seed0=100, rt=random_trace):
    return [
        rt(seed0 + s, n_ticks=n_ticks, lease_ticks=2, p_attempt=0.5,
           p_release=0.08, p_down_flip=0.05,
           max_delay_ticks=1 if delayed else 0,
           p_drop=0.1 if delayed else 0.0, round_ticks=2, **GEOM)
        for s in range(n)
    ]


def _engine(**kw):
    return LeaseArrayEngine(lease_ticks=2, round_ticks=2, device="cpu",
                            **GEOM, **kw)


def _ref_engine(**kw):
    return RefEngine(lease_ticks=2, round_ticks=2, **GEOM, **kw)


def _chaos(n, seed0=500, n_ticks=40):
    """Restart, drift, delay, drop and renewal scenarios (the reference's
    chaos mixes) on the sweep geometry."""
    return [
        random_trace(seed0 + s, n_ticks=n_ticks, lease_ticks=6,
                     p_attempt=0.15, p_release=0.04, max_delay_ticks=1,
                     p_drop=0.05, drift_eps=0.25, restarts=0.02, renew=0.5,
                     asymmetric=bool(s % 2), round_ticks=5, **GEOM)
        for s in range(n)
    ]


def _assert_results_equal(ref, port):
    for field in port._fields:
        got, want = getattr(port, field), getattr(ref, field)
        if want is None:
            assert got is None, field
            continue
        assert isinstance(got, torch.Tensor), field
        if field == "owned_frac":
            assert got.dtype == torch.float32
            np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 1)
        else:
            assert got.dtype == torch.int32, field
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=field)


@pytest.mark.parametrize("collect", ["summary", "owners"])
@pytest.mark.parametrize("delayed", [False, True])
def test_sweep_matches_reference(delayed, collect):
    """Every field of the port's SweepResult equals the reference's, from
    a fresh engine and from one that has run a trace first."""
    netplane = delayed or None
    port = [t.scenario() for t in _traces(6, delayed=delayed)]
    ref = [t.scenario() for t in _traces(6, delayed=delayed,
                                         rt=ref_random_trace)]
    for warm in (None, 7):
        peng, reng = _engine(), _ref_engine()
        if warm is not None:
            peng.run_trace(_traces(1, n_ticks=warm, delayed=True, seed0=9)[0]
                           .scenario())
            reng.run_trace(_traces(1, n_ticks=warm, delayed=True, seed0=9,
                                   rt=ref_random_trace)[0].scenario())
        want = reng.sweep(ref, collect=collect, netplane=netplane)
        got = peng.sweep(port, collect=collect, netplane=netplane)
        _assert_results_equal(want, got)
        assert got.max_owner_count.shape == (6,)
        assert got.final_owners.shape == (6, GEOM["n_cells"])
        if collect == "owners":
            assert got.owners.shape == (6, 12, GEOM["n_cells"])


@pytest.mark.parametrize("collect", ["summary", "owners"])
def test_chaos_sweep_matches_reference(collect):
    """Restarts, drift, asymmetric delay, drops and renewals (the delayed
    kernel's restart and extend variants), from an engine that already
    carries restart history."""
    scs = [t.scenario() for t in _chaos(5)]
    # the batch restarts some proposer more often than the 2-bit carve
    # holds, but no scenario does: the budget charges the worst scenario
    prst = np.stack([sc.planes["prop_restart"] for sc in scs])
    assert prst.sum(axis=(0, 1)).max() > MAX_RESTARTS
    assert prst.sum(axis=1).max() <= MAX_RESTARTS - 1
    peng, reng = _engine(), _ref_engine()
    warm = _chaos(1, seed0=77, n_ticks=9)[0].scenario()
    peng.run_trace(warm)
    reng.run_trace(RefScenario(dict(warm.planes)))
    assert peng._restart_active and reng._restart_active
    want = reng.sweep(RefScenario.stack([RefScenario(dict(s.planes))
                                         for s in scs]), collect=collect)
    got = peng.sweep(Scenario.stack(scs), collect=collect)
    _assert_results_equal(want, got)


@pytest.mark.parametrize("delayed", [False, True])
def test_sweep_matches_solo_replays(delayed):
    """collect="owners": every scenario in the batch equals its own
    run_trace replay bit-for-bit."""
    traces = _traces(6, delayed=delayed)
    res = _engine().sweep([t.scenario() for t in traces], collect="owners",
                          netplane=delayed or None)
    assert (res.max_owner_count <= 1).all()
    for b, tr in enumerate(traces):
        ow, cn = _engine().run_trace(tr.scenario(), netplane=delayed or None)
        assert torch.equal(res.owners[b], ow)
        assert torch.equal(res.counts[b], cn)
        assert torch.equal(res.final_owners[b], ow[-1])


def test_sweep_is_read_only_and_continues_from_the_engine():
    """A sweep leaves state, net, tick, clocks and restart history as they
    were, and starts from them: each scenario equals run_trace on a twin
    that replayed the same warm-up."""
    warm = _chaos(1, seed0=31, n_ticks=9)[0].scenario()
    eng = _engine()
    eng.run_trace(warm)
    before = engine_to_arrays(eng)
    flags = (eng.t, eng._netplane_active, eng._restart_active)
    scs = [t.scenario() for t in _chaos(3, seed0=300)]
    res = eng.sweep(scs, collect="owners")
    after = engine_to_arrays(eng)
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert (eng.t, eng._netplane_active, eng._restart_active) == flags
    for b, sc in enumerate(scs):
        twin = _engine()
        twin.run_trace(warm)
        ow, cn = twin.run_trace(sc)
        assert torch.equal(res.owners[b], ow) and torch.equal(res.counts[b], cn)
    # a zero-delay sweep leaves a sync engine on the sync model
    fresh = _engine()
    fresh.sweep([t.scenario() for t in _traces(2, delayed=True)])
    assert not fresh._netplane_active and fresh.t == 0


def test_sweep_1024_scenarios_single_dispatch():
    """The reference's acceptance batch: 1024 scenarios in ONE dispatch
    of the batched plain window loop, summary reductions only."""
    stacked = Scenario.stack([t.scenario() for t in _traces(1024, n_ticks=8)])
    K.reset_launches()
    res = _engine().sweep(stacked)
    assert K.lease_window_sync_batched_torch.launches == 1
    assert K.lease_window_delayed_batched_torch.launches == 0
    assert res.max_owner_count.shape == (1024,)
    assert (res.max_owner_count <= 1).all()
    assert res.final_owners.shape == (1024, GEOM["n_cells"])
    assert res.owners is None and res.counts is None
    assert float(res.owned_frac.mean()) > 0.1, "sweeps actually lease"


def test_sweep_rejects_bad_input():
    eng = _engine()
    scs = [t.scenario() for t in _traces(2)]
    with pytest.raises(ValueError, match="at least one scenario"):
        eng.sweep([])
    with pytest.raises(ValueError, match="collect"):
        eng.sweep(scs, collect="everything")
    # margins mode is ported (tests/test_torch_margins.py holds it)
    margins = eng.sweep(scs, collect="margins").margins
    assert [v.shape for v in margins.values()] == [(2,)] * 5
    with pytest.raises(ValueError, match="at least one tick"):
        eng.sweep([sc[:0] for sc in scs])
    with pytest.raises(ValueError, match="netplane=False"):
        eng.sweep([t.scenario() for t in _traces(2, delayed=True)],
                  netplane=False)
    with pytest.raises(ValueError, match="engine geometry"):
        LeaseArrayEngine(9, n_acceptors=3, n_proposers=4,
                         device="cpu").sweep(scs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        eng.sweep(scs, backend="cuda")
    with pytest.raises(ValueError, match="cannot stack"):
        eng.sweep([scs[0], _traces(1, n_ticks=9)[0].scenario()])


def test_sweep_pack_budget_refusal_matches_reference():
    msgs = []
    for eng, scs in ((_engine(), [t.scenario() for t in _traces(2)]),
                     (_ref_engine(), [t.scenario() for t in
                                      _traces(2, rt=ref_random_trace)])):
        eng.t = 8185  # 12 ticks run past 8190, the last that fits at P = 4
        with pytest.raises(ValueError, match="exceeds the packed int32") as e:
            eng.sweep(scs)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _m_wait(rival: int):
    """Proposer 0 acquires everywhere; every acceptor crash-restarts at
    tick 2; proposer ``rival`` attacks at tick 3 (no attack for -1)."""
    T, N, A, P = 10, 8, 3, 4
    att = np.full((T, N), -1, np.int32)
    att[0, :] = 0
    att[3, :] = rival
    rst = np.zeros((T, A), np.int32)
    rst[2, :] = 1
    return Scenario.build(T, n_cells=N, n_acceptors=A, n_proposers=P,
                          attempts=att, acc_restart=rst)


def test_verify_names_each_offender_by_digest_and_tag():
    """With the deaf window off (the §4 negative control) the attacked
    scenarios break §4; verify names exactly those by digest and tag."""
    scs = [_m_wait(1), _m_wait(-1), _m_wait(2)]
    eng = LeaseArrayEngine(8, n_acceptors=3, n_proposers=4, lease_ticks=4,
                           restart_guard=False, device="cpu")
    with pytest.raises(AssertionError, match="2 scenario") as e:
        eng.sweep(scs, tags=["a", "b", "c"])
    msg = str(e.value)
    for i, tag in ((0, "a"), (2, "c")):
        assert f"#{i} digest={plane_digest(scs[i].planes)} tag={tag}" in msg
    assert "#1 " not in msg
    res = eng.sweep(scs, verify=False)
    assert res.max_owner_count.tolist() == [2, 1, 2]
    guarded = LeaseArrayEngine(8, n_acceptors=3, n_proposers=4,
                               lease_ticks=4, device="cpu")
    assert (guarded.sweep(scs).max_owner_count <= 1).all()


def test_all_default_optional_planes_are_stripped(monkeypatch):
    """All-default corruption, restart and extends planes give the same
    sweep as scenarios without them, and never reach the window loop."""
    scs = [t.scenario() for t in _traces(3, delayed=True)]
    optional = CORRUPTION_PLANES + RESTART_PLANES + EXTEND_PLANES
    bare = Scenario({
        k: np.stack([sc.planes[k] for sc in scs])
        for k in scs[0].planes if k not in optional
    })
    seen = []
    plain = K.lease_window_delayed_batched_torch

    def spy(*args, **kw):
        seen.append({k for k, v in kw.items() if v is not None})
        return plain(*args, **kw)

    monkeypatch.setattr(
        "repro_torch.lease_array.ops.lease_window_delayed_batched_torch", spy)
    full = _engine().sweep(scs, collect="owners")
    stripped = _engine().sweep(bare, collect="owners")
    for f in full._fields:  # margins is None in owners mode
        a, b = getattr(full, f), getattr(stripped, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert len(seen) == 2 and seen[0] == seen[1]
    assert not seen[0] & set(K.DELAYED_OPTIONAL)


@pytest.mark.parametrize("delayed", [False, True])
def test_scenario_scanner_equals_run_trace_and_reference(delayed):
    """The per-tick scanner gives run_trace's fused answer and the
    reference scanner's, from a drifted start clock."""
    tr = random_trace(8, n_ticks=30, lease_ticks=3,
                      max_delay_ticks=2 if delayed else 0,
                      p_drop=0.05 if delayed else 0.0,
                      drift_eps=0.25 if delayed else 0.0, **GEOM)
    sc = tr.scenario()
    eng = _engine()
    kw = dict(majority=eng.majority, lease_q4=eng.lease_q4,
              round_q4=eng.round_q4, guard_q4=eng.guard_q4, backend="torch",
              sync=not delayed)
    clk0 = (np.array([4, 5, 3, 4], np.int32), np.array([5, 4, 3], np.int32))
    state, net, ow, cn = _scenario_scanner(**kw)(
        eng.state, eng.net, 1, clk0, sc.planes)
    eng.prop_clk, eng.acc_clk, eng.t = clk0[0], clk0[1], 1
    fused = _engine()
    fused.prop_clk, fused.acc_clk, fused.t = clk0[0], clk0[1], 1
    fow, fcn = fused.run_trace(sc, netplane=delayed or None)
    assert torch.equal(ow, fow) and torch.equal(cn, fcn)
    for a, b in zip((*state, *net), (*fused.state, *fused.net)):
        assert torch.equal(a, b)
    ref = ref_scanner(**{**kw, "backend": "jnp"})
    reng = _ref_engine()
    _, _, row, rcn = ref(reng.state, reng.net, 1, clk0,
                         {k: np.asarray(v) for k, v in sc.planes.items()})
    np.testing.assert_array_equal(np.asarray(row), ow.numpy())
    np.testing.assert_array_equal(np.asarray(rcn), cn.numpy())


def test_scenario_scanner_refuses_restarts():
    sc = _chaos(1, n_ticks=30)[0].scenario()
    assert sc.restarted
    eng = _engine()
    scan = _scenario_scanner(majority=2, lease_q4=25, round_q4=20,
                             backend="torch", sync=False)
    with pytest.raises(ValueError, match="restart history"):
        scan(eng.state, eng.net, 0, None, sc.planes)
