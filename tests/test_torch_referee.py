"""The port's differential referee: the event-driven engine (``core/``,
``sim/``) replaying a trace with pinned message timing, against the
reference's and against the port's own vectorized plane.

All comparisons are bit-exact int32 owners [T, N]. The port's
``replay_event_sim`` is held once against ``repro``'s on crash, drift,
delay, drop and renewal traces; from there on the port's event sim is the
referee for its own ``replay_array`` (``device="cpu"``, the plain
``"torch"`` backend here; ``chip_smoke.py`` phase 18 does the same with
``backend="cuda"`` on the card).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.lease_array import replay_event_sim as ref_replay_event_sim
from repro.lease_array.trace import trace_from_scenario as ref_trace_from_scenario
from repro.lease_array.trace import Trace as RefTrace
from repro_torch.lease_array import (
    Scenario,
    random_trace,
    replay_array,
    replay_event_sim,
    trace_from_scenario,
)
from repro_torch.lease_array.state import MAX_RESTARTS
from repro_torch.lease_array.trace import Trace

#: the fault mixes of the reference's differential suites
#: (tests/test_lease_array_{differential,restart,drift,extend}.py), at their
#: geometries: name -> (seed, random_trace options)
MIXES = {
    "zero-delay": (1234, dict(n_cells=16, n_acceptors=5, n_proposers=4,
                              lease_ticks=3, p_attempt=0.35, p_release=0.06,
                              p_down_flip=0.02)),
    "crash-drift-delay-drop": (42, dict(max_delay_ticks=2, p_drop=0.05,
                                        drift_eps=0.25, asymmetric=True,
                                        restarts=0.02)),
    "drift": (4242, dict(n_cells=8, n_acceptors=5, n_proposers=4,
                         lease_ticks=8, p_attempt=0.8, p_release=0.06,
                         p_down_flip=0.03, max_delay_ticks=1, p_drop=0.08,
                         drift_eps=0.25, round_ticks=3)),
    "renew-chaos": (1234, dict(n_cells=8, n_acceptors=3, n_proposers=4,
                               lease_ticks=6, p_attempt=0.12, p_release=0.04,
                               renew=0.5, max_delay_ticks=1, p_drop=0.05,
                               drift_eps=0.25, round_ticks=5)),
}


def _trace(mix: str, n_ticks: int) -> Trace:
    seed, opts = MIXES[mix]
    return random_trace(seed, n_ticks=n_ticks, **opts)


def _ref_trace(tr: Trace) -> RefTrace:
    return RefTrace(**{f.name: getattr(tr, f.name)
                       for f in dataclasses.fields(Trace)})


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_event_sim_matches_reference(mix):
    """The copied event-driven engine gives the reference's owners."""
    tr = _trace(mix, 400)
    got = replay_event_sim(tr)
    assert got.dtype == np.int32 and got.shape == (400, tr.n_cells)
    np.testing.assert_array_equal(got, ref_replay_event_sim(_ref_trace(tr)))


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_thousand_tick_array_matches_event_sim(mix):
    """1000 ticks through the plain vectorized plane equal the port's
    event sim at every tick, with never two believers."""
    tr = _trace(mix, 1000)
    assert tr.delayed == (mix != "zero-delay")
    ow, cn = replay_array(tr, device="cpu")
    assert isinstance(ow, torch.Tensor) and ow.dtype == torch.int32
    assert int(cn.max()) <= 1
    owners = replay_event_sim(tr)
    np.testing.assert_array_equal(owners, ow.numpy())
    # the trace exercises the plane: ownership and vacancy both occur
    assert (owners >= 0).any() and (owners == -1).any()


def test_mix_properties():
    assert _trace("crash-drift-delay-drop", 200).restarted
    assert _trace("drift", 200).drifted
    assert _trace("renew-chaos", 200).extended


def _restart_scenario(acc_val=1, prop_hits=1):
    T, N, A, P = 12, 2, 3, 4
    att = np.full((T, N), -1, np.int32)
    att[0, :] = 0
    arst = np.zeros((T, A), np.int32)
    arst[4, 1] = acc_val
    prst = np.zeros((T, P), np.int32)
    prst[2:2 + prop_hits, 0] = 1
    return Scenario.build(T, n_cells=N, n_acceptors=A, n_proposers=P,
                          attempts=att, acc_restart=arst, prop_restart=prst)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_trace_from_scenario_matches_reference(mix):
    """A round trip through trace_from_scenario gives the reference's
    Trace field by field, and the converted trace replays referee ==
    array."""
    tr = _trace(mix, 60)
    kw = dict(lease_ticks=tr.lease_ticks, round_ticks=tr.round_ticks,
              drift_eps=tr.drift_eps)
    got = trace_from_scenario(tr.scenario(), **kw)
    want = ref_trace_from_scenario(_ref_trace(tr).scenario(), **kw)
    for f in dataclasses.fields(Trace):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if b is None or np.isscalar(b):
            assert a == b if b is not None else a is None, f.name
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
    ow, cn = replay_array(got, device="cpu")
    np.testing.assert_array_equal(replay_event_sim(got), ow.numpy())


def test_trace_from_scenario_refusals_match_reference():
    from repro.lease_array import Scenario as RefScenario

    cases = [
        (_restart_scenario(acc_val=2), "binary restart"),
        (_restart_scenario(prop_hits=MAX_RESTARTS + 1), "MAX_RESTARTS"),
    ]
    sc = random_trace(3, n_ticks=10, n_cells=4, n_acceptors=3).scenario()
    stale = np.zeros((10, 3), np.int32)
    stale[2, 1] = 1
    cases.append((Scenario({**sc.planes, "acc_stale": stale}), "corruption"))
    rate = np.full((10, 4), 4, np.int32)
    rate[5, 0] = 5
    cases.append((Scenario({**sc.planes, "prop_rate": rate}), "varies over"))
    for scenario, match in cases:
        msgs = []
        for fn, bundle in ((trace_from_scenario, scenario),
                           (ref_trace_from_scenario,
                            RefScenario(dict(scenario.planes)))):
            with pytest.raises(ValueError, match=match) as e:
                fn(bundle, lease_ticks=2)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_restart_scenario_converts_and_replays():
    sc = _restart_scenario()
    tr = trace_from_scenario(sc, lease_ticks=2, round_ticks=3)
    np.testing.assert_array_equal(tr.acc_restarts, sc.planes["acc_restart"])
    np.testing.assert_array_equal(tr.prop_restarts, sc.planes["prop_restart"])
    ow, cn = replay_array(tr, device="cpu")
    np.testing.assert_array_equal(replay_event_sim(tr), ow.numpy())
    assert int(cn.max()) <= 1


def _m_wait_trace() -> Trace:
    """Proposer 0 acquires everywhere; every acceptor crash-restarts
    mid-lease at tick 2; proposer 1 attacks at tick 3 while p0's belief is
    still live (the §3 M-wait showdown of the reference's restart suite)."""
    T, N, A, P = 10, 4, 5, 4
    att = np.full((T, N), -1, np.int32)
    att[0, :] = 0
    att[3, :] = 1
    rst = np.zeros((T, A), np.int32)
    rst[2, :] = 1
    return Trace(N, A, P, 4, att, np.full((T, N), -1, np.int32),
                 np.ones((T, A), bool), acc_restarts=rst)


def test_restart_guard_is_what_holds_section4():
    """Deaf window on: §4 holds and the referee agrees on every owner;
    off (the negative control): a second live lease, owner count 2."""
    tr = _m_wait_trace()
    ow, cn = replay_array(tr, device="cpu")
    assert int(cn.max()) <= 1
    np.testing.assert_array_equal(replay_event_sim(tr), ow.numpy())
    _, cn = replay_array(tr, device="cpu", restart_guard=False)
    assert int(cn.max()) == 2


def test_referee_rejects_unreplayable_rates():
    tr = random_trace(51, n_ticks=10, n_cells=4, drift_eps=0.25)
    tr.prop_rate = np.full(tr.n_proposers, 10, np.int32)
    with pytest.raises(ValueError, match="exact event-sim"):
        replay_event_sim(tr)


def test_replay_array_follows_the_engine_device_rule(monkeypatch):
    tr = random_trace(0, n_ticks=5, n_cells=4)
    with pytest.raises(ValueError, match="CUDA device"):
        replay_array(tr, device="cpu", backend="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay_array(tr)
