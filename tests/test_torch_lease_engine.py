"""LeaseArrayEngine of the PyTorch lease plane against the JAX reference.

``run_trace`` and ``step`` of ``repro_torch`` (``device="cpu"``, the plain
PyTorch backend) replay the same scenarios as ``repro``'s engine
(``backend="jnp"``): owners, counts, the final lease state, the in-flight
plane, the carried clocks and the restart history must be bit-exact. The
port's owners are also held against the port's own event-driven referee
(``repro_torch.lease_array.replay_event_sim``, itself held against the
reference's in ``tests/test_torch_referee.py``) on chaos traces, and a renewal
deployment must keep its cells owned. Without CUDA the default device
raises rather than moving to the CPU.
"""
import numpy as np
import pytest
import torch

from repro.lease_array import LeaseArrayEngine as JEngine
from repro.lease_array import random_trace
from repro.lease_array.trace import Trace as JTrace
from repro_torch.lease_array import LeaseArrayEngine, Scenario, TickInputs
from repro_torch.lease_array import random_trace as port_random_trace
from repro_torch.lease_array import replay_event_sim
from repro_torch.lease_array import state as tstate

#: name -> (seed, random_trace options)
CASES = {
    "zero-delay": (0, dict(n_cells=24, n_acceptors=5, n_proposers=4, lease_ticks=3)),
    "delay-asym-drop": (1, dict(n_cells=24, n_acceptors=5, n_proposers=4,
                                max_delay_ticks=2, p_drop=0.1, asymmetric=True)),
    "drift": (2, dict(n_cells=24, n_acceptors=3, n_proposers=3, lease_ticks=5,
                      max_delay_ticks=1, drift_eps=0.25)),
    "restart": (3, dict(n_cells=16, n_acceptors=3, n_proposers=4, lease_ticks=3,
                        max_delay_ticks=2, p_drop=0.05, restarts=0.03,
                        drift_eps=0.25, asymmetric=True)),
    "renew-chaos": (4, dict(n_cells=16, n_acceptors=3, n_proposers=4, lease_ticks=6,
                            p_attempt=0.12, p_release=0.04, renew=0.5,
                            max_delay_ticks=1, p_drop=0.05, drift_eps=0.25,
                            round_ticks=5)),
}
N_TICKS = 100


def _trace(case: str):
    seed, opts = CASES[case]
    return random_trace(seed, n_ticks=N_TICKS, **opts)


def _engines(trace, **kw):
    cfg = dict(n_acceptors=trace.n_acceptors, n_proposers=trace.n_proposers,
               lease_ticks=trace.lease_ticks, round_ticks=trace.round_ticks,
               drift_eps=trace.drift_eps, **kw)
    return (JEngine(trace.n_cells, backend="jnp", **cfg),
            LeaseArrayEngine(trace.n_cells, device="cpu", **cfg))


def _port_scenario(jsc) -> Scenario:
    return Scenario(dict(jsc.planes))


def _same(ref, port, what=""):
    assert isinstance(port, torch.Tensor) and port.dtype == torch.int32, what
    np.testing.assert_array_equal(np.asarray(ref), port.numpy(), err_msg=what)


def _assert_engines_equal(jeng, teng):
    for f in jeng.state._fields:
        _same(getattr(jeng.state, f), getattr(teng.state, f), f)
    for f in jeng.net._fields:
        _same(getattr(jeng.net, f), getattr(teng.net, f), f)
    _same(jeng.last_owner_count, teng.last_owner_count, "last_owner_count")
    _same(jeng.owners(), teng.owners(), "owners()")
    np.testing.assert_array_equal(jeng.ticks_left(), teng.ticks_left().numpy())
    assert jeng.t == teng.t
    for k in ("prop_clk", "acc_clk", "_rc", "_deaf_until"):
        np.testing.assert_array_equal(getattr(jeng, k), getattr(teng, k), err_msg=k)
        assert getattr(teng, k).dtype == np.int32, k
    assert jeng._netplane_active == teng._netplane_active
    assert jeng._restart_active == teng._restart_active


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_trace_matches_reference(case):
    tr = _trace(case)
    jeng, teng = _engines(tr)
    jsc = tr.scenario()
    jow, jcn = jeng.run_trace(jsc)
    tow, tcn = teng.run_trace(_port_scenario(jsc))
    _same(jow, tow, "owners")
    _same(jcn, tcn, "counts")
    assert int(tcn.max()) <= 1
    _assert_engines_equal(jeng, teng)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_and_run_trace_interleaved_match_reference(case):
    """A run_trace, then single steps, then a run_trace again: every owner
    row, count and the carried engine state agree with the reference."""
    tr = _trace(case)
    jeng, teng = _engines(tr)
    jsc = tr.scenario()
    _same(*[e.run_trace(s)[0] for e, s in ((jeng, jsc[:30]), (teng, _port_scenario(jsc[:30])))])
    for t in range(30, 38):
        jrow = jeng.step(jsc[t])
        trow = teng.step(TickInputs(dict(jsc[t].planes)))
        _same(jrow, trow, f"step {t}")
        _same(jeng.last_owner_count, teng.last_owner_count, f"count {t}")
    jow, jcn = jeng.run_trace(jsc[38:])
    tow, tcn = teng.run_trace(_port_scenario(jsc[38:]))
    _same(jow, tow, "owners")
    _same(jcn, tcn, "counts")
    _assert_engines_equal(jeng, teng)


def test_step_from_fresh_engine_on_sync_model():
    """Zero-delay ticks keep a fresh engine on the synchronous model."""
    tr = _trace("zero-delay")
    jeng, teng = _engines(tr)
    jsc = tr.scenario()
    for t in range(20):
        _same(jeng.step(jsc[t]), teng.step(TickInputs(dict(jsc[t].planes))))
    assert not teng._netplane_active
    _assert_engines_equal(jeng, teng)


def _renewal_trace(n_cells: int, n_ticks: int) -> JTrace:
    """Every cell acquired at t=0 by proposer n % 8 and extended every 64
    ticks over links of delay 4 (benchmarks/bench_lease_array.py's renewal
    storm at a small cell count)."""
    att = np.full((n_ticks, n_cells), -1, np.int32)
    ext = np.full((n_ticks, n_cells), -1, np.int32)
    cells = np.arange(n_cells, dtype=np.int32) % 8
    att[0] = cells
    ext[64::64] = cells
    return JTrace(
        n_cells, 5, 8, 96, att, np.full((n_ticks, n_cells), -1, np.int32),
        np.ones((n_ticks, 5), np.int32),
        delay=np.full((n_ticks, 5), 4, np.int32), round_ticks=17, extends=ext,
    )


def test_renewal_deployment_stays_owned():
    tr = _renewal_trace(64, 384)
    jeng, teng = _engines(tr)
    jsc = tr.scenario()
    jow, jcn = jeng.run_trace(jsc)
    tow, tcn = teng.run_trace(_port_scenario(jsc))
    _same(jow, tow, "owners")
    _same(jcn, tcn, "counts")
    _assert_engines_equal(jeng, teng)
    assert int(tcn.max()) <= 1
    owned = float((tow[9:] >= 0).float().mean())  # after the first round trip
    assert owned >= 0.95, owned


@pytest.mark.parametrize("case", ["restart", "renew-chaos", "delay-asym-drop"])
def test_owners_equal_event_sim_referee(case):
    """Differential check against the port's event-driven referee: same
    owners at every tick, never two believers."""
    seed, opts = CASES[case]
    tr = port_random_trace(seed, n_ticks=N_TICKS, **opts)
    _, teng = _engines(tr)
    tow, tcn = teng.run_trace(tr.scenario())
    assert int(tcn.max()) <= 1
    np.testing.assert_array_equal(replay_event_sim(tr), tow.numpy())


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeaseArrayEngine(8)
    with pytest.raises(RuntimeError, match="is_available"):
        tstate.init_state(8, 3, 2)


def test_default_backend_follows_device():
    eng = LeaseArrayEngine(8, device="cpu")
    assert eng.backend == "torch" and eng.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA device"):
        LeaseArrayEngine(8, device="cpu", backend="cuda")
    with pytest.raises(ValueError, match="unknown lease-plane backend"):
        LeaseArrayEngine(8, device="cpu", backend="jnp")


def test_pack_budget_refusal_matches_reference():
    """Both engines refuse the same trace at the same tick with the same
    message (4094 ticks at P = 8 honest)."""
    from repro.lease_array import Scenario as JScenario

    sc = Scenario.build(8, n_cells=8, n_acceptors=5, n_proposers=8)
    msgs = []
    for eng, bundle in ((JEngine(8, n_proposers=8), JScenario(dict(sc.planes))),
                        (LeaseArrayEngine(8, n_proposers=8, device="cpu"), sc)):
        eng.t = 4090
        eng.run_trace(bundle[:4])  # through tick 4094: the last one that fits
        with pytest.raises(ValueError, match="exceeds the packed int32") as e:
            eng.run_trace(bundle[:1])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_model_choice_and_input_checks():
    tr = _trace("delay-asym-drop")
    _, teng = _engines(tr)
    sc = _port_scenario(tr.scenario())
    with pytest.raises(ValueError, match="netplane=False"):
        teng.run_trace(sc, netplane=False)
    # raw plane arrays are the deprecated spelling (tests/test_torch_deprecations.py);
    # anything that is neither a Scenario/TickInputs nor a plane is refused
    with pytest.raises(TypeError, match="Scenario"):
        teng.run_trace({"attempts": np.zeros((3, tr.n_cells), np.int32)})
    with pytest.raises(TypeError, match="TickInputs"):
        teng.step({"attempts": np.zeros(tr.n_cells, np.int32)})
    ow, cn = teng.run_trace(sc[:0])
    assert ow.shape == (0, tr.n_cells) and cn.dtype == torch.int32
    teng.run_trace(sc[:10])
    assert teng._netplane_active and teng.t == 10
