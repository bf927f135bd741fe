"""Carrying an engine's state across packages, bit-exact.

Half a chaos trace (delay, drops, drift, restarts, §6 renewals) runs on the
JAX reference engine; its carried state leaves as numpy arrays
(``engine_to_arrays``), enters the PyTorch engine (``engine_from_reference``)
and the port replays the second half. Owners, counts and the final state
must equal one uninterrupted reference run. The port -> arrays -> port
round trip must continue exactly as the engine it came from.
"""
import numpy as np
import pytest
import torch

from repro.lease_array import LeaseArrayEngine as JEngine
from repro.lease_array import random_trace
from repro_torch.lease_array import (
    LeaseArrayEngine,
    Scenario,
    engine_from_reference,
    engine_to_arrays,
)

CHAOS = dict(n_ticks=120, n_cells=20, n_acceptors=5, n_proposers=4, lease_ticks=6,
             max_delay_ticks=2, p_drop=0.05, asymmetric=True, drift_eps=0.25,
             restarts=0.03, renew=0.5)
CUT = 57


def _cfg(tr):
    return dict(lease_ticks=tr.lease_ticks, round_ticks=tr.round_ticks,
                drift_eps=tr.drift_eps)


def _geom(tr):
    return dict(n_acceptors=tr.n_acceptors, n_proposers=tr.n_proposers)


def _assert_state_equal(ref_engine, port_engine):
    ref = engine_to_arrays(ref_engine)
    port = engine_to_arrays(port_engine)
    assert ref.keys() == port.keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k], port[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_half_then_port_half_equals_one_reference_run(seed):
    tr = random_trace(seed, **CHAOS)
    assert tr.restarted and tr.extended and tr.delayed
    jsc = tr.scenario()
    whole = JEngine(tr.n_cells, **_geom(tr), **_cfg(tr))
    w_ow, w_cn = whole.run_trace(jsc)

    half = JEngine(tr.n_cells, **_geom(tr), **_cfg(tr))
    h_ow, h_cn = half.run_trace(jsc[:CUT])
    arrays = engine_to_arrays(half)
    assert all(isinstance(v, np.ndarray) for v in arrays.values())
    port = engine_from_reference(arrays, device="cpu", **_cfg(tr))
    p_ow, p_cn = port.run_trace(Scenario(dict(jsc[CUT:].planes)))

    np.testing.assert_array_equal(w_ow, np.concatenate([h_ow, p_ow.numpy()]))
    np.testing.assert_array_equal(w_cn, np.concatenate([h_cn, p_cn.numpy()]))
    _assert_state_equal(whole, port)


def test_port_round_trip_continues_exactly():
    tr = random_trace(3, **CHAOS)
    sc = Scenario(dict(tr.scenario().planes))
    eng = LeaseArrayEngine(tr.n_cells, **_geom(tr), device="cpu", **_cfg(tr))
    eng.run_trace(sc[:CUT])
    twin = engine_from_reference(engine_to_arrays(eng), device="cpu", **_cfg(tr))
    assert twin.t == eng.t == CUT
    a = eng.run_trace(sc[CUT:])
    b = twin.run_trace(sc[CUT:])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _assert_state_equal(eng, twin)


def test_arrays_name_every_carried_field():
    tr = random_trace(4, **CHAOS)
    eng = LeaseArrayEngine(tr.n_cells, **_geom(tr), device="cpu", **_cfg(tr))
    arrays = engine_to_arrays(eng)
    want = {*eng.state._fields, *eng.net._fields, "t", "prop_clk", "acc_clk",
            "_rc", "_deaf_until", "_netplane_active", "_restart_active"}
    assert set(arrays) == want
    assert arrays["highest_promised"].shape == (tr.n_acceptors, tr.n_cells)
    assert arrays["owner_mask"].shape == (tr.n_proposers, tr.n_cells)
    assert all(arrays[f].dtype == np.int32 for f in eng.state._fields)
