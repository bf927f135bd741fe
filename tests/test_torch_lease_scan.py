"""lease_window_scan of the PyTorch lease plane against the JAX reference.

The same scenario planes, drawn with numpy from a seed, are replayed by
``repro.lease_array.ops.lease_window_scan`` (``backend="jnp"``) and by
``repro_torch.lease_array.ops.lease_window_scan`` (``backend="torch"``, on
the CPU), over the fault matrix of the reference's own suites: delay, drops,
asymmetric links, drift, restarts, §6 renewals and stale/equiv corruption;
a trace split over two dispatches; and the zero-delay synchronous model.
Owners, counts, the final lease state and the in-flight plane must be
bit-exact (int32). The window size and the quiescence skip shape only the
CUDA kernels' work (the plain path has neither); the ``cuda``-marked tests
of ``test_torch_lease_kernel.py`` hold the kernels at windows 1/3/5/16/64,
skip on and off, against this plain path.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lease_array import ops as jops
from repro.lease_array import random_trace
from repro.lease_array.netplane import init_netplane as j_init_netplane
from repro.lease_array.scenario import Scenario as JScenario
from repro.lease_array.state import guarded_lease_q4, init_state as j_init_state
from repro.lease_array.state import lease_quarters
from repro_torch.lease_array import LeaseArrayEngine, Scenario, TickInputs
from repro_torch.lease_array import ops as tops
from repro_torch.lease_array.netplane import init_netplane
from repro_torch.lease_array.state import init_state

GEOM = dict(n_cells=40, n_acceptors=5, n_proposers=4)

#: name -> (seed, random_trace options, add stale/equiv planes)
CASES = {
    "delay2-drop": (1, dict(max_delay_ticks=2, p_drop=0.1), False),
    "delay3-asym": (2, dict(max_delay_ticks=3, p_drop=0.05, asymmetric=True), False),
    "drift": (3, dict(max_delay_ticks=1, drift_eps=0.25, lease_ticks=5), False),
    "restart": (4, dict(max_delay_ticks=2, p_drop=0.05, restarts=0.03,
                        drift_eps=0.25, asymmetric=True), False),
    "renew": (5, dict(max_delay_ticks=2, renew=0.5, lease_ticks=8), False),
    "corrupt": (6, dict(max_delay_ticks=1, p_drop=0.05, lease_ticks=4), True),
    "chaos": (7, dict(max_delay_ticks=2, p_drop=0.05, asymmetric=True,
                      drift_eps=0.25, restarts=0.02, renew=0.5, lease_ticks=6), True),
}
N_TICKS = 120


@functools.cache
def _case(name: str):
    """(planes, engine config) of one case: numpy planes shared by both."""
    seed, opts, corrupt = CASES[name]
    tr = random_trace(seed, n_ticks=N_TICKS, **GEOM, **opts)
    planes = dict(tr.scenario().planes)
    if corrupt:
        rng = np.random.default_rng(seed)
        A = GEOM["n_acceptors"]
        planes["acc_stale"] = (rng.random((N_TICKS, A)) < 0.1).astype(np.int32)
        planes["acc_equiv"] = (rng.random((N_TICKS, A)) < 0.1).astype(np.int32)
    lease_q4 = lease_quarters(tr.lease_ticks)
    cfg = dict(majority=GEOM["n_acceptors"] // 2 + 1, lease_q4=lease_q4,
               round_q4=4 * tr.round_ticks,
               guard_q4=guarded_lease_q4(lease_q4, tr.drift_eps))
    eng = dict(lease_ticks=tr.lease_ticks, round_ticks=tr.round_ticks,
               drift_eps=tr.drift_eps)
    return planes, cfg, eng


@functools.cache
def _reference(name: str, sync: bool = False):
    planes, cfg, _ = _case(name)
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    st, net, ow, cn = jops.lease_window_scan(
        j_init_state(N, A, P), j_init_netplane(N, A), 0, planes,
        backend="jnp", sync=sync, **cfg,
    )
    return [np.asarray(x) for x in (ow, cn, *st, *net)]


def _port(name: str, sync: bool = False, **kw):
    planes, cfg, _ = _case(name)
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    st, net, ow, cn = tops.lease_window_scan(
        init_state(N, A, P, device="cpu"), init_netplane(N, A, device="cpu"),
        0, planes, backend="torch", sync=sync, **cfg, **kw,
    )
    return [ow, cn, *st, *net]


def _assert_bit_exact(ref, port):
    assert len(ref) == len(port)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p.dtype == torch.int32, i
        np.testing.assert_array_equal(r, p.numpy(), err_msg=f"output {i}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_scan_bit_exact(case):
    _assert_bit_exact(_reference(case), _port(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_trace_continuation(case):
    """Two run_trace dispatches (clocks, restart history and the in-flight
    plane carried by the engine) equal the reference's single scan."""
    planes, _, eng_cfg = _case(case)
    sc = Scenario.build(N_TICKS, **GEOM, **planes)
    eng = LeaseArrayEngine(GEOM["n_cells"], n_acceptors=GEOM["n_acceptors"],
                           n_proposers=GEOM["n_proposers"], device="cpu",
                           window=7, **eng_cfg)
    cut = 47
    a = eng.run_trace(sc[:cut], netplane=True)
    b = eng.run_trace(sc[cut:], netplane=True)
    _assert_bit_exact(
        _reference(case),
        [torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]]), *eng.state, *eng.net],
    )


@pytest.mark.parametrize("window", [1, 16])
def test_sync_model_bit_exact(window):
    tr = random_trace(8, n_ticks=N_TICKS, lease_ticks=4, **GEOM)
    planes = tr.scenario().planes
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    cfg = dict(majority=3, lease_q4=lease_quarters(4), round_q4=4)
    jst, _, jow, jcn = jops.lease_window_scan(
        j_init_state(N, A, P), j_init_netplane(N, A), 0, planes,
        backend="jnp", sync=True, **cfg)
    net0 = init_netplane(N, A, device="cpu")
    tst, tnet, tow, tcn = tops.lease_window_scan(
        init_state(N, A, P, device="cpu"), net0, 0, planes,
        backend="torch", sync=True, window=window, **cfg)
    assert tnet is net0  # the synchronous model passes the net through
    _assert_bit_exact([np.asarray(x) for x in (jow, jcn, *jst)],
                      [tow, tcn, *tst])


def test_zero_delay_trace_same_on_both_models():
    """A zero-delay scenario replays bit-identically on the sync and the
    delayed model (owners and counts), as in the reference."""
    tr = random_trace(9, n_ticks=60, lease_ticks=3, **GEOM)
    planes = tr.scenario().planes
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    outs = [
        tops.lease_window_scan(
            init_state(N, A, P, device="cpu"), init_netplane(N, A, device="cpu"),
            0, planes, majority=3, lease_q4=lease_quarters(3), round_q4=4,
            sync=sync)[2:]
        for sync in (True, False)
    ]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("case", ["restart", "chaos"])
def test_lease_plane_tick_matches_reference(case):
    """Six single ticks through lease_plane_tick, clocks carried by hand."""
    planes, cfg, _ = _case(case)
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    js, jn = j_init_state(N, A, P), j_init_netplane(N, A)
    ts, tn = init_state(N, A, P, device="cpu"), init_netplane(N, A, device="cpu")
    pclk = np.zeros(P, np.int32)
    aclk = np.zeros(A, np.int32)
    sc = JScenario({k: v for k, v in planes.items()})
    for t in range(6):
        tick = sc[t]
        clk0 = (pclk.copy(), aclk.copy())
        rst0 = (np.zeros(P, np.int32), np.zeros(A, np.int32))
        js, jn, jc = jops.lease_plane_tick(
            js, jn, t, tick, clk0=tuple(map(jnp.asarray, clk0)), rst0=rst0, **cfg)
        ts, tn, tc = tops.lease_plane_tick(
            ts, tn, t, TickInputs(dict(tick.planes)), clk0=clk0, rst0=rst0,
            backend="torch", **cfg)
        _assert_bit_exact([np.asarray(x) for x in (jc, *js, *jn)], [tc, *ts, *tn])
        pclk += tick.prop_rate
        aclk += tick.acc_rate


def test_cuda_backend_refuses_cpu_tensors():
    planes, cfg, _ = _case("delay2-drop")
    A, N, P = GEOM["n_acceptors"], GEOM["n_cells"], GEOM["n_proposers"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tops.lease_window_scan(
            init_state(N, A, P, device="cpu"), init_netplane(N, A, device="cpu"),
            0, planes, backend="cuda", **cfg)


def test_default_backend_follows_the_device():
    assert tops.default_backend("cpu") == "torch"
    assert tops.default_backend(torch.device("cuda", 0)) == "cuda"
    assert tops.BACKENDS == ("torch", "cuda")


def test_all_default_fault_planes_are_stripped():
    """Omit means honest: all-default corruption/restart/extends planes
    leave the dispatch, anything else stays."""
    planes, _, _ = _case("delay2-drop")
    full = dict(planes)
    A = GEOM["n_acceptors"]
    full["acc_stale"] = np.zeros((N_TICKS, A), np.int32)
    full["acc_restart"] = np.zeros((N_TICKS, A), np.int32)
    stripped = tops.strip_default_planes(full)
    assert set(stripped) == set(jops.strip_default_planes(full))
    assert "acc_stale" not in stripped and "acc_restart" not in stripped
    assert "extends" not in stripped and "attempts" in stripped
