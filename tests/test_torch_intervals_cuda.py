"""The static pack-budget gate in front of the lease kernels, on the card.

A restart-mode replay that ends at the pack bound (P 8, 3-tick leases,
proposer 7 restarted three times and attempting on every cell at the
last tick, 1022 ticks from t 0) runs through the delayed kernel bit-exact
against the plain version, its top ballot ``((1022 << 2) | 3) * 8 + 7``;
one tick longer is refused before anything is allocated on the card or any
lease kernel launches, and so is a 100-tick replay whose round horizon
overflows int32 (the gate's refusal; the hand check passes it). Without a
CUDA device the tests skip. This file imports no JAX, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_intervals_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.lease_array import LeaseArrayEngine, Scenario
from repro_torch.lease_array import engine as lease_engine
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.state import MAX_RESTARTS, RESTART_SHIFT, max_pack_tick

A, P, N, LEASE, T_EDGE = 5, 8, 4096, 3, 1022
RESTARTS = (100, 400, 700)
HUGE_ROUND_TICKS = 536_870_900


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda")


def _edge(n_ticks):
    t = np.arange(n_ticks)[:, None]
    n = np.arange(N)[None, :]
    att = np.where((t + n) % 32 == 0, (n + t // 32) % P, -1).astype(np.int32)
    att[-1] = P - 1
    prst = np.zeros((n_ticks, P), np.int32)
    prst[list(RESTARTS), P - 1] = 1
    return Scenario.build(n_cells=N, n_acceptors=A, n_proposers=P,
                          attempts=att, prop_restart=prst)


def _engine(dev, backend, **kw):
    return LeaseArrayEngine(N, n_acceptors=A, n_proposers=P, lease_ticks=LEASE,
                            backend=backend, device=dev, **kw)


def _replays_equal(dev, sc, **kw):
    outs = []
    for backend in ("cuda", "torch"):
        eng = _engine(dev, backend, **kw)
        ow, cn = eng.run_trace(sc)
        outs.append((ow, cn, *eng.state, *eng.net))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    return outs[0]


def _refused(dev, sc, match, **kw):
    eng = _engine(dev, "cuda", **kw)
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
    launches = (K.lease_window_delayed.launches, K.lease_window_sync.launches)
    with pytest.raises(ValueError, match=match):
        eng.run_trace(sc)
    assert torch.cuda.memory_stats().get("allocation.all.allocated", 0) == allocs
    assert (K.lease_window_delayed.launches, K.lease_window_sync.launches) == launches
    assert eng.t == 0


@pytest.mark.cuda
def test_edge_replay_is_bit_exact_and_one_tick_more_is_refused(cuda_device):
    assert max_pack_tick(P, 4 * LEASE + 1, 0, max_restarts=MAX_RESTARTS) == T_EDGE
    K.reset_launches()
    got = _replays_equal(cuda_device, _edge(T_EDGE))
    assert K.lease_window_delayed.launches == 1
    assert int(got[2].max()) == ((T_EDGE << RESTART_SHIFT) | MAX_RESTARTS) * P + P - 1
    _refused(cuda_device, _edge(T_EDGE + 1), "exceeds the packed int32 layout's budget")
    assert lease_engine._static_pack_findings(
        T_EDGE + 1, P, A, 4 * LEASE + 1, 4, 4 * LEASE + 1, 0, 4, 0, MAX_RESTARTS)
    assert lease_engine._STATIC_CHECK_FAILED is False


@pytest.mark.cuda
def test_huge_round_horizon_is_refused_and_three_ticks_run(cuda_device):
    t, n = np.arange(100)[:, None], np.arange(N)[None, :]
    sc = Scenario.build(
        n_cells=N, n_acceptors=A, n_proposers=P,
        attempts=np.where(t == n % 3, n % P, -1).astype(np.int32),
        delay=np.ones((100, A), np.int32))
    K.reset_launches()
    _refused(cuda_device, sc, "static analysis refused",
             round_ticks=HUGE_ROUND_TICKS)
    _replays_equal(cuda_device, sc[:3], round_ticks=HUGE_ROUND_TICKS)
    assert K.lease_window_delayed.launches == 1
    assert lease_engine._STATIC_CHECK_FAILED is False
