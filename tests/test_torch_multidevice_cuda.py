"""The lease plane split over devices, on the card: ``run_trace`` and
``sweep`` over ``[cuda:0] * 2`` against one device.

The engine's device list (``engine._split_devices``) is substituted, so a
one-card machine runs the split path: each shard launches the CUDA entry
on its own slice (its own ``kernel.LaunchPlan``), and the pieces come back
in order. Owners, counts, the state after two consecutive calls, and every
field of a sweep in each ``collect`` mode must be bit-exact against one
device. Without a CUDA device the tests skip. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_multidevice_cuda.py
"""
import pytest
import torch

from repro_torch.lease_array import LeaseArrayEngine, Scenario, random_trace
from repro_torch.lease_array import engine as engine_mod
from repro_torch.lease_array import kernel as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda", 0)


TRACES = {
    "chaos": dict(n_cells=4096, n_acceptors=5, n_proposers=8, lease_ticks=6,
                  p_attempt=0.12, p_release=0.04, renew=0.5, max_delay_ticks=2,
                  p_drop=0.05, drift_eps=0.25, restarts=0.01, asymmetric=True,
                  round_ticks=9),
    "sync": dict(n_cells=4096, n_acceptors=5, n_proposers=8, lease_ticks=3),
}


def _engine(tr, dev):
    return LeaseArrayEngine(tr.n_cells, n_acceptors=tr.n_acceptors,
                            n_proposers=tr.n_proposers, lease_ticks=tr.lease_ticks,
                            round_ticks=tr.round_ticks, drift_eps=tr.drift_eps,
                            device=dev)


def _fields(eng):
    return (*eng.state, *eng.net, eng.last_owner_count)


@pytest.mark.parametrize("case", sorted(TRACES))
def test_split_run_trace_equals_one_device(cuda_device, monkeypatch, case):
    tr = random_trace(21, n_ticks=96, **TRACES[case])
    sc = tr.scenario()
    parts = (sc[:40], sc[40:])
    one, two = _engine(tr, cuda_device), _engine(tr, cuda_device)
    want = [one.run_trace(p) for p in parts]
    entry = K.lease_window_delayed if case == "chaos" else K.lease_window_sync
    monkeypatch.setattr(engine_mod, "_split_devices", lambda dev: [cuda_device] * 2)
    before = entry.launches
    got = [two.run_trace(p) for p in parts]
    assert entry.launches - before == 4  # two shards a call
    for g, w in zip(got, want):
        assert all(bool((x == y).all()) for x, y in zip(g, w))
    for x, y in zip(_fields(two), _fields(one)):
        assert x.device == cuda_device and bool((x == y).all())
    assert two.t == one.t == 96


@pytest.mark.parametrize("collect", ["summary", "owners", "margins"])
def test_split_sweep_equals_one_device(cuda_device, monkeypatch, collect):
    geom = dict(n_cells=512, n_acceptors=3, n_proposers=4)
    scs = [random_trace(300 + s, n_ticks=32, lease_ticks=6, p_attempt=0.15,
                        p_release=0.04, max_delay_ticks=1, p_drop=0.05,
                        drift_eps=0.25, restarts=0.02, renew=0.5,
                        round_ticks=5, **geom).scenario() for s in range(8)]
    kw = dict(lease_ticks=6, round_ticks=5, drift_eps=0.25, device=cuda_device, **geom)
    one, two = LeaseArrayEngine(**kw), LeaseArrayEngine(**kw)
    want = one.sweep(Scenario.stack(scs), collect=collect)
    monkeypatch.setattr(engine_mod, "_split_devices", lambda dev: [cuda_device] * 2)
    before = K.lease_window_delayed_batched.launches
    got = two.sweep(Scenario.stack(scs), collect=collect)
    assert K.lease_window_delayed_batched.launches - before == (
        0 if collect == "margins" else 2)
    for field in want._fields:
        w, g = getattr(want, field), getattr(got, field)
        if isinstance(w, dict):
            assert all(bool((g[k] == w[k]).all()) for k in w), field
        elif w is None:
            assert g is None, field
        else:
            assert g.device == cuda_device and bool((g == w).all()), field
