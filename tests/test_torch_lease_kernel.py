"""The CUDA window kernels against their plain PyTorch versions.

Tests marked ``cuda`` build ``csrc/lease_window.cu`` and hold both kernels
bit-exact against ``lease_window_*_torch`` on the card; without a CUDA
device they skip. Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lease_kernel.py

The rest run anywhere: the wrappers refuse CPU tensors instead of falling
back, the library name follows the sources, and the plain versions count
their calls and continue across split dispatches.
"""
import numpy as np
import pytest
import torch

from repro_torch.lease_array import LeaseArrayEngine, Scenario, random_trace
from repro_torch.lease_array import _build
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.netplane import init_netplane
from repro_torch.lease_array.state import init_state, pack_state
from repro_torch.lease_array.trace import Trace


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda")


def _renewal(n_cells: int, n_ticks: int, n_acceptors: int = 5) -> Trace:
    att = np.full((n_ticks, n_cells), -1, np.int32)
    ext = np.full((n_ticks, n_cells), -1, np.int32)
    att[0] = np.arange(n_cells) % 8
    ext[64::64] = np.arange(n_cells) % 8
    return Trace(n_cells, n_acceptors, 8, 96, att,
                 np.full((n_ticks, n_cells), -1, np.int32),
                 np.ones((n_ticks, n_acceptors), np.int32),
                 delay=np.full((n_ticks, n_acceptors), 4, np.int32),
                 round_ticks=17, extends=ext)


TRACES = {
    "sync": lambda: random_trace(1, n_ticks=80, n_cells=300, n_proposers=8, lease_ticks=4),
    "delay-asym-drop": lambda: random_trace(2, n_ticks=80, n_cells=300, n_proposers=8,
                                            max_delay_ticks=3, p_drop=0.1, asymmetric=True),
    "chaos-a3": lambda: random_trace(3, n_ticks=100, n_cells=257, n_acceptors=3,
                                     n_proposers=5, lease_ticks=8, max_delay_ticks=2,
                                     p_drop=0.05, drift_eps=0.25, restarts=0.02,
                                     renew=0.5),
    "renewal": lambda: _renewal(300, 200),
}


def _engine(tr, device, **kw):
    return LeaseArrayEngine(tr.n_cells, n_acceptors=tr.n_acceptors,
                            n_proposers=tr.n_proposers, lease_ticks=tr.lease_ticks,
                            round_ticks=tr.round_ticks, drift_eps=tr.drift_eps,
                            device=device, **kw)


def _replay(tr, device, split=None, **kw):
    eng = _engine(tr, device, **kw)
    sc = tr.scenario()
    parts = [sc] if split is None else [sc[:split], sc[split:]]
    outs = [eng.run_trace(p) for p in parts]
    return [torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            *eng.state, *eng.net]


@pytest.mark.cuda
@pytest.mark.parametrize("split", [None, 33])
@pytest.mark.parametrize("window", [1, 3, 5, 16, 64])
@pytest.mark.parametrize("case", sorted(TRACES))
def test_kernel_equals_plain(cuda_device, case, window, split):
    tr = TRACES[case]()
    plain = _replay(tr, cuda_device, backend="torch", skip_stable=False)
    before = K.lease_window_delayed.launches + K.lease_window_sync.launches
    for skip in (True, False):
        got = _replay(tr, cuda_device, split, backend="cuda", window=window,
                      skip_stable=skip)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, plain)):
            assert torch.equal(a, b), (case, window, split, skip, i)
    after = K.lease_window_delayed.launches + K.lease_window_sync.launches
    assert after - before == 2 * (1 if split is None else 2)


@pytest.mark.cuda
def test_wrappers_check_their_inputs(cuda_device):
    N, A, P, T = 64, 5, 8, 4
    packed = pack_state(init_state(N, A, P, device=cuda_device))
    rows = torch.full((T, N), -1, dtype=torch.int32, device=cuda_device)
    cols = torch.ones((T, A), dtype=torch.int32, device=cuda_device)
    pclk = torch.zeros((T, P), dtype=torch.int32, device=cuda_device)
    kw = dict(majority=3, lease_q4=13, n_proposers=P)
    K.lease_window_sync(packed, 0, rows, rows, cols, pclk, cols, **kw)
    with pytest.raises(ValueError, match="int32"):
        K.lease_window_sync(packed, 0, rows.long(), rows, cols, pclk, cols, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        K.lease_window_sync(packed, 0, rows.t().contiguous().t(), rows, cols,
                            pclk, cols, **kw)
    with pytest.raises(ValueError, match="shape"):
        K.lease_window_sync(packed, 0, rows[:, 1:], rows, cols, pclk, cols, **kw)
    with pytest.raises(ValueError, match="acceptors"):
        big = pack_state(init_state(N, 16, P, device=cuda_device))
        cols16 = torch.ones((T, 16), dtype=torch.int32, device=cuda_device)
        K.lease_window_sync(big, 0, rows, rows, cols16, pclk, cols16, **kw)


def test_cuda_wrappers_refuse_cpu_tensors():
    N, A, P, T = 16, 3, 2, 4
    packed = pack_state(init_state(N, A, P, device="cpu"))
    net = init_netplane(N, A, device="cpu")
    rows = torch.full((T, N), -1, dtype=torch.int32)
    up = torch.ones((T, A), dtype=torch.int32)
    pclk = torch.zeros((T, P), dtype=torch.int32)
    link = torch.zeros((T, P, A), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.lease_window_sync(packed, 0, rows, rows, up, pclk, up, majority=2,
                            lease_q4=13, n_proposers=P)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.lease_window_delayed(packed, net, 0, rows, rows, up, pclk, up, link,
                               majority=2, lease_q4=13, round_q4=4, n_proposers=P)


def test_library_name_follows_sources_and_acceptors(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path(5)
    assert first.parent == _build.BUILD_DIR and "_a5_" in first.name
    assert _build.library_path(3) != first
    (src / "k.cu").write_text("// two\n")
    assert _build.library_path(5) != first


def test_every_function_counts_its_launches():
    """Each plain version counts its calls; reset_launches zeros all four
    counters. (The kernels' counts are checked on the card.)"""
    K.reset_launches()
    _replay(TRACES["sync"](), "cpu")
    _replay(TRACES["delay-asym-drop"](), "cpu", split=40)
    assert K.lease_window_sync_torch.launches == 1
    assert K.lease_window_delayed_torch.launches == 2
    assert K.lease_window_sync.launches == K.lease_window_delayed.launches == 0
    K.reset_launches()
    assert K.lease_window_sync_torch.launches == 0
    assert K.lease_window_delayed_torch.launches == 0


def test_plain_delayed_split_by_hand_equals_whole():
    """The plain window loop continues across calls: two calls on the
    packed state and net equal one."""
    tr = random_trace(5, n_ticks=60, n_cells=50, n_proposers=4, max_delay_ticks=2,
                      p_drop=0.1)
    eng = _engine(tr, "cpu")
    whole = eng.run_trace(tr.scenario())
    eng2 = _engine(tr, "cpu", window=5)
    sc = Scenario(dict(tr.scenario().planes))
    a = eng2.run_trace(sc[:25])
    b = eng2.run_trace(sc[25:])
    assert torch.equal(whole[0], torch.cat([a[0], b[0]]))
    assert torch.equal(whole[1], torch.cat([a[1], b[1]]))
    for x, y in zip((*eng.state, *eng.net), (*eng2.state, *eng2.net)):
        assert torch.equal(x, y)
