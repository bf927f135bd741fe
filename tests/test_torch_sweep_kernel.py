"""The batched window kernels (the sweep's) against their plain batched
versions, and the differential referee on the card.

Tests marked ``cuda`` build ``csrc/lease_window.cu`` and hold
``lease_window_{delayed,sync}_batched`` bit-exact against
``lease_window_*_batched_torch`` (the plain window loop scenario by
scenario) in both collect modes: one scenario against the unbatched
kernel, ragged and small cell counts, every template variant (extends,
corruption, restarts), and the batched delayed kernel at every lane count
its plan can take (``kernel.lane_counts``), at the reference bench's sweep
and in summary mode at the chaos sweep (64 x 2^14 cells x 128 ticks, equal
to one ``run_trace`` a scenario). They also check that ``sweep`` on the
card launches the batched kernels and that ``replay_array(backend="cuda")``
equals the event-driven referee. Without a CUDA device they skip. This file
imports no JAX, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sweep_kernel.py

The rest run anywhere: the batched wrappers refuse CPU tensors, the plain
versions count their calls, and the summary reduction is what it says.
"""
import numpy as np
import pytest
import torch

from repro_torch.lease_array import (
    LeaseArrayEngine,
    Scenario,
    random_trace,
    replay_array,
    replay_event_sim,
)
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.netplane import NetPlaneState, init_netplane
from repro_torch.lease_array.ops import _device_planes, strip_default_planes
from repro_torch.lease_array.state import PackedLeaseState, init_state, pack_state


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda")


def _corrupt(tr, seed):
    rng = np.random.default_rng(seed)
    T, A = tr.n_ticks, tr.n_acceptors
    return Scenario.build(
        n_cells=tr.n_cells, n_acceptors=A, n_proposers=tr.n_proposers,
        **{**tr.scenario().planes,
           "acc_stale": (rng.random((T, A)) < 0.05).astype(np.int32),
           "acc_equiv": (rng.random((T, A)) < 0.05).astype(np.int32)})


def _sync_case(n_cells, n_ticks):
    """A zero-delay scenario of the bench sweep's mix (A 3, P 4) from a seed."""
    return (dict(lease_ticks=3, round_ticks=2), lambda s: random_trace(
        s, n_ticks=n_ticks, n_cells=n_cells, n_acceptors=3, n_proposers=4,
        lease_ticks=3, p_attempt=0.5, p_release=0.05, p_down_flip=0.05,
        round_ticks=2).scenario())


#: name -> (engine options, B scenarios from a seed); each batch shares
#: its geometry, and the cell counts are small (8), the bench sweep's (32),
#: ragged (37, 257) or past one block (300)
CASES = {
    "sync-n8": (dict(lease_ticks=2, round_ticks=2), lambda s: random_trace(
        s, n_ticks=16, n_cells=8, n_acceptors=3, n_proposers=4,
        lease_ticks=2, p_attempt=0.5, p_release=0.08, p_down_flip=0.05,
        round_ticks=2).scenario()),
    "sync-n32": _sync_case(32, 16),
    "sync-n300": _sync_case(300, 37),
    "delay-drop-n37": (dict(lease_ticks=3, round_ticks=3), lambda s: random_trace(
        s, n_ticks=40, n_cells=37, n_proposers=8, max_delay_ticks=2,
        p_drop=0.1, asymmetric=True).scenario()),
    "chaos-a3-n257": (dict(lease_ticks=8, round_ticks=3, drift_eps=0.25),
                      lambda s: random_trace(
        s, n_ticks=60, n_cells=257, n_acceptors=3, n_proposers=5,
        lease_ticks=8, max_delay_ticks=2, p_drop=0.05, drift_eps=0.25,
        restarts=0.01, renew=0.5, round_ticks=3).scenario()),
    "corrupt-restart-n300": (dict(lease_ticks=8, round_ticks=3), lambda s: _corrupt(
        random_trace(s, n_ticks=48, n_cells=300, n_proposers=8, lease_ticks=8,
                     max_delay_ticks=2, p_drop=0.05, restarts=0.01,
                     round_ticks=3), s)),
}


def _every_group(device, n_cells, n_acceptors, B=3, n_ticks=40, seed=5):
    """B scenarios that carry every optional plane group (extends, stale/
    equiv corruption, restarts; each planted once where the draw left it
    out), and an engine of their geometry."""
    A, P = n_acceptors, n_acceptors + 1
    mix = dict(n_ticks=n_ticks, n_cells=n_cells, n_acceptors=A, n_proposers=P,
               lease_ticks=6, max_delay_ticks=2, p_drop=0.05, asymmetric=True,
               drift_eps=0.25, restarts=0.02, renew=0.5, round_ticks=3)
    rng = np.random.default_rng(seed)
    scs = []
    for b in range(B):
        tr = random_trace(seed + b, **mix)
        stale, equiv = (rng.random((2, n_ticks, A)) < 0.05).astype(np.int32)
        stale[-2, 0] = equiv[-2, -1] = tr.acc_restarts[-3, 0] = 1
        tr.extends[-2, 0] = 0
        scs.append(Scenario.build(n_cells=n_cells, n_acceptors=A, n_proposers=P, **{
            **tr.scenario().planes, "acc_stale": stale, "acc_equiv": equiv}))
    eng = LeaseArrayEngine(n_cells, n_acceptors=A, n_proposers=P, lease_ticks=6,
                           round_ticks=3, drift_eps=0.25, device=device)
    return eng, Scenario.stack(scs)


def _delayed_args(eng, stacked, collect="owners"):
    """The batched delayed kernel's arguments for a sweep of ``stacked``
    from ``eng``, as ``ops._sweep_scan_impl`` builds them."""
    d = _device_planes(strip_default_planes(stacked.planes), eng.device, eng._clk0(),
                       eng._rst0(), eng.t, n_proposers=eng.n_proposers,
                       n_acceptors=eng.n_acceptors, lease_q4=eng.lease_q4,
                       restart_guard=eng.restart_guard, sync=False)
    cols = [d[k] for k in ("attempts", "releases", "acc_up", "pclk", "aclk")]
    args = (PackedLeaseState(*(x.contiguous() for x in pack_state(eng.state))),
            NetPlaneState(*(x.contiguous() for x in eng.net)), eng.t, *cols, d["link"])
    kw = dict(majority=eng.majority, lease_q4=eng.lease_q4, round_q4=eng.round_q4,
              n_proposers=eng.n_proposers, guard_q4=eng.guard_q4, collect=collect,
              **{k: d.get(k) for k in K.DELAYED_OPTIONAL})
    return args, kw


#: the optional planes of each plane group of kernel.VARIANTS
GROUP_PLANES = {"extends": ("extends",), "corrupt": ("stale", "equiv"),
                "restart": ("acc_restart", "acc_deaf", "prop_restart", "prop_rc")}


def _engine(case, device, **kw):
    opts, make = CASES[case]
    sc = make(0)
    return LeaseArrayEngine(sc.n_cells, n_acceptors=sc.n_acceptors,
                            n_proposers=sc.n_proposers, device=device,
                            **opts, **kw)


def _batch(case, B=4, seed0=10):
    return [CASES[case][1](seed0 + b) for b in range(B)]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 16])
@pytest.mark.parametrize("collect", ["summary", "owners"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batched_kernel_equals_plain_batched(cuda_device, case, collect, window):
    """sweep on the card equals sweep with the plain batched window loop,
    from a fresh engine and from one that has run a scenario first, with
    the quiescence skip on and off."""
    scs = _batch(case)
    for warm in (False, True):
        for skip in (True, False):
            eng = _engine(case, cuda_device, window=window, skip_stable=skip)
            if warm:
                eng.run_trace(CASES[case][1](99))
            plain = eng.sweep(scs, collect=collect, backend="torch",
                              verify=False)
            K.reset_launches()
            got = eng.sweep(scs, collect=collect, verify=False)
            assert (K.lease_window_delayed_batched.launches
                    + K.lease_window_sync_batched.launches) == 1
            assert (K.lease_window_delayed.launches
                    + K.lease_window_sync.launches) == 0
            for f in got._fields:
                a, b = getattr(got, f), getattr(plain, f)
                assert (a is None) == (b is None), f
                if a is not None:
                    assert a.device.type == "cuda" and torch.equal(a, b), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_one_scenario_equals_the_unbatched_kernel(cuda_device, case):
    """B = 1 gives the unbatched kernel's owner and count rows, and its
    summary is their reduction."""
    sc = strip_default_planes(CASES[case][1](3).planes)
    eng = _engine(case, cuda_device)
    A, P, N = eng.n_acceptors, eng.n_proposers, eng.n_cells
    sync = case.startswith("sync")
    d = _device_planes(sc, cuda_device, None, None, 0, n_proposers=P,
                       n_acceptors=A, lease_q4=eng.lease_q4,
                       restart_guard=True, sync=sync)
    packed = pack_state(init_state(N, A, P, device=cuda_device))
    cols = [d[k] for k in ("attempts", "releases", "acc_up", "pclk", "aclk")]
    if sync:
        kw = dict(majority=eng.majority, lease_q4=eng.lease_q4, n_proposers=P)
        _, ow, cn = K.lease_window_sync(packed, 0, *cols, **kw)
        rows = K.lease_window_sync_batched(
            packed, 0, *(x[None] for x in cols), collect="owners", **kw)
        summ = K.lease_window_sync_batched(
            packed, 0, *(x[None] for x in cols), collect="summary", **kw)
    else:
        net = init_netplane(N, A, device=cuda_device)
        kw = dict(majority=eng.majority, lease_q4=eng.lease_q4,
                  round_q4=eng.round_q4, n_proposers=P)
        opt = {k: d.get(k) for k in K.DELAYED_OPTIONAL}
        _, _, ow, cn = K.lease_window_delayed(packed, net, 0, *cols, d["link"],
                                              **kw, **opt)
        bopt = {k: None if v is None else v[None] for k, v in opt.items()}
        args = (packed, net, 0, *(x[None] for x in cols), d["link"][None])
        rows = K.lease_window_delayed_batched(*args, collect="owners", **kw,
                                              **bopt)
        summ = K.lease_window_delayed_batched(*args, collect="summary", **kw,
                                              **bopt)
    torch.cuda.synchronize()
    assert torch.equal(rows[0][0], ow) and torch.equal(rows[1][0], cn)
    for got, want in zip(summ, K.window_summary(ow, cn)):
        assert torch.equal(got[0], want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sync-n32", "sync-n300"])
def test_sync_batch_of_five_equals_plain_and_one_launch_a_scenario(cuda_device, case):
    """Five scenarios, no multiple of the batched sync kernel's four warps a
    block (a warp a scenario at N 32, ten 32-cell tiles a scenario at N 300):
    both collect modes equal the plain batched version, and the rows equal
    one unbatched launch per scenario."""
    eng = _engine(case, cuda_device)
    stacked = Scenario.stack(_batch(case, B=5))
    d = _device_planes(strip_default_planes(stacked.planes), cuda_device, eng._clk0(),
                       eng._rst0(), eng.t, n_proposers=eng.n_proposers,
                       n_acceptors=eng.n_acceptors, lease_q4=eng.lease_q4,
                       restart_guard=eng.restart_guard, sync=True)
    packed = pack_state(eng.state)
    cols = [d[k] for k in ("attempts", "releases", "acc_up", "pclk", "aclk")]
    kw = dict(majority=eng.majority, lease_q4=eng.lease_q4, n_proposers=eng.n_proposers,
              guard_q4=eng.guard_q4)
    for collect in ("summary", "owners"):
        got = K.lease_window_sync_batched(packed, eng.t, *cols, collect=collect, **kw)
        want = K.lease_window_sync_batched_torch(packed, eng.t, *cols, collect=collect, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), collect
    owners, counts = got
    assert int((owners >= 0).sum()) > 0
    for b in range(5):
        _, ow, cn = K.lease_window_sync(packed, eng.t, *(x[b] for x in cols), **kw)
        assert torch.equal(ow, owners[b]) and torch.equal(cn, counts[b])


@pytest.mark.cuda
def test_batched_wrappers_check_their_inputs(cuda_device):
    A, P, N, T = 3, 4, 8, 5
    packed = pack_state(init_state(N, A, P, device=cuda_device))
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=cuda_device)
    kw = dict(majority=2, lease_q4=9, n_proposers=P)
    good = (z(2, T, N), z(2, T, N), z(2, T, A), z(2, T, P), z(2, T, A))
    out = K.lease_window_sync_batched(packed, 0, *good, **kw)
    assert [tuple(x.shape) for x in out] == [(2, N)] * 3
    with pytest.raises(ValueError, match="collect"):
        K.lease_window_sync_batched(packed, 0, *good, collect="all", **kw)
    with pytest.raises(ValueError, match="attempts has shape"):
        K.lease_window_sync_batched(packed, 0, z(2, T, N + 1), *good[1:], **kw)
    with pytest.raises(ValueError, match="acc_up has shape"):
        K.lease_window_sync_batched(packed, 0, *good[:2], z(3, T, A),
                                    *good[3:], **kw)
    with pytest.raises(ValueError, match="1..65535 scenarios"):
        K.lease_window_sync_batched(
            packed, 0, *(x[:0] for x in good), **kw)
    net = init_netplane(N, A, device=cuda_device)
    with pytest.raises(ValueError, match="link has shape"):
        K.lease_window_delayed_batched(packed, net, 0, *good, z(2, T, A, P),
                                       round_q4=8, **kw)


@pytest.mark.cuda
def test_referee_equals_the_kernels(cuda_device):
    """replay_array on the card equals the event-driven referee."""
    for seed, opts in ((42, dict(max_delay_ticks=2, p_drop=0.05,
                                 drift_eps=0.25, asymmetric=True,
                                 restarts=0.02)),
                       (1234, dict(n_cells=8, n_acceptors=3, lease_ticks=6,
                                   p_attempt=0.12, p_release=0.04, renew=0.5,
                                   max_delay_ticks=1, p_drop=0.05,
                                   drift_eps=0.25, round_ticks=5))):
        tr = random_trace(seed, n_ticks=400, **opts)
        ow, cn = replay_array(tr, backend="cuda", device=cuda_device)
        assert int(cn.max()) <= 1
        np.testing.assert_array_equal(replay_event_sim(tr), ow.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n_cells,n_acceptors", [(37, 3), (300, 5), (4, 3), (32, 5)])
def test_every_lane_count_in_every_variant_equals_plain(cuda_device, n_cells, n_acceptors):
    """At every lane count the plan can take, in each of the eight plane-group
    variants, both collect modes, windows 1 and 16 and the skip on and off,
    the batched delayed kernel equals the plain batched version, at ragged
    and small cell counts and past a block."""
    eng, stacked = _every_group(cuda_device, n_cells, n_acceptors)
    args, kw = _delayed_args(eng, stacked)
    assert all(kw[k] is not None for k in K.DELAYED_OPTIONAL)
    for bits in np.ndindex(2, 2, 2):
        variant = {v for v, on in zip(K.VARIANTS, bits) if on}
        vkw = {k: None if any(k in GROUP_PLANES[g] for g in K.VARIANTS if g not in variant)
               else x for k, x in kw.items()}
        rows = K.lease_window_delayed_batched_torch(*args, **vkw)
        want = {"owners": rows, "summary": K.window_summary(*rows)}
        for lanes in K.lane_counts(n_acceptors):
            for window in (1, 16):
                for skip in (True, False):
                    for collect in ("owners", "summary"):
                        got = K.lease_window_delayed_batched(
                            *args, **{**vkw, "collect": collect}, window=window,
                            skip_stable=skip, lanes=lanes)
                        assert all(torch.equal(a, b) for a, b in zip(got, want[collect])), (
                            variant, lanes, window, skip, collect)


def _bench_sweep(device, n_scenarios):
    """The reference bench's sweep geometry (32 cells x 16 ticks, A 3, P 4)
    with delay <= 2 and drops, as chip_smoke.py phase 19a runs it."""
    traces = [random_trace(s, n_ticks=16, n_cells=32, n_acceptors=3, n_proposers=4,
                           lease_ticks=3, p_attempt=0.5, p_release=0.05, p_down_flip=0.05,
                           max_delay_ticks=2, p_drop=0.05) for s in range(n_scenarios)]
    eng = LeaseArrayEngine(32, n_acceptors=3, n_proposers=4, lease_ticks=3,
                           round_ticks=traces[0].round_ticks, device=device)
    return eng, Scenario.stack([t.scenario() for t in traces])


@pytest.mark.cuda
def test_bench_sweep_at_every_lane_count(cuda_device):
    """The bench sweep's 1024 scenarios at every lane count equal the
    plan's own choice, and on the first 16 the plain batched version."""
    eng, stacked = _bench_sweep(cuda_device, 1024)
    for collect in ("owners", "summary"):
        args, kw = _delayed_args(eng, stacked, collect)
        mine = K.lease_window_delayed_batched(*args, **kw)
        head = (*args[:3], *(x[:16] for x in args[3:]))
        want = K.lease_window_delayed_batched_torch(*head, **{
            k: x[:16] if isinstance(x, torch.Tensor) else x for k, x in kw.items()})
        for lanes in K.lane_counts(3):
            got = K.lease_window_delayed_batched(*args, lanes=lanes, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, mine)), (collect, lanes)
            assert all(torch.equal(a[:16], b) for a, b in zip(got, want)), (collect, lanes)


@pytest.mark.cuda
def test_chaos_sweep_summary_equals_its_run_traces(cuda_device):
    """chip_smoke.py phase 19b's chaos sweep (64 scenarios of 2^14 cells x
    128 ticks at DEFAULT_CELL from a warmed engine) in summary mode, at
    every lane count: each scenario's max owner count, owned count and
    final owners equal one ``run_trace`` of it from the same state."""
    from repro_torch.lease_array import engine_from_reference, engine_to_arrays

    mix = dict(n_cells=1 << 14, n_acceptors=5, n_proposers=8, lease_ticks=24,
               max_delay_ticks=4, p_drop=0.05, asymmetric=True, drift_eps=0.25,
               restarts=0.002, renew=0.5, round_ticks=17)
    cfg = dict(lease_ticks=24, round_ticks=17, drift_eps=0.25, device=cuda_device)
    eng = LeaseArrayEngine(1 << 14, n_acceptors=5, n_proposers=8, **cfg)
    warm = random_trace(70, n_ticks=16, **mix)
    warm.prop_restarts[:] = 0
    eng.run_trace(warm.scenario())
    before = engine_to_arrays(eng)
    scs = [random_trace(700 + b, n_ticks=128, **mix).scenario() for b in range(64)]
    args, kw = _delayed_args(eng, Scenario.stack(scs), "summary")
    max_count, owned, final = zip(*(
        (int(cn.max()), int((ow >= 0).sum()), ow[-1])
        for ow, cn in (engine_from_reference(before, **cfg).run_trace(sc) for sc in scs)))
    for lanes in K.lane_counts(5):
        got = K.lease_window_delayed_batched(*args, lanes=lanes, **kw)
        assert got[0].amax(-1).tolist() == list(max_count), lanes
        assert got[1].sum(-1).tolist() == list(owned), lanes
        assert torch.equal(got[2], torch.stack(final)), lanes


def test_batched_wrappers_refuse_cpu_tensors():
    A, P, N, T = 3, 4, 8, 5
    packed = pack_state(init_state(N, A, P, device="cpu"))
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    cols = (z(1, T, N), z(1, T, N), z(1, T, A), z(1, T, P), z(1, T, A))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.lease_window_sync_batched(packed, 0, *cols, majority=2, lease_q4=9,
                                    n_proposers=P)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.lease_window_delayed_batched(
            packed, init_netplane(N, A, device="cpu"), 0, *cols,
            z(1, T, P, A), majority=2, lease_q4=9, round_q4=8, n_proposers=P)


def test_window_summary_reduces_over_ticks():
    owners = torch.tensor([[[0, -1, 2], [1, -1, -1], [1, 3, -1]]],
                          dtype=torch.int32)
    counts = torch.tensor([[[1, 0, 1], [2, 0, 0], [1, 1, 0]]],
                          dtype=torch.int32)
    mx, owned, final = K.window_summary(owners, counts)
    assert mx.tolist() == [[2, 1, 1]]
    assert owned.tolist() == [[3, 1, 1]] and owned.dtype == torch.int32
    assert final.tolist() == [[1, 3, -1]]


def test_plain_batched_versions_count_one_call_per_batch():
    eng = _engine("chaos-a3-n257", "cpu")
    scs = _batch("chaos-a3-n257", B=2)
    K.reset_launches()
    eng.sweep(scs, collect="owners")
    assert K.lease_window_delayed_batched_torch.launches == 1
    assert K.lease_window_delayed_torch.launches == 2  # one per scenario
    assert K.lease_window_delayed_batched.launches == 0
    K.reset_launches()
    assert all(fn.launches == 0 for fn in (
        K.lease_window_delayed_batched, K.lease_window_sync_batched,
        K.lease_window_delayed_batched_torch,
        K.lease_window_sync_batched_torch))
