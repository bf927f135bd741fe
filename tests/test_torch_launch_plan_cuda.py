"""The lease kernels launch the geometry of their launch plan, and refuse a
plan that disagrees with the layout compiled into them.

Tests marked ``cuda`` build ``csrc/lease_window.cu`` and check that

  - a launcher refuses (``cudaErrorInvalidValue``) a plan whose shared
    memory is off by one staging word a tick, a batched sync plan with
    another warp count than kBatchWarps, a block past kBlock and a grid that
    does not cover the cells;
  - every plan the launch audit checks (``window_launch_plans``: each entry,
    each plane-group variant, both collect modes, at the audit's default
    geometry N 4096, A 5, P 8, T 64, B 8, and a ragged one) is the plan the
    wrapper launches, and the launch equals the plain version bit for bit.

Without a CUDA device they skip. This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_launch_plan_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.analysis.staticcheck.launch import (
    check_launch_plan,
    window_launch_plans,
)
from repro_torch.lease_array import Scenario, random_trace
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.netplane import init_netplane
from repro_torch.lease_array.ops import _device_planes, strip_default_planes
from repro_torch.lease_array.state import init_state, pack_state

#: the audit's default geometry, and a ragged one past a block
GEOMETRIES = {"default": dict(), "ragged": dict(n_cells=970, n_acceptors=3,
                                                n_proposers=5, n_ticks=37,
                                                window=3, batch=5)}
LEASE_TICKS, ROUND_TICKS = 8, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda")


def _scenario(plan, seed):
    """A trace of the plan's geometry with every fault plane: delay <= 2
    with drops, drift, restarts, renewals (extends) and corruption."""
    A, P, N, T = plan.n_acceptors, plan.n_proposers, plan.n_cells, plan.n_ticks
    tr = random_trace(seed, n_ticks=T, n_cells=N, n_acceptors=A, n_proposers=P,
                      lease_ticks=LEASE_TICKS, max_delay_ticks=2, p_drop=0.05,
                      drift_eps=0.25, restarts=0.02, renew=0.5,
                      round_ticks=ROUND_TICKS)
    rng = np.random.default_rng(seed)
    return Scenario.build(
        n_cells=N, n_acceptors=A, n_proposers=P,
        **{**tr.scenario().planes,
           "acc_stale": (rng.random((T, A)) < 0.05).astype(np.int32),
           "acc_equiv": (rng.random((T, A)) < 0.05).astype(np.int32)})


def _args(plan, dev):
    """The wrapper's and its plain version's arguments for ``plan``: the
    planes of the variants it carries, [B, T, ...] for a batched entry."""
    A, P, N = plan.n_acceptors, plan.n_proposers, plan.n_cells
    batched = plan.entry.endswith("_batched")
    scs = [_scenario(plan, seed) for seed in range(plan.batch)]
    planes = (Scenario.stack(scs) if batched else scs[0]).planes
    sync = plan.entry in ("lease_window_sync", "lease_window_sync_batched")
    lease_q4 = 4 * LEASE_TICKS + 1
    if sync:
        planes = {k: v for k, v in planes.items()
                  if k in ("attempts", "releases", "acc_up")}
    d = _device_planes(strip_default_planes(planes), dev, None, None, 0,
                       n_proposers=P, n_acceptors=A, lease_q4=lease_q4,
                       restart_guard=True, sync=sync)
    packed = pack_state(init_state(N, A, P, device=dev))
    cols = [d[k] for k in ("attempts", "releases", "acc_up", "pclk", "aclk")]
    kw = dict(majority=A // 2 + 1, lease_q4=lease_q4, n_proposers=P)
    if sync:
        return (packed, 0, *cols), kw
    groups = {"extends": ("extends",), "corrupt": ("stale", "equiv"),
              "restart": ("acc_restart", "acc_deaf", "prop_restart", "prop_rc")}
    for v in K.VARIANTS:
        for name in groups[v]:
            kw[name] = d[name] if v in plan.variant else None
    kw["round_q4"] = 4 * ROUND_TICKS
    net = init_netplane(N, A, device=dev)
    return (packed, net, 0, *cols, d["link"]), kw


def _call(plan, dev, plain=False):
    """Calls the entry of ``plan`` (or its plain version) on fresh inputs,
    with the plan's window and collect mode."""
    args, kw = _args(plan, dev)
    if plan.entry.endswith("_batched"):
        kw["collect"] = plan.collect
    if plain:
        return getattr(K, plan.entry + "_torch")(*args, **kw)
    return getattr(K, plan.entry)(*args, window=plan.tw, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_every_audited_plan_launches_and_matches_plain(cuda_device, geometry):
    for what, plan in window_launch_plans(**GEOMETRIES[geometry]):
        assert check_launch_plan(plan, what=what) == []
        entry = getattr(K, plan.entry)
        entry.plans.clear()
        got = _call(plan, cuda_device)
        want = _call(plan, cuda_device, plain=True)
        torch.cuda.synchronize()
        assert entry.plans == {plan}, what
        for a, b in zip(got, want):
            if isinstance(a, tuple):  # the final lease or net state
                assert all(torch.equal(x, y) for x, y in zip(a, b)), what
            else:
                assert torch.equal(a, b), what


def _tampered(plan, how):
    if how == "staging-word":  # one word a tick more than the layout
        return plan._replace(staged=(*plan.staged, ("extra", 1)))
    if how == "staging-word-less":  # the last plane one word short
        *rest, (name, words) = plan.staged
        return plan._replace(staged=(*rest, (name, words - 1)))
    if how == "warps":  # one warp (and its staging area) more than kBatchWarps
        w = K.SYNC_BATCH_WARPS + 1
        return plan._replace(threads=32 * w, stage_copies=w)
    if how == "block":  # past kBlock, the kernels' __launch_bounds__
        return plan._replace(threads=2 * K.BLOCK_THREADS)
    if how == "grid":  # one block short of the cells
        return plan._replace(grid=(plan.grid[0] - 1, plan.grid[1]))
    raise ValueError(how)


CELL_PLANS = ("sync_launch_plan", "delayed_launch_plan",
              "delayed_batched_launch_plan")


@pytest.mark.cuda
@pytest.mark.parametrize("how,maker", [
    *(("staging-word", m) for m in (*CELL_PLANS, "sync_batched_launch_plan")),
    *(("staging-word-less", m) for m in CELL_PLANS),
    ("warps", "sync_batched_launch_plan"),
    *(("block", m) for m in CELL_PLANS),
    *(("grid", m) for m in (*CELL_PLANS, "sync_batched_launch_plan")),
])
def test_launcher_refuses_a_plan_off_its_layout(cuda_device, monkeypatch,
                                               how, maker):
    plans = dict(window_launch_plans(n_cells=1000, n_acceptors=3,
                                     n_proposers=5, n_ticks=20, batch=5))
    what = {"sync_launch_plan": "lease_window_sync",
            "delayed_launch_plan": "lease_window_delayed[corrupt,restart]",
            "delayed_batched_launch_plan":
                "lease_window_delayed_batched[extends]/summary",
            "sync_batched_launch_plan": "lease_window_sync_batched/owners"}[maker]
    plan = plans[what]
    bad = _tampered(plan, how)
    assert check_launch_plan(bad) != []  # the audit finds it too
    monkeypatch.setattr(K, maker, lambda *a, **k: bad)
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        _call(plan, cuda_device)
    monkeypatch.undo()
    _call(plan, cuda_device)  # the plan as made launches
    torch.cuda.synchronize()


def test_tampered_plans_are_audit_findings():
    """The same tampered plans, on the CPU: each is a launch-audit
    finding, so the launcher's refusal and the audit agree."""
    plans = window_launch_plans(n_cells=1000, n_acceptors=3, n_proposers=5,
                                n_ticks=20, batch=5)
    for what, plan in plans:
        hows = ["staging-word", "grid"]
        hows += (["warps"] if plan.index_map == K.WARP_TILE_MAP
                 else ["staging-word-less", "block"])
        for how in hows:
            assert check_launch_plan(_tampered(plan, how)) != [], (what, how)
