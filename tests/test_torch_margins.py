"""``LeaseArrayEngine.sweep(collect="margins")`` of the port against the
reference's, bit for bit.

The port runs ``device="cpu"`` (the margin scan is plain torch ops on any
device); the reference runs its jnp margin scan under ``vmap``. Seeded
falsifier populations (``falsify.random_population``, a numpy copy of the
reference's) cover the honest planes, corruption, restarts, extends and
zero delay; every margin component, the max owner count, the final owners
and the owned fraction must be equal. The batch is one tick loop over B·N
columns: it must equal the same scenarios swept one at a time. The card's
margins are held against this CPU path by
``tests/test_torch_falsify_cuda.py`` and ``chip_smoke.py`` phase 20.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.lease_array import Scenario as RefScenario
from repro.lease_array.falsify import FalsifyConfig as RefConfig
from repro_torch.lease_array import (
    MARGIN_BIG,
    MARGIN_NAMES,
    Scenario,
    engine_to_arrays,
    random_trace,
)
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.falsify import FalsifyConfig, random_population
from repro_torch.lease_array.netplane import legs_columns, legs_gather

#: falsifier mixes: FalsifyConfig options over its canonical cell (4 cells,
#: A 3, P 4, 16 ticks, lease 2, round 3, drift 0.25)
MIXES = {
    "honest": dict(),
    "corrupt": dict(corrupt=True),
    "restarts": dict(restarts=True),
    "extends": dict(extends=True),
    "restarts-extends": dict(restarts=True, extends=True),
    "zero-delay": dict(max_delay=0, p_drop=0.0),
    "zero-delay-no-drift": dict(max_delay=0, p_drop=0.0, drift=False),
}


def _population(mix, pop=96, seed=5):
    cfg = FalsifyConfig(pop_size=pop, device="cpu", **MIXES[mix])
    return cfg, random_population(np.random.default_rng(seed), cfg)


def _ref_engine(cfg):
    return RefConfig(**{k: v for k, v in asdict(cfg).items()
                        if k != "device"}).engine()


def _assert_same(got, ref):
    for k in MARGIN_NAMES:
        assert got.margins[k].dtype == torch.int32, k
        np.testing.assert_array_equal(got.margins[k].numpy(), ref.margins[k],
                                      err_msg=k)
    np.testing.assert_array_equal(got.max_owner_count.numpy(),
                                  ref.max_owner_count)
    np.testing.assert_array_equal(got.final_owners.numpy(), ref.final_owners)
    np.testing.assert_array_equal(got.owned_frac.numpy(), ref.owned_frac)


@pytest.mark.parametrize("mix", list(MIXES))
def test_margins_match_reference(mix):
    cfg, planes = _population(mix)
    got = cfg.engine().sweep(Scenario(planes), collect="margins", verify=False)
    ref = _ref_engine(cfg).sweep(RefScenario(planes), collect="margins",
                                 verify=False)
    _assert_same(got, ref)
    assert got.owners is None and got.counts is None
    # the population reaches the boundary species its mix allows
    if cfg.drift:
        assert int(got.margins["tie_q4"].min()) == 0
    if "restarts" in mix:
        assert int(got.margins["deaf_q4"].min()) < MARGIN_BIG
    if mix == "corrupt":
        assert int(got.max_owner_count.max()) > 1, "the alarm fires"


@pytest.mark.parametrize("mix", ["honest", "corrupt", "restarts-extends",
                                 "zero-delay"])
def test_batched_scan_equals_per_scenario_loop(mix):
    """The scan folds B scenarios into the cell axis: scenario b alone
    gives row b of the batch."""
    cfg, planes = _population(mix, pop=12, seed=9)
    eng = cfg.engine()
    batch = eng.sweep(Scenario(planes), collect="margins", verify=False)
    for b in range(cfg.pop_size):
        one = eng.sweep(Scenario({k: v[b:b + 1] for k, v in planes.items()}),
                        collect="margins", verify=False)
        for k in MARGIN_NAMES:
            assert torch.equal(one.margins[k], batch.margins[k][b:b + 1]), (b, k)
        assert torch.equal(one.final_owners, batch.final_owners[b:b + 1])
        assert torch.equal(one.max_owner_count, batch.max_owner_count[b:b + 1])
        assert torch.equal(one.owned_frac, batch.owned_frac[b:b + 1])


def test_margins_from_a_warmed_engine_match_reference():
    """From an engine past tick 0 with drifted clocks, messages in flight
    and a restart history (clk0, rst0 and net all set), margins still equal
    the reference's, and the sweep leaves the engine as it was."""
    cfg, planes = _population("restarts-extends", pop=48, seed=21)
    warm = random_trace(3, n_ticks=10, n_cells=cfg.n_cells,
                        n_acceptors=cfg.n_acceptors,
                        n_proposers=cfg.n_proposers, lease_ticks=2,
                        max_delay_ticks=2, p_drop=0.1, drift_eps=0.25,
                        restarts=0.05, round_ticks=3)
    warm.prop_restarts[:] = 0  # the population's own fit the restart carve
    sc = warm.scenario()
    eng, ref_eng = cfg.engine(), _ref_engine(cfg)
    eng.run_trace(sc)
    ref_eng.run_trace(RefScenario(sc.planes))
    assert eng._rst0() is not None and eng._clk0() is not None
    before = engine_to_arrays(eng)
    got = eng.sweep(Scenario(planes), collect="margins", verify=False)
    ref = ref_eng.sweep(RefScenario(planes), collect="margins", verify=False)
    _assert_same(got, ref)
    after = engine_to_arrays(eng)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_margins_run_no_window_loop_and_verify_names_the_offender():
    """The margin scan is its own tick loop (no plain window loop, no
    kernel), and ``verify=True`` names a violating scenario by digest."""
    cfg, planes = _population("corrupt")
    eng = cfg.engine()
    K.reset_launches()
    res = eng.sweep(Scenario(planes), collect="margins", verify=False)
    assert K.lease_window_delayed_batched_torch.launches == 0
    assert K.lease_window_sync_batched_torch.launches == 0
    assert K.lease_window_delayed_torch.launches == 0
    bad = int(torch.nonzero(res.max_owner_count > 1)[0])
    with pytest.raises(AssertionError, match=f"#{bad} digest=.* tag=x{bad}"):
        eng.sweep(Scenario(planes), collect="margins",
                  tags=[f"x{i}" for i in range(cfg.pop_size)])


def test_legs_columns_is_legs_gather_per_column():
    rng = np.random.default_rng(0)
    P, A, bn = 4, 3, 10
    links = torch.from_numpy(rng.integers(0, 8, (bn, P, A)).astype(np.int32))
    for shape in ((1, bn), (A, bn)):
        prop = torch.from_numpy(rng.integers(-1, P + 1, shape).astype(np.int32))
        dq4, lost = legs_columns(links.permute(1, 2, 0).contiguous(), prop)
        for j in range(bn):
            want_dq4, want_lost = legs_gather(links[j], prop[:, j:j + 1])
            assert torch.equal(dq4[:, j:j + 1], want_dq4)
            assert torch.equal(lost[:, j:j + 1], want_lost)
