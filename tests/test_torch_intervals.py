"""The port's interval analysis (``repro_torch.analysis.staticcheck.
intervals``) and the static pack-budget gate of ``LeaseArrayEngine``.

The analysis walks the aten graphs ``make_fx`` traces of the port's own
tick cores. It is held to what the reference's tests hold the reference
to, without calling the reference's analyzer (``repro.analysis.
staticcheck`` needs a jax with ``jax.core.Literal``):

  - the derived bound equals the hand bound ``state.max_pack_tick`` of
    both packages on the grid of ``tests/test_pack_budget.py`` (P x clock
    rate x restarts), and stays within the reference's inequality under
    link delays;
  - a round horizon the hand check cannot see is refused at 100 ticks and
    proven safe at 3; both engine entries (``run_trace``, ``sweep``) refuse
    the 100-tick replay and run the 3-tick one and the default configs;
  - the tick number as a Python int and as a 0-d int32 tensor gives the
    same bits in every core variant;
  - soundness: on seeded scenarios (delays, drops, drift, restarts,
    extends, corruption), a ``torch.fx.Interpreter`` run of the traced core
    on every tick's concrete planes keeps every node's values inside that
    node's interval.
"""
import warnings

import numpy as np
import pytest
import torch

import repro_torch.lease_array.engine as engine_mod
from repro.lease_array import state as jstate
from repro_torch.analysis.staticcheck import intervals as IA
from repro_torch.analysis.staticcheck.intervals import (
    TickConfig,
    analyze_tick_config,
    derived_max_pack_tick,
    node_intervals,
    trace_tick_core,
)
from repro_torch.analysis.staticcheck.purity import DELAYED_VARIANTS
from repro_torch.lease_array import LeaseArrayEngine, Scenario, random_trace
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array import netplane as tnet
from repro_torch.lease_array import ref as tref
from repro_torch.lease_array import state as tstate

LEASE_Q4 = 13
I32 = torch.int32

# round_ticks chosen so round deadlines (rnd_clk + 4*round_ticks) sit just
# under int32 max at t=0 and cross it within ~100 ticks — invisible to
# check_pack_budget, which never consults round_q4
HUGE_ROUND_TICKS = 536_870_900
HUGE_ROUND_Q4 = 4 * HUGE_ROUND_TICKS


# ------------------------------------------------------ the derived bound
@pytest.mark.parametrize("n_proposers", [2, 3, 8, 16])
@pytest.mark.parametrize("max_rate", [tstate.QUARTERS, 9])
@pytest.mark.parametrize("max_restarts", [0, 1, tstate.MAX_RESTARTS])
def test_derived_bound_equals_both_hand_bounds(n_proposers, max_rate,
                                               max_restarts):
    """The interval analysis re-derives the hand bound to the tick from the
    traced core, with no knowledge of the formula, in the honest encoding
    and the restart-counter carve; the port's hand bound is the
    reference's."""
    hand = jstate.max_pack_tick(n_proposers, LEASE_Q4, 0, max_rate, 0,
                                max_restarts)
    assert tstate.max_pack_tick(n_proposers, LEASE_Q4, 0, max_rate, 0,
                                max_restarts) == hand
    assert derived_max_pack_tick(n_proposers, LEASE_Q4, 0, max_rate, 0,
                                 max_restarts=max_restarts) == hand


@pytest.mark.parametrize("max_delay", [1, 3])
def test_hand_bound_never_optimistic_under_delay(max_delay):
    hand = jstate.max_pack_tick(8, LEASE_Q4, max_delay)
    derived = derived_max_pack_tick(8, LEASE_Q4, max_delay)
    assert hand <= derived <= hand + tstate.QUARTERS * max_delay + 1


def test_huge_round_horizon_overflows_at_100_ticks_only():
    tstate.check_pack_budget(100, 2, LEASE_Q4, 0)  # the hand check is blind
    hot = TickConfig(t_end=100, n_proposers=2, n_acceptors=3,
                     lease_q4=LEASE_Q4, round_q4=HUGE_ROUND_Q4)
    assert "int32-overflow" in {f.rule for f in analyze_tick_config(hot)}
    short = TickConfig(t_end=3, n_proposers=2, n_acceptors=3,
                       lease_q4=LEASE_Q4, round_q4=HUGE_ROUND_Q4)
    assert analyze_tick_config(short) == []


def _variant_cfgs():
    yield "sync", TickConfig(t_end=64, sync=True, lease_q4=LEASE_Q4), "gather"
    for legs, corrupt, restart, extend in DELAYED_VARIANTS:
        yield (f"{legs}-c{int(corrupt)}-r{int(restart)}-e{int(extend)}",
               TickConfig(t_end=64, lease_q4=LEASE_Q4, max_delay=2,
                          corrupt=corrupt, max_restarts=3 * restart,
                          extend=extend), legs)


@pytest.mark.parametrize("label", [label for label, _, _ in _variant_cfgs()])
def test_no_unknown_primitive_on_any_real_core(label):
    cfg, legs = {lb: (c, lg) for lb, c, lg in _variant_cfgs()}[label]
    assert analyze_tick_config(cfg, legs=legs) == []


# ----------------------------------------------------- the engine's gate
def _huge_engine(**kw):
    return LeaseArrayEngine(4, n_acceptors=3, n_proposers=2,
                            round_ticks=HUGE_ROUND_TICKS, **kw)


def _reference_analysis_runs() -> bool:
    """The reference's analyzer reads ``jax.core.Literal``, which some jax
    releases no longer have; there its engine skips the gate with a
    warning."""
    import jax

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return hasattr(jax.core, "Literal")


@pytest.mark.parametrize("entry", ["run_trace", "sweep"])
def test_engine_refuses_the_huge_round_horizon(entry):
    """The fault the gate fixes: the hand check passes this replay, the
    traced core can wrap int32; the port refuses it before any work, and
    runs the same config at 3 ticks. Where the reference's analysis runs,
    the reference engine refuses it too."""
    sc = Scenario.build(100, n_cells=4, n_acceptors=3, n_proposers=2)
    eng = _huge_engine(device="cpu")
    call = (lambda e, s: e.run_trace(s)) if entry == "run_trace" else (
        lambda e, s: e.sweep([s]))
    with pytest.raises(ValueError, match="static analysis refused"):
        call(eng, sc)
    assert eng.t == 0
    call(eng, sc[:3])
    if _reference_analysis_runs():
        from repro.lease_array import LeaseArrayEngine as RefEngine
        from repro.lease_array import Scenario as RefScenario

        ref = RefEngine(4, n_acceptors=3, n_proposers=2,
                        round_ticks=HUGE_ROUND_TICKS)
        rsc = RefScenario.build(100, n_cells=4, n_acceptors=3, n_proposers=2)
        with pytest.raises(ValueError, match="static analysis refused"):
            call(ref, rsc)
    assert engine_mod._STATIC_CHECK_FAILED is False


def test_engine_accepts_default_configs_and_the_gate_never_failed():
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        eng = LeaseArrayEngine(8, n_acceptors=5, n_proposers=8, device="cpu")
        sc = Scenario.build(20, n_cells=8, n_acceptors=5, n_proposers=8,
                            attempts=np.zeros((20, 8), np.int32))
        owners, counts = eng.run_trace(sc)
        assert owners.shape == (20, 8)
        assert (owners[-1] == 0).all()
        res = eng.sweep([sc, sc])
        assert int(res.max_owner_count.max()) == 1
    assert engine_mod._STATIC_CHECK_FAILED is False


def test_gate_caches_per_config_and_t_end():
    engine_mod._static_pack_findings.cache_clear()
    eng = LeaseArrayEngine(8, n_acceptors=5, n_proposers=8, device="cpu")
    sc = Scenario.build(5, n_cells=8, n_acceptors=5, n_proposers=8)
    eng.run_trace(sc)
    eng.run_trace(sc)  # a new t_end: a fresh walk of the cached trace
    fresh = LeaseArrayEngine(8, n_acceptors=5, n_proposers=8, device="cpu")
    fresh.run_trace(sc)  # the first key again: a cache hit
    info = engine_mod._static_pack_findings.cache_info()
    assert (info.hits, info.misses) == (1, 2)


def test_a_failing_analyzer_warns_once_and_falls_back(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("analyzer exploded")

    monkeypatch.setattr(engine_mod, "_static_pack_findings", boom)
    monkeypatch.setattr(engine_mod, "_STATIC_CHECK_FAILED", False)
    eng = LeaseArrayEngine(4, n_acceptors=3, n_proposers=2, device="cpu")
    sc = Scenario.build(5, n_cells=4, n_acceptors=3, n_proposers=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng.run_trace(sc)
        eng.run_trace(sc)
    msgs = [x for x in w if issubclass(x.category, RuntimeWarning)
            and "static pack-budget analysis unavailable" in str(x.message)]
    assert len(msgs) == 1
    assert engine_mod._STATIC_CHECK_FAILED is True


# ------------------------------------------------- the tick as a tensor
def _random_planes(rng, A, P, bn, t, corrupt, restart, extend):
    """One tick's packed state and inputs around tick ``t``: live and
    expired leases, due and future slots, open rounds."""
    top, t4 = (t + 1) * P, 4 * t

    def packed(shape, p=0.6):
        v = (rng.integers(t4 - 8, t4 + 40, shape) << 15) | rng.integers(1, top, shape)
        return np.where(rng.random(shape) < p, v, 0)

    def ids(shape):
        return rng.integers(-1, P, shape)

    sa, sr = (A, bn), (1, bn)
    lease = [rng.integers(0, top + P, sa), packed(sa), ids(sr), packed(sr)]
    rb = np.where(rng.random(sr) < 0.5, rng.integers(1, top, sr), 0)
    net = [packed(sa, 0.4), packed(sa, 0.4), ids(sa), packed(sa, 0.4),
           packed(sa, 0.4), packed(sa, 0.4), rb,
           np.where(rb > 0, rng.integers(1, 3, sr), 0),
           rng.integers(t4, t4 + 20, sr), rng.integers(t4, t4 + 20, sr),
           rng.integers(0, 1 << A, sr), rng.integers(0, 1 << A, sr)]
    inputs = [ids(sr), ids(sr), rng.integers(0, 2, (A, 1)),
              rng.integers(t4, t4 + 4, (P, 1)), rng.integers(t4, t4 + 4, (A, 1))]
    link = (rng.integers(0, 3, (P, A)) << 1) | (rng.random((P, A)) < 0.2)
    adv = {}
    if corrupt:
        adv.update(stale=rng.integers(0, 2, (A, 1)), equiv=rng.integers(0, 2, (A, 1)))
    if restart:
        adv.update(acc_restart=rng.integers(0, 2, (A, 1)),
                   acc_deaf=rng.integers(0, 2, (A, 1)),
                   prop_restart=rng.integers(0, 2, (P, 1)),
                   prop_rc=rng.integers(0, 4, (P, 1)))
    if extend:
        adv["extend"] = ids(sr)
    as_t = lambda x: torch.as_tensor(np.asarray(x), dtype=I32)  # noqa: E731
    return ([as_t(x) for x in lease], [as_t(x) for x in net],
            [as_t(x) for x in inputs], as_t(link),
            {k: as_t(v) for k, v in adv.items()})


@pytest.mark.parametrize("variant", ["sync"] + [
    f"{legs}-c{int(c)}-r{int(r)}-e{int(e)}" for legs, c, r, e in DELAYED_VARIANTS])
@pytest.mark.parametrize("P", [3, 8])
def test_tick_as_int_and_as_tensor_give_the_same_bits(variant, P):
    A, bn, t = 5, 64, 77
    rng = np.random.default_rng(P * 101 + len(variant))
    corrupt, restart, extend = ("-c1" in variant, "-r1" in variant,
                                "-e1" in variant)
    lease, net, inputs, link, adv = _random_planes(rng, A, P, bn, t, corrupt,
                                                   restart, extend)
    outs = []
    for tick in (t, torch.tensor(t, dtype=I32)):
        if variant == "sync":
            out, count = tref.sync_tick_math(
                lease, tick, *inputs, majority=3, lease_q4=LEASE_Q4,
                n_proposers=P, guard_q4=11)
        else:
            legs = tnet.legs_select if variant.startswith("select") else tnet.legs_gather
            out, netp, count = tnet.delayed_tick_math(
                lease, net, tick, *inputs, link, majority=3,
                lease_q4=LEASE_Q4, round_q4=8, n_proposers=P, guard_q4=11,
                legs=legs, **adv)
            out = (*out, *netp)
        outs.append((*out, count))
    for x, y in zip(*outs):
        assert x.dtype == y.dtype == I32
        assert torch.equal(x, y)


# -------------------------------------------------------------- soundness
class _Ranges(torch.fx.Interpreter):
    """Runs a traced core and keeps every tensor node's [min, max]."""

    def __init__(self, gm, seen):
        super().__init__(gm)
        self.seen = seen

    def run_node(self, n):
        out = super().run_node(n)
        if isinstance(out, torch.Tensor) and out.numel():
            lo, hi = int(out.min()), int(out.max())
            old = self.seen.get(n.name)
            self.seen[n.name] = (lo, hi) if old is None else (
                min(old[0], lo), max(old[1], hi))
        return out


_BN = 8  # the traced block width: the scenarios run 8 cells
SOUNDNESS = {
    "sync": dict(n_ticks=96, lease_ticks=3),
    "delay-drop-drift": dict(n_ticks=96, max_delay_ticks=3, p_drop=0.1,
                             asymmetric=True, drift_eps=0.25, round_ticks=3),
    "restart-renew": dict(n_ticks=128, lease_ticks=6, max_delay_ticks=2,
                          p_drop=0.05, restarts=0.05, renew=0.5,
                          drift_eps=0.1),
    "corrupt": dict(n_ticks=96, lease_ticks=4, max_delay_ticks=1,
                    p_drop=0.05),
}


@pytest.mark.parametrize("name", sorted(SOUNDNESS))
@pytest.mark.parametrize("seed", [3, 19])
def test_interval_analysis_is_sound_on_real_runs(name, seed, monkeypatch):
    kw = SOUNDNESS[name]
    trace = random_trace(seed, n_cells=_BN, n_acceptors=5, n_proposers=4, **kw)
    sc = trace.scenario()
    if name == "corrupt":
        rng = np.random.default_rng(seed)
        T, A = sc.n_ticks, 5
        sc = Scenario.build(n_cells=_BN, n_acceptors=A, n_proposers=4, **{
            **sc.planes,
            "acc_stale": (rng.random((T, A)) < 0.1).astype(np.int32),
            "acc_equiv": (rng.random((T, A)) < 0.1).astype(np.int32)})
    eng = LeaseArrayEngine(
        _BN, n_acceptors=5, n_proposers=4, lease_ticks=trace.lease_ticks,
        round_ticks=trace.round_ticks, drift_eps=trace.drift_eps,
        device="cpu", backend="torch")
    rates = max(int(sc.planes["prop_rate"].max()), int(sc.planes["acc_rate"].max()))
    rc = np.asarray(sc.planes["prop_restart"]).sum(axis=0).max(initial=0)
    cfg = TickConfig(
        t_end=sc.n_ticks, n_proposers=4, n_acceptors=5, lease_q4=eng.lease_q4,
        round_q4=eng.round_q4, guard_q4=eng.guard_q4,
        max_delay=int(np.asarray(sc.planes["delay"]).max()), max_rate=rates,
        sync=name == "sync", corrupt=name == "corrupt",
        max_restarts=max(1, int(rc)) if sc.restarted else 0,
        extend=sc.extended)
    seen, cores = {}, {}

    def core_for(legs):
        key = legs
        if key not in cores:
            gm, layout = IA._core_and_layout(cfg, legs)
            cores[key] = (gm, node_intervals(cfg, legs=legs, core=gm,
                                             layout=layout))
        return cores[key]

    real_delayed, real_sync = K.delayed_tick_math, K.sync_tick_math

    def delayed(lease, net, t, att, rel, up, pclk, aclk, link, **kwargs):
        legs = "select" if kwargs["legs"] is tnet.legs_select else "gather"
        flat = [*lease, *net, torch.tensor(t, dtype=I32), att, rel, up, pclk,
                aclk, link]
        if kwargs.get("stale") is not None:
            flat += [kwargs["stale"], kwargs["equiv"]]
        if kwargs.get("acc_restart") is not None:
            flat += [kwargs[k] for k in ("acc_restart", "acc_deaf",
                                         "prop_restart", "prop_rc")]
        if kwargs.get("extend") is not None:
            flat.append(kwargs["extend"])
        got = _Ranges(core_for(legs)[0], seen).run(*flat)
        want = real_delayed(lease, net, t, att, rel, up, pclk, aclk, link, **kwargs)
        flat_want = [*want[0], *want[1], want[2]]
        assert all(torch.equal(g, w) for g, w in zip(got, flat_want))
        return want

    def sync(lease, t, att, rel, up, pclk, aclk, **kwargs):
        flat = [*lease, torch.tensor(t, dtype=I32), att, rel, up, pclk, aclk]
        got = _Ranges(core_for("gather")[0], seen).run(*flat)
        want = real_sync(lease, t, att, rel, up, pclk, aclk, **kwargs)
        assert all(torch.equal(g, w) for g, w in zip(got, [*want[0], want[1]]))
        return want

    monkeypatch.setattr(K, "delayed_tick_math", delayed)
    monkeypatch.setattr(K, "sync_tick_math", sync)
    eng.run_trace(sc)
    assert len(cores) == 1 and seen
    ivs = next(iter(cores.values()))[1]
    outside = {n: (r, ivs[n]) for n, r in seen.items()
               if not (ivs[n].lo <= r[0] and r[1] <= ivs[n].hi)}
    assert outside == {}
    assert analyze_tick_config(cfg, legs=next(iter(cores))) == []


def test_traces_are_cached_per_protocol_config():
    a = trace_tick_core(8, 5, LEASE_Q4, 4, LEASE_Q4, 3)
    assert trace_tick_core(8, 5, LEASE_Q4, 4, LEASE_Q4, 3) is a
    placeholders = [n for n in a.graph.nodes if n.op == "placeholder"]
    assert len(placeholders) == len(IA._DELAYED_ARGS)
    t_node = placeholders[[k for k, _ in IA._DELAYED_ARGS].index("t")]
    assert tuple(t_node.meta["val"].shape) == ()
