"""The lease plane split over several devices, on the CPU, against one
device and against ``repro``.

An engine on the card splits ``run_trace``'s cell axis and ``sweep``'s
batch axis over every visible CUDA device (``engine._split_devices``), as
the reference's ``shard_map`` splits them over every JAX device. Here the
device list is substituted by ``[cpu] * n`` (the counterpart of the
reference's tests forcing two host devices), so each shard runs the plain
path on its own slice and the pieces are joined as on the card. Owners,
counts, the engine's state, net, clocks and tick after consecutive split
calls, and every field of a split sweep, must be bit-exact against one
device and against the reference; an axis that does not divide stays on
one device. ``tests/test_torch_multidevice_cuda.py`` runs the same split on
the card over ``[cuda:0] * 2``.
"""
import contextlib

import numpy as np
import pytest

from repro.lease_array import LeaseArrayEngine as RefEngine
from repro.lease_array import Scenario as RefScenario
from repro.lease_array import random_trace as ref_random_trace
from repro_torch.lease_array import LeaseArrayEngine, Scenario
from repro_torch.lease_array import engine as engine_mod
from test_torch_lease_engine import _assert_engines_equal, _same
from test_torch_sweep import _assert_results_equal as _assert_fields_equal

#: name -> (seed, random_trace options); N divides by 2 and 4 (and not by 5)
CASES = {
    "sync": (10, dict(n_cells=24, n_acceptors=5, n_proposers=4, lease_ticks=3)),
    "renewal": (11, dict(n_cells=24, n_acceptors=5, n_proposers=4, lease_ticks=6,
                         p_attempt=0.2, p_release=0.02, renew=0.9,
                         max_delay_ticks=1, round_ticks=5)),
    "chaos": (12, dict(n_cells=16, n_acceptors=3, n_proposers=4, lease_ticks=6,
                       p_attempt=0.12, p_release=0.04, renew=0.5,
                       max_delay_ticks=2, p_drop=0.05, drift_eps=0.25,
                       restarts=0.02, asymmetric=True, round_ticks=5)),
    "restart": (13, dict(n_cells=16, n_acceptors=3, n_proposers=4, lease_ticks=3,
                         max_delay_ticks=2, p_drop=0.05, restarts=0.03,
                         drift_eps=0.25, asymmetric=True)),
    "extend": (14, dict(n_cells=24, n_acceptors=5, n_proposers=4, lease_ticks=6,
                        p_attempt=0.12, p_release=0.04, renew=0.5,
                        max_delay_ticks=1, p_drop=0.05, round_ticks=5)),
}
N_TICKS = 80
SPLIT_AT = 37


@contextlib.contextmanager
def split_over(n: int, shards: list = None):
    """Every bulk dispatch inside splits over ``n`` copies of the engine's
    device; ``shards`` collects the width of each shard that ran."""
    real_split, real_scan = engine_mod._split_devices, engine_mod._window_scan_impl

    def counting_scan(state, *args, **kw):
        if shards is not None:
            shards.append(state.n_cells)
        return real_scan(state, *args, **kw)

    engine_mod._split_devices = lambda dev: [dev] * n
    engine_mod._window_scan_impl = counting_scan
    try:
        yield
    finally:
        engine_mod._split_devices, engine_mod._window_scan_impl = real_split, real_scan


def _engines(tr):
    cfg = dict(n_acceptors=tr.n_acceptors, n_proposers=tr.n_proposers,
               lease_ticks=tr.lease_ticks, round_ticks=tr.round_ticks,
               drift_eps=tr.drift_eps)
    return (RefEngine(tr.n_cells, backend="jnp", **cfg),
            LeaseArrayEngine(tr.n_cells, device="cpu", **cfg),
            LeaseArrayEngine(tr.n_cells, device="cpu", **cfg),
            LeaseArrayEngine(tr.n_cells, device="cpu", **cfg))


def _assert_results_equal(ref, port):
    """Every SweepResult field bit-exact (owned_frac within one float32
    ulp), the margins component by component."""
    _assert_fields_equal(ref._replace(margins=None), port._replace(margins=None))
    if ref.margins is not None:
        assert sorted(port.margins) == sorted(ref.margins)
        for k, v in ref.margins.items():
            _same(v, port.margins[k], k)


def _port(jsc) -> Scenario:
    return Scenario(dict(jsc.planes))


def _assert_port_engines_equal(a, b):
    for x, y in zip((*a.state, *a.net, a.last_owner_count),
                    (*b.state, *b.net, b.last_owner_count)):
        assert x.device == y.device and x.is_contiguous()
        assert bool((x == y).all())
    assert a.t == b.t
    for k in ("prop_clk", "acc_clk", "_rc", "_deaf_until"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    assert (a._netplane_active, a._restart_active) == (b._netplane_active, b._restart_active)


@pytest.mark.parametrize("case", sorted(CASES))
def test_split_run_trace_equals_one_device_and_reference(case):
    seed, opts = CASES[case]
    tr = ref_random_trace(seed, n_ticks=N_TICKS, **opts)
    jsc = tr.scenario()
    parts = (jsc[:SPLIT_AT], jsc[SPLIT_AT:])
    ref, one, two, four = _engines(tr)
    want = [ref.run_trace(p) for p in parts]
    solo = [one.run_trace(_port(p)) for p in parts]
    for n, eng in ((2, two), (4, four)):
        shards = []
        with split_over(n, shards):
            got = [eng.run_trace(_port(p)) for p in parts]
        assert shards == [tr.n_cells // n] * (2 * n), shards
        for (gow, gcn), (sow, scn), (wow, wcn) in zip(got, solo, want):
            assert bool((gow == sow).all()) and bool((gcn == scn).all())
            _same(wow, gow, f"owners, {n} devices")
            _same(wcn, gcn, f"counts, {n} devices")
            assert int(gcn.max()) <= 1
        _assert_port_engines_equal(eng, one)
        _assert_engines_equal(ref, eng)


def test_uneven_cells_stay_on_one_device():
    """N 24 over 5 devices does not divide: one shard of every cell, the
    same result as one device and as the reference."""
    seed, opts = CASES["chaos"]
    tr = ref_random_trace(seed, n_ticks=40, **{**opts, "n_cells": 24})
    ref, one, split, _ = _engines(tr)
    jsc = tr.scenario()
    shards = []
    with split_over(5, shards):
        got = split.run_trace(_port(jsc))
    assert shards == [24]
    want, solo = ref.run_trace(jsc), one.run_trace(_port(jsc))
    for g, s, w in zip(got, solo, want):
        assert bool((g == s).all())
        _same(w, g)
    _assert_port_engines_equal(split, one)


def test_one_device_takes_todays_path(monkeypatch):
    """With one device neither split helper runs: the dispatch is the
    one-card dispatch."""
    def refuse(*a, **k):
        raise AssertionError("a one-device engine took the split path")

    monkeypatch.setattr(engine_mod, "_split_trace", refuse)
    monkeypatch.setattr(engine_mod, "_split_sweep", refuse)
    seed, opts = CASES["extend"]
    tr = ref_random_trace(seed, n_ticks=20, **opts)
    eng = _engines(tr)[1]
    assert engine_mod._split_devices(eng.device) == [eng.device]
    eng.run_trace(_port(tr.scenario()))
    eng.sweep([_port(tr.scenario())] * 2)


SWEEP_GEOM = dict(n_cells=8, n_acceptors=3, n_proposers=4)


def _sweep_traces(rt, n=8):
    return [rt(700 + s, n_ticks=24, lease_ticks=6, p_attempt=0.15, p_release=0.04,
               max_delay_ticks=1, p_drop=0.05, drift_eps=0.25, restarts=0.02,
               renew=0.5, asymmetric=bool(s % 2), round_ticks=5, **SWEEP_GEOM)
            for s in range(n)]


@pytest.mark.parametrize("collect", ["summary", "owners", "margins"])
def test_split_sweep_equals_one_device_and_reference(collect):
    """The chaos mix (restarts, drift, delay, drops, renewals) from an
    engine that already ran a trace: B 8 split over 2 and 4 devices."""
    ref_scs = [t.scenario() for t in _sweep_traces(ref_random_trace)]
    scs = [_port(s) for s in ref_scs]
    warm = ref_random_trace(9, n_ticks=7, lease_ticks=6, max_delay_ticks=1,
                            round_ticks=5, **SWEEP_GEOM).scenario()
    kw = dict(lease_ticks=6, round_ticks=5, drift_eps=0.25, **SWEEP_GEOM)
    ref = RefEngine(backend="jnp", **kw)
    ref.run_trace(warm)
    want = ref.sweep(RefScenario.stack(ref_scs), collect=collect)
    engines = []
    for n in (1, 2, 4):
        eng = LeaseArrayEngine(device="cpu", **kw)
        eng.run_trace(_port(warm))
        engines.append(eng)
    solo = engines[0].sweep(Scenario.stack(scs), collect=collect)
    _assert_results_equal(want, solo)
    for n, eng in zip((2, 4), engines[1:]):
        with split_over(n):
            got = eng.sweep(Scenario.stack(scs), collect=collect)
        for field in got._fields:
            g, s = getattr(got, field), getattr(solo, field)
            if isinstance(s, dict):
                assert all(bool((g[k] == s[k]).all()) for k in s), field
            elif s is None:
                assert g is None, field
            else:
                assert g.shape == s.shape and bool((g == s).all()), field
        _assert_results_equal(want, got)
        _assert_port_engines_equal(eng, engines[0])  # a sweep leaves it as it was


def test_uneven_batch_stays_on_one_device(monkeypatch):
    calls = []
    real = engine_mod._sweep_scan_impl

    def counting(state, net, t0, clk0, rst0, planes, **kw):
        calls.append(int(planes["attempts"].shape[0]))
        return real(state, net, t0, clk0, rst0, planes, **kw)

    monkeypatch.setattr(engine_mod, "_sweep_scan_impl", counting)
    scs = [_port(t.scenario()) for t in _sweep_traces(ref_random_trace, n=6)]
    eng = LeaseArrayEngine(device="cpu", lease_ticks=6, round_ticks=5,
                           drift_eps=0.25, **SWEEP_GEOM)
    with split_over(4):
        uneven = eng.sweep(scs, collect="owners")
    with split_over(3):
        even = eng.sweep(scs, collect="owners")
    assert calls == [6, 2, 2, 2]
    assert bool((uneven.owners == even.owners).all())
