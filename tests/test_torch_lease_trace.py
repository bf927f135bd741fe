"""Traces and scenarios of the PyTorch lease plane against the JAX reference.

``random_trace`` draws from ``numpy.random.default_rng`` in the reference's
order, so one seed must give identical planes in both packages, and
``plane_digest`` must name a scenario with the same 12 hex characters (the
falsifier's corpus fixtures are stamped with it). The Scenario bundle
(build, slicing, concat, stack, validation) must accept and refuse the same
inputs.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.lease_array.scenario as jsc
import repro.lease_array.trace as jtrace
import repro_torch.lease_array.scenario as tsc
import repro_torch.lease_array.trace as ttrace

OPTIONS = {
    "default": dict(),
    "delay": dict(max_delay_ticks=3, p_drop=0.1),
    "asym": dict(max_delay_ticks=2, p_drop=0.05, asymmetric=True),
    "drift": dict(drift_eps=0.25, lease_ticks=5),
    "restart": dict(max_delay_ticks=2, restarts=0.05),
    "renew": dict(max_delay_ticks=1, renew=0.5, lease_ticks=8),
    "chaos": dict(max_delay_ticks=4, p_drop=0.05, asymmetric=True, drift_eps=0.25,
                  restarts=0.02, renew=0.5, lease_ticks=24, round_ticks=17),
}
CORPUS = Path(jsc.__file__).parent / "falsify" / "corpus"


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_random_trace_identical_to_reference(option, seed):
    kw = dict(n_ticks=150, n_cells=24, n_acceptors=5, n_proposers=4, **OPTIONS[option])
    j = jtrace.random_trace(seed, **kw)
    t = ttrace.random_trace(seed, **kw)
    for f in dataclasses.fields(j):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert (a is None) == (b is None), f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
        else:
            assert a == b, f.name
    for prop in ("n_ticks", "delayed", "restarted", "extended", "drifted"):
        assert getattr(j, prop) == getattr(t, prop), prop
    js, ts = j.scenario(), t.scenario()
    assert list(js.planes) == list(ts.planes)
    for k in js.planes:
        np.testing.assert_array_equal(js.planes[k], ts.planes[k], err_msg=k)
    assert jsc.plane_digest(js.planes) == tsc.plane_digest(ts.planes)
    for a, b in zip(j.link_planes(), t.link_planes()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fixture", sorted(p.name for p in CORPUS.glob("*.json")))
def test_plane_digest_matches_corpus_fixture(fixture):
    doc = json.loads((CORPUS / fixture).read_text())
    stored = {k: np.asarray(v, np.int32) for k, v in doc["planes"].items()}
    assert tsc.plane_digest(stored) == doc["digest"]


def test_plane_registry_matches_reference():
    assert list(tsc.PLANES) == list(jsc.PLANES)
    for name, spec in jsc.PLANES.items():
        assert tuple(tsc.PLANES[name]) == tuple(spec), name
    for group in ("CORRUPTION_PLANES", "RESTART_PLANES", "EXTEND_PLANES"):
        assert getattr(tsc, group) == getattr(jsc, group)


def _outcome(fn):
    try:
        return ("ok", fn())
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


BAD_BUILDS = {
    "ghost-id": dict(attempts=np.full((4, 6), 9, np.int32)),
    "below-sentinel": dict(releases=np.full((4, 6), -2, np.int32)),
    "negative-delay": dict(delay=np.full((4, 3), -1, np.int32)),
    "zero-rate": dict(prop_rate=np.zeros((4, 2), np.int32)),
    "bad-shape": dict(acc_up=np.ones((4, 5), np.int32)),
    "unknown": dict(wormholes=np.ones((4, 3), np.int32)),
}


@pytest.mark.parametrize("case", sorted(BAD_BUILDS))
def test_scenario_build_refuses_like_reference(case):
    geom = dict(n_cells=6, n_acceptors=3, n_proposers=2)
    j = _outcome(lambda: jsc.Scenario.build(4, **geom, **BAD_BUILDS[case]))
    t = _outcome(lambda: tsc.Scenario.build(4, **geom, **BAD_BUILDS[case]))
    assert j[0] == t[0] != "ok"
    assert j[1] == t[1]


def test_scenario_composition_matches_reference():
    tr = jtrace.random_trace(2, n_ticks=30, n_cells=6, max_delay_ticks=1, renew=0.5)
    planes = dict(tr.scenario().planes)
    j, t = jsc.Scenario(dict(planes)), tsc.Scenario(dict(planes))
    pairs = [
        (j[3], t[3]),
        (j[4:9], t[4:9]),
        (j[:10].concat(j[10:20], j[20:]), t[:10].concat(t[10:20], t[20:])),
        (jsc.Scenario.stack([j[:5], j[5:10]]), tsc.Scenario.stack([t[:5], t[5:10]])),
    ]
    for a, b in pairs:
        assert type(a).__name__ == type(b).__name__
        assert list(a.planes) == list(b.planes)
        for k in a.planes:
            np.testing.assert_array_equal(np.asarray(a.planes[k]), b.planes[k])
    assert (t.n_ticks, t.n_cells, t.n_acceptors, t.n_proposers) == (
        j.n_ticks, j.n_cells, j.n_acceptors, j.n_proposers)
    for prop in ("delayed", "drifted", "corrupted", "restarted", "extended"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert repr(t[:2]) == repr(j[:2])
    geom = dict(n_cells=6, n_acceptors=5, n_proposers=4)
    t.validate_for(**geom)
    wrong = dict(geom, n_acceptors=3)
    assert _outcome(lambda: j.validate_for(**wrong)) == _outcome(lambda: t.validate_for(**wrong))
    assert (_outcome(lambda: jsc.Scenario.stack([j[:5], j[:6]]))[1]
            == _outcome(lambda: tsc.Scenario.stack([t[:5], t[:6]]))[1])


def test_make_tick_matches_reference():
    geom = dict(n_cells=5, n_acceptors=3, n_proposers=2)
    kw = dict(attempts=np.array([0, -1, 1, -1, 0]), delay=np.array([1, 0, 2]),
              drop=np.array([True, False, False]))
    j, t = jsc.make_tick(**geom, **kw), tsc.make_tick(**geom, **kw)
    assert isinstance(t, tsc.TickInputs)
    for k in j.planes:
        np.testing.assert_array_equal(np.asarray(j.planes[k]), t.planes[k])
        assert t.planes[k].dtype == np.int32
    bad = dict(attempts=np.array([0, 5, 0, 0, 0]))
    assert (_outcome(lambda: jsc.make_tick(**geom, **bad))
            == _outcome(lambda: tsc.make_tick(**geom, **bad)))
    assert tsc.validate_proposer_ids(np.array([-1, 0, 1]), 2) is None
