"""The port's falsifier (``repro_torch.lease_array.falsify``) against the
reference's, and the reference's own contracts on it.

Everything runs ``device="cpu"``: the margins sweep is the port's batched
tick loop, the shrinker's probes the plain batched window loop. The numpy
parts are copies of the reference's, so the same seed must give the same
population, mutants, search (found, lineage, digest, evaluations, scores)
and shrunk scenario. The corpus fixtures are byte-identical copies. The
card runs the same search in ``tests/test_torch_falsify_cuda.py`` and
``chip_smoke.py`` phase 20.
"""
import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from repro.lease_array.falsify import FalsifyConfig as RefConfig
from repro.lease_array.falsify import mutate as ref_mutate
from repro.lease_array.falsify import random_population as ref_random_population
from repro.lease_array.falsify import search as ref_search
from repro.lease_array.falsify import shrink as ref_shrink
from repro.lease_array.falsify.corpus import CORPUS_DIR as REF_CORPUS_DIR
from repro.lease_array.scenario import plane_digest as ref_plane_digest
from repro_torch.lease_array import Scenario, replay_array, replay_event_sim
from repro_torch.lease_array.falsify import (
    CORPUS_DIR,
    FalsifyConfig,
    load_corpus,
    load_scenario,
    margin_score,
    mutate,
    random_population,
    search,
    shrink,
)
from repro_torch.lease_array.falsify.search import replace_config
from repro_torch.lease_array.scenario import (
    CORRUPTION_PLANES,
    PLANES,
    RESTART_PLANES,
    plane_digest,
)
from repro_torch.lease_array.state import MAX_RESTARTS
from repro_torch.lease_array.trace import trace_from_scenario

SRC = Path(__file__).resolve().parents[1] / "src"

#: the seeded controls of the reference's tests: corrupt must violate,
#: honest must not (seed 7, pop 128, 6 generations)
CONTROL = dict(seed=7, pop_size=128, generations=6)


def _cfg(**kw):
    return FalsifyConfig(device="cpu", **kw)


def _ref_cfg(cfg):
    return RefConfig(**{k: v for k, v in asdict(cfg).items() if k != "device"})


def _seed_planes(cfg, seed=0):
    return random_population(np.random.default_rng(seed), cfg)


def _nonzero(sc):
    return sum(int((np.asarray(sc.planes[k]) != s.default).sum())
               for k, s in PLANES.items())


@pytest.fixture(scope="module")
def corrupt_control():
    return search(_cfg(corrupt=True, **CONTROL))


# ------------------------------------------------------------------ corpus

def test_corpus_copies_are_byte_identical():
    names = sorted(p.name for p in CORPUS_DIR.glob("*.json"))
    assert names == sorted(p.name for p in REF_CORPUS_DIR.glob("*.json"))
    for name in names:
        assert (CORPUS_DIR / name).read_bytes() == (REF_CORPUS_DIR / name).read_bytes()
    assert "repro_torch" in CORPUS_DIR.parts


def test_corpus_loads_and_names_species():
    corpus = load_corpus()
    assert set(corpus) == {"tie", "ghost", "restart", "extend"}
    assert corpus["tie"][1]["species"] == "guarded-expiry-tie"
    assert corpus["ghost"][1]["species"] == "ghost-lease"
    assert corpus["restart"][1]["species"] == "deaf-window-boundary"
    assert corpus["extend"][1]["species"] == "extend-expiry-tie"


@pytest.mark.parametrize("name", ["tie", "ghost", "restart", "extend"])
def test_corpus_fixture_ranks_top_percentile(name):
    """Each known species sits at its recorded boundary distance and within
    the top percentile of a random batch under the same engine."""
    fixture, meta = load_corpus()[name]
    cfg = _cfg(n_cells=fixture.n_cells, n_acceptors=fixture.n_acceptors,
               n_proposers=fixture.n_proposers, n_ticks=fixture.n_ticks,
               **meta["engine"])
    eng = cfg.engine()
    got = eng.sweep([fixture], collect="margins", verify=False)
    for comp, expect in meta["expect_margins"].items():
        assert int(got.margins[comp][0]) == expect, comp
    rand = eng.sweep(Scenario(_seed_planes(cfg, 2024)), collect="margins",
                     verify=False)
    for comp, expect in meta["expect_margins"].items():
        floor = np.percentile(rand.margins[comp].numpy(), 1)
        assert expect <= floor, (comp, expect, floor)


def test_corpus_digests_are_intact(tmp_path):
    """load_scenario re-hashes the stored planes: a hand-edited fixture
    fails loudly (the tampered copy lives in tmp_path, not the corpus)."""
    doc = json.loads((CORPUS_DIR / "tie.json").read_text())
    doc["planes"]["attempts"][0][0] = 3
    tampered = tmp_path / "tampered.json"
    tampered.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="drifted"):
        load_scenario(tampered)


# ---------------------------------------------------------------- mutation

@pytest.mark.parametrize("kw", [dict(), dict(corrupt=True), dict(restarts=True),
                                dict(extends=True, drift=False)],
                         ids=["honest", "corrupt", "restarts", "extends"])
def test_population_and_mutants_match_reference(kw):
    cfg = _cfg(pop_size=64, **kw)
    planes = _seed_planes(cfg, seed=9)
    ref_planes = ref_random_population(np.random.default_rng(9), _ref_cfg(cfg))
    assert set(planes) == set(ref_planes)
    for k in planes:
        np.testing.assert_array_equal(planes[k], ref_planes[k], err_msg=k)
    rng, ref_rng = np.random.default_rng(42), np.random.default_rng(42)
    for _ in range(5):
        planes, ops = mutate(planes, rng, cfg.mutation_space())
        ref_planes, ref_ops = ref_mutate(ref_planes, ref_rng,
                                         _ref_cfg(cfg).mutation_space())
        np.testing.assert_array_equal(ops, ref_ops)
        for k in planes:
            np.testing.assert_array_equal(planes[k], ref_planes[k], err_msg=k)
    assert cfg.mutation_space().op_names() == _ref_cfg(cfg).mutation_space().op_names()


@pytest.mark.parametrize("B, T, P, A", [(1, 1, 1, 1), (4, 16, 4, 3), (3, 7, 8, 5)])
def test_default_rate_planes_match_reference(B, T, P, A):
    """The drift-free rate planes: int32 tensors equal to the reference's
    numpy fill."""
    import torch

    from repro.lease_array.falsify.mutate import default_rate_planes as ref_default_rate_planes
    from repro_torch.lease_array.falsify.mutate import default_rate_planes

    got = default_rate_planes(B, T, P, A, device="cpu")
    want = ref_default_rate_planes(B, T, P, A)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.dtype == torch.int32 and v.device.type == "cpu"
        assert np.array_equal(v.numpy(), want[k]), k


def test_mutation_is_deterministic():
    cfg = _cfg(pop_size=64, corrupt=True)
    outs = [mutate(_seed_planes(cfg, seed=9), np.random.default_rng(42),
                   cfg.mutation_space()) for _ in range(2)]
    assert np.array_equal(outs[0][1], outs[1][1])
    for k in outs[0][0]:
        assert np.array_equal(outs[0][0][k], outs[1][0][k]), k


def test_mutation_closed_under_validation():
    """Many rounds of mutation keep every member inside the registry's
    legal ranges (ids in [-1, P), delays >= 0, rates >= 1)."""
    cfg = _cfg(pop_size=32, corrupt=True)
    rng = np.random.default_rng(3)
    planes = _seed_planes(cfg, seed=3)
    for _ in range(25):
        planes, _ = mutate(planes, rng, cfg.mutation_space())
    for b in range(cfg.pop_size):
        Scenario({k: v[b] for k, v in planes.items()}).validate_for(
            n_cells=cfg.n_cells, n_acceptors=cfg.n_acceptors,
            n_proposers=cfg.n_proposers)
    assert planes["delay"].min() == 0
    assert planes["prop_rate"].min() >= 1


def test_mutation_only_touches_enabled_planes():
    cfg = _cfg(pop_size=64)
    space = cfg.mutation_space()
    assert not set(space.op_names()) & {
        "flip_stale", "flip_equiv", "crash_insert", "crash_shift",
        "deaf_boundary_nudge"}
    planes = _seed_planes(cfg, seed=1)
    rng = np.random.default_rng(1)
    for _ in range(10):
        planes, _ = mutate(planes, rng, space)
    for k in CORRUPTION_PLANES + RESTART_PLANES:
        assert not planes[k].any()


def test_restart_mutation_closed_under_carve():
    cfg = _cfg(pop_size=32, restarts=True)
    space = cfg.mutation_space()
    assert set(space.op_names()) >= {"crash_insert", "crash_shift",
                                     "deaf_boundary_nudge"}
    rng = np.random.default_rng(11)
    planes = _seed_planes(cfg, seed=11)
    for _ in range(25):
        planes, _ = mutate(planes, rng, space)
    assert planes["prop_restart"].sum(axis=1).max() <= MAX_RESTARTS
    assert set(np.unique(planes["acc_restart"])) <= {0, 1}


def test_mutants_flow_through_the_batched_sweep():
    cfg = _cfg(pop_size=16)
    planes, _ = mutate(_seed_planes(cfg, seed=4), np.random.default_rng(4),
                       cfg.mutation_space())
    res = cfg.engine().sweep(Scenario(planes), collect="margins", verify=False)
    assert res.max_owner_count.shape == (16,)
    assert all(v.shape == (16,) for v in res.margins.values())
    assert margin_score({k: v.numpy() for k, v in res.margins.items()}).shape == (16,)


# ------------------------------------------------------------------ search

@pytest.mark.parametrize("corrupt", [True, False], ids=["corrupt", "honest"])
def test_search_matches_reference(corrupt, corrupt_control):
    cfg = _cfg(corrupt=corrupt, **CONTROL)
    got = corrupt_control if corrupt else search(cfg)
    ref = ref_search(_ref_cfg(cfg))
    assert (got.found, got.lineage, got.digest, got.generations,
            got.evaluations) == (ref.found, ref.lineage, ref.digest,
                                 ref.generations, ref.evaluations)
    np.testing.assert_array_equal(got.survivor_scores, ref.survivor_scores)
    np.testing.assert_array_equal(got.random_scores, ref.random_scores)
    for k, v in ref.survivor_margins.items():
        np.testing.assert_array_equal(got.survivor_margins[k], v, err_msg=k)
    assert got.found == corrupt
    if corrupt:
        for k, v in ref.violation.planes.items():
            np.testing.assert_array_equal(got.violation.planes[k], v, err_msg=k)


def test_corrupt_search_finds_violation(corrupt_control):
    res = corrupt_control
    assert res.found and res.violation is not None
    assert res.lineage.startswith("s7.")
    assert len(res.digest) == 12
    assert res.evaluations <= 128 * 6
    assert res.digest == plane_digest(res.violation.planes)


def test_sweep_error_carries_digest_and_lineage(corrupt_control):
    res = corrupt_control
    stacked = Scenario({k: np.asarray(v)[None]
                        for k, v in res.violation.planes.items()})
    with pytest.raises(AssertionError) as ei:
        _cfg().engine().sweep(stacked, tags=[res.lineage])
    assert f"digest={res.digest}" in str(ei.value)
    assert f"tag={res.lineage}" in str(ei.value)


def test_honest_search_concentrates_without_violating():
    res = search(_cfg(**CONTROL))
    assert not res.found
    assert res.evaluations == 128 * 6
    assert res.concentrated()


# ------------------------------------------------------------------ shrink

def test_shrink_preserves_the_violation_and_matches_reference(corrupt_control):
    res = corrupt_control
    small = shrink(res.violation, _cfg().engine(), budget=120)
    assert small.n_ticks <= res.violation.n_ticks
    sweep = _cfg().engine().sweep(
        Scenario({k: np.asarray(v)[None] for k, v in small.planes.items()}),
        verify=False)
    assert int(sweep.max_owner_count[0]) > 1
    assert _nonzero(small) <= _nonzero(res.violation)
    ref_small = ref_shrink(res.violation, RefConfig().engine(), budget=120)
    assert plane_digest(small.planes) == ref_plane_digest(ref_small.planes)


def test_shrink_returns_a_clean_scenario_unchanged():
    fixture, _ = load_corpus()["tie"]
    assert shrink(fixture, _cfg().engine(), budget=10) is fixture


def test_replace_config_roundtrip():
    cfg = replace_config(_cfg(), pop_size=8, corrupt=True)
    assert cfg.pop_size == 8 and cfg.corrupt and cfg.device == "cpu"
    assert FalsifyConfig().device == "cuda"


# ------------------------------------------------------------------ triage

def test_triage_rejects_corrupt(corrupt_control):
    with pytest.raises(ValueError, match="Byzantine"):
        trace_from_scenario(corrupt_control.violation, lease_ticks=2,
                            round_ticks=3)


def test_tie_fixture_replays_through_the_referee():
    fixture, meta = load_corpus()["tie"]
    tr = trace_from_scenario(fixture, **meta["engine"])
    ow, cn = replay_array(tr, device="cpu")
    assert np.array_equal(replay_event_sim(tr), ow.numpy())
    assert int(cn.max()) <= 1


# --------------------------------------------------------------------- CLI

@pytest.mark.parametrize("mode,expect,rc", [("corrupt", "violation", 0),
                                            ("honest", "none", 0),
                                            ("honest", "violation", 1)])
def test_cli_honours_expect(tmp_path, mode, expect, rc):
    out = tmp_path / "artifact.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.lease_array.falsify", "--mode",
         mode, "--seed", "7", "--pop", "128", "--generations", "6",
         "--expect", expect, "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == rc, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["found"] == (mode == "corrupt")
    assert doc["config"]["device"] == "cpu"
    assert doc["evaluations"] <= 128 * 6
    if mode == "corrupt":
        assert doc["violation"]["shrunk_ticks"] <= 16
        assert len(doc["violation"]["shrunk_digest"]) == 12
    else:
        assert doc["concentrated"]
