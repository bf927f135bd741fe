"""The falsifier and the shard directory on the card, held against the same
runs on the CPU.

Tests marked ``cuda`` run the margins sweep (the batched tick loop on the
card), the seeded search, the shrinker (its probes one launch each of the
batched lease kernels, at B 1 and N 4: a block wider than the cells) and
the directory's failover handoff (every tick one launch of the unbatched
delayed kernel) on the card, and require the CPU run's answers bit for
bit. Without a CUDA device they skip. This file imports no JAX, so it runs
on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_falsify_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.lease_array import MARGIN_NAMES, LeaseArrayDirectory, Scenario
from repro_torch.lease_array import kernel as K
from repro_torch.lease_array.falsify import (
    FalsifyConfig,
    load_corpus,
    random_population,
    search,
    shrink,
)
from repro_torch.lease_array.scenario import plane_digest

MIXES = {
    "honest": dict(),
    "corrupt": dict(corrupt=True),
    "restarts-extends": dict(restarts=True, extends=True),
    "zero-delay": dict(max_delay=0, p_drop=0.0),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the lease kernels run only on the card")
    return torch.device("cuda")


def _same(a, b):
    fields = ["max_owner_count", "owned_frac", "final_owners"]
    for f in fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
    for k in MARGIN_NAMES if a.margins is not None else ():
        assert torch.equal(a.margins[k].cpu(), b.margins[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("mix", list(MIXES))
def test_margins_on_the_card_match_the_cpu(cuda_device, mix):
    planes = random_population(np.random.default_rng(5),
                               FalsifyConfig(pop_size=512, **MIXES[mix]))
    got, want = (FalsifyConfig(device=d, **MIXES[mix]).engine().sweep(
        Scenario(planes), collect="margins", verify=False) for d in ("cuda", "cpu"))
    assert got.margins["tie_q4"].device.type == "cuda"
    _same(got, want)


@pytest.mark.cuda
def test_corpus_fixtures_on_the_card(cuda_device):
    for name, (sc, meta) in load_corpus().items():
        cfg = FalsifyConfig(n_cells=sc.n_cells, n_acceptors=sc.n_acceptors,
                            n_proposers=sc.n_proposers, n_ticks=sc.n_ticks,
                            **meta["engine"])
        got = cfg.engine().sweep([sc], collect="margins", verify=False)
        for comp, want in meta["expect_margins"].items():
            assert int(got.margins[comp][0]) == want, (name, comp)


@pytest.mark.cuda
@pytest.mark.parametrize("corrupt", [True, False], ids=["corrupt", "honest"])
def test_search_on_the_card_matches_the_cpu(cuda_device, corrupt):
    control = dict(corrupt=corrupt, seed=7, pop_size=128, generations=6)
    got = search(FalsifyConfig(**control))
    want = search(FalsifyConfig(device="cpu", **control))
    assert (got.found, got.lineage, got.digest, got.evaluations) == (
        want.found, want.lineage, want.digest, want.evaluations)
    np.testing.assert_array_equal(got.survivor_scores, want.survivor_scores)
    np.testing.assert_array_equal(got.random_scores, want.random_scores)
    assert got.found == corrupt


@pytest.mark.cuda
def test_shrink_on_the_card_probes_through_the_batched_kernels(cuda_device):
    found = search(FalsifyConfig(corrupt=True, seed=7, pop_size=128,
                                 generations=6, device="cpu"))
    K.reset_launches()
    small = shrink(found.violation, FalsifyConfig().engine(), budget=120)
    assert K.lease_window_delayed_batched.launches > 0
    assert K.lease_window_delayed_batched_torch.launches == 0
    want = shrink(found.violation, FalsifyConfig(device="cpu").engine(), budget=120)
    assert plane_digest(small.planes) == plane_digest(want.planes)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["zero-delay", "corrupt", "restarts-extends"])
@pytest.mark.parametrize("collect", ["summary", "owners"])
def test_probe_geometry_masks_its_tail(cuda_device, mix, collect):
    """A shrinker probe's launch: one scenario of 4 cells (a block of 32
    threads, 28 of them past the cells) equals the plain loop."""
    kw = dict(MIXES[mix], drift=mix != "zero-delay")
    planes = random_population(np.random.default_rng(3),
                               FalsifyConfig(pop_size=8, **kw))
    for b in range(8):
        one = Scenario({k: v[b:b + 1] for k, v in planes.items()})
        K.reset_launches()
        got = FalsifyConfig().engine().sweep(one, collect=collect, verify=False)
        kernel = (K.lease_window_sync_batched if mix == "zero-delay"
                  else K.lease_window_delayed_batched)
        assert kernel.launches == 1
        want = FalsifyConfig(device="cpu").engine().sweep(one, collect=collect,
                                                          verify=False)
        _same(got, want)
        if collect == "owners":
            assert torch.equal(got.owners.cpu(), want.owners)
            assert torch.equal(got.counts.cpu(), want.counts)


def _handoff(device):
    """The bench's failover handoff (1024 shards, 8 workers, A 5, lease 24,
    delay <= 2): (handoff ticks, owner rows)."""
    d = LeaseArrayDirectory(1024, n_acceptors=5, lease_ticks=24, max_workers=8,
                            max_delay_ticks=2, device=device)
    for i in range(8):
        d.add_worker(i, 128)
    rows = [d.tick(1).copy() for _ in range(40)]
    d.stall(0)
    for i in range(1, 8):
        d.set_target(i, 1024 // 7 + 1)
    ticks = 0
    while (d.owned_count(0) > 0 or d.coverage() < 0.95) and ticks < 400:
        rows.append(d.tick(1).copy())
        ticks += 1
    return ticks, np.stack(rows)


@pytest.mark.cuda
def test_directory_on_the_card_matches_the_cpu(cuda_device):
    K.reset_launches()
    ticks, rows = _handoff("cuda")
    assert K.lease_window_delayed.launches == len(rows)
    assert K.lease_window_delayed_torch.launches == 0
    cpu_ticks, cpu_rows = _handoff("cpu")
    assert ticks == cpu_ticks == 31
    np.testing.assert_array_equal(rows, cpu_rows)
