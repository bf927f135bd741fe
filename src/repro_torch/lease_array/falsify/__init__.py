"""Coverage-guided falsification of the §4 at-most-one-owner guarantee, on
the port's engine: the counterpart of ``repro.lease_array.falsify``, with
the same seeded search (the numpy mutation, selection, lineage tags and
digests are copies of the reference's, so a seed gives the same search).

A PRNG-keyed population of :class:`~repro_torch.lease_array.scenario.Scenario`
planes is evolved toward the invariant boundary with structure-aware
mutations (:mod:`.mutate`), scored by the margin reductions of ONE
``engine.sweep(collect="margins")`` a generation (the whole population in
one batched tick loop on the engine's device), and elitist-selected on
boundary proximity (:mod:`.search`). A violating survivor is minimized by
the greedy shrinker (:mod:`.shrink`; each probe a one-scenario summary
sweep through the batched lease kernels on the card) and identified by its
plane digest and mutation lineage. ``falsify/corpus/`` holds the known bug
species as regression fixtures (a copy of the reference's).

Run it: ``python -m repro_torch.lease_array.falsify --mode corrupt --expect
violation`` (the corruption-plane negative control proving the alarm can
fire) / ``--mode honest --expect none`` (the actual falsification run); on
the card by default, ``--device cpu`` on the host.
"""
from .corpus import CORPUS_DIR, load_corpus, load_scenario, save_scenario
from .mutate import MUTATION_OPS, MutationSpace, mutate
from .search import (
    FalsifyConfig,
    FalsifyResult,
    margin_score,
    random_population,
    search,
)
from .shrink import shrink

__all__ = [
    "CORPUS_DIR",
    "FalsifyConfig",
    "FalsifyResult",
    "MUTATION_OPS",
    "MutationSpace",
    "load_corpus",
    "load_scenario",
    "margin_score",
    "mutate",
    "random_population",
    "save_scenario",
    "search",
    "shrink",
]
