"""The seed corpus: known §4 bug species as checked-in Scenario fixtures
(``corpus/`` holds byte-identical copies of the reference's fixtures).

Each fixture is a small JSON file — geometry, engine config, and only the
non-default planes — encoding a scenario that once tripped (or grazed)
the invariant: the guarded-expiry tie of drifting clocks (``tie.json``),
the §3-step-5 ghost lease (``ghost.json``), the deaf-window boundary of a
restart (``restart.json``) and the extend-expiry tie (``extend.json``).
They are *fixed* bugs, so the scenarios no longer violate — they sit exactly ON the boundary, and the
regression tests (tests/test_torch_falsify.py) assert the margin scorer keeps
ranking them in the top percentile of a random batch: a falsifier that
cannot re-find known species cannot be trusted to find new ones.

The JSON is intentionally plain (nested lists, no pickles) so a shrunk
survivor can be pasted into a bug report or checked in as a new fixture
with ``save_scenario``.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..scenario import PLANES, Scenario, plane_digest

__all__ = ["CORPUS_DIR", "load_corpus", "load_scenario", "save_scenario"]

CORPUS_DIR = Path(__file__).resolve().parent / "corpus"


def save_scenario(path, scenario: Scenario, *, meta: dict = None) -> None:
    """Write one scenario as a corpus JSON fixture. Planes that are
    entirely their registered default are omitted (the loader refills
    them), keeping fixtures reviewable; ``meta`` is free-form provenance
    (species name, the PR that fixed it, expected margins...). The
    scenario's ``plane_digest`` is stamped in so a drifted fixture is
    detectable."""
    planes = {}
    for name, spec in PLANES.items():
        arr = np.asarray(scenario.planes[name])
        if not (arr == spec.default).all():
            planes[name] = arr.tolist()
    # digest the stored (non-default) planes only: a plane registered
    # AFTER this fixture was saved defaults in on load and must not
    # invalidate the stored hash
    doc = {
        "meta": dict(meta or {}),
        "digest": plane_digest(planes),
        "n_ticks": scenario.n_ticks,
        "n_cells": scenario.n_cells,
        "n_acceptors": scenario.n_acceptors,
        "n_proposers": scenario.n_proposers,
        "planes": planes,
    }
    Path(path).write_text(json.dumps(doc, indent=1) + "\n")


def load_scenario(path) -> tuple[Scenario, dict]:
    """Load one corpus fixture back into a validated ``Scenario`` (omitted
    planes refill with their registered defaults; the stored digest is
    re-checked). Returns ``(scenario, meta)``."""
    doc = json.loads(Path(path).read_text())
    stored = {
        k: np.asarray(v, np.int32) for k, v in doc["planes"].items()
    }
    got = plane_digest(stored)
    if got != doc["digest"]:
        raise ValueError(
            f"corpus fixture {path} drifted: stored digest {doc['digest']} "
            f"but planes hash to {got} (was a plane edited by hand?)"
        )
    sc = Scenario.build(
        doc["n_ticks"],
        n_cells=doc["n_cells"],
        n_acceptors=doc["n_acceptors"],
        n_proposers=doc["n_proposers"],
        **stored,
    )
    return sc, doc["meta"]


def load_corpus(directory=None) -> dict[str, tuple[Scenario, dict]]:
    """Every ``*.json`` fixture in the corpus directory, keyed by stem."""
    d = CORPUS_DIR if directory is None else Path(directory)
    return {
        p.stem: load_scenario(p) for p in sorted(d.glob("*.json"))
    }
