"""The coverage-guided search loop: evolve scenario planes toward §4.

One generation = ONE ``engine.sweep(collect="margins")`` over the whole
population (one batched tick loop on the engine's device; the margins are
[B] reductions, and they move to the host with the §4 verdicts in one copy
a generation), then host-side elitist selection on :func:`margin_score`
and a vectorized mutation pass (:func:`.mutate.mutate`). The numpy parts
(population, selection, mutation, lineage tags) are copies of
``repro.lease_array.falsify.search``'s, so one seed gives the reference's
search whenever the margins agree, which they do bit for bit.

Every member carries a **lineage tag** ``s<seed>.g<gen>.p<parent>.<op>``
(chained, most-recent first) so a violating survivor is reproducible
without the search: ``engine.sweep`` stamps the tag plus the member's
plane digest into the violation error, and :class:`FalsifyResult` carries
the violating ``Scenario`` itself.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..engine import LeaseArrayEngine
from ..ops import MARGIN_NAMES
from ..scenario import Scenario, plane_digest
from ..state import DEFAULT_RATE, MAX_RESTARTS, NO_PROPOSER
from .mutate import MutationSpace, mutate

__all__ = [
    "FalsifyConfig",
    "FalsifyResult",
    "margin_score",
    "random_population",
    "search",
]

#: lineage tags keep this many most-recent hops (older history adds no
#: reproduction power — the planes themselves are the ground truth)
_MAX_LINEAGE_HOPS = 6

#: margin-component weights: a vote still missing from a foreign quorum is
#: scored as 256 quarter-ticks of distance; expiry/guard distances count
#: at 64 per quarter-tick so a 4-quarter miss outranks a missing vote
_W_VOTES, _W_Q4 = 256, 64


@dataclass(frozen=True)
class FalsifyConfig:
    """Geometry + fault ranges + budget of one falsification run.

    The defaults are the **canonical falsifier cell**: small geometry
    (margins care about boundary proximity, not scale), ``lease_ticks=2``
    with ``drift_eps=0.25`` (guard_q4 = 5 — a rate-5 proposer clock meets
    its own guarded expiry on a whole tick, the guarded-expiry tie),
    ``round_ticks=3`` (round_q4 = 12 — just enough abandon headroom for a
    delayed accept quorum to reach the §3 step-5 ghost guard; at
    ``round_ticks=2`` that species is statically unreachable), and
    every honest fault plane enabled (drift + delay + drop + outages).
    ``corrupt=True`` adds the acc_stale/acc_equiv adversarial planes —
    the negative control where the search MUST reach a violation.
    ``device`` is the engine's (the card unless ``"cpu"``); the backend
    follows it, as ``ops.default_backend`` has it.
    """

    n_cells: int = 4
    n_acceptors: int = 3
    n_proposers: int = 4
    n_ticks: int = 16
    lease_ticks: int = 2
    round_ticks: int = 3
    drift_eps: float = 0.25
    device: str = "cuda"
    # population / budget
    seed: int = 0
    pop_size: int = 256
    generations: int = 8
    elite_frac: float = 0.25
    # initial-population fault densities
    p_attempt: float = 0.5
    p_release: float = 0.1
    p_down: float = 0.05
    max_delay: int = 2
    p_drop: float = 0.1
    drift: bool = True
    corrupt: bool = False
    p_corrupt: float = 0.05
    #: enable the crash/restart planes: diskless acceptor restarts (blank
    #: + deaf for M) and proposer restart-counter bumps — honest faults,
    #: so the search must NOT find a violation through them
    restarts: bool = False
    p_restart: float = 0.03
    #: enable the §6 extends plane: owner in-flight renewals — honest
    #: behavior (the gate requires the live owner), so the search must
    #: NOT find a violation through them either
    extends: bool = False
    p_extend: float = 0.15

    @property
    def rate_bounds(self) -> tuple[int, int]:
        """Integer clock-rate steps honoring ``drift_eps`` (state.py's
        guard math): eps=0.25 -> [3, 5] around DEFAULT_RATE=4."""
        lo = max(1, int(np.ceil(DEFAULT_RATE * (1.0 - self.drift_eps))))
        hi = max(lo, int(DEFAULT_RATE * (1.0 + self.drift_eps)))
        return lo, hi

    def mutation_space(self) -> MutationSpace:
        lo, hi = self.rate_bounds
        return MutationSpace(
            n_ticks=self.n_ticks, n_cells=self.n_cells,
            n_acceptors=self.n_acceptors, n_proposers=self.n_proposers,
            delay_hi=self.max_delay, rate_lo=lo, rate_hi=hi,
            corrupt=self.corrupt, restart=self.restarts,
            extend=self.extends,
            lease_ticks=self.lease_ticks,
        )

    def engine(self) -> LeaseArrayEngine:
        return LeaseArrayEngine(
            self.n_cells, n_acceptors=self.n_acceptors,
            n_proposers=self.n_proposers, lease_ticks=self.lease_ticks,
            round_ticks=self.round_ticks, drift_eps=self.drift_eps,
            device=self.device,
        )


class FalsifyResult(NamedTuple):
    """What one :func:`search` run found (and how hard it looked)."""

    found: bool                      # did any member trip §4?
    violation: Optional[Scenario]    # the violating scenario (unshrunk)
    lineage: Optional[str]           # its mutation lineage tag
    digest: Optional[str]            # its plane_digest
    generations: int                 # generations actually run
    evaluations: int                 # scenarios evaluated in total
    survivor_scores: np.ndarray      # [B] final-generation margin scores
    random_scores: np.ndarray        # [B] generation-0 (random) scores
    survivor_margins: dict           # final-generation raw margins [B]
    config: FalsifyConfig

    def concentrated(self) -> bool:
        """The search-worked signal the artifact reports: the survivor
        population sits strictly closer to the §4 boundary than the
        random batch it started from (median margin score)."""
        return float(np.median(self.survivor_scores)) < float(
            np.median(self.random_scores)
        )


def margin_score(margins: dict) -> np.ndarray:
    """[B] int64 boundary-proximity score — LOWER is closer to a §4
    violation. The primary distance is the smallest weighted margin
    component (one missing quorum vote = 256; one quarter-tick of
    expiry-tie, ghost-guard, or deaf-window distance = 64); concurrent
    open rounds subtract a small contention bonus (capped far below one
    primary unit) so equal-margin members with more simultaneous rounds
    rank first. ``MARGIN_BIG`` sentinels ("never got close") stay
    astronomically large, int64 keeps the weighting overflow-free."""
    m = {k: np.asarray(v, np.int64) for k, v in margins.items()}
    primary = np.minimum(
        m["votes_gap"] * _W_VOTES,
        np.minimum(
            m["tie_q4"] * _W_Q4,
            np.minimum(m["ghost_q4"] * _W_Q4, m["deaf_q4"] * _W_Q4),
        ),
    )
    return primary - np.minimum(m["open_rounds"], _W_Q4 - 1)


def random_population(rng: np.random.Generator, cfg: FalsifyConfig) -> dict:
    """The seeded generation-0 planes: iid per-entry draws at the config's
    fault densities, [B, T, ...] numpy int32 (the ``Scenario.stack``
    layout). Unlike ``trace.random_trace`` there is no same-cell spacing:
    overwriting an in-flight slot is loss, which the protocol must (and
    does) tolerate — the falsifier explores it on purpose."""
    B, T = cfg.pop_size, cfg.n_ticks
    N, A, P = cfg.n_cells, cfg.n_acceptors, cfg.n_proposers
    i32 = np.int32

    def ids(p):
        return np.where(
            rng.random((B, T, N)) < p,
            rng.integers(0, P, (B, T, N)), NO_PROPOSER,
        ).astype(i32)

    planes = {
        "attempts": ids(cfg.p_attempt),
        "releases": ids(cfg.p_release),
        "extends": (
            ids(cfg.p_extend) if cfg.extends
            else np.full((B, T, N), NO_PROPOSER, i32)
        ),
        "acc_up": (rng.random((B, T, A)) >= cfg.p_down).astype(i32),
        "delay": rng.integers(0, cfg.max_delay + 1, (B, T, P, A)).astype(i32),
        "drop": (rng.random((B, T, P, A)) < cfg.p_drop).astype(i32),
    }
    lo, hi = cfg.rate_bounds
    if cfg.drift:
        planes["prop_rate"] = rng.integers(lo, hi + 1, (B, T, P)).astype(i32)
        planes["acc_rate"] = rng.integers(lo, hi + 1, (B, T, A)).astype(i32)
    else:
        planes["prop_rate"] = np.full((B, T, P), DEFAULT_RATE, i32)
        planes["acc_rate"] = np.full((B, T, A), DEFAULT_RATE, i32)
    fill = (
        (lambda: (rng.random((B, T, A)) < cfg.p_corrupt).astype(i32))
        if cfg.corrupt else
        (lambda: np.zeros((B, T, A), i32))
    )
    planes["acc_stale"] = fill()
    planes["acc_equiv"] = fill()
    if cfg.restarts:
        planes["acc_restart"] = (
            rng.random((B, T, A)) < cfg.p_restart
        ).astype(i32)
        prop = (rng.random((B, T, P)) < cfg.p_restart / 2).astype(i32)
        # the RESTART_SHIFT carve caps per-proposer totals: zero every
        # restart past the cap so the batch clears check_pack_budget
        prop[np.cumsum(prop, axis=1) > MAX_RESTARTS] = 0
        planes["prop_restart"] = prop
    else:
        planes["acc_restart"] = np.zeros((B, T, A), i32)
        planes["prop_restart"] = np.zeros((B, T, P), i32)
    return planes


def _scenario_at(planes: dict, b: int) -> Scenario:
    return Scenario({k: np.array(np.asarray(v)[b]) for k, v in planes.items()})


def search(cfg: FalsifyConfig, *, engine: Optional[LeaseArrayEngine] = None,
           log=None) -> FalsifyResult:
    """Run the falsification loop to the configured budget (or the first
    violation). ``engine`` overrides the config-built one (it must match
    the geometry; sweeps never advance it). ``log`` is an optional
    ``callable(str)`` for per-generation progress."""
    rng = np.random.default_rng(cfg.seed)
    eng = engine if engine is not None else cfg.engine()
    space = cfg.mutation_space()
    op_names = space.op_names()
    planes = random_population(rng, cfg)
    B = cfg.pop_size
    tags = [f"s{cfg.seed}.g0.r{i}" for i in range(B)]
    elite_k = max(1, int(B * cfg.elite_frac))
    evaluations = 0
    random_scores = None
    scores = margins = None

    for gen in range(cfg.generations):
        res = eng.sweep(
            Scenario(planes), collect="margins", verify=False, tags=tags,
        )
        evaluations += B
        # the verdicts and the margins to the host in one copy
        host = torch.stack(
            [res.max_owner_count] + [res.margins[k] for k in MARGIN_NAMES]
        ).cpu().numpy()
        margins = dict(zip(MARGIN_NAMES, host[1:]))
        scores = margin_score(margins)
        if random_scores is None:
            random_scores = scores.copy()
        bad = np.flatnonzero(host[0] > 1)
        if bad.size:
            b = int(bad[0])
            sc = _scenario_at(planes, b)
            return FalsifyResult(
                found=True, violation=sc, lineage=tags[b],
                digest=plane_digest(sc.planes),
                generations=gen + 1, evaluations=evaluations,
                survivor_scores=scores, random_scores=random_scores,
                survivor_margins=margins, config=cfg,
            )
        if log is not None:
            log(
                f"gen {gen}: best={int(scores.min())} "
                f"median={int(np.median(scores))}"
            )
        if gen == cfg.generations - 1:
            break
        # elitist selection: keep the closest-to-boundary members
        # verbatim, refill by mutating parents sampled from the elite
        order = np.argsort(scores, kind="stable")
        elite = order[:elite_k]
        parents = rng.choice(elite, size=B - elite_k)
        children = {
            k: np.asarray(v)[parents] for k, v in planes.items()
        }
        children, op_idx = mutate(children, rng, space)
        planes = {
            k: np.concatenate([np.asarray(v)[elite], children[k]])
            for k, v in planes.items()
        }
        new_tags = [tags[i] for i in elite]
        for j, p in enumerate(parents):
            hops = tags[p].split("<-")[: _MAX_LINEAGE_HOPS - 1]
            new_tags.append(
                f"s{cfg.seed}.g{gen + 1}.p{int(p)}."
                f"{op_names[op_idx[j]]}<-" + "<-".join(hops)
            )
        tags = new_tags

    return FalsifyResult(
        found=False, violation=None, lineage=None, digest=None,
        generations=cfg.generations, evaluations=evaluations,
        survivor_scores=scores, random_scores=random_scores,
        survivor_margins=margins, config=cfg,
    )


def replace_config(cfg: FalsifyConfig, **kw) -> FalsifyConfig:
    """``dataclasses.replace`` re-exported next to the config it serves."""
    return replace(cfg, **kw)
