"""CLI: one seeded fixed-budget falsification run + a JSON artifact.

    python -m repro_torch.lease_array.falsify --mode honest --expect none
    python -m repro_torch.lease_array.falsify --mode corrupt --expect violation
    python -m repro_torch.lease_array.falsify --mode honest --restarts --expect none

``--mode corrupt`` enables the adversarial acc_stale/acc_equiv planes —
the negative control where the search MUST reach a §4 violation (the
alarm provably fires); ``--mode honest`` runs the real falsification
sweep over drift + delay + drop + outages, where it must NOT. ``--expect``
turns either statement into the process exit code. The run is on the
card unless ``--device cpu``. The artifact (``--out``) records the
config, margin-score distributions (random generation-0 vs final
survivors), the concentration verdict, and — on a violation — the
shrunk offender's planes, digest, and mutation lineage.
"""
from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np

from ..scenario import PLANES, plane_digest
from .search import FalsifyConfig, search
from .shrink import shrink


def _pcts(scores: np.ndarray) -> dict:
    qs = (0, 1, 5, 25, 50, 75, 100)
    return {
        f"p{q}": int(v) for q, v in zip(qs, np.percentile(scores, qs))
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lease_array.falsify",
        description="coverage-guided §4 falsification at sweep speed",
    )
    ap.add_argument("--mode", choices=("honest", "corrupt"), default="honest")
    ap.add_argument(
        "--restarts", action="store_true",
        help="also explore the crash/restart planes (diskless acceptor "
             "restarts + proposer restart counters) — honest faults in "
             "either mode, so --expect stays mode-driven",
    )
    ap.add_argument(
        "--extends", action="store_true",
        help="also explore the §6 extends plane (owner in-flight "
             "renewals) — honest behavior in either mode, so --expect "
             "stays mode-driven",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pop", type=int, default=256)
    ap.add_argument("--generations", type=int, default=8)
    ap.add_argument(
        "--device", default="cuda",
        help="the engine's device (the lease kernels run on a CUDA one)",
    )
    ap.add_argument(
        "--expect", choices=("violation", "none"), default=None,
        help="exit nonzero unless the run ends this way",
    )
    ap.add_argument(
        "--out", type=Path, default=None,
        help="write the survivors/margins JSON artifact here",
    )
    ap.add_argument(
        "--shrink-budget", type=int, default=120,
        help="sweep probes the survivor shrinker may spend (0 = skip)",
    )
    args = ap.parse_args(argv)

    cfg = FalsifyConfig(
        seed=args.seed, pop_size=args.pop, generations=args.generations,
        device=args.device, corrupt=args.mode == "corrupt",
        restarts=args.restarts, extends=args.extends,
    )
    res = search(cfg, log=lambda m: print(f"[falsify] {m}", flush=True))

    doc = {
        "mode": args.mode,
        "config": asdict(cfg),
        "found": res.found,
        "generations": res.generations,
        "evaluations": res.evaluations,
        "random_scores": _pcts(res.random_scores),
        "survivor_scores": _pcts(res.survivor_scores),
        "survivor_margins": {
            k: _pcts(v) for k, v in res.survivor_margins.items()
        },
        "concentrated": res.concentrated(),
    }
    if res.found:
        sc = res.violation
        if args.shrink_budget > 0:
            # shrink against a fresh engine (sweeps never advance it)
            sc = shrink(
                sc, cfg.engine(), budget=args.shrink_budget,
                log=lambda m: print(f"[falsify] {m}", flush=True),
            )
        doc["violation"] = {
            "lineage": res.lineage,
            "digest": res.digest,
            "shrunk_digest": plane_digest(sc.planes),
            "shrunk_ticks": sc.n_ticks,
            "planes": {
                k: np.asarray(v).tolist()
                for k, v in sc.planes.items()
                if not (np.asarray(v) == PLANES[k].default).all()
            },
        }
        print(
            f"[falsify] VIOLATION after {res.evaluations} scenarios: "
            f"digest={res.digest} lineage={res.lineage}"
        )
    else:
        print(
            f"[falsify] no violation in {res.evaluations} scenarios "
            f"(median margin: random={int(np.median(res.random_scores))} "
            f"-> survivors={int(np.median(res.survivor_scores))})"
        )
    if args.out is not None:
        args.out.write_text(json.dumps(doc, indent=1) + "\n")
        print(f"[falsify] artifact -> {args.out}")

    if args.expect == "violation" and not res.found:
        print("[falsify] FAIL: expected a violation (negative control)")
        return 1
    if args.expect == "none" and res.found:
        print("[falsify] FAIL: the honest engine violated §4")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
