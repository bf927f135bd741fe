"""The port's ``leaselint`` entry point: run every static checker, print
findings, emit the JSON artifact.

    python -m repro_torch.analysis.staticcheck [--json PATH] [--skip-mutation]

Exit status is 0 iff no checker produced a finding AND every seeded
mutation fixture was caught (a checker that stops firing is itself a
finding). It runs on the CPU with no card: launch plans are plain Python
data and the tick cores are traced on tiny CPU blocks. The SASS rule (``purity.check_sass``) needs a built library and runs
on the card (``chip_smoke.py`` phase 23).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .findings import Finding, findings_to_json

#: the geometries every run audits: the reference's default (N 4096, A 5,
#: P 8, T 64) and a ragged one (N past a block and no multiple of a warp,
#: B 5, so neither the blocks nor the batched sync kernel's 155 tiles fill
#: evenly; A 3, P 5; a 3-tick window)
GEOMETRIES = (
    dict(),
    dict(n_cells=970, n_acceptors=3, n_proposers=5, n_ticks=37, window=3,
         batch=5),
)


#: the interval self-checks' geometry (the reference CLI's): P 8, A 5, a
#: 3-tick lease, at the drift-free and the worst referee clock rate
_RATES = (4, 9)  # DEFAULT_RATE and MAX_REFEREE_RATE
_P, _A, _LEASE_Q4 = 8, 5, 13


def _check_intervals() -> list[Finding]:
    """Self-checks of the interval analysis on the real cores:

    - the derived bound must equal ``state.max_pack_tick`` exactly for the
      P 8 geometry at both clock rates, with and without the restart-
      counter ballot carve (0, 1 and MAX_RESTARTS restarts);
    - a config whose *round horizon* blows int32 — invisible to the hand
      check, which only budgets ballots and lease deadlines — must be
      refused.
    """
    from ...lease_array.state import MAX_RESTARTS, max_pack_tick
    from .intervals import TickConfig, analyze_tick_config, derived_max_pack_tick

    findings: list[Finding] = []
    for rate in _RATES:
        for mr in (0, 1, MAX_RESTARTS):
            hand = max_pack_tick(_P, _LEASE_Q4, 0, max_rate=rate,
                                 max_restarts=mr)
            derived = derived_max_pack_tick(_P, _LEASE_Q4, 0, max_rate=rate,
                                            max_restarts=mr)
            if hand != derived:
                findings.append(Finding(
                    "intervals", "bound-mismatch",
                    f"max_pack_tick(P={_P}, rate={rate}, restarts={mr})",
                    f"hand bound {hand} != interval-derived bound {derived}; "
                    f"state.max_pack_tick and the traced tick core disagree "
                    f"about the pack budget",
                ))
    # the gap the hand check cannot see: an absurd round-abandon horizon
    # overflows `rnd_clk + round_q4` inside the core
    hot = TickConfig(
        t_end=100, n_proposers=_P, n_acceptors=_A,
        lease_q4=_LEASE_Q4, round_q4=2_147_483_600,
    )
    if not analyze_tick_config(hot):
        findings.append(Finding(
            "intervals", "lost-rejection", "round_q4=2147483600",
            "a round horizon that overflows int32 inside the core was "
            "proven 'safe'; the interval analysis has lost the regression "
            "the hand check cannot see",
        ))
    return findings


def _check_purity() -> list[Finding]:
    from .conventions import _repo_root
    from .purity import check_sources, check_tick_cores

    return check_sources(_repo_root()) + check_tick_cores(
        _P, _A, _LEASE_Q4)


def _check_launch() -> list[Finding]:
    from .conventions import _repo_root
    from .launch import LEASE_CU, check_kernel_constants, check_window_launches

    findings = check_kernel_constants((_repo_root() / LEASE_CU).read_text())
    return findings + [f for geometry in GEOMETRIES
                       for f in check_window_launches(**geometry)]


def _check_conventions() -> list[Finding]:
    from .conventions import check_conventions

    return check_conventions()


def _check_mutation() -> list[Finding]:
    from .fixtures import run_mutation_tests

    return run_mutation_tests()


_CHECKERS = (
    ("intervals", _check_intervals),
    ("purity", _check_purity),
    ("launch", _check_launch),
    ("conventions", _check_conventions),
    ("mutation", _check_mutation),
)


def run_all(*, skip_mutation: bool = False) -> list[Finding]:
    """Run every leaselint pass over the real tree; returns all findings."""
    return [f for name, fn in _CHECKERS
            if not (skip_mutation and name == "mutation") for f in fn()]


def write_plane_table(root: Path) -> Path:
    """Write the port's registry-generated plane table between the
    ``plane-table`` markers of ``root``/docs/scenario_api.md (a tree the
    caller names; the repository's own docs are the reference's and are
    only read)."""
    from ...lease_array.scenario import plane_table_md
    from .conventions import _PLANE_TABLE_BEGIN, _PLANE_TABLE_END

    path = Path(root) / "docs" / "scenario_api.md"
    text = path.read_text()
    begin = text.find(_PLANE_TABLE_BEGIN)
    end = text.find(_PLANE_TABLE_END)
    if begin < 0 or end < 0:
        raise ValueError(
            f"{path}: plane-table markers not found; add "
            f"{_PLANE_TABLE_BEGIN} ... --> and {_PLANE_TABLE_END} around "
            f"the table first"
        )
    close = text.index("-->", begin) + len("-->")
    path.write_text(text[:close] + "\n" + plane_table_md() + text[end:])
    return path


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="leaselint for the port: the pack budget of the traced "
                    "tick cores, launch-plan safety of the CUDA lease "
                    "kernels, int32 purity, repo conventions",
    )
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the findings JSON artifact here")
    ap.add_argument("--skip-mutation", action="store_true",
                    help="skip the checker self-test against the seeded "
                         "mutants")
    args = ap.parse_args(argv)

    findings = run_all(skip_mutation=args.skip_mutation)
    for f in findings:
        print(f)
    checkers = [n for n, _ in _CHECKERS
                if not (args.skip_mutation and n == "mutation")]
    payload = findings_to_json(
        findings, checkers=checkers, geometries=list(GEOMETRIES),
        config={"n_proposers": _P, "n_acceptors": _A, "lease_q4": _LEASE_Q4,
                "rates": list(_RATES)})
    if args.json:
        Path(args.json).write_text(payload + "\n")
        print(f"findings artifact: {args.json}")
    if findings:
        print(f"leaselint: {len(findings)} finding(s)")
        return 1
    print(f"leaselint: clean ({', '.join(checkers)})")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
