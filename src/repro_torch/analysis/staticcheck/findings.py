"""The finding currency every leaselint checker speaks (a copy of
``repro.analysis.staticcheck.findings``).

A checker returns a (possibly empty) list of :class:`Finding`s; the CLI
(``python -m repro_torch.analysis.staticcheck``) aggregates them into the
findings JSON artifact and exits nonzero iff any survived. Severity is
deliberately absent: every finding is a proof obligation the tree failed,
not a style nit.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class Finding:
    """One static-check violation.

    checker: which pass found it ("purity" | "launch" | "conventions" |
             "mutation").
    rule:    the machine-readable rule id (e.g. "write-race", "float-type",
             "plane-accounting", "undocumented-plane").
    where:   where it was found: a launch plan, a SASS function, or a
             ``path:line`` location.
    detail:  the human-readable explanation (what was proven false and
             with which numbers).
    """

    checker: str
    rule: str
    where: str
    detail: str

    def __str__(self) -> str:  # the one-line CLI rendering
        return f"[{self.checker}:{self.rule}] {self.where}: {self.detail}"


def findings_to_json(findings: list[Finding], **meta) -> str:
    """Serialize findings (+ run metadata) for the JSON artifact."""
    return json.dumps(
        {
            "ok": not findings,
            "n_findings": len(findings),
            "findings": [asdict(f) for f in findings],
            **meta,
        },
        indent=2,
        sort_keys=True,
    )
