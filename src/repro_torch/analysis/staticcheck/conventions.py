"""AST/doc convention lint over the port (``src/repro_torch`` and its tests).

Three conventions, the reference's (``repro.analysis.staticcheck.
conventions``) as they apply to the port:

  - ``plane-docs``: the port's plane registry renders, through
    ``scenario.plane_table_md``, exactly the table between the
    ``plane-table`` markers of docs/scenario_api.md (the reference's
    generated table: the two registries must not drift), and no plane is
    registered with an empty ``doc``. The docs file is read, never written.
  - ``deprecated-shim``: the deprecated per-plane shims
    ``lease_plane_step`` and ``lease_plane_step_delayed`` are named only
    where they are defined (``src/repro_torch/lease_array/ops.py``) and in
    the one test file that exercises them (``tests/test_torch_deprecations.
    py``); any other module of ``src/repro_torch/`` or test of the port
    that names one (an import, a call, an attribute) is a finding.
  - ``deadline-compare``: node-side deadline fields are minted in each
    node's *local* quarter-ticks (the §4 drift model). A comparison of a
    deadline field against anything that is not a local-clock value (or
    the constant-0 presence test) silently mixes clock domains. The
    reference's AST rule, over ``src/repro_torch/lease_array/``.

All rules are pure-source checks (``ast`` + text); ``check_source_text``
exposes the AST rules to the mutation fixtures without touching the tree.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding

SHIM_NAMES = frozenset({"lease_plane_step", "lease_plane_step_delayed"})
#: files allowed to name the deprecated shims: the definition site and the
#: shim-behaviour tests
SHIM_ALLOWLIST = frozenset({
    "src/repro_torch/lease_array/ops.py",
    "tests/test_torch_deprecations.py",
})
#: where the deadline rule applies
DEADLINE_SCOPE = "src/repro_torch/lease_array/"

#: packed node-side deadline fields (minted in local quarter-ticks)
DEADLINE_NAMES = frozenset({
    "ownp", "owner_lease", "acc_lease",
    "owner_expiry", "lease_expiry", "rnd_expiry", "rnd_deadline",
})
#: identifier substrings that mark a value as local-clock time
_CLOCK_TOKENS = ("clk", "clock")

_PLANE_TABLE_BEGIN = "<!-- plane-table:begin"
_PLANE_TABLE_END = "<!-- plane-table:end -->"


def _names_in(node) -> set[str]:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _is_zero_const(node) -> bool:
    return isinstance(node, ast.Constant) and node.value == 0


def _is_clockish(node) -> bool:
    return any(
        any(tok in name for tok in _CLOCK_TOKENS) for name in _names_in(node)
    )


def _lint_tree(tree: ast.AST, relpath: str) -> list[Finding]:
    findings: list[Finding] = []
    deadline_scope = relpath.startswith(DEADLINE_SCOPE)
    shim_ok = relpath in SHIM_ALLOWLIST
    for node in ast.walk(tree):
        name = None
        if isinstance(node, ast.Name) and node.id in SHIM_NAMES:
            name = node.id
        elif isinstance(node, ast.Attribute) and node.attr in SHIM_NAMES:
            name = node.attr
        elif isinstance(node, (ast.ImportFrom, ast.Import)):
            hit = [a.name.split(".")[-1] for a in node.names
                   if a.name.split(".")[-1] in SHIM_NAMES]
            name = hit[0] if hit else None
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in SHIM_NAMES:
            name = node.name
        if name is not None and not shim_ok:
            findings.append(Finding(
                "conventions", "deprecated-shim",
                f"{relpath}:{node.lineno}",
                f"`{name}` is a deprecated shim; build a TickInputs with "
                f"make_tick and call lease_plane_tick",
            ))
        if deadline_scope and isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            for a, b in zip(sides, sides[1:]):
                for dl, other in ((a, b), (b, a)):
                    names = _names_in(dl)
                    if not (names & DEADLINE_NAMES):
                        continue
                    if _is_zero_const(other):  # presence test, clock-free
                        continue
                    if "PACK_MASK" in names:  # ballot-field extraction,
                        continue              # not a deadline comparison
                    if _is_clockish(other) or _is_clockish(dl):
                        continue
                    field = sorted(_names_in(dl) & DEADLINE_NAMES)[0]
                    findings.append(Finding(
                        "conventions", "deadline-compare",
                        f"{relpath}:{node.lineno}",
                        f"deadline field `{field}` compared against a "
                        f"non-clock value; node-side deadlines live in "
                        f"local quarter-ticks — compare against the "
                        f"clock_select'ed local clock (or a constant-0 "
                        f"presence test), never global time",
                    ))
    return findings


def check_source_text(src: str, relpath: str) -> list[Finding]:
    """Lint one source string as if it lived at ``relpath`` (the hook the
    mutation fixtures use)."""
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [Finding(
            "conventions", "syntax-error", f"{relpath}:{e.lineno}", str(e),
        )]
    return _lint_tree(tree, relpath)


def _repo_root() -> Path:
    # src/repro_torch/analysis/staticcheck/conventions.py -> repo root is 5 up
    return Path(__file__).resolve().parents[4]


def check_plane_docs(
    doc_text: str | None = None, *, root: Path | None = None,
    planes: dict | None = None,
) -> list[Finding]:
    """The port's plane registry (or ``planes``) must render the table
    committed in docs/scenario_api.md, and every plane must carry a
    non-empty doc."""
    from ...lease_array.scenario import PLANES, plane_table_md

    planes = PLANES if planes is None else planes
    findings = [
        Finding(
            "conventions", "undocumented-plane",
            f"register_plane({name!r})",
            "registered plane has an empty doc; the generated plane table "
            "would ship a blank meaning column",
        )
        for name, spec in planes.items() if not spec.doc.strip()
    ]
    doc_path = (root or _repo_root()) / "docs" / "scenario_api.md"
    if doc_text is None:
        try:
            doc_text = doc_path.read_text()
        except OSError as e:
            return findings + [Finding(
                "conventions", "undocumented-plane", str(doc_path),
                f"cannot read the scenario API doc: {e}",
            )]
    begin = doc_text.find(_PLANE_TABLE_BEGIN)
    end = doc_text.find(_PLANE_TABLE_END)
    if begin < 0 or end < 0:
        return findings + [Finding(
            "conventions", "undocumented-plane", "docs/scenario_api.md",
            f"plane-table markers missing ({_PLANE_TABLE_BEGIN} ... "
            f"{_PLANE_TABLE_END})",
        )]
    committed = doc_text[begin:end]
    # drop the marker comment itself (it may span lines); keep table rows
    committed = "\n".join(
        ln for ln in committed.splitlines() if ln.startswith("|")
    ) + "\n"
    generated = plane_table_md(planes)
    if committed != generated:
        want = {ln.split("|")[1].strip(" `") for ln in generated.splitlines()[2:]}
        have = {ln.split("|")[1].strip(" `") for ln in committed.splitlines()[2:]
                if ln.count("|") > 2}
        missing = sorted(want - have)
        hint = (
            f"planes missing from the doc table: {missing}" if missing
            else "the committed table text no longer matches the registry"
        )
        findings.append(Finding(
            "conventions", "undocumented-plane", "docs/scenario_api.md",
            f"the port's plane registry drifted from the docs table — "
            f"{hint}",
        ))
    return findings


def check_conventions(root: Path | None = None) -> list[Finding]:
    """Run every convention rule over the real tree."""
    root = root or _repo_root()
    findings = check_plane_docs(root=root)
    paths = sorted((root / "src" / "repro_torch").rglob("*.py"))
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    for path in paths:
        rel = path.relative_to(root).as_posix()
        findings += check_source_text(path.read_text(), rel)
    return findings
