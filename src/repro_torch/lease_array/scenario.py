"""Scenario plane: one declarative bundle for every fault dimension.

The paper's failure model (§1) is open-ended — "messages may be delayed,
reordered, lost, and nodes may crash and restart" — so the engine API does
not grow one argument per failure dimension. A ``Scenario`` is a
*registry-driven* bundle of named planes, each a dense numpy array with a
leading tick axis:

  attempts  [T, N]     proposer id attempting each cell (-1 = none)
  releases  [T, N]     proposer id releasing each cell (-1 = none)
  acc_up    [T, A]     acceptor reachability (1 = reachable)
  delay     [T, P, A]  per-(proposer, acceptor) link delay in whole ticks
  drop      [T, P, A]  per-(proposer, acceptor) link loss mask
  prop_rate [T, P]     proposer local-clock step (local quarter-ticks/tick)
  acc_rate  [T, A]     acceptor local-clock step (local quarter-ticks/tick)
  ... plus the corruption, restart and §6 extends planes below.

``delay``/``drop`` are asymmetric link matrices; the symmetric per-acceptor
``[T, A]`` form is the P-broadcast special case (each spec's ``alts``).
Rates are validated ≥ 1 (``min_value``): a rate-0 clock freezes its timers.

Planes stay numpy at rest; the ops layer moves them to the engine's device
per dispatch. ``register_plane`` extends the schema without any signature
change.
"""
from __future__ import annotations

import hashlib
from typing import Iterable, NamedTuple, Optional

import numpy as np

from .state import DEFAULT_RATE, NO_PROPOSER

__all__ = [
    "PlaneSpec",
    "PLANES",
    "CORRUPTION_PLANES",
    "RESTART_PLANES",
    "EXTEND_PLANES",
    "register_plane",
    "plane_table_md",
    "plane_digest",
    "Scenario",
    "TickInputs",
    "make_tick",
    "validate_proposer_ids",
]


class PlaneSpec(NamedTuple):
    """Schema of one scenario plane (shapes are per tick, sans the T axis)."""

    name: str
    dims: tuple[str, ...]  # per-tick dims, of {"N", "A", "P"}
    default: int           # fill value when the plane is omitted
    doc: str = ""
    #: alternate per-tick shapes accepted from callers; missing axes are
    #: broadcast (e.g. delay's ("A",): a symmetric [T, A] plane is expanded
    #: to [T, P, A] by repeating it for every proposer)
    alts: tuple[tuple[str, ...], ...] = ()
    #: validated as proposer-id rows (-1 sentinel .. n_proposers - 1)
    proposer_ids: bool = False
    #: entries below this raise at build/validate time (None = unchecked)
    min_value: Optional[int] = None


#: the plane registry — insertion order is the canonical plane order
PLANES: dict[str, PlaneSpec] = {}


def register_plane(
    name: str,
    dims: Iterable[str],
    default: int,
    doc: str = "",
    *,
    alts: Iterable[Iterable[str]] = (),
    proposer_ids: bool = False,
    min_value: Optional[int] = None,
) -> PlaneSpec:
    """Extend the scenario schema with a new named plane."""
    spec = PlaneSpec(
        name, tuple(dims), int(default), doc,
        tuple(tuple(a) for a in alts), proposer_ids,
        None if min_value is None else int(min_value),
    )
    PLANES[name] = spec
    return spec


register_plane(
    "attempts", ("N",), NO_PROPOSER,
    "proposer id attempting each cell this tick (-1 = none)",
    proposer_ids=True,
)
register_plane(
    "releases", ("N",), NO_PROPOSER,
    "proposer id releasing each cell this tick (-1 = none)",
    proposer_ids=True,
)
register_plane(
    "acc_up", ("A",), 1,
    "acceptor reachability this tick (1 = reachable)",
)
register_plane(
    "delay", ("P", "A"), 0,
    "per-(proposer, acceptor) link delay (whole ticks) for legs sent this tick",
    alts=(("A",),),
    min_value=0,
)
register_plane(
    "drop", ("P", "A"), 0,
    "per-(proposer, acceptor) link loss mask for legs sent this tick",
    alts=(("A",),),
)
register_plane(
    "prop_rate", ("P",), DEFAULT_RATE,
    "proposer local-clock step this tick (local quarter-ticks; 4 = rate 1.0)",
    min_value=1,
)
register_plane(
    "acc_rate", ("A",), DEFAULT_RATE,
    "acceptor local-clock step this tick (local quarter-ticks; 4 = rate 1.0)",
    min_value=1,
)
register_plane(
    "acc_stale", ("A",), 0,
    "adversarial (falsifier negative control): acceptor honors "
    "below-promise ballots this tick",
    min_value=0,
)
register_plane(
    "acc_equiv", ("A",), 0,
    "adversarial (falsifier negative control): acceptor reports its live "
    "accepted lease as open this tick",
    min_value=0,
)
register_plane(
    "acc_restart", ("A",), 0,
    "diskless acceptor crash+restart this tick: state blanks, then deaf "
    "for a maximal lease span on its local clock",
    min_value=0,
)
register_plane(
    "prop_restart", ("P",), 0,
    "proposer crash+restart this tick: abandons its round, drops its owner "
    "belief, bumps its ballot restart counter",
    min_value=0,
)
register_plane(
    "extends", ("N",), NO_PROPOSER,
    "proposer id extending its own live lease on each cell this tick "
    "(§6 in-flight re-propose; -1 = none, non-owners are a no-op)",
    proposer_ids=True,
)

#: the adversarial corruption planes — Byzantine acceptor behaviors the
#: honest protocol must never exhibit (negative controls for the §4 alarm)
CORRUPTION_PLANES = ("acc_stale", "acc_equiv")

#: the crash/restart planes (paper §1 failure model): diskless acceptor
#: restarts + proposer restart counters. All-zero planes are stripped from
#: dispatch, so the honest engine runs no restart work
RESTART_PLANES = ("acc_restart", "prop_restart")

#: the §6 owner-extension plane. All-default (-1 everywhere) is stripped
#: from dispatch like the corruption/restart planes
EXTEND_PLANES = ("extends",)


def plane_table_md(planes: Optional[dict[str, PlaneSpec]] = None) -> str:
    """Render the registry as the markdown plane table of
    docs/scenario_api.md (between its ``plane-table`` markers), as the
    reference's ``plane_table_md`` renders its own registry; the port's
    leaselint (``repro_torch.analysis.staticcheck.conventions``) fails when
    this table and the docs drift, or a plane has an empty ``doc``."""
    specs = (PLANES if planes is None else planes).values()
    rows = [
        "| plane | per-tick shape | default | meaning |",
        "|-------|----------------|---------|---------|",
    ]
    for spec in specs:
        shape = "`[" + ", ".join(spec.dims) + "]`"
        if spec.alts:
            shape += " (or " + " / ".join(
                "`[" + ", ".join(a) + "]`" for a in spec.alts
            ) + ")"
        rows.append(
            f"| `{spec.name}` | {shape} | `{spec.default}` | {spec.doc} |"
        )
    return "\n".join(rows) + "\n"


def plane_digest(planes: dict) -> str:
    """Content hash of one scenario's planes (12 hex chars): a stable,
    seed-independent identifier for "which exact scenario was this" — the
    same hash the reference engine prints, so a scenario is named alike in
    both. Plane *names* participate."""
    h = hashlib.sha256()
    for name in sorted(planes):
        arr = np.ascontiguousarray(np.asarray(planes[name], np.int32))
        h.update(name.encode())
        h.update(np.asarray(arr.shape, np.int64).tobytes())
        h.update(arr.tobytes())
    return h.hexdigest()[:12]


def validate_proposer_ids(arr, n_proposers: int) -> None:
    """Reject ids outside [-1, n_proposers): an out-of-range id would lease
    cells to a proposer the plane has no row for — a ghost owner nobody
    believes in."""
    a = np.asarray(arr)
    if a.size == 0:
        return
    hi, lo = int(a.max()), int(a.min())
    if hi >= n_proposers:
        raise ValueError(
            f"proposer id {hi} out of range "
            f"(plane has {n_proposers} proposers)"
        )
    if lo < NO_PROPOSER:
        raise ValueError(
            f"proposer id {lo} out of range ({NO_PROPOSER} means no proposer)"
        )


def _dim_sizes(n_cells: int, n_acceptors: int, n_proposers: int) -> dict[str, int]:
    return {"N": int(n_cells), "A": int(n_acceptors), "P": int(n_proposers)}


def _check_min_value(spec: PlaneSpec, arr: np.ndarray, what: str) -> None:
    """Registry-driven range floor: delays must be >= 0 (legs cannot land
    in the past), clock rates >= 1 (a rate-0 clock freezes its timers)."""
    if spec.min_value is None or arr.size == 0:
        return
    lo = int(arr.min())
    if lo < spec.min_value:
        kind = (
            "negative entries" if spec.min_value == 0
            else f"entries below {spec.min_value}"
        )
        raise ValueError(
            f"{what} plane {spec.name!r} has {kind} (min {lo}); "
            f"valid entries are >= {spec.min_value}"
        )


def _coerce_plane(
    spec: PlaneSpec,
    value,
    sizes: dict[str, int],
    lead: tuple[int, ...],
    what: str,
) -> np.ndarray:
    """Default / validate / broadcast one plane to ``lead + canonical``."""
    shape = lead + tuple(sizes[d] for d in spec.dims)
    if value is None:
        return np.full(shape, spec.default, np.int32)
    arr = np.asarray(value)
    if arr.dtype == bool:
        arr = arr.astype(np.int32)
    arr = arr.astype(np.int32, copy=False)
    forms = (spec.dims,) + spec.alts
    for dims in forms:
        want = lead + tuple(sizes[d] for d in dims)
        if arr.shape == want:
            if dims != spec.dims:  # expand the alternate form, e.g. [T,A]
                missing = [d for d in spec.dims if d not in dims]
                for d in missing:
                    ax = len(lead) + spec.dims.index(d)
                    arr = np.expand_dims(arr, ax)
                arr = np.broadcast_to(arr, shape).copy()
            if spec.proposer_ids:
                validate_proposer_ids(arr, sizes["P"])
            _check_min_value(spec, arr, what)
            return arr
    accepted = " or ".join(
        str(lead + tuple(sizes[d] for d in dims)) for dims in forms
    )
    raise ValueError(
        f"{what} plane {spec.name!r} has shape {arr.shape}; expected "
        f"{accepted} (T, N, A, P = ticks, cells, acceptors, proposers)"
    )


def _raise_unknown(bad):
    raise ValueError(
        f"unknown scenario plane(s) {sorted(bad)}; registered planes: "
        f"{sorted(PLANES)} (extend with register_plane)"
    )


class _PlaneBundle:
    """Shared dict-of-planes behavior for Scenario / TickInputs."""

    __slots__ = ("planes",)
    _lead_ndim = 0  # leading axes before the per-tick dims

    def __init__(self, planes: dict) -> None:
        if bad := set(planes) - set(PLANES):
            _raise_unknown(bad)
        self.planes = {k: planes[k] for k in PLANES if k in planes}

    def __getattr__(self, name: str):
        if name == "planes":  # unset slot (e.g. during unpickling probes)
            raise AttributeError(name)
        try:
            return self.planes[name]
        except KeyError:
            raise AttributeError(name) from None

    def _dim(self, plane: str, axis: int) -> int:
        return int(self.planes[plane].shape[self._lead_ndim + axis])

    @property
    def n_cells(self) -> int:
        return self._dim("attempts", 0)

    @property
    def n_acceptors(self) -> int:
        return self._dim("acc_up", 0)

    @property
    def n_proposers(self) -> int:
        return self._dim("delay", 0)

    @property
    def delayed(self) -> bool:
        """True iff the delay or drop plane is nonzero anywhere (needs the
        in-flight netplane model)."""
        return bool(
            np.asarray(self.planes["delay"]).any()
            or np.asarray(self.planes["drop"]).any()
        )

    @property
    def drifted(self) -> bool:
        """True iff any clock-rate plane departs from DEFAULT_RATE."""
        return bool(
            (np.asarray(self.planes["prop_rate"]) != DEFAULT_RATE).any()
            or (np.asarray(self.planes["acc_rate"]) != DEFAULT_RATE).any()
        )

    @property
    def corrupted(self) -> bool:
        """True iff an adversarial corruption plane is nonzero anywhere."""
        return bool(any(
            np.asarray(self.planes[k]).any() for k in CORRUPTION_PLANES
        ))

    @property
    def restarted(self) -> bool:
        """True iff a crash/restart plane is nonzero anywhere (needs the
        delayed model and switches ballots to the restart-counter carve)."""
        return bool(any(
            np.asarray(self.planes[k]).any() for k in RESTART_PLANES
        ))

    @property
    def extended(self) -> bool:
        """True iff the §6 extends plane schedules any owner extension."""
        return bool(any(
            (np.asarray(self.planes[k]) != PLANES[k].default).any()
            for k in EXTEND_PLANES
        ))

    def validate_for(
        self, *, n_cells: int, n_acceptors: int, n_proposers: int
    ) -> None:
        """Check every plane against an engine's geometry (shape + ids +
        range floors). ``build``/``make_tick`` output always passes;
        hand-rolled bundles are checked here before they reach a driver."""
        sizes = _dim_sizes(n_cells, n_acceptors, n_proposers)
        lead: tuple[int, ...] = ()
        if self._lead_ndim:
            lead = (int(self.planes["attempts"].shape[0]),)
        what = type(self).__name__
        for name, spec in PLANES.items():
            if name not in self.planes:
                raise ValueError(f"{what} is missing plane {name!r}")
            arr = np.asarray(self.planes[name])
            want = lead + tuple(sizes[d] for d in spec.dims)
            if arr.shape != want:
                raise ValueError(
                    f"{what} plane {name!r} has shape {arr.shape}; "
                    f"engine geometry wants {want}"
                )
            if spec.proposer_ids:
                validate_proposer_ids(arr, sizes["P"])
            _check_min_value(spec, arr, what)

    def __repr__(self) -> str:
        inner = ", ".join(
            f"{k}{tuple(v.shape)}" for k, v in self.planes.items()
        )
        return f"{type(self).__name__}({inner})"


class TickInputs(_PlaneBundle):
    """One tick's worth of every scenario plane (no leading T axis)."""


def make_tick(
    *,
    n_cells: int,
    n_acceptors: int,
    n_proposers: int,
    **planes,
) -> TickInputs:
    """Build a validated single-tick input bundle (engine.step's currency).

    Omitted planes get their registered defaults; ``delay``/``drop`` accept
    the symmetric per-acceptor ``[A]`` form and broadcast it over P.
    """
    if bad := set(planes) - set(PLANES):
        _raise_unknown(bad)
    sizes = _dim_sizes(n_cells, n_acceptors, n_proposers)
    return TickInputs({
        name: _coerce_plane(spec, planes.get(name), sizes, (), "tick")
        for name, spec in PLANES.items()
    })


class Scenario(_PlaneBundle):
    """A [T]-tick fault scenario: every registered plane, leading T axis.

    Build with :meth:`Scenario.build` (defaulting + shape/dtype/id
    validation + broadcasting), slice with ``scenario[t]`` (→ TickInputs)
    or ``scenario[a:b]`` (→ sub-Scenario), join with :meth:`concat`, and
    batch with :meth:`stack`.
    """

    _lead_ndim = 1

    @classmethod
    def build(
        cls,
        n_ticks: Optional[int] = None,
        *,
        n_cells: int,
        n_acceptors: int,
        n_proposers: int,
        **planes,
    ) -> "Scenario":
        """Default, validate and broadcast every registered plane.

        ``n_ticks`` may be omitted when at least one plane is given (it is
        inferred from the first one). Unknown plane names are rejected with
        the list of registered planes.
        """
        if bad := {k for k in planes if k not in PLANES}:
            _raise_unknown(bad)
        if n_ticks is None:
            for v in planes.values():
                if v is not None:
                    n_ticks = int(np.asarray(v).shape[0])
                    break
            else:
                raise ValueError(
                    "n_ticks is required when no plane is provided"
                )
        sizes = _dim_sizes(n_cells, n_acceptors, n_proposers)
        lead = (int(n_ticks),)
        return cls({
            name: _coerce_plane(spec, planes.get(name), sizes, lead, "scenario")
            for name, spec in PLANES.items()
        })

    # ------------------------------------------------------------- queries
    @property
    def n_ticks(self) -> int:
        return int(self.planes["attempts"].shape[0])

    # -------------------------------------------------------- composition
    def __getitem__(self, key):
        if isinstance(key, slice):
            return Scenario({k: v[key] for k, v in self.planes.items()})
        return TickInputs({k: v[key] for k, v in self.planes.items()})

    def concat(self, *others: "Scenario") -> "Scenario":
        """Concatenate scenarios along the tick axis (same geometry)."""
        for o in others:
            for name in PLANES:
                a, b = self.planes[name], o.planes[name]
                if a.shape[1:] != b.shape[1:]:
                    raise ValueError(
                        f"cannot concat: plane {name!r} per-tick shapes "
                        f"differ ({a.shape[1:]} vs {b.shape[1:]})"
                    )
        return Scenario({
            k: np.concatenate(
                [np.asarray(self.planes[k])]
                + [np.asarray(o.planes[k]) for o in others], axis=0,
            )
            for k in self.planes
        })

    @classmethod
    def stack(cls, scenarios: Iterable["Scenario"]) -> "Scenario":
        """Stack same-shape scenarios on a new leading batch axis. Returns a
        Scenario-shaped bundle whose planes are [B, T, ...] (its per-tick
        properties no longer apply)."""
        scenarios = list(scenarios)
        if not scenarios:
            raise ValueError("Scenario.stack needs at least one scenario")
        first = scenarios[0]
        for i, sc in enumerate(scenarios[1:], 1):
            for name in PLANES:
                a = np.asarray(first.planes[name])
                b = np.asarray(sc.planes[name])
                if a.shape != b.shape:
                    raise ValueError(
                        f"cannot stack: scenario 0 plane {name!r} has shape "
                        f"{a.shape} but scenario {i} has {b.shape} "
                        f"(same tick count and geometry required)"
                    )
        return cls({
            k: np.stack([np.asarray(sc.planes[k]) for sc in scenarios])
            for k in first.planes
        })
