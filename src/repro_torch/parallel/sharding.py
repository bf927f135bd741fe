"""Logical-axis sharding rules -> mesh-axis specs and DTensor placements
(the port of ``repro.parallel.sharding``).

Params and activations are annotated with *logical* axis names (see
``models.schema``); this module maps them onto mesh axes with per-tensor
divisibility fallback (a dim that doesn't divide its mesh axes is
replicated rather than failing — e.g. 40 RWKV heads on a 16-way "model"
axis).

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry per tensor dim, each a mesh-axis name, a tuple of them, or None,
trailing Nones dropped. ``placements`` turns one into DTensor placements
(``Shard(d)``/``Replicate()``, one per mesh dim) on a
``torch.distributed.device_mesh.DeviceMesh``. ``make_rules``,
``spec_for``, ``tree_shardings`` and ``zero1_axes`` read only the mesh's
axis names and sizes, so they take a ``DeviceMesh`` or a shape-only
``AbstractMesh`` alike: the dry run needs no process group.

An ambient context (``use_mesh``) lets model code drop sharding hints
(``hint(x, ("batch", None, "embed"))``): without a mesh, and for a plain
tensor under one, a hint returns its argument; a DTensor is redistributed
to the hint's placements.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

import torch

# Logical axis -> mesh axis (or tuple of mesh axes, or None = replicate).
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "experts": ("pod", "data"),  # EP: expert axis over the data axes when divisible
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head": None,
    "mlp": "model",
    "expert_ff": "model",
    "ssm_inner": "model",
    "rwkv_inner": "model",
    "rwkv_heads": "model",
    "embed": None,
    "seq": None,  # becomes data axes under sequence parallelism
    "layers": None,
    None: None,
}


class AbstractMesh:
    """A mesh of axis names and sizes and no devices (the dry run's)."""

    def __init__(self, shape: tuple, axis_names: tuple) -> None:
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of anything with ``shape``
    (a mapping) and ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a DeviceMesh: shape is a tuple of sizes
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def make_rules(mesh, overrides: Optional[dict] = None) -> dict:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    names = mesh_axes(mesh)

    # Drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh).
    def _filter(v):
        if v is None:
            return None
        axes = v if isinstance(v, tuple) else (v,)
        axes = tuple(a for a in axes if a in names)
        if not axes:
            return None
        return axes if len(axes) > 1 else axes[0]

    return {k: _filter(v) for k, v in rules.items()}


def _axis_size(sizes: dict, v) -> int:
    if v is None:
        return 1
    axes = v if isinstance(v, tuple) else (v,)
    return math.prod(sizes[a] for a in axes)


def spec_for(mesh, rules: dict, logical: tuple, shape: tuple) -> tuple:
    """The spec of one tensor, replicating non-divisible dims."""
    sizes = mesh_axes(mesh)
    out, used = [], set()
    for dim, name in zip(shape, logical):
        v = rules.get(name)
        axes = () if v is None else (v if isinstance(v, tuple) else (v,))
        axes = tuple(a for a in axes if a not in used)
        size = math.prod(sizes[a] for a in axes) if axes else 1
        if axes and dim % size == 0:
            used.update(axes)
            out.append(axes if len(axes) > 1 else axes[0])
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` is split over, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate() for a in mesh_axes(mesh))


def local_shape(mesh, spec: tuple, shape: tuple) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor under ``spec``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= _axis_size(sizes, entry)
    return tuple(out)


def tree_shardings(mesh, rules: dict, axes_tree, abstract_tree):
    """The spec tree matching ``abstract_tree`` (nested dicts of tensors, or
    of anything with a ``shape``)."""

    def go(ax, ab):
        if isinstance(ab, dict):
            return {k: go(ax[k], ab[k]) for k in ab}
        return spec_for(mesh, rules, ax, tuple(ab.shape))

    return go(axes_tree, abstract_tree)


def zero1_axes(logical: tuple, shape: tuple, mesh, rules: dict) -> tuple:
    """Optimizer-state logical axes: additionally shard the first dim that is
    currently replicated and divisible by the data axes (ZeRO-1)."""
    dp = rules.get("batch")
    if dp is None:
        return logical
    dp_size = _axis_size(mesh_axes(mesh), dp)
    current = [rules.get(n) for n in logical]
    if any(v is not None and set((v if isinstance(v, tuple) else (v,))) & {"pod", "data"}
           for v in current):
        return logical  # already uses a data axis (e.g. experts)
    for i, (dim, name) in enumerate(zip(shape, logical)):
        if rules.get(name) is None and dim % dp_size == 0 and dim > 1:
            return logical[:i] + ("batch",) + logical[i + 1:]
    return logical


# ---------------------------------------------------------------------------
# Ambient mesh context for activation sharding hints
# ---------------------------------------------------------------------------
class _Ctx(threading.local):
    mesh = None
    rules: Optional[dict] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[dict] = None):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules if rules is not None else (make_rules(mesh) if mesh else None)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[dict]:
    return _CTX.rules


_MISSING = object()


def hint(x: torch.Tensor, logical: tuple) -> torch.Tensor:
    """A DTensor redistributed to ``spec_for``'s placements under an ambient
    mesh; identity otherwise (no mesh, or a plain tensor).

    The port's only DTensors are the leaves of a resharding restore
    (``checkpoint.restore_checkpoint(..., shardings=, mesh=)``); the model
    code takes plain tensors (data-parallel training all-reduces them), so
    at the models' call sites, the reference's, it returns its argument;
    they wait for execution along the "model" axis.

    If any named logical axis is absent from the active rules the hint is a
    no-op (lets optional hints — e.g. MoE buffer EP constraints — be enabled
    per-run by adding the rule, without constraining baseline runs)."""
    mesh = _CTX.mesh
    if mesh is None or not hasattr(x, "redistribute"):
        return x
    if any(n is not None and _CTX.rules.get(n, _MISSING) is _MISSING for n in logical):
        return x
    spec = spec_for(mesh, _CTX.rules, logical, tuple(x.shape))
    return x.redistribute(mesh, placements(mesh, spec))
