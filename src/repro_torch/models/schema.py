"""Schema-driven parameter trees (the port of ``repro.models.schema``).

A *schema* is a nested dict whose leaves are ``P`` descriptors (shape, logical
axes, init kind); ``init_params`` turns it into a nested dict of tensors with
the same keys, ``abstract_params`` into one of ``meta`` tensors (shapes and
dtypes, no storage: the dry run's), and ``logical_axes`` into the tree of
logical axis names that ``parallel.sharding`` maps onto a mesh.

Initial weights come from one ``torch.Generator`` walking the leaves in a
fixed order, so a seed gives the same weights on every run. They are not the
reference's: ``repro`` seeds each leaf from Python's per-process string hash.
Tests carry the reference's weights across instead (``models/carry.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple  # logical axis names (or None), len == len(shape)
    init: str = "normal"  # normal | zeros | ones | a_log | decay_base
    scale: Optional[float] = None  # stddev override; default fan-in scaled

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Schema = dict  # nested dict[str, "Schema | P"]


def leaf_paths(tree: dict, prefix=()):
    """(path, leaf) of a schema or a parameter tree, depth-first in sorted
    key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def map_tree(tree: dict, fn) -> dict:
    """The nested dict with ``fn`` applied to every leaf."""
    return {k: map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def set_path(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _fan_in(shape: tuple) -> int:
    if len(shape) == 1:
        return shape[0]
    # last dim is the output dim by convention in this codebase
    return int(np.prod(shape[:-1])) or 1


def _init_leaf(gen: torch.Generator, p: P, dtype, device) -> torch.Tensor:
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "a_log":
        # mamba-style: A = -(1..state) over the inner dim; stored as log(1..state)
        a = torch.arange(1, p.shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(p.shape).to(dtype).contiguous()
    if p.init == "decay_base":
        # rwkv base decay omega_0: spread over [-6, 1] across channels
        r = torch.linspace(0.0, 1.0, p.shape[-1], dtype=torch.float32, device=device)
        return (-6.0 + 7.0 * r**1.5).expand(p.shape).to(dtype).contiguous()
    if p.init != "normal":
        raise NotImplementedError(f"init kind {p.init!r} (its family is not ported)")
    scale = p.scale if p.scale is not None else 1.0 / math.sqrt(_fan_in(p.shape))
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def init_params(schema: Schema, gen: torch.Generator, dtype=torch.float32) -> dict:
    """A tensor for every leaf, on the generator's device."""
    params: dict = {}
    for path, p in leaf_paths(schema):
        set_path(params, path, _init_leaf(gen, p, dtype, gen.device))
    return params


def abstract_params(schema: Schema, dtype=torch.float32) -> dict:
    """A ``meta`` tensor for every leaf (for dry runs: no allocation)."""
    tree: dict = {}
    for path, p in leaf_paths(schema):
        set_path(tree, path, torch.empty(p.shape, dtype=dtype, device="meta"))
    return tree


def logical_axes(schema: Schema) -> dict:
    tree: dict = {}
    for path, p in leaf_paths(schema):
        set_path(tree, path, p.axes)
    return tree


def stacked(schema: Schema, n: int) -> Schema:
    """Add a leading ``layers`` axis of size n to every leaf."""
    out: dict = {}
    for path, p in leaf_paths(schema):
        set_path(out, path, P((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale))
    return out


def count_params(schema: Schema) -> int:
    return sum(int(np.prod(p.shape)) for _, p in leaf_paths(schema))
