"""Weights made from the seed, on the device, in a few large calls.

A reference module's ``leaves(model)`` lists the parameter tree the program
takes (path, shape, init). This module fills it from one ``torch.Generator``
on the device: every normal leaf from one stream of ``randn``, every
uniform leaf from one stream of ``rand``, each leaf then a copy of its own
slice. The same seed gives the same tree, so the reference makes the
program's starting weights again after the window, without reading the
program's state.

Init kinds: ``("normal", std)``, ``("uniform", lo, hi)``, ``("scale",
noise)`` (1 + noise · N(0, 1), a norm's scale), and ``("decay_base",)`` (a
spread of RWKV6's base decay over [-6, 1] across channels, no randomness).
"""
from __future__ import annotations

import torch

#: the largest slice drawn by one call
CALL_ELEMS = 1 << 30


def _draw(gen, n: int, fn, device) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.float32, device=device)
    for start in range(0, n, CALL_ELEMS):
        stop = min(n, start + CALL_ELEMS)
        fn(stop - start, generator=gen, out=out[start:stop])
    return out


def make(leaves: list, seed: int, device, requires_grad: bool = False) -> dict:
    """The nested parameter dict, fp32, on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    numel = {path: _numel(shape) for path, shape, _ in leaves}
    normal = [x for x in leaves if x[2][0] in ("normal", "scale")]
    uniform = [x for x in leaves if x[2][0] == "uniform"]
    streams = {
        "n": _draw(gen, sum(numel[p] for p, _, _ in normal), torch.randn, device),
        "u": _draw(gen, sum(numel[p] for p, _, _ in uniform), torch.rand, device),
    }
    offsets = {"n": 0, "u": 0}
    tree: dict = {}
    for path, shape, init in leaves:
        kind = init[0]
        n = numel[path]
        if kind in ("normal", "scale", "uniform"):
            key = "u" if kind == "uniform" else "n"
            raw = streams[key][offsets[key]:offsets[key] + n].view(shape)
            offsets[key] += n
            if kind == "normal":
                leaf = raw * init[1]
            elif kind == "scale":
                leaf = 1.0 + init[1] * raw
            else:
                leaf = init[1] + (init[2] - init[1]) * raw
        elif kind == "decay_base":
            r = torch.linspace(0.0, 1.0, shape[-1], dtype=torch.float32, device=device)
            leaf = (-6.0 + 7.0 * r ** 1.5).expand(shape).contiguous()
        else:
            raise ValueError(f"unknown init {init!r} for {'.'.join(path)}")
        leaf.requires_grad_(requires_grad)
        _set(tree, path, leaf)
    return tree


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _set(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def flat(tree: dict, prefix=()) -> list:
    """(path, leaf) of a nested dict, depth-first in sorted key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += flat(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out
