"""Carry parameters, optimizer states and decode caches between ``repro``
and the port.

The reference's trees are nested dicts of arrays with the same keys and
stacked ``[L, ...]`` layer leaves as the port's. These functions take and
give numpy arrays (``np.asarray`` of a jax array), so the port never imports
the reference: a test turns the reference's weights into the port's and both
packages compute the same function.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .schema import leaf_paths, set_path
from .transformer import cache_spec, model_schema, torch_dtype


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    """A writable copy; floats go through fp32, since torch does not read
    ml_dtypes' bfloat16 numpy arrays."""
    x = np.asarray(a)
    x = np.array(x, dtype=x.dtype if np.issubdtype(x.dtype, np.integer) else np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def params_from_reference(cfg: ModelConfig, tree: dict, *, device="cuda") -> dict:
    """The reference's parameter tree (numpy arrays) as the port's
    parameters, in ``cfg.param_dtype`` on ``device``. Raises ValueError if a
    key is missing or extra or a shape differs from the port's schema."""
    dev = resolve_device(device)
    got = dict(leaf_paths(tree))
    want = dict(leaf_paths(model_schema(cfg)))
    if set(got) != set(want):
        raise ValueError(f"parameter keys differ: missing "
                         f"{sorted(set(want) - set(got))}, extra "
                         f"{sorted(set(got) - set(want))}")
    out: dict = {}
    dt = torch_dtype(cfg.param_dtype)
    for path, p in want.items():
        a = got[path]
        if tuple(np.shape(a)) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {np.shape(a)}, schema {p.shape}")
        set_path(out, path, _tensor(a, dt, dev))
    return out


def opt_state_from_reference(cfg: ModelConfig, opt_state: dict, *, device="cuda") -> dict:
    """The reference's AdamW state (``{"m", "v", "step"}``, numpy arrays) as
    the port's (``optim.adamw_init``'s layout) on ``device``: the moments
    keep their dtype (fp32, or bf16 for the reference's ``moment_dtype``),
    checked against the parameters' schema as ``params_from_reference``
    checks weights; the step an int32 scalar."""
    dev = resolve_device(device)
    want = dict(leaf_paths(model_schema(cfg)))
    out = {}
    for name in ("m", "v"):
        got = dict(leaf_paths(opt_state[name]))
        if set(got) != set(want):
            raise ValueError(f"{name}: keys differ from the parameters' schema")
        tree: dict = {}
        for path, p in want.items():
            a = np.asarray(got[path])
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}/{'/'.join(path)}: shape {a.shape}, schema {p.shape}")
            dt = torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32
            set_path(tree, path, _tensor(a, dt, dev))
        out[name] = tree
    out["step"] = torch.tensor(int(np.asarray(opt_state["step"])), dtype=torch.int32, device=dev)
    return out


def cache_from_reference(cfg: ModelConfig, cache: dict, *, device="cuda") -> dict:
    """The reference's decode cache (numpy arrays) as the port's. The batch
    size is any leaf's second axis; the K/V ring's length is that of
    ``slot_pos`` (rwkv6's recurrent cache has no ring)."""
    dev = resolve_device(device)
    batch = np.shape(next(iter(cache.values())))[1]
    ring = np.shape(cache["slot_pos"])[2] if "slot_pos" in cache else 0
    spec = cache_spec(cfg, batch, ring)
    if set(cache) != set(spec):
        raise ValueError(f"cache keys {sorted(cache)}, want {sorted(spec)}")
    out = {}
    for name, (shape, dt) in spec.items():
        if tuple(np.shape(cache[name])) != tuple(shape):
            raise ValueError(f"{name}: shape {np.shape(cache[name])}, want {shape}")
        out[name] = _tensor(cache[name], dt, dev)
    return out


def cache_to_arrays(cache: dict) -> dict:
    """The port's decode cache as numpy arrays (float leaves as fp32)."""
    return {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
            for k, v in cache.items()}
