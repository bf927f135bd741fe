"""Checkpoint I/O in the reference's format (``repro.checkpoint.io``): one
``arrays.npz`` of the state's leaves under their ``/``-joined keys and a
JSON manifest (step, keys, shapes, dtypes, a digest of the shapes),
written to a temporary directory and renamed into place, so a crash never
leaves a half-written ``step_*`` directory; ``keep`` newest are retained.

Tensors go to the host with ``.cpu().numpy()``. A bf16 leaf is written as
the reference writes one: its raw two-byte values (numpy ``|V2``) with
``"bfloat16"`` in the manifest; ``restore_checkpoint`` turns such a leaf
back into a bf16 tensor (the reference's own reader returns the raw
bytes). Either package reads the other's checkpoints.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import tempfile
import time
from typing import Optional

import numpy as np
import torch

#: numpy's view of a bf16 leaf: its raw bytes, as the reference stores it
BF16_VOID = np.dtype("V2")


def _flatten(tree, prefix=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
    else:
        out["/".join(prefix)] = tree
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        t = tree
        for p in parts[:-1]:
            t = t.setdefault(p, {})
        t[parts[-1]] = v
    return tree


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and its manifest dtype."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.cpu().view(torch.int16).numpy().view(BF16_VOID), "bfloat16"
        x = x.cpu().numpy()
    a = np.asarray(x)
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, state: dict, *,
                    keep: int = 3) -> pathlib.Path:
    """state: nested dicts of tensors or arrays (params/opt/extra). Returns
    the final directory."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat, dtypes = {}, {}
    for k, v in _flatten(state).items():
        flat[k], dtypes[k] = _host(v)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=f".tmp_step{step}_"))
    try:
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(flat),
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": dtypes,
        }
        manifest["digest"] = hashlib.sha256(
            json.dumps(manifest["shapes"], sort_keys=True).encode()
        ).hexdigest()[:16]
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)
    for p in ckpt_dir.glob(".tmp_*"):
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir: str | pathlib.Path) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted(ckpt_dir.glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore_checkpoint(ckpt_dir: str | pathlib.Path, step: Optional[int] = None,
                       *, device=None) -> tuple[dict, int]:
    """Returns (state, step): numpy arrays (bf16 leaves as bf16 tensors on
    the CPU), or, given ``device``, every leaf as a tensor there. ``step``
    None reads the latest."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    with np.load(d / "arrays.npz") as z:
        for k in manifest["keys"]:
            a = z[k]
            if manifest["dtypes"][k] == "bfloat16":
                a = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            elif device is not None:
                a = torch.from_numpy(a)
            flat[k] = a.to(device) if device is not None else a
    return _unflatten(flat), int(manifest["step"])
