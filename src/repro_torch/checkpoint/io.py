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

The resharding restore (``restore_checkpoint(..., shardings=, mesh=)``)
places leaves straight onto a ``DeviceMesh``: ``shardings`` is a tree of
specs (``parallel.sharding``'s tuples, as ``launch.steps.param_shardings``
and ``opt_shardings`` build them) matched to the state by path. Each rank
reads the saved array on the host, cuts its own slice there (the mesh
coordinates of ``sharding.placements(mesh, spec)``'s ``Shard`` dims, in
mesh-dim order, as DTensor lays shards out) and copies only that slice to
the mesh's device, where ``DTensor.from_local`` wraps it: no collective
runs. A leaf without a spec comes back as it would without ``shardings``.
"""
from __future__ import annotations

import hashlib
import json
import math
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


def _mesh_device(mesh) -> torch.device:
    """The device a ``DeviceMesh``'s local shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_slice(mesh, spec: tuple, a):
    """This rank's shard of the host array or tensor ``a`` under ``spec``,
    and the placements: each mesh dim that shards tensor dim d splits the
    part left by the mesh dims before it into equal pieces and keeps the
    piece at this rank's coordinate."""
    from ..parallel.sharding import placements

    pl = placements(mesh, spec)
    coord = mesh.get_coordinate()
    index = [slice(None)] * len(a.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            d, n = p.dim, mesh.size(i)
            s = index[d]
            start, stop = s.start or 0, a.shape[d] if s.stop is None else s.stop
            if (stop - start) % n:
                raise ValueError(f"dim {d} of {tuple(a.shape)} does not split "
                                 f"into {n} shards on mesh dim {i}")
            w = (stop - start) // n
            index[d] = slice(start + coord[i] * w, start + (coord[i] + 1) * w)
    return a[tuple(index)], pl


def _to_dtensor(mesh, spec: tuple, a):
    """A DTensor on ``mesh`` with ``spec``'s placements, from the host array
    (or CPU tensor) ``a`` of the whole leaf."""
    from torch.distributed.tensor import DTensor

    part, pl = _local_slice(mesh, spec, a)
    local = (part if isinstance(part, torch.Tensor)
             else torch.from_numpy(np.array(part, order="C")))
    local = local.contiguous().to(_mesh_device(mesh))
    full = tuple(a.shape)
    stride = tuple(math.prod(full[i + 1:]) for i in range(len(full)))
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=full,
                              stride=stride)


def restore_checkpoint(ckpt_dir: str | pathlib.Path, step: Optional[int] = None,
                       *, device=None, shardings=None, mesh=None) -> tuple[dict, int]:
    """Returns (state, step): numpy arrays (bf16 leaves as bf16 tensors on
    the CPU), or, given ``device``, every leaf as a tensor there. ``step``
    None reads the latest. With ``shardings`` (a spec tree, matched to the
    state by path) and ``mesh`` (a ``DeviceMesh``) every leaf that has a
    spec comes back as a DTensor on the mesh holding this rank's shard; a
    spec for a path the checkpoint lacks raises."""
    if shardings is not None and mesh is None:
        raise ValueError("restoring with shardings needs the mesh they refer to")
    flat_sh = {} if shardings is None else _flatten(shardings)
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if missing := sorted(set(flat_sh) - set(manifest["keys"])):
        raise KeyError(f"shardings name paths the checkpoint at {d} lacks: {missing}")
    flat = {}
    with np.load(d / "arrays.npz") as z:
        for k in manifest["keys"]:
            a = z[k]
            if manifest["dtypes"][k] == "bfloat16":
                a = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            if k in flat_sh:
                flat[k] = _to_dtensor(mesh, flat_sh[k], a)
                continue
            if device is not None and not isinstance(a, torch.Tensor):
                a = torch.from_numpy(a)
            flat[k] = a.to(device) if device is not None else a
    return _unflatten(flat), int(manifest["step"])
