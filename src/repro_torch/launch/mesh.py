"""Mesh construction (the port of ``repro.launch.mesh``), and the
data-parallel world torchrun describes.

Functions, not module-level constants, so importing this module never
touches ``torch.distributed``. Single pod = (data=16, model=16) -> 256
ranks; multi-pod = (pod=2, data=16, model=16) -> 512 ranks. A
``DeviceMesh`` needs the default process group with that many ranks; the
dry run takes ``abstract_production_mesh``'s axis names and sizes instead.
"""
from __future__ import annotations

import math
import os

import torch

from ..parallel.sharding import AbstractMesh


def _production_shape(multi_pod: bool) -> tuple[tuple, tuple]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _mesh_device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The production ``DeviceMesh`` over the default process group; fewer
    ranks than the shape needs raise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = _production_shape(multi_pod)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but only {world} present; the dry run "
            "takes abstract_production_mesh() instead"
        )
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=axes)


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes, with no devices."""
    return AbstractMesh(*_production_shape(multi_pod))


def make_local_mesh(axes=("data", "model")):
    """A (world, 1, ...) ``DeviceMesh`` over the default process group: every
    rank on the first axis (data parallelism), the others of size 1."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (dist.get_world_size(),) + (1,) * (len(axes) - 1)
    return init_device_mesh(_mesh_device_type(), shape, mesh_dim_names=tuple(axes))


def dp_world() -> tuple[int, int, int]:
    """(rank, world size, local rank) as torchrun's environment gives them;
    (0, 1, 0) without it."""
    env = os.environ
    return (int(env.get("RANK", 0)), int(env.get("WORLD_SIZE", 1)),
            int(env.get("LOCAL_RANK", env.get("RANK", 0))))


def init_data_parallel(device: torch.device):
    """When torchrun's environment says the world is larger than one:
    initialise the default process group (NCCL on the card, gloo on the
    CPU; ``MASTER_ADDR``/``MASTER_PORT`` from the environment) unless it is
    up already, and return the mesh of data = world size, model = 1.
    Returns None for a world of one, and creates nothing."""
    import torch.distributed as dist

    rank, world, _ = dp_world()
    if world <= 1:
        return None
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://", rank=rank, world_size=world)
    return make_local_mesh()
