"""Config registry: ``get_config(arch_id)`` resolves any architecture."""
from __future__ import annotations

from .archs import ASSIGNED, EXTRAS
from .base import (
    LONG_CONTEXT_CAPABLE,
    SHAPES,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    ShapeConfig,
    SSMConfig,
    reduced,
    supports_shape,
)

REGISTRY: dict[str, ModelConfig] = {**ASSIGNED, **EXTRAS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def arch_ids(assigned_only: bool = True) -> list[str]:
    return sorted(ASSIGNED if assigned_only else REGISTRY)


__all__ = [
    "ASSIGNED",
    "LONG_CONTEXT_CAPABLE",
    "ModelConfig",
    "MoEConfig",
    "REGISTRY",
    "RWKVConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "arch_ids",
    "get_config",
    "get_shape",
    "reduced",
    "supports_shape",
]
