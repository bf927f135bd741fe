"""Checkpoints in the reference's on-disk format, lease-guarded writers and
the async writer: the port of ``repro.checkpoint``."""
from .io import latest_step, restore_checkpoint, save_checkpoint
from .manager import AsyncCheckpointer, CheckpointManager

__all__ = [
    "AsyncCheckpointer",
    "CheckpointManager",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
