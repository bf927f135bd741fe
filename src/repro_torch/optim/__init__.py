"""AdamW with global-norm clipping and the cosine schedule: the port of
``repro.optim``, plain functions on dicts of tensors."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule"]
