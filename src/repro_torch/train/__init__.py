"""Training (``loop``: ``Trainer``, ``TrainerConfig``) and serving
(``serve``: ``ServeEngine``)."""
from .loop import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
