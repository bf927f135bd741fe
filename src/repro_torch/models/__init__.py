"""Language models of the port (the dense family; see ``transformer``)."""
from .transformer import decode_step, forward, init_cache, init_model, model_schema

__all__ = ["decode_step", "forward", "init_cache", "init_model", "model_schema"]
