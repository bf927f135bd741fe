"""Language models of the port: every family of the registry (see
``transformer``), and the inputs of each (architecture, shape)
(``frontends``)."""
from .frontends import input_specs, synth_inputs
from .transformer import decode_step, forward, init_cache, init_model, model_schema

__all__ = ["decode_step", "forward", "init_cache", "init_model", "input_specs",
           "model_schema", "synth_inputs"]
