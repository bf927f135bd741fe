"""Step functions (prefill / decode), shared by the serving engine and
``chip_smoke.py``. The sharding trees of ``repro.launch.steps`` wait for a
multi-GPU slice."""
from __future__ import annotations

from ..configs.base import ModelConfig
from ..models import transformer


def make_prefill_step(cfg: ModelConfig, *, logits_mode: str = "all"):
    """(params, batch) -> (last logits, cache); ``batch`` as ``forward``
    takes it (tokens, and whisper's ``frames`` or internvl2's
    ``patch_embeds``), passed through unchanged."""

    def prefill_step(params, batch):
        logits, cache = transformer.forward(
            cfg, params, batch, emit_cache=True, logits_mode=logits_mode
        )
        return logits[:, -1:, :], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return transformer.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
