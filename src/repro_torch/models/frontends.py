"""Modality frontend stubs and the inputs of every (architecture, shape).

The port of ``repro.models.frontends``. As in the reference, whisper's conv
audio frontend and internvl2's InternViT are stubs: the model takes their
outputs as embeddings (``frames``, ``patch_embeds``), and
``synth_inputs`` draws them at random.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from .transformer import cache_spec, init_cache, torch_dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """(shape, torch dtype) for every model input of (arch, shape), as
    ``cache_spec`` gives them:

    train   -> the loss's inputs: tokens and labels (and frontend embeds)
    prefill -> ``forward(..., emit_cache=True)``'s: tokens (and embeds)
    decode  -> ``decode_step``'s: a cache of seq_len, one token a sequence,
               the position (a scalar)
    """
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def tok(*sh):
        return (sh, torch.int32)

    if shape.kind == "decode":
        return {"cache": cache_spec(cfg, b, s), "tokens": tok(b, 1), "pos": tok()}
    d: dict = {}
    text = s
    if cfg.frontend == "vision":
        d["patch_embeds"] = ((b, cfg.n_frontend_tokens, cfg.d_model), dt)
        text = s - cfg.n_frontend_tokens
    elif cfg.enc_dec:
        d["frames"] = ((b, cfg.encoder_seq, cfg.d_model), dt)
    d["tokens"] = tok(b, text)
    if shape.kind == "train":
        d["labels"] = tok(b, text)
    return {"batch": d}


def synth_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                 device="cuda") -> dict:
    """Random inputs of ``input_specs``' shapes and dtypes, from a
    ``torch.Generator`` seeded with ``seed``: ints in [0, min(vocab, 1000)),
    floats normal · 0.02; a decode shape's cache empty (``init_cache``) and
    its position 0. The values are not the reference's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    hi = min(cfg.vocab_size, 1000)

    def make(shape, dt):
        if dt == torch.int32:
            return torch.randint(0, hi, shape, generator=gen, dtype=dt, device=dev)
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(dt)

    specs = input_specs(cfg, shape)
    if shape.kind == "decode":
        return {"cache": init_cache(cfg, shape.global_batch, shape.seq_len, device=dev),
                "tokens": make(*specs["tokens"]),
                "pos": torch.zeros((), dtype=torch.int32, device=dev)}
    return {"batch": {name: make(*spec) for name, spec in specs["batch"].items()}}
