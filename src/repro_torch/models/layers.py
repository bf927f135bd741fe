"""Shared primitive layers: norms, MLPs, rotary / sinusoidal positions.

Plain functions on tensors, as ``repro.models.layers``; parameters are the
nested dicts of ``schema.init_params``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .schema import P, Schema


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------
def norm_schema(cfg: ModelConfig) -> Schema:
    s: Schema = {"scale": P((cfg.d_model,), ("embed",), init="ones")}
    if cfg.norm_type == "layernorm":
        s["bias"] = P((cfg.d_model,), ("embed",), init="zeros")
    return s


def apply_norm(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm or LayerNorm, computed in fp32 and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * params["scale"].float() + params["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * params["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------------
# Dense MLP (SwiGLU or plain)
# ----------------------------------------------------------------------------
def mlp_schema(cfg: ModelConfig) -> Schema:
    d, f = cfg.d_model, cfg.d_ff
    s: Schema = {
        "w1": P((d, f), ("embed", "mlp")),
        "w2": P((f, d), ("mlp", "embed")),
    }
    if cfg.mlp_gated:
        s["w3"] = P((d, f), ("embed", "mlp"))
    if cfg.linear_bias:
        s["b1"] = P((f,), ("mlp",), init="zeros")
        s["b2"] = P((d,), ("embed",), init="zeros")
        if cfg.mlp_gated:
            s["b3"] = P((f,), ("mlp",), init="zeros")
    return s


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def apply_mlp(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    h = x @ params["w1"]
    if cfg.linear_bias:
        h = h + params["b1"]
    h = _act(cfg.mlp_act, h)
    if cfg.mlp_gated:
        g = x @ params["w3"]
        if cfg.linear_bias:
            g = g + params["b3"]
        h = h * g
    y = h @ params["w2"]
    if cfg.linear_bias:
        y = y + params["b2"]
    return y


# ----------------------------------------------------------------------------
# Positions
# ----------------------------------------------------------------------------
def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    dh = cfg.head_dim
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (cfg.rope_theta ** exps)  # (dh/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S). Rotates the two HALVES
    of each head against each other (not interleaved pairs), as ``repro``."""
    angles = positions[..., None].float() * inv_freq  # (..., S, dh/2)
    if angles.ndim == 2:  # (S, dh/2) -> broadcast over batch/heads
        angles = angles[None, :, None, :]
    else:  # (B, S, dh/2)
        angles = angles[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset=0, device=None) -> torch.Tensor:
    """(seq_len, d_model) fp32; ``offset`` is an int or a 0-d tensor."""
    pos = (torch.arange(seq_len, dtype=torch.float32, device=device) + offset)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d_model)
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : d_model // 2])
    return pe
