"""RWKV6 (Finch) block: data-dependent-decay time mixing + channel mixing.

The port of ``repro.models.rwkv6``. Sequence mode (``apply_time_mix``,
prefill and training) runs the WKV6 recurrence through
``kernels.rwkv6.ops.wkv6``: the CUDA kernels for CUDA tensors (under
autograd the forward kernel and the backward kernel's three passes, through
``kernels.rwkv6.kernel.WKV6``), the plain chunked form for CPU tensors,
which autograd differentiates. Under remat "dots" only the products with a
weight are kept, so the forward kernel runs twice a layer and microbatch,
once more in the backward's recompute. Decode
(``apply_time_mix_step``) runs the one-token recurrence ``wkv_step`` in plain
PyTorch, as the reference does. ``wkv_chunked`` is the plain chunked form
with the reference's signature.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.rwkv6.ops import wkv6
from ..kernels.rwkv6.ref import wkv_chunked
from .schema import P, Schema

__all__ = ["apply_channel_mix", "apply_channel_mix_step", "apply_time_mix",
           "apply_time_mix_step", "rwkv_schema", "wkv_chunked", "wkv_step"]


def rwkv_schema(cfg: ModelConfig) -> Schema:
    assert cfg.rwkv is not None
    d, f = cfg.d_model, cfg.d_ff
    lora = cfg.rwkv.decay_lora
    tm: Schema = {
        "mu": P((5, d), (None, "embed"), init="zeros"),  # r,k,v,g,w token-shift mixes
        "wr": P((d, d), ("embed", "rwkv_inner")),
        "wk": P((d, d), ("embed", "rwkv_inner")),
        "wv": P((d, d), ("embed", "rwkv_inner")),
        "wg": P((d, d), ("embed", "rwkv_inner")),
        "wo": P((d, d), ("rwkv_inner", "embed")),
        "w0": P((d,), ("embed",), init="decay_base"),
        "wa": P((d, lora), ("embed", None), scale=0.01),
        "wb": P((lora, d), (None, "rwkv_inner"), scale=0.01),
        "u": P((d,), ("embed",), init="zeros"),
        "ln": P((d,), ("embed",), init="ones"),
    }
    cm: Schema = {
        "mu": P((2, d), (None, "embed"), init="zeros"),  # k, r mixes
        "wk": P((d, f), ("embed", "mlp")),
        "wv": P((f, d), ("mlp", "embed")),
        "wr": P((d, d), ("embed", "rwkv_inner")),
    }
    return {"tm": tm, "cm": cm}


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d); prev: (B, d) last token of the previous segment."""
    return torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu


def _decay(params, xw: torch.Tensor) -> torch.Tensor:
    """log w = -exp(w0 + tanh(xw wa) wb) in fp32, <= 0 always."""
    omega = params["w0"].float() + torch.tanh(xw.float() @ params["wa"].float()) @ params["wb"].float()
    return -torch.exp(omega)


def wkv_step(r, k, v, logw, u, state):
    """Single-token recurrence (decode). r, k, v, logw: (B, H, N); u: (H, N);
    state: (B, H, N, N) -> (o (B, H, N) fp32, state')."""
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    kv = kf[..., :, None] * vf[..., None, :]  # (B, H, N, N)
    o = torch.einsum("bhn,bhnm->bhm", rf, state + u.float()[..., None] * kv)
    return o, w[..., :, None] * state + kv


def _headnorm(x: torch.Tensor, scale: torch.Tensor, h: int, n: int, eps: float = 1e-5):
    """Per-head layernorm on (B, S, H*N), in fp32, cast back to x's dtype."""
    b, s, _ = x.shape
    xh = x.reshape(b, s, h, n).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    y = (xh - mu) * torch.rsqrt(var + eps)
    return (y.reshape(b, s, h * n) * scale.float()).to(x.dtype)


def apply_time_mix(cfg: ModelConfig, params, x: torch.Tensor, prev: torch.Tensor,
                   state: torch.Tensor):
    """x: (B, S, d); prev: (B, d); state: (B, H, N, N) -> (y, prev', state')."""
    hsize = cfg.rwkv.head_size
    h = cfg.d_model // hsize
    xs = _token_shift(x, prev)
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (_lerp(x, xs, mu[i]) for i in range(5))
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    logw = _decay(params, xw)
    b, s, d = x.shape
    shp = (b, s, h, hsize)
    out, state = wkv6(r.reshape(shp), k.reshape(shp), v.reshape(shp), logw.reshape(shp),
                      params["u"].float().reshape(h, hsize), state)
    out = _headnorm(out.to(x.dtype).reshape(b, s, d), params["ln"], h, hsize)
    return (out * g) @ params["wo"], x[:, -1, :], state


def apply_time_mix_step(cfg: ModelConfig, params, x: torch.Tensor, prev: torch.Tensor,
                        state: torch.Tensor):
    """Decode: x (B, 1, d) -> (y (B, 1, d), prev', state')."""
    hsize = cfg.rwkv.head_size
    h = cfg.d_model // hsize
    b = x.shape[0]
    xt = x[:, 0, :]
    mu = params["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (xt + (prev - xt) * mu[i] for i in range(5))
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    logw = _decay(params, xw)
    shp = (b, h, hsize)
    o, state = wkv_step(r.reshape(shp), k.reshape(shp), v.reshape(shp), logw.reshape(shp),
                        params["u"].float().reshape(h, hsize), state)
    o = _headnorm(o.to(x.dtype).reshape(b, 1, cfg.d_model), params["ln"], h, hsize)
    y = (o[:, 0] * g) @ params["wo"]
    return y[:, None, :], xt, state


def apply_channel_mix(cfg: ModelConfig, params, x: torch.Tensor, prev: torch.Tensor):
    """x: (B, S, d); prev: (B, d) -> (y, prev')."""
    xs = _token_shift(x, prev)
    mu = params["mu"].to(x.dtype)
    xk = _lerp(x, xs, mu[0])
    xr = _lerp(x, xs, mu[1])
    k = F.relu(xk @ params["wk"]).square()
    return torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"]), x[:, -1, :]


def apply_channel_mix_step(cfg: ModelConfig, params, x: torch.Tensor, prev: torch.Tensor):
    xt = x[:, 0, :]
    mu = params["mu"].to(x.dtype)
    xk = xt + (prev - xt) * mu[0]
    xr = xt + (prev - xt) * mu[1]
    k = F.relu(xk @ params["wk"]).square()
    y = torch.sigmoid(xr @ params["wr"]) * (k @ params["wv"])
    return y[:, None, :], xt
