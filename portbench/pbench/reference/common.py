"""Plain PyTorch pieces the reference models share: products with a
weight, norms, positions, attention, the loss, clipping and AdamW.

Everything computes in fp32 with TF32 off (``strict_fp32``), unless asked
for in fp8: with ``quant="fp8"`` every tensor that the program holds in its
compute dtype is held in float8 e4m3 instead, one scale a tensor: both
operands and the output of every product with a weight (forward and, under
autograd, both backward products) and, through ``act``, the activations
between them (the residual stream, norms' outputs, mixes), their gradients
rounded alike. That is the control: the reference computed one step below
the bf16 the configurations state.

Imports nothing of the program.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0  # largest finite float8 e4m3fn


def strict_fp32() -> None:
    """fp32 products stay fp32: no TF32 in matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale, back in fp32."""
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale


class _Fp8(torch.autograd.Function):
    """x held in fp8; its gradient too."""

    @staticmethod
    def forward(ctx, x):
        return fp8(x)

    @staticmethod
    def backward(ctx, dy):
        return fp8(dy)


class _Fp8Product(torch.autograd.Function):
    """y = fp8(fp8(x) @ fp8(w)); dx = fp8(fp8(dy) @ fp8(w)ᵀ); dw = fp8(x)ᵀ @ fp8(dy)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        return fp8(xq @ wq)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = fp8(dy)
        dx = fp8(dyq @ wq.T)
        dw = xq.reshape(-1, xq.shape[-1]).T @ dyq.reshape(-1, dyq.shape[-1])
        return dx, dw


def act(x: torch.Tensor, quant=None) -> torch.Tensor:
    """An activation as the compute dtype holds it: x itself in fp32, or in fp8."""
    return x if quant is None else _Fp8.apply(x)


def mm(x: torch.Tensor, w: torch.Tensor, quant=None) -> torch.Tensor:
    """x (..., k) @ w (k, n), in fp32 or with fp8 operands."""
    if quant is None:
        return x @ w
    if quant != "fp8":
        raise ValueError(f"unknown precision {quant!r}")
    return _Fp8Product.apply(x, w)


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def sinusoidal(s: int, d: int, device) -> torch.Tensor:
    """The Transformer's absolute positions: sin on even, cos on odd channels."""
    pos = torch.arange(s, dtype=F32, device=device)[:, None]
    angle = pos / torch.pow(10000.0, torch.arange(0, d, 2, dtype=F32, device=device) / d)
    pe = torch.empty((s, d), dtype=F32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh): the two halves of each head rotated against each
    other by position · theta^(-2i/Dh)."""
    s, dh = x.shape[1], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device) / dh)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 2048) -> torch.Tensor:
    """Softmax(q kᵀ / √Dh) v under the causal mask, GQA (query head h reads
    key head h // (Hq / Hkv)), in blocks of ``block`` queries against the
    keys up to the block's end. q (B, S, Hq, Dh); k, v (B, S, Hkv, Dh)."""
    b, s, hq, dh = q.shape
    g = hq // k.shape[2]
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2)  # (B, Hq, S, Dh)
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2)
    qt = q.transpose(1, 2)
    outs = []
    for i0 in range(0, s, block):
        i1 = min(s, i0 + block)
        sc = qt[:, :, i0:i1] @ kt[:, :, :i1].transpose(-1, -2) / math.sqrt(dh)
        qpos = torch.arange(i0, i1, device=q.device)[:, None]
        kpos = torch.arange(i1, device=q.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(torch.softmax(sc, dim=-1) @ vt[:, :, :i1])
    return torch.cat(outs, dim=2).transpose(1, 2)


def token_shift(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) moved one position later, zeros first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Σ over positions of logsumexp(logits) - logits[label]."""
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def cosine_lr(step: int, peak: float, warmup: int, total: int, min_ratio: float = 0.1) -> float:
    """Linear warm-up to ``peak``, then a cosine to ``min_ratio`` · peak at ``total``."""
    if step < warmup:
        return peak * min(step / max(warmup, 1), 1.0)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return peak * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def clip_global(grads: list, max_norm: float) -> None:
    """Every gradient scaled in place by min(1, max_norm / ‖g‖), ‖g‖ over all."""
    total = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-9), max=1.0)
    for g in grads:
        g.mul_(scale)


@torch.no_grad()
def adamw(params: list, grads: list, m: list, v: list, step: int, lr: float, b1=0.9,
          b2=0.95, eps=1e-8, wd=0.1) -> None:
    """One AdamW step (``step`` counted from 1), bias-corrected, decoupled
    decay on every leaf, in place."""
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * ((mi / bc1) / ((vi / bc2).sqrt() + eps) + wd * p))
