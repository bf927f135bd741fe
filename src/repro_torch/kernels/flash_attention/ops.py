"""Public wrapper: the (B, S, H, Dh) layout of ``repro``'s attention code,
folded to the kernel's (B·H, S, Dh) and back. The tile size belongs to the
kernel, so there are no ``block_*`` arguments."""
from __future__ import annotations

import torch

from .kernel import flash_attention_bhsd


def flash_attention(q, k, v, *, causal: bool = True, window=None) -> torch.Tensor:
    """q: (B, Sq, Hq, Dh); k, v: (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh)."""
    b, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    qt = q.transpose(1, 2).reshape(b * hq, sq, dh)
    kt = k.transpose(1, 2).reshape(b * hkv, sk, dh)
    vt = v.transpose(1, 2).reshape(b * hkv, sk, dh)
    o = flash_attention_bhsd(qt, kt, vt, causal=causal, window=window)
    return o.reshape(b, hq, sq, dh).transpose(1, 2)
