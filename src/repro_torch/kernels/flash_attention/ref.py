"""Plain PyTorch version of the flash-attention kernel.

``attention_ref`` computes what ``csrc/flash_attention.cu`` computes, with
the whole (Sq, Sk) score matrix: the CPU path of ``flash_attention_bhsd``
and the yardstick the kernel is held against on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None):
    """q: (BHq, Sq, Dh); k, v: (BHkv, Sk, Dh) -> (BHq, Sq, Dh) in q's dtype.
    Query head h reads kv head h // (BHq // BHkv); positions count from 0
    for q and k alike; masked scores take the finite ``NEG_INF``."""
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    g = bhq // bhkv
    kf = k.float().repeat_interleave(g, dim=0)
    vf = v.float().repeat_interleave(g, dim=0)
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) / math.sqrt(dh)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)
