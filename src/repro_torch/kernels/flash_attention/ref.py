"""Plain PyTorch versions of the flash-attention kernels.

``attention_ref`` computes what ``csrc/flash_attention.cu`` computes, with
the whole (Sq, Sk) score matrix: the CPU path of ``flash_attention_bhsd``
and the yardstick the kernel is held against on the card.
``attention_lse_ref`` is the row log-sum-exp the forward kernels emit for
the backward, and ``attention_bwd_ref`` the backward kernels' function
(``csrc/flash_attention_bwd_wgmma.cu``, ``csrc/flash_attention_bwd.cu``)
from its explicit formulas. The backward pair works in fp32 and takes the
kv heads a few at a time, so that the score matrices of long sequences fit
beside a model on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
#: score-matrix elements the backward pair holds at once (fp32, 1 GiB)
CHUNK_ELEMENTS = 1 << 28


def live_mask(sq: int, sk: int, *, causal: bool, window, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: the (query, key) pairs a row attends to; positions
    count from 0 for q and k alike."""
    q_pos = torch.arange(sq, device=device)[:, None]
    k_pos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


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
    mask = live_mask(sq, sk, causal=causal, window=window, device=q.device)
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)


def _kv_chunks(bhkv: int, g: int, sq: int, sk: int):
    """The kv-head slices the backward pair takes at a time."""
    step = max(1, CHUNK_ELEMENTS // max(1, g * sq * sk))
    return [slice(i, min(i + step, bhkv)) for i in range(0, bhkv, step)]


def _scores(q, k, g: int, mask) -> torch.Tensor:
    """fp32 scores (kv heads, g, Sq, Sk) of q (kv heads * g, Sq, Dh) against
    k (kv heads, Sk, Dh), scaled, masked with ``NEG_INF``."""
    hkv, sk, dh = k.shape
    qg = q.float().reshape(hkv, g, -1, dh)
    s = torch.einsum("ngqd,nkd->ngqk", qg, k.float()) / math.sqrt(dh)
    return torch.where(mask, s, NEG_INF)


def attention_lse_ref(q, k, *, causal=True, window=None) -> torch.Tensor:
    """The row log-sum-exp of the scaled, masked scores: (BHq, Sq) fp32, as
    the forward kernels emit it."""
    bhq, sq, _ = q.shape
    bhkv, sk, _ = k.shape
    g = bhq // bhkv
    mask = live_mask(sq, sk, causal=causal, window=window, device=q.device)
    out = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
    for c in _kv_chunks(bhkv, g, sq, sk):
        s = _scores(q[c.start * g:c.stop * g], k[c], g, mask)
        out[c.start * g:c.stop * g] = torch.logsumexp(s, dim=-1).reshape(-1, sq)
    return out


def attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=None):
    """(dq, dk, dv) of ``attention_ref`` at output gradient ``do``, from
    the explicit formulas, in fp32, cast to the inputs' dtypes:
    P = exp(S·scale − lse), D = rowsum(do ∘ o), dS = P ∘ (do Vᵀ − D),
    dV = Σ_group Pᵀ do, dK = Σ_group dSᵀ Q · scale, dQ = dS K · scale.
    ``o`` and ``lse`` are the forward's output and row log-sum-exp."""
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    g = bhq // bhkv
    scale = 1.0 / math.sqrt(dh)
    mask = live_mask(sq, sk, causal=causal, window=window, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    for c in _kv_chunks(bhkv, g, sq, sk):
        rows = slice(c.start * g, c.stop * g)
        n = c.stop - c.start
        p = torch.exp(_scores(q[rows], k[c], g, mask)
                      - lse[rows].float().reshape(n, g, sq, 1))
        dof = do[rows].float().reshape(n, g, sq, dh)
        d = (dof * o[rows].float().reshape(n, g, sq, dh)).sum(-1, keepdim=True)
        ds = p * (torch.einsum("ngqd,nkd->ngqk", dof, v[c].float()) - d)
        dv[c] = torch.einsum("ngqk,ngqd->nkd", p, dof)
        dk[c] = torch.einsum("ngqk,ngqd->nkd", ds,
                             q[rows].float().reshape(n, g, sq, dh)) * scale
        dq[rows] = (torch.einsum("ngqk,nkd->ngqd", ds, k[c].float()) * scale).reshape(-1, sq, dh)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
