"""GQA attention: projections and the plain attention functions.

``attention_full`` (score matrix) and ``attention_chunked`` (online softmax
over KV chunks) are the port of ``repro.models.attention``: plain PyTorch,
kept for the tests and for decode's cross-attention against the cached
encoder K/V. The model's sequence path, prefill's cross-attention
included, calls the flash kernel instead (``transformer._attn_seq``,
``transformer._cross``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import apply_rope, rope_freqs
from .schema import P, Schema

NEG_INF = -1e30


def attn_schema(cfg: ModelConfig) -> Schema:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s: Schema = {
        "wq": P((d, hq, dh), ("embed", "heads", "head")),
        "wk": P((d, hkv, dh), ("embed", "kv_heads", "head")),
        "wv": P((d, hkv, dh), ("embed", "kv_heads", "head")),
        "wo": P((hq, dh, d), ("heads", "head", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((hq, dh), ("heads", "head"), init="zeros")
        s["bk"] = P((hkv, dh), ("kv_heads", "head"), init="zeros")
        s["bv"] = P((hkv, dh), ("kv_heads", "head"), init="zeros")
    if cfg.linear_bias:
        s["bo"] = P((d,), ("embed",), init="zeros")
    return s


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) @ w (d, H, Dh) -> (B, S, H, Dh)."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).unflatten(-1, (h, dh))


def project(cfg: ModelConfig, params, x: torch.Tensor, name: str) -> torch.Tensor:
    """x (B, S, d) -> (B, S, H, Dh) through ``w{name}`` (and ``b{name}``
    under ``qkv_bias``), ``name`` one of q, k, v; no RoPE."""
    y = _heads(x, params["w" + name])
    return y + params["b" + name] if cfg.qkv_bias else y


def qkv_project(cfg: ModelConfig, params, x: torch.Tensor, positions: Optional[torch.Tensor]):
    """x: (B, S, d) -> q (B,S,Hq,Dh), k/v (B,S,Hkv,Dh); RoPE applied if configured."""
    q, k, v = (project(cfg, params, x, name) for name in "qkv")
    if cfg.use_rope and positions is not None:
        inv = rope_freqs(cfg, x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    return q, k, v


def out_project(cfg: ModelConfig, params, o: torch.Tensor) -> torch.Tensor:
    h, dh, d = params["wo"].shape
    y = o.flatten(-2) @ params["wo"].reshape(h * dh, d)
    if cfg.linear_bias:
        y = y + params["bo"]
    return y


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B,S,Hq,Dh) -> (B,S,Hkv,G,Dh)."""
    b, s, hq, dh = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, dh)


def _mask(sq: int, k_pos: torch.Tensor, q_offset, causal: bool, window) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=k_pos.device)
    mask = torch.ones((sq, k_pos.shape[0]), dtype=torch.bool, device=k_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def attention_full(q, k, v, *, causal: bool, window: Optional[int] = None,
                   q_offset=0, kv_len=None) -> torch.Tensor:
    """Reference (score-matrix materializing) attention.

    q: (B,Sq,Hq,Dh); k,v: (B,Sk,Hkv,Dh). Returns (B,Sq,Hq,Dh).
    ``q_offset`` is the absolute position of q[0]. ``kv_len`` masks slots
    >= kv_len.
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    qg = _group(q, hkv)
    scores = torch.einsum("bsngk,btnk->bngst", qg, k).float() * dh**-0.5
    k_pos = torch.arange(k.shape[1], device=q.device)
    mask = _mask(sq, k_pos, q_offset, causal, window)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    if kv_len is not None:
        scores = torch.where((k_pos < kv_len)[None, None, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bngst,btnk->bsngk", p, v)
    return o.reshape(b, sq, hq, dh)


def attention_chunked(q, k, v, *, causal: bool, window: Optional[int] = None,
                      chunk: int = 512, q_offset=0, kv_len=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks (no (Sq, Sk) matrix)."""
    b, sq, hq, dh = q.shape
    sk = k.shape[1]
    hkv = k.shape[2]
    g = hq // hkv
    if sk % chunk != 0:
        pad = chunk - sk % chunk
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = sk
        sk = k.shape[1]
    qg = _group(q, hkv).float()
    scale = dh**-0.5
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dh), dtype=torch.float32, device=q.device)
    for j in range(sk // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].float()
        vj = v[:, j * chunk:(j + 1) * chunk].float()
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bsngk,btnk->bngst", qg, kj) * scale
        s = torch.where(_mask(sq, k_pos, q_offset, causal, window)[None, None, None], s, NEG_INF)
        if kv_len is not None:
            s = torch.where((k_pos < kv_len)[None, None, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bngst,btnk->bngsk", p, vj)
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.movedim(3, 1).reshape(b, sq, hq, dh)
    return o.to(q.dtype)


def attention(cfg: ModelConfig, q, k, v, *, causal: bool = True, q_offset=0,
              kv_len=None, impl: Optional[str] = None) -> torch.Tensor:
    impl = impl or ("full" if q.shape[1] * k.shape[1] <= 256 * 256 else "chunked")
    if impl == "full":
        return attention_full(q, k, v, causal=causal, window=cfg.sliding_window,
                              q_offset=q_offset, kv_len=kv_len)
    return attention_chunked(q, k, v, causal=causal, window=cfg.sliding_window,
                             chunk=min(cfg.attn_chunk, k.shape[1]),
                             q_offset=q_offset, kv_len=kv_len)
