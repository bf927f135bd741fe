"""Plain PyTorch versions of the WKV6 kernel (RWKV6 "Finch").

Per head, with an N x N state mapping keys to values:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(e^{logw_t}) S_{t-1} + k_t^T v_t

``wkv6_ref`` is the exact sequential scan. ``wkv_chunked_bhsn`` is the
chunked form of ``repro.models.rwkv6.wkv_chunked``: within a chunk the
recurrence is closed-form with the per-channel pairwise decay factors
``exp(min(cum_ex[t] - cum[s], 0))``, which are <= 1 for any decay, so no
clamp is needed. (The Pallas kernel instead clamps ``cum >= -30`` and forms
``k e^{-cum}``, which is wrong once the decay within a chunk passes -30;
``ROADMAP.md``, faults found while porting.) It is the CPU path of
``kernel.wkv6_bhsn`` and the yardstick the CUDA kernel is held against.

Both work on the kernel's (BH, S, N) layout with ``u`` (BH, N), take an
optional initial state (BH, N, N) and return ``(out, state)`` in fp32.
``wkv_chunked`` is the model's (B, S, H, N) layout with ``u`` (H, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(*xs):
    return tuple(x.float() for x in xs)


def _state0(state, bh: int, n: int, like: torch.Tensor) -> torch.Tensor:
    if state is None:
        return torch.zeros((bh, n, n), dtype=torch.float32, device=like.device)
    return state.float()


def wkv6_ref(r, k, v, logw, u, state=None):
    """r, k, v, logw: (BH, S, N); u: (BH, N); state: (BH, N, N) or None.
    The sequential scan, one token at a time -> (out (BH, S, N), state)."""
    bh, s, n = r.shape
    rf, kf, vf, wf, uf = _f32(r, k, v, logw, u)
    st = _state0(state, bh, n, r)
    outs = []
    for t in range(s):
        kv = kf[:, t, :, None] * vf[:, t, None, :]  # (BH, N, N)
        outs.append(torch.einsum("bn,bnm->bm", rf[:, t], st + uf[:, :, None] * kv))
        st = torch.exp(wf[:, t])[:, :, None] * st + kv
    return torch.stack(outs, 1), st


def wkv_chunked_bhsn(r, k, v, logw, u, state=None, chunk: int = 32):
    """The chunked form on (BH, S, N) -> (out (BH, S, N), state (BH, N, N)).
    A ragged tail is padded with r, k, v = 0 and logw = 0 (decay 1), which
    leaves the state as the unpadded sequence leaves it."""
    bh, s, n = r.shape
    pad = (-s) % chunk
    rf, kf, vf, wf = (F.pad(x, (0, 0, 0, pad)) for x in _f32(r, k, v, logw))
    uf = u.float()[:, None, :]  # (BH, 1, N)
    st = _state0(state, bh, n, r)
    tri = torch.ones((chunk, chunk), device=r.device).tril(-1)  # strict lower
    eye = torch.eye(chunk, device=r.device)
    outs = []
    for c0 in range(0, s + pad, chunk):
        rj, kj, vj, wj = (x[:, c0:c0 + chunk] for x in (rf, kf, vf, wf))
        cum = wj.cumsum(1)  # inclusive, decreasing
        cum_ex = cum - wj  # exclusive
        # pairwise decay exp(cum_ex[t] - cum[s]) for t > s, <= 1 always
        fac = torch.exp(torch.clamp_max(cum_ex[:, :, None, :] - cum[:, None, :, :], 0.0))
        scores = (rj[:, :, None, :] * kj[:, None, :, :] * fac).sum(-1) * tri
        scores = scores + (rj * uf * kj).sum(-1)[:, :, None] * eye
        o = scores @ vj + (rj * torch.exp(cum_ex)) @ st  # intra + inter chunk
        cum_end = cum[:, -1:, :]  # (BH, 1, N)
        st = (torch.exp(cum_end).transpose(1, 2) * st
              + (kj * torch.exp(cum_end - cum)).transpose(1, 2) @ vj)
        outs.append(o)
    return torch.cat(outs, 1)[:, :s], st


def fold_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, N) -> (B·H, S, N)."""
    b, s, h, n = x.shape
    return x.transpose(1, 2).reshape(b * h, s, n)


def unfold_heads(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B·H, S, N) -> (B, S, H, N)."""
    bh, s, n = x.shape
    return x.reshape(b, bh // b, s, n).transpose(1, 2)


def wkv_chunked(r, k, v, logw, u, state, chunk: int = 32):
    """The model's layout: r, k, v, logw (B, S, H, N) with logw <= 0; u (H, N);
    state (B, H, N, N) -> (out (B, S, H, N) fp32, state (B, H, N, N))."""
    b, _, h, n = r.shape
    ue = u.float()[None].expand(b, h, n).reshape(b * h, n)
    out, st = wkv_chunked_bhsn(*map(fold_heads, (r, k, v, logw)), ue,
                               state.reshape(b * h, n, n), chunk=chunk)
    return unfold_heads(out, b), st.reshape(b, h, n, n)
