"""Plain PyTorch versions of the WKV6 kernel (RWKV6 "Finch").

Per head, with an N x N state mapping keys to values:

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(e^{logw_t}) S_{t-1} + k_t^T v_t

``wkv6_ref`` is the exact sequential scan and ``wkv6_bwd_ref`` its
gradient, token by token (the plain version of the backward kernel
``csrc/wkv6_bwd.cu``). ``wkv_chunked_bhsn`` is the
chunked form of ``repro.models.rwkv6.wkv_chunked``: within a chunk the
recurrence is closed-form with the per-channel pairwise decay factors
``exp(min(cum_ex[t] - cum[s], 0))``, which are <= 1 for any decay, so no
clamp is needed. (The Pallas kernel instead clamps ``cum >= -30`` and forms
``k e^{-cum}``, which is wrong once the decay within a chunk passes -30;
``ROADMAP.md``, faults found while porting.) It is the CPU path of
``kernel.wkv6_bhsn`` and the yardstick the CUDA kernel is held against.

Both work on the kernel's (BH, S, N) layout with ``u`` (BH, N), take an
optional initial state (BH, N, N) and return ``(out, state)`` in fp32
(``wkv_chunked_bhsn`` in the ``dtype`` it is asked for).
``wkv_chunked`` is the model's (B, S, H, N) layout with ``u`` (H, N).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _f32(*xs):
    return tuple(x.float() for x in xs)


def _state0(state, bh: int, n: int, like: torch.Tensor,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if state is None:
        return torch.zeros((bh, n, n), dtype=dtype, device=like.device)
    return state.to(dtype)


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


def wkv6_bwd_ref(r, k, v, logw, u, state, dout, dstate):
    """The gradient of ``wkv6_ref`` at output gradient ``dout`` (BH, S, N)
    and final-state gradient ``dstate`` (BH, N, N; None: zero), in fp32,
    token by token. With G_t = dL/dS_t, G_T = dstate,
    G_{t-1} = diag(w_t) G_t + r_t^T do_t, h_t = S_{t-1} do_t, f_t = G_t v_t,
    e_t = do_t . v_t:

        dr_t = h_t + (u * k_t) e_t          dk_t = f_t + (u * r_t) e_t
        dv_t = k_t G_t + (r_t . (u * k_t)) do_t      du = sum_t (r_t * k_t) e_t
        dlogw_t = w_t * rowsum(S_{t-1} * G_t) = D_t - k_t * f_t

    where D_t = rowsum(S_t * G_t) runs back from rowsum(S_T * dS_T) as
    D_{t-1} = D_t - k_t * f_t + r_t * h_t: the reverse cumulative sum the
    kernel takes (which restarts it every 64 tokens from the exact rowsum,
    against its rounding walk). -> (dr, dk, dv, dlogw, du, dstate0), the first four
    (BH, S, N), du (BH, N), dstate0 (BH, N, N)."""
    bh, s, n = r.shape
    rf, kf, vf, wf, uf, do = _f32(r, k, v, logw, u, dout)
    w = torch.exp(wf)
    st = _state0(state, bh, n, r)
    hs = []
    for t in range(s):  # forward: h_t = S_{t-1} do_t
        hs.append(torch.einsum("bjm,bm->bj", st, do[:, t]))
        st = w[:, t, :, None] * st + kf[:, t, :, None] * vf[:, t, None, :]
    h = torch.stack(hs, 1) if s else torch.zeros_like(rf)
    g = torch.zeros_like(st) if dstate is None else dstate.float()
    dsum = (st * g).sum(-1)  # D_T
    f, dv, dl = [], [], []
    for t in reversed(range(s)):  # backward: G_t, then G_{t-1}
        ft = torch.einsum("bjm,bm->bj", g, vf[:, t])
        dv.append(torch.einsum("bj,bjm->bm", kf[:, t], g))
        dl.append(dsum - kf[:, t] * ft)
        dsum = dl[-1] + rf[:, t] * h[:, t]
        f.append(ft)
        g = w[:, t, :, None] * g + rf[:, t, :, None] * do[:, t, None, :]

    def stacked(xs):
        return torch.stack(xs[::-1], 1) if s else torch.zeros_like(rf)

    f, dv, dlogw = stacked(f), stacked(dv), stacked(dl)
    e = (do * vf).sum(-1, keepdim=True)  # (BH, S, 1)
    b = (rf * uf[:, None, :] * kf).sum(-1, keepdim=True)
    dr = h + uf[:, None, :] * kf * e
    dk = f + uf[:, None, :] * rf * e
    return dr, dk, dv + b * do, dlogw, (rf * kf * e).sum(1), g


def wkv_chunked_bhsn(r, k, v, logw, u, state=None, chunk: int = 32,
                     dtype: torch.dtype = torch.float32):
    """The chunked form on (BH, S, N) -> (out (BH, S, N), state (BH, N, N)),
    computed and returned in ``dtype`` (float64 makes it the exact
    recurrence to ~1e-15, a witness for both the kernels and the fp32 form).
    A ragged tail is padded with r, k, v = 0 and logw = 0 (decay 1), which
    leaves the state as the unpadded sequence leaves it."""
    bh, s, n = r.shape
    pad = (-s) % chunk
    rf, kf, vf, wf = (F.pad(x.to(dtype), (0, 0, 0, pad)) for x in (r, k, v, logw))
    uf = u.to(dtype)[:, None, :]  # (BH, 1, N)
    st = _state0(state, bh, n, r, dtype)
    tri = torch.ones((chunk, chunk), dtype=dtype, device=r.device).tril(-1)  # strict lower
    eye = torch.eye(chunk, dtype=dtype, device=r.device)
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
