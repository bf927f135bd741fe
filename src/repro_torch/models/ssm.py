"""Mamba-style selective SSM head (the port of ``repro.models.ssm``), used by
Hymba's parallel attention + SSM blocks.

Diagonal state-space recurrence with input-dependent dt/B/C:
    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t        (per channel, state)
    y_t = C_t . h_t + D * x_t
No conv1d frontend, as in the reference.

``ssm_scan`` takes the sequence in chunks of ``CHUNK``, as the reference does: within
a chunk a token loop, all chunks at once, builds each position's decay
product and input sum from the chunk's start; then a loop over the chunks
carries the state from each chunk into the next (in place, or out of place
where autograd records the scan for a gradient). The reference runs an
associative scan within the chunk; both compute the same first-order
recurrence in fp32, summed in another order. The reference has no kernel for
this, so this plain PyTorch scan is the port's version on every device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .schema import P, Schema

#: tokens of one scan chunk (the reference's)
CHUNK = 64

def ssm_schema(cfg: ModelConfig) -> Schema:
    assert cfg.ssm is not None
    d, di, st, r = cfg.d_model, cfg.ssm.d_inner, cfg.ssm.state_size, cfg.ssm.dt_rank
    return {
        "in_proj": P((d, 2 * di), ("embed", "ssm_inner")),
        "x_proj": P((di, r + 2 * st), ("ssm_inner", None)),
        "dt_proj": P((r, di), (None, "ssm_inner")),
        "dt_bias": P((di,), ("ssm_inner",), init="zeros"),
        "a_log": P((di, st), ("ssm_inner", None), init="a_log"),
        "d_skip": P((di,), ("ssm_inner",), init="ones"),
        "out_proj": P((di, d), ("ssm_inner", "embed")),
    }


def _selective(params, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,di) -> (da (B,S,di,st), db_x (B,S,di,st), C (B,S,st), dt (B,S,di))."""
    r, st = cfg.ssm.dt_rank, cfg.ssm.state_size
    proj = x @ params["x_proj"]  # (B,S,r+2st)
    dt_r, bmat, cmat = torch.split(proj, [r, st, st], dim=-1)
    dt = F.softplus(dt_r @ params["dt_proj"] + params["dt_bias"])  # (B,S,di)
    a = -torch.exp(params["a_log"].float())  # (di, st), negative
    da = torch.exp(dt.float()[..., None] * a)  # (B,S,di,st) in (0,1)
    db_x = (dt * x).float()[..., None] * bmat.float()[..., None, :]
    return da, db_x, cmat, dt


def _chunk_prefix(aa: torch.Tensor, bb: torch.Tensor):
    """The token loop of ``ssm_scan`` out of place, for autograd (the same
    products and sums in the same order): (decay products, states from a
    zero state), each (B, chunks, CHUNK, di, st)."""
    a_t, b_t = [aa[:, :, 0]], [bb[:, :, 0]]
    for t in range(1, CHUNK):
        b_t.append(torch.addcmul(bb[:, :, t], aa[:, :, t], b_t[-1]))
        a_t.append(aa[:, :, t] * a_t[-1])
    return torch.stack(a_t, 2), torch.stack(b_t, 2)


def ssm_scan(params, x: torch.Tensor, state: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,di); state: (B,di,st) -> (y (B,S,di), state')."""
    b, s, di = x.shape
    st = cfg.ssm.state_size
    da, db, cmat, _ = _selective(params, x, cfg)
    pad = (-s) % CHUNK
    if pad:  # a padded step keeps the state: decay 1, input 0
        da = F.pad(da, (0, 0, 0, 0, 0, pad), value=1.0)
        db = F.pad(db, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // CHUNK
    aa = da.view(b, nc, CHUNK, di, st)  # becomes the decay product from the chunk's start
    bb = db.view(b, nc, CHUNK, di, st)  # becomes the state from a zero state at the start
    if da.requires_grad or db.requires_grad:
        aa, bb = _chunk_prefix(aa, bb)
    else:
        for t in range(1, CHUNK):  # one read-modify-write a step (bb first: it reads aa[t] raw)
            bb[:, :, t].addcmul_(aa[:, :, t], bb[:, :, t - 1])
            aa[:, :, t].mul_(aa[:, :, t - 1])
    h = state.float()
    starts = []
    for c in range(nc):
        starts.append(h)
        h = aa[:, c, -1] * h + bb[:, c, -1]
    h_all = torch.addcmul(bb, aa, torch.stack(starts, 1)[:, :, None])
    h_all = h_all.view(b, s + pad, di, st)[:, :s]
    y = torch.einsum("bsdn,bsn->bsd", h_all, cmat.float())
    y = y + x.float() * params["d_skip"].float()
    return y.to(x.dtype), h


def apply_ssm(cfg: ModelConfig, params, xres: torch.Tensor, state: torch.Tensor):
    """Full SSM branch: in_proj -> selective scan -> gate -> out_proj."""
    di = cfg.ssm.d_inner
    x, z = torch.split(xres @ params["in_proj"], [di, di], dim=-1)
    y, state = ssm_scan(params, x, state, cfg)
    y = y * F.silu(z)
    return y @ params["out_proj"], state


def apply_ssm_step(cfg: ModelConfig, params, xres: torch.Tensor, state: torch.Tensor):
    """Decode: xres (B,1,d); state (B,di,st)."""
    di = cfg.ssm.d_inner
    x, z = torch.split(xres @ params["in_proj"], [di, di], dim=-1)
    da, db, cmat, _ = _selective(params, x, cfg)
    state = da[:, 0] * state.float() + db[:, 0]  # (B,di,st)
    y = torch.einsum("bdn,bn->bd", state, cmat[:, 0].float())
    y = y + x[:, 0].float() * params["d_skip"].float()
    y = (y.to(xres.dtype) * F.silu(z[:, 0]))[:, None, :]
    return y @ params["out_proj"], state
