"""Mixture-of-experts block (the port of ``repro.models.moe``).

Two implementations sharing one router, with the reference's names:

- ``moe_dispatch``, the model's: group-capacity dispatch. Tokens are taken in
  groups of ``GROUP_SIZE``; each (group, expert) has a buffer of ``cap`` rows, and a (token,
  slot) pair's row is its position among the group's pairs routed to that
  expert (a cumsum over the token-major ``tg·k`` axis, no sort). Pairs at a
  position >= ``cap`` are dropped. The group size, the capacity and the
  positions are the reference's, so the same tokens drop. Tokens move into
  and out of the buffers by an exact gather and scatter (the reference's
  one-hot products are exact too), with integer positions.
- ``moe_dense``: every expert computes every token, combined with the
  router's weights. Nothing drops; the oracle of the tests.

``apply_moe`` switches between the two (``impl="dispatch"``, the default,
or ``"dense"``), as the reference's; the transformer block calls it.

Each returns ``(y, aux, dropped)``: the output, the Switch load-balance loss
and the share of (token, slot) pairs dropped. The expert products are plain
``torch.einsum`` (the reference computes them outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..parallel.sharding import hint
from .layers import _act
from .schema import P, Schema

#: tokens a dispatch group holds at most (the reference's default group size)
GROUP_SIZE = 512

def moe_schema(cfg: ModelConfig) -> Schema:
    assert cfg.moe is not None
    d, e, fe = cfg.d_model, cfg.moe.n_experts, cfg.moe.d_expert
    s: Schema = {
        "router": P((d, e), ("embed", None), scale=1.0 / math.sqrt(d)),
        "wi": P((e, d, fe), ("experts", "embed", "expert_ff")),
        "wo": P((e, fe, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.mlp_gated:
        s["wg"] = P((e, d, fe), ("experts", "embed", "expert_ff"))
    return s


def router_topk(cfg: ModelConfig, params, x: torch.Tensor):
    """x: (..., d) -> gates (..., k) normalized, idx (..., k), aux load-balance
    loss. fp32 logits and softmax; of equal gates the lower expert index comes
    first, as ``jax.lax.top_k`` orders them (a stable sort, not ``topk``,
    whose tie order is unspecified)."""
    moe = cfg.moe
    logits = x.float() @ params["router"].float()
    gates_all = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(gates_all, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :moe.top_k], idx[..., :moe.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balancing aux loss: E * sum_e f_e * p_e
    me = gates_all.reshape(-1, moe.n_experts).mean(0)
    onehot = F.one_hot(idx.reshape(-1, moe.top_k), moe.n_experts).float()
    ce = onehot.sum(1).mean(0) / moe.top_k
    aux = moe.n_experts * torch.sum(me * ce)
    return gates, idx, aux


def _expert_ffn(cfg: ModelConfig, params, xb: torch.Tensor) -> torch.Tensor:
    """xb: (..., E, C, d) batched per-expert FFN -> same shape."""
    h = torch.einsum("...ecd,edf->...ecf", xb, params["wi"])
    h = _act(cfg.mlp_act, h)
    if cfg.mlp_gated:
        h = h * torch.einsum("...ecd,edf->...ecf", xb, params["wg"])
    return torch.einsum("...ecf,efd->...ecd", h, params["wo"])


def group_and_capacity(cfg: ModelConfig, t: int,
                       group_size: int = GROUP_SIZE) -> tuple[int, int]:
    """The reference's group size for ``t`` tokens (``min(group_size, t)``,
    or its gcd with ``t`` where it does not divide) and the capacity of one
    (group, expert) buffer (``ceil(tg·k·cf / E)``, rounded up to a multiple
    of 4)."""
    moe = cfg.moe
    tg = min(group_size, t)
    if t % tg != 0:
        tg = math.gcd(t, tg)
    cap = max(1, math.ceil(tg * moe.top_k * moe.capacity_factor / moe.n_experts))
    return tg, (cap + 3) // 4 * 4


def moe_dispatch(cfg: ModelConfig, params, x: torch.Tensor, *,
                 group_size: int = GROUP_SIZE):
    """Group-capacity dispatch. x: (B, S, d) -> (y, aux, dropped)."""
    moe = cfg.moe
    b, s, d = x.shape
    e, k = moe.n_experts, moe.top_k
    tg, cap = group_and_capacity(cfg, b * s, group_size)
    g = b * s // tg
    xg = x.reshape(g, tg, d)
    gates, idx, aux = router_topk(cfg, params, xg)  # (g, tg, k)

    # position of each (token, slot) within its expert, cumsum over the group
    flat = F.one_hot(idx, e).reshape(g, tg * k, e)  # int64
    pos = (torch.cumsum(flat, dim=1) - flat).mul_(flat).sum(-1).reshape(g, tg, k)
    keep = pos < cap

    # buffer row of each kept pair; dropped pairs go to a spare last row
    rows = torch.where(keep, idx * cap + pos, e * cap)
    gi = torch.arange(g, device=x.device)[:, None, None].expand(g, tg, k)
    ti = torch.arange(tg, device=x.device)[None, :, None].expand(g, tg, k)
    xb = x.new_zeros((g, e * cap + 1, d))
    xb[gi, rows] = xg[gi, ti]
    # optional EP constraints, active only when the run's sharding rules
    # define "moe_group" (as the reference's)
    xe = hint(xb[:, :-1].reshape(g, e, cap, d), ("moe_group", "experts", None, "embed"))
    yb = hint(_expert_ffn(cfg, params, xe), ("moe_group", "experts", None, "embed"))
    yb = torch.cat([yb.reshape(g, e * cap, d), yb.new_zeros((g, 1, d))], dim=1)
    # the combine weights in x's dtype, the sum over slots in fp32, as a
    # product of x.dtype operands accumulates
    w = (gates * keep).to(x.dtype).float()
    y = torch.einsum("gtkd,gtk->gtd", yb[gi, rows].float(), w).to(x.dtype)
    dropped = 1.0 - keep.float().mean()
    return y.reshape(b, s, d), aux, dropped


def moe_dense(cfg: ModelConfig, params, x: torch.Tensor):
    """Oracle: every expert computes every token, weighted-combined."""
    moe = cfg.moe
    b, s, d = x.shape
    gates, idx, aux = router_topk(cfg, params, x)  # (b, s, k)
    weights = torch.zeros((b, s, moe.n_experts), dtype=torch.float32, device=x.device)
    weights.scatter_add_(-1, idx, gates)
    xe = x[:, :, None, None, :].expand(b, s, moe.n_experts, 1, d)
    ye = _expert_ffn(cfg, params, xe.reshape(b * s, moe.n_experts, 1, d))
    ye = ye.reshape(b, s, moe.n_experts, d)
    y = torch.einsum("bsed,bse->bsd", ye, weights.to(x.dtype))
    return y, aux, torch.zeros((), dtype=torch.float32, device=x.device)


def apply_moe(cfg: ModelConfig, params, x: torch.Tensor, *, impl: str = "dispatch",
              group_size: int = GROUP_SIZE):
    """The block's MoE: ``moe_dispatch`` (groups of ``group_size`` tokens),
    or with ``impl="dense"`` the ``moe_dense`` oracle. Returns
    (y, aux, dropped)."""
    if impl == "dense":
        return moe_dense(cfg, params, x)
    return moe_dispatch(cfg, params, x, group_size=group_size)
