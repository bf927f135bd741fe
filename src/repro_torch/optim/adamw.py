"""AdamW on nested dicts of tensors (the port of ``repro.optim.adamw``).

The state is ``{"m": tree, "v": tree, "step": int32 scalar}``, moments in
fp32 by default (or ``moment_dtype``, bf16 in the reference's
memory-saving variant). ``adamw_update`` updates parameters and moments in
place, without autograd, and returns them with the metrics: the port's
idiom where the reference returns new trees. The reference's jnp updates
run no Pallas kernel, so the port's are plain torch (``torch._foreach_*``
over the leaves).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.schema import leaf_paths, map_tree


def leaves(tree: dict) -> list:
    """The tensors of a nested dict in ``leaf_paths`` order."""
    return [x for _, x in leaf_paths(tree)]


def adamw_init(params: dict, moment_dtype=torch.float32) -> dict:
    """Zero moments shaped like ``params`` and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=moment_dtype, device=p.device)

    return {"m": map_tree(params, zeros), "v": map_tree(params, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device)}


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales every gradient leaf, in place, by min(1, max_norm / ‖g‖) with
    ‖g‖ the fp32 2-norm over all leaves. Returns (grads, ‖g‖)."""
    gs = leaves(grads)
    gn = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in gs]))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in gs:
        g.copy_(g.float() * scale)
    return grads, gn


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: dict, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0):
    """One AdamW step, the reference's arithmetic: gradients clipped to
    ``max_grad_norm`` (their norm reported either way), moments
    m = b1 m + (1 - b1) g and v = b2 v + (1 - b2) g² in fp32, bias-corrected,
    p -= lr (m̂ / (√v̂ + eps) + weight_decay p). ``params``, the moments
    and ``grads`` (clipped) are updated in place. Returns (params, state,
    {"grad_norm"})."""
    gs = leaves(grads)
    if max_grad_norm is not None:
        _, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in gs]))
    step = state["step"] + 1
    stepf = step.float()
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    ps, ms, vs = leaves(params), leaves(state["m"]), leaves(state["v"])
    for p, g, m, v in zip(ps, gs, ms, vs):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf.square()
        delta = (m_new / bc1) / ((v_new / bc2).sqrt() + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    state["step"] = step
    return params, state, {"grad_norm": gnorm}
