"""Step functions (train, prefill, decode), shared by the training loop,
the serving engine and ``chip_smoke.py``. The sharding trees of
``repro.launch.steps`` describe GSPMD over a many-chip mesh and wait for
the multi-device item of ``ROADMAP.md``."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import transformer
from ..models.schema import leaf_paths, map_tree
from ..optim import adamw_update, cosine_schedule


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


def accumulate_grads(cfg: ModelConfig, params: dict, batch: dict, *, microbatches: int = 1):
    """The gradient of ``loss_fn`` over ``batch``, split along the batch
    into ``microbatches`` equal parts (peak activation memory / microbatches)
    whose gradients add up in the parameters' fp32 ``.grad`` and are then
    divided by their count, as the reference's scan does. Returns (grads,
    loss, metrics): grads a tree of the ``.grad`` tensors; loss the mean of
    the microbatches' losses; metrics ``loss_fn``'s, or with several
    microbatches the reference's stand-ins (``ce`` the mean loss, ``aux``
    and ``tokens`` 0)."""
    dev = params["embed"].device
    batch = batch_to(batch, dev)
    leaves = [p for _, p in leaf_paths(params)]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} does not split into {microbatches} microbatches")
    size = n // microbatches
    losses = []
    try:
        for i in range(microbatches):
            part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, metrics = transformer.loss_fn(cfg, params, part)
            loss.backward()
            losses.append(loss.detach())
    finally:  # the parameters record no graph outside this function
        for p in leaves:
            p.requires_grad_(False)
    grads = map_tree(params, lambda p: p.grad)
    if microbatches > 1:
        with torch.no_grad():
            for p in leaves:
                p.grad.div_(microbatches)
        loss = torch.stack(losses).mean()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {"ce": loss, "aux": zero, "tokens": zero}
    else:
        loss = losses[0]
        metrics = {k: v.detach() for k, v in metrics.items()}
    return grads, loss, metrics


def make_train_step(cfg: ModelConfig, *, peak_lr=3e-4, warmup=100, total=10000,
                    microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics), as the
    reference's: the gradient of ``loss_fn`` (``accumulate_grads``), the
    cosine schedule's learning rate at the optimizer's step, one AdamW
    update. ``params`` and ``opt_state`` are updated in place and returned;
    metrics hold ``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm`` and
    ``lr`` as 0-d tensors. The gradients are dropped after the update."""

    def train_step(params, opt_state, batch):
        grads, loss, metrics = accumulate_grads(cfg, params, batch, microbatches=microbatches)
        lr = cosine_schedule(opt_state["step"], peak_lr=peak_lr, warmup_steps=warmup,
                             total_steps=total)
        params, opt_state, om = adamw_update(params, grads, opt_state, lr=lr)
        for _, p in leaf_paths(params):
            p.grad = None
        return params, opt_state, {"loss": loss, **metrics, **om, "lr": lr}

    return train_step


def make_prefill_step(cfg: ModelConfig, *, logits_mode: str = "all"):
    """(params, batch) -> (last logits, cache); ``batch`` as ``forward``
    takes it (tokens, and whisper's ``frames`` or internvl2's
    ``patch_embeds``), passed through unchanged."""

    def prefill_step(params, batch):
        logits, cache = transformer.forward(
            cfg, params, batch, emit_cache=True, logits_mode=logits_mode
        )
        return logits[:, -1:, :], cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        return transformer.decode_step(cfg, params, cache, tokens, pos)

    return serve_step
