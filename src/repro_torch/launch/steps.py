"""Step functions (train, prefill, decode) and their sharding trees, shared
by the training loop, the serving engine, the dry run and ``chip_smoke.py``.

The trees (``step_shardings`` and its parts) are the reference's: one spec
a leaf (``parallel.sharding.spec_for``) for the 256- and 512-rank
production meshes. What runs of them is their "batch" rule: the train
step, given ``dp_group``, is data-parallel — each rank takes its
contiguous slice of the global batch (``shard_batch``), and
``accumulate_grads`` averages the fp32 gradients across the group with an
all-reduce before the clip and AdamW, so every rank holds the one-rank
step's parameters. Model-axis shards, ZeRO-1 and resharding restores are
described here and in the dry run, not executed.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import frontends, transformer
from ..models.schema import leaf_paths, map_tree
from ..optim import adamw_init, adamw_update, cosine_schedule
from ..parallel import sharding as shd


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(v)).to(device)
            for k, v in batch.items()}


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous slice of a global batch (every leaf split
    along its first axis into ``world`` equal parts)."""
    n = next(iter(batch.values())).shape[0]
    if n % world:
        raise ValueError(f"global batch {n} does not split over {world} ranks")
    size = n // world
    return {k: v[rank * size:(rank + 1) * size] for k, v in batch.items()}


def accumulate_grads(cfg: ModelConfig, params: dict, batch: dict, *, microbatches: int = 1,
                     dp_group=None):
    """The gradient of ``loss_fn`` over ``batch``, split along the batch
    into ``microbatches`` equal parts (peak activation memory / microbatches)
    whose gradients add up in the parameters' fp32 ``.grad`` and are then
    divided by their count, as the reference's scan does. With ``dp_group``
    (a process group of W ranks, each holding its slice of the global
    batch) the summed gradients are all-reduced (one ``all_reduce`` a leaf,
    fp32) and divided by microbatches × W, so every rank holds the gradient
    of the whole batch. Returns (grads, loss, metrics): grads a tree of the
    ``.grad`` tensors; loss the mean of this rank's microbatches' losses;
    metrics ``loss_fn``'s, or with several microbatches the reference's
    stand-ins (``ce`` the mean loss, ``aux`` and ``tokens`` 0). Loss and
    metrics are this rank's own (as DDP's); the gradient is the group's."""
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
    parts = microbatches
    if dp_group is not None:
        import torch.distributed as dist

        for p in leaves:
            dist.all_reduce(p.grad, group=dp_group)
        parts *= dist.get_world_size(dp_group)
    if parts > 1:
        with torch.no_grad():
            for p in leaves:
                p.grad.div_(parts)
    if microbatches > 1:
        loss = torch.stack(losses).mean()
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        metrics = {"ce": loss, "aux": zero, "tokens": zero}
    else:
        loss = losses[0]
        metrics = {k: v.detach() for k, v in metrics.items()}
    return grads, loss, metrics


def make_train_step(cfg: ModelConfig, *, peak_lr=3e-4, warmup=100, total=10000,
                    microbatches: int = 1, dp_group=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), as the
    reference's: the gradient of ``loss_fn`` (``accumulate_grads``, across
    ``dp_group`` when given, ``batch`` then this rank's slice), the cosine
    schedule's learning rate at the optimizer's step, one AdamW update.
    ``params`` and ``opt_state`` are updated in place and returned; metrics
    hold ``loss``, ``ce``, ``aux``, ``tokens``, ``grad_norm`` and ``lr`` as
    0-d tensors. The gradients are dropped after the update."""

    def train_step(params, opt_state, batch):
        grads, loss, metrics = accumulate_grads(cfg, params, batch, microbatches=microbatches,
                                                dp_group=dp_group)
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


# ---------------------------------------------------------------------------
# Logical axes for non-param step inputs
# ---------------------------------------------------------------------------
def batch_axes(cfg: ModelConfig, with_labels: bool) -> dict:
    d: dict = {"tokens": ("batch", None)}
    if with_labels:
        d["labels"] = ("batch", None)
    if cfg.frontend == "vision":
        d["patch_embeds"] = ("batch", None, "embed")
    if cfg.enc_dec:
        d["frames"] = ("batch", None, "embed")
    return d


def cache_axes(cfg: ModelConfig, mesh) -> dict:
    """Logical axes for the decode cache; if kv heads don't divide the model
    axis, shard the head_dim instead (partial-dot attention)."""
    model_size = shd.mesh_axes(mesh).get("model", 1)
    kv_ok = cfg.n_kv_heads % model_size == 0
    kv = ("layers", "batch", None, "kv_heads" if kv_ok else None, None if kv_ok else "head_tp")
    ax: dict = {}
    if cfg.attention_free:
        return {
            "wkv": ("layers", "batch", "rwkv_heads", None, None),
            "tm_prev": ("layers", "batch", "embed"),
            "cm_prev": ("layers", "batch", "embed"),
        }
    ax["k"] = kv
    ax["v"] = kv
    ax["slot_pos"] = ("layers", "batch", None)
    if cfg.hybrid_parallel_ssm:
        ax["ssm"] = ("layers", "batch", "ssm_inner", None)
    if cfg.enc_dec:
        ax["ck"] = kv
        ax["cv"] = kv
    return ax


CACHE_RULES = {"head_tp": "model", "rwkv_heads": "model"}


# ---------------------------------------------------------------------------
# Sharding trees per step kind: a spec (``parallel.sharding.spec_for``) a leaf
# ---------------------------------------------------------------------------
def _shape_of(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the shape of ``input_specs``' (shape,
    dtype) pairs."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def param_shardings(cfg: ModelConfig, mesh, rules: dict):
    return shd.tree_shardings(mesh, rules, transformer.model_axes(cfg),
                              transformer.abstract_model(cfg))


def opt_shardings(cfg: ModelConfig, mesh, rules: dict, *, zero1: bool):
    axes = transformer.model_axes(cfg)
    ab = transformer.abstract_model(cfg)

    def go(ax, a):
        if isinstance(a, dict):
            return {k: go(ax[k], a[k]) for k in a}
        lax_ = shd.zero1_axes(ax, tuple(a.shape), mesh, rules) if zero1 else ax
        return shd.spec_for(mesh, rules, lax_, tuple(a.shape))

    moment = go(axes, ab)
    return {"m": moment, "v": moment, "step": ()}


def tree_of_shardings(mesh, rules, axes_tree, spec_tree):
    def go(ax, sp):
        if isinstance(sp, dict):
            return {k: go(ax[k], sp[k]) for k in sp}
        return shd.spec_for(mesh, rules, ax, _shape_of(sp))

    return go(axes_tree, spec_tree)


def step_shardings(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    zero1: bool = False,
    rule_overrides: Optional[dict] = None,
):
    """Returns (in_shardings, out_shardings, rules) for the step of
    ``shape.kind``: spec trees in the order of the step's arguments and
    results, as the reference's."""
    rules = shd.make_rules(mesh, {**CACHE_RULES, **(rule_overrides or {})})
    p_sh = param_shardings(cfg, mesh, rules)
    specs = frontends.input_specs(cfg, shape)
    scalar = ()
    logits_sh = shd.spec_for(mesh, rules, ("batch", None, "vocab"),
                             (shape.global_batch, 1, cfg.vocab_size))

    if shape.kind == "train":
        o_sh = opt_shardings(cfg, mesh, rules, zero1=zero1)
        b_sh = tree_of_shardings(mesh, rules, batch_axes(cfg, True), specs["batch"])
        metrics_sh = {k: scalar for k in ["loss", "ce", "aux", "tokens", "grad_norm", "lr"]}
        return (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh), rules

    if shape.kind == "prefill":
        b_sh = tree_of_shardings(mesh, rules, batch_axes(cfg, False), specs["batch"])
        c_sh = tree_of_shardings(
            mesh, rules, cache_axes(cfg, mesh), frontends.input_specs(
                cfg, ShapeConfig(shape.name, "decode", shape.seq_len, shape.global_batch)
            )["cache"],
        )
        return (p_sh, b_sh), (logits_sh, c_sh), rules

    # decode
    c_sh = tree_of_shardings(mesh, rules, cache_axes(cfg, mesh), specs["cache"])
    tok_sh = shd.spec_for(mesh, rules, ("batch", None), (shape.global_batch, 1))
    return (p_sh, c_sh, tok_sh, scalar), (logits_sh, c_sh), rules


def make_optimizer_state(cfg: ModelConfig, params):
    return adamw_init(params)
