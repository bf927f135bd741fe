"""A step's temporary memory, counted (the port's counterpart of the
reference's ``memory_analysis().temp_size_in_bytes``).

The reference reads the bytes XLA's buffer assignment plans for a compiled
step's temporaries. The port has no compiler, so it runs the step's forward
(on ``meta`` tensors: shapes and dtypes, no storage, so a full-size cell
counts in seconds on the host; on real tensors the same run computes and
counts the same bytes) and follows every storage the forward makes. A
storage is told apart by its ``StorageImpl`` (views share one), and the
step's arguments (parameters, batch, cache) are never counted: they are
``argument_size_in_bytes``.

The forward runs as on the card (``rank_temp``): under
``device.kernel_footprint`` the attention and WKV6 wrappers allocate what
their kernels return and save what their autograd Functions save, not
their plain versions' intermediates (attention's scores, which no kernel
makes).

The rule, by step kind:

  - train: what the forward leaves for the backward. The distinct storages
    alive when ``loss_fn`` returns: those autograd saved (seen by a
    ``torch.autograd.graph.saved_tensors_hooks`` pack hook; under a remat
    policy these include the input each checkpointed layer keeps for its
    recompute) and the rest still alive (the weight products the "dots"
    policy caches, the loss). The policy is the config's
    (``cfg.remat_policy``: "nothing", "dots", "full"). Then the loss
    head's transients, which the backward makes before it reaches the
    saved tensors: the logits in the compute dtype and their gradient in
    fp32, at the microbatch's batch. One microbatch counts: the next one's
    forward starts after its backward freed the saved tensors.
  - prefill and decode (under ``torch.no_grad``): the forward's live
    activations at their peak, over the storages it made that are not
    alive when it returns (its outputs, the logits and the cache).

Depth: the count runs at 1 and 2 layers (and 1 and 2 encoder layers) and
extends linearly to the config's depth, as ``launch.dryrun.step_flops``
counts FLOPs: every layer is the same.

Per rank (``rank_temp``): the batch at the batch spec's
``local_shape`` (the data axes; split again into microbatches for train),
and every width on a logical axis that the mesh's rules put on a model axis
at its local size, where ``spec_for`` shards it: the vocabulary (the
logits), ``d_ff`` ("mlp"), the heads and kv heads together (where both
divide; otherwise attention stays whole), an expert's ``d_expert``
("expert_ff") and the SSM's ``d_inner``. The count then runs the forward
of that rank's slice of the model: a Megatron-style split, where the
activations of a column-split product are the local ones. RWKV's inner
width is ``d_model`` itself, which the embed axis keeps whole, so it
stays whole; expert parallelism over the data axes is not counted (each
rank's buffers count every expert).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: the artifact's ``temp_source``: how ``temp_size_in_bytes`` was counted
TEMP_SOURCE = (
    "counted: the storages a rank's forward leaves for the backward (autograd's "
    "saved tensors and the remat policy's kept ones; meta tensors, analysis.memory) "
    "plus the logits and their fp32 gradient; prefill/decode the forward's peak of "
    "live activations; at 1 and 2 layers, extended to the depth"
)


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class _Storages(TorchDispatchMode):
    """Every storage the ops under it make (those of ``skip``, the step's
    arguments, aside): which are alive, and the run's events (+bytes at a
    storage's first tensor, -bytes when its last one dies). A storage's
    tensors are followed by weak references, so what autograd saved and
    what checkpointing keeps stay alive, as on a device."""

    def __init__(self, skip: set) -> None:
        super().__init__()
        self.skip = skip
        # key -> [bytes, tensors alive, serial]: a freed storage's key may
        # come back for a new one, so events name storages by serial
        self.live: dict = {}
        self.events: list = []  # (+bytes or -bytes, serial)
        self._serials = 0

    def _add(self, t: torch.Tensor) -> None:
        key = _key(t)
        if key in self.skip:
            return
        ent = self.live.get(key)
        if ent is None:
            ent = self.live[key] = [t.untyped_storage().nbytes(), 0, self._serials]
            self._serials += 1
            self.events.append((ent[0], ent[2]))
        ent[1] += 1
        weakref.finalize(t, self._drop, key, ent[2])

    def _drop(self, key: int, serial: int) -> None:
        ent = self.live.get(key)
        if ent is None or ent[2] != serial:
            return
        ent[1] -= 1
        if ent[1] == 0:
            del self.live[key]
            self.events.append((-ent[0], serial))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._add(t)
        return out

    def peak_without(self, serials: set) -> int:
        """The largest sum of live bytes over the run, the storages of
        ``serials`` left out."""
        cur = peak = 0
        for nbytes, serial in self.events:
            if serial not in serials:
                cur += nbytes
                peak = max(peak, cur)
        return peak


def _inputs(cfg, shape, device):
    """(params, batch or (cache, tokens, pos)) of ``shape`` for ``cfg``: meta
    tensors, or random ones on a real device."""
    from ..models import frontends, init_model, transformer

    if device.type == "meta":
        params = transformer.abstract_model(cfg)
        specs = frontends.input_specs(cfg, shape)

        def meta(pair):
            return torch.empty(pair[0], dtype=pair[1], device="meta")

        if shape.kind == "decode":
            cache = transformer.abstract_cache(cfg, shape.global_batch, shape.seq_len)
            return params, (cache, meta(specs["tokens"]), shape.seq_len - 1)
        return params, {k: meta(v) for k, v in specs["batch"].items()}
    params = init_model(cfg, 0, device=device)
    inputs = frontends.synth_inputs(cfg, shape, seed=0, device=device)
    if shape.kind == "decode":
        return params, (inputs["cache"], inputs["tokens"], shape.seq_len - 1)
    return params, inputs["batch"]


def head_transient_bytes(cfg, shape) -> int:
    """The loss head's transients at ``shape``'s batch: the logits in the
    compute dtype and their gradient in fp32 (b x positions x vocab)."""
    from ..models.transformer import torch_dtype

    per = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size() + 4
    return shape.global_batch * shape.seq_len * cfg.vocab_size * per


def count_temp(cfg, shape, *, device="meta", logits_mode: str = "all") -> dict:
    """The temporary bytes of one step of ``shape.kind`` for ``cfg`` at
    ``shape``'s batch and ``cfg``'s own depth (the rule in the module's
    docstring), by part: ``saved`` (live storages autograd saved), ``kept``
    (the other live ones) and ``head`` for a train step, ``peak`` for
    prefill and decode; and their ``total``. On ``meta`` tensors by
    default; ``device="cpu"`` runs the same count over real tensors. The
    kernels' wrappers take their plain versions on both, unless the caller
    runs the count under ``device.kernel_footprint`` (``rank_temp`` does)."""
    from ..launch import steps as steps_lib
    from ..models import transformer

    device = torch.device(device)
    params, inputs = _inputs(cfg, shape, device)
    args = _tensors((params, inputs))
    skip = {_key(t) for t in args}
    saved: set = set()

    def pack(t):
        saved.add(_key(t))
        return t

    mode = _Storages(skip)
    if shape.kind == "train":
        leaves = _tensors(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                    pack, lambda t: t), mode:
                out = transformer.loss_fn(cfg, params, inputs)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        # a storage autograd saved and later freed may have passed its key
        # on, so the split reads the live storages only
        parts = {"saved": sum(e[0] for k, e in mode.live.items() if k in saved),
                 "kept": sum(e[0] for k, e in mode.live.items() if k not in saved),
                 "head": head_transient_bytes(cfg, shape)}
        del out
    else:
        with torch.no_grad(), mode:
            if shape.kind == "prefill":
                out = steps_lib.make_prefill_step(cfg, logits_mode=logits_mode)(
                    params, inputs)
            else:
                out = steps_lib.make_decode_step(cfg)(params, *inputs)
        parts = {"peak": mode.peak_without({ent[2] for ent in mode.live.values()})}
        del out
    return {**parts, "total": sum(parts.values())}


def rank_config(cfg, mesh, rules: dict):
    """``cfg`` with every width on a model-axis logical name at its local
    size where ``spec_for`` would shard it (the module's docstring)."""
    from ..parallel.sharding import mesh_axes

    sizes = mesh_axes(mesh)

    def div(name: str, width: int) -> int:
        v = rules.get(name)
        axes = () if v is None else v if isinstance(v, tuple) else (v,)
        if "model" not in axes:  # not a model-axis name (the experts' is data)
            return 1
        n = math.prod(sizes[a] for a in axes)
        return n if width % n == 0 else 1

    changes = {"d_head": cfg.head_dim}
    changes["vocab_size"] = cfg.vocab_size // div("vocab", cfg.vocab_size)
    changes["d_ff"] = cfg.d_ff // div("mlp", cfg.d_ff)
    h, kv = div("heads", cfg.n_heads), div("kv_heads", cfg.n_kv_heads)
    if h > 1 and h == kv:
        changes["n_heads"], changes["n_kv_heads"] = cfg.n_heads // h, cfg.n_kv_heads // h
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, d_expert=cfg.moe.d_expert // div("expert_ff", cfg.moe.d_expert))
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_inner=cfg.ssm.d_inner // div("ssm_inner", cfg.ssm.d_inner))
    return dataclasses.replace(cfg, **changes)


def local_batch(mesh, rules: dict, global_batch: int) -> int:
    """A rank's rows of a ``global_batch``-row batch (the "batch" logical
    axis on the mesh, as ``spec_for`` shards it)."""
    from ..parallel.sharding import local_shape, spec_for

    spec = spec_for(mesh, rules, ("batch", None), (global_batch, 1))
    return local_shape(mesh, spec, (global_batch, 1))[0]


@functools.lru_cache(maxsize=None)
def _extended(cfg, shape, logits_mode: str = "all") -> dict:
    """``count_temp``'s parts under the kernels' footprint at 1 and 2 layers
    (and encoder layers), each extended linearly to ``cfg``'s depth."""
    from ..device import kernel_footprint

    def at(layers: int, enc: int) -> dict:
        c = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=enc)
        with kernel_footprint():
            return count_temp(c, shape, logits_mode=logits_mode)

    enc = 1 if cfg.enc_dec else 0
    base, two = at(1, enc), at(2, enc)
    enc2 = at(1, 2) if cfg.enc_dec else base
    return {k: base[k] + (cfg.n_layers - 1) * (two[k] - base[k])
            + (cfg.n_encoder_layers - 1) * (enc2[k] - base[k]) for k in base}


def rank_temp(cfg, shape, mesh, rules: dict, *, microbatches: int = 1,
              logits_mode: str = "all") -> dict:
    """One rank's temporary bytes for ``shape`` on ``mesh`` (the module's
    rule), by ``count_temp``'s parts and ``total``: its slice of the model
    (``rank_config``) at its local batch (``local_batch``; a train step's
    microbatch of it), through the kernels' footprint, at the full depth."""
    from ..configs import ShapeConfig

    b = local_batch(mesh, rules, shape.global_batch)
    if shape.kind == "train":
        b = max(1, b // microbatches)
    local = ShapeConfig(shape.name, shape.kind, shape.seq_len, b)
    return dict(_extended(rank_config(cfg, mesh, rules), local, logits_mode))
