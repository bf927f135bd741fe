"""Multi-pod dry run (the port of ``repro.launch.dryrun``): every
(architecture x input shape) on the production meshes, as per-rank memory,
a count of the step's FLOPs, analytic collective bytes and the roofline
terms at H100 rates, written as one JSON artifact a cell.

There is no compile. A cell is built on ``meta`` tensors (shapes and
dtypes, no storage) under the shape-only production mesh
(``mesh.abstract_production_mesh``: 16 x 16, or 2 x 16 x 16), so no
process group and no device is needed:

  - ``memory_analysis``: ``argument_size_in_bytes`` is one rank's share of
    the step's inputs — the local shards of the parameters, the optimizer
    state and the batch (train), of the parameters and the batch
    (prefill), or of the parameters, the cache and the tokens (decode) —
    under the spec trees of ``launch.steps.step_shardings``;
    ``output_size_in_bytes`` the same of its outputs;
    ``temp_size_in_bytes`` one rank's temporaries, counted by
    ``analysis.memory.rank_temp`` on meta tensors (what the forward
    leaves for the backward and the loss head's transients; a forward's
    peak of live activations for prefill and decode), and ``temp_source``
    says how.
  - ``cost_analysis.flops``: the whole step (global batch; the train step's
    gradient with its remat recompute) counted by ``analysis.costs`` on
    meta tensors. The layers are identical, so the count runs at 1 and 2
    layers (and encoder layers) and extends linearly to the model's depth.
  - ``collectives``: ``analysis.roofline``'s analytic per-device model,
    marked ``"source": "analytic"`` (no collective runs in a dry run).
  - ``roofline``: ``roofline_terms`` at H100 rates.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out-dir artifacts/dryrun_torch]

``--all`` writes every arch x shape on both meshes (80 artifacts).
``--unroll`` and ``--moe-ep-hints`` are the reference's flags for variants
the port does not run; they refuse (``NO_VARIANT``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import pathlib
import time
import traceback

import torch

from ..analysis.costs import cost_analysis_dict
from ..analysis.memory import TEMP_SOURCE, rank_temp
from ..analysis.roofline import MESHES, collective_bytes_by_op, roofline_terms
from ..configs import SHAPES, ShapeConfig, arch_ids, get_config, get_shape, supports_shape
from ..models import frontends, transformer
from ..models.schema import map_tree
from ..parallel import sharding as shd
from . import steps as steps_lib
from .mesh import abstract_production_mesh

#: the reference's flags for variants the port has none of: they refuse
NO_VARIANT = {
    "unroll": "the port's layers are a Python loop; there is no layer scan to unroll",
    "moe_ep_hints": ("the port runs no expert-parallel buffers (no DTensor on the "
                     "model axis yet), so no hint could act on them"),
}


def abstract_opt(cfg, moment_dtype="float32"):
    """The optimizer state as meta tensors: fp32 (or ``moment_dtype``)
    moments m and v of every parameter, and the int32 step."""
    dt = getattr(torch, moment_dtype)
    mom = map_tree(transformer.abstract_model(cfg),
                   lambda a: torch.empty(a.shape, dtype=dt, device="meta"))
    return {"m": mom, "v": map_tree(mom, lambda a: a),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _meta(specs: dict) -> dict:
    return {k: torch.empty(shape, dtype=dt, device="meta") for k, (shape, dt) in specs.items()}


def _leaf_bytes(leaf) -> tuple:
    """(shape, element bytes) of a meta tensor or an ``input_specs`` pair."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.element_size()
    shape, dt = leaf
    return tuple(shape), torch.empty((), dtype=dt).element_size()


def local_bytes(mesh, spec_tree, value_tree) -> int:
    """One rank's bytes of ``value_tree`` sharded by ``spec_tree``."""
    if isinstance(value_tree, dict):
        return sum(local_bytes(mesh, spec_tree[k], value_tree[k]) for k in value_tree)
    shape, size = _leaf_bytes(value_tree)
    return math.prod(shd.local_shape(mesh, spec_tree, shape)) * size


def _run_step(cfg, shape, microbatches: int, logits_mode: str) -> None:
    """One step of ``shape.kind`` on meta tensors."""
    params = transformer.abstract_model(cfg)
    specs = frontends.input_specs(cfg, shape)
    if shape.kind == "train":
        steps_lib.accumulate_grads(cfg, params, _meta(specs["batch"]),
                                   microbatches=microbatches)
    elif shape.kind == "prefill":
        steps_lib.make_prefill_step(cfg, logits_mode=logits_mode)(params, _meta(specs["batch"]))
    else:
        cache = transformer.abstract_cache(cfg, shape.global_batch, shape.seq_len)
        tokens = torch.empty(specs["tokens"][0], dtype=torch.int32, device="meta")
        steps_lib.make_decode_step(cfg)(params, cache, tokens, shape.seq_len - 1)


@functools.lru_cache(maxsize=None)
def step_flops(cfg, shape, *, microbatches: int = 1, logits_mode: str = "all") -> float:
    """The whole step's FLOPs (``analysis.costs``), counted at depths 1 and 2
    (with an encoder, its depth moved alone too) and extended linearly to
    the config's: every layer is the same. Cached: both meshes count the
    same step."""

    def at(layers: int, enc: int) -> float:
        c = dataclasses.replace(cfg, n_layers=layers, n_encoder_layers=enc)
        return cost_analysis_dict(_run_step, c, shape, microbatches, logits_mode)["flops"]

    enc = 1 if cfg.enc_dec else 0
    base = at(1, enc)
    total = base + (cfg.n_layers - 1) * (at(2, enc) - base)
    if cfg.enc_dec:
        total += (cfg.n_encoder_layers - 1) * (at(1, 2) - base)
    return total


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, zero1: bool = False,
               rule_overrides=None, microbatches: int = 1, param_dtype: str = None,
               remat: str = None, logits_mode: str = "all", moment_dtype: str = "float32"):
    """Build one (arch, shape, mesh) cell; returns the artifact dict. The
    keyword levers are the reference's, less two the port has no variant
    for (``NO_VARIANT``)."""
    cfg = get_config(arch)
    if param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=param_dtype)
    if remat:
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    shape = get_shape(shape_name)
    ok, reason = supports_shape(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    meta = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "kind": shape.kind,
        "n_params": cfg.n_params(),
        "n_params_active": cfg.n_params(active=True),
        "n_matmul_params_active": cfg.matmul_params(active=True),
        "tokens_per_step": shape.tokens_per_step,
    }
    if not ok:
        return {**meta, "status": "skipped", "reason": reason}

    mesh = abstract_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    in_sh, out_sh, rules = steps_lib.step_shardings(
        cfg, shape, mesh, zero1=zero1, rule_overrides=rule_overrides)
    params = transformer.abstract_model(cfg)
    specs = frontends.input_specs(cfg, shape)
    if shape.kind == "train":
        opt = abstract_opt(cfg, moment_dtype)
        metrics = {k: ((), torch.float32) for k in out_sh[2]}
        args, outs = (params, opt, specs["batch"]), (params, opt, metrics)
    elif shape.kind == "prefill":
        cache = frontends.input_specs(cfg, ShapeConfig(
            shape.name, "decode", shape.seq_len, shape.global_batch))["cache"]
        logits = ((shape.global_batch, 1, cfg.vocab_size), transformer.torch_dtype(cfg.dtype))
        args, outs = (params, specs["batch"]), (logits, cache)
    else:
        logits = ((shape.global_batch, 1, cfg.vocab_size), transformer.torch_dtype(cfg.dtype))
        args = (params, specs["cache"], specs["tokens"], specs["pos"])
        outs = (logits, specs["cache"])
    mem = {
        "argument_size_in_bytes": sum(local_bytes(mesh, s, a) for s, a in zip(in_sh, args)),
        "output_size_in_bytes": sum(local_bytes(mesh, s, o) for s, o in zip(out_sh, outs)),
        "temp_size_in_bytes": rank_temp(cfg, shape, mesh, rules, microbatches=microbatches,
                                        logits_mode=logits_mode)["total"],
        "temp_source": TEMP_SOURCE,
    }
    t_lower = time.time() - t0
    t0 = time.time()
    with shd.use_mesh(mesh, {**rules}):
        flops = step_flops(cfg, shape, microbatches=microbatches, logits_mode=logits_mode)
    t_count = time.time() - t0
    variant = {"remat": cfg.remat_policy, "param_dtype": cfg.param_dtype, "zero1": zero1}
    rmesh = MESHES[mesh_name]
    terms = roofline_terms(cfg, shape, rmesh, variant)
    by_op = collective_bytes_by_op(cfg, shape, rmesh, variant)
    return {
        **meta,
        "status": "ok",
        "n_chips": int(mesh.size),
        "zero1": zero1,
        "variant": {
            "microbatches": microbatches, "param_dtype": cfg.param_dtype,
            "remat": cfg.remat_policy, "logits_mode": logits_mode,
            "moe_ep_hints": False, "moment_dtype": moment_dtype,
        },
        "lower_s": round(t_lower, 2),   # the spec trees and per-rank bytes
        "compile_s": round(t_count, 2),  # the FLOP count on meta tensors
        "cost_analysis": {"flops": flops},
        "memory_analysis": mem,
        "collectives": {
            "source": "analytic",
            "total_bytes": terms["coll_bytes_per_dev"],
            "by_op_bytes": by_op,
            "by_op_count": {},
        },
        "roofline": terms,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape on both meshes")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--unroll", action="store_true", help=NO_VARIANT["unroll"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--param-dtype", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--logits-mode", default="all", choices=["all", "last"])
    ap.add_argument("--moe-ep-hints", action="store_true", help=NO_VARIANT["moe_ep_hints"])
    ap.add_argument("--moment-dtype", default="float32")
    ap.add_argument("--experts-pod", action="store_true",
                    help="shard the expert axis over the pod axis only (for "
                         "n_experts divisible by pods but not by pod*data)")
    ap.add_argument("--out-dir", default="artifacts/dryrun_torch")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    for name, why in NO_VARIANT.items():
        if getattr(args, name):
            ap.error(f"--{name.replace('_', '-')}: {why}")

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s) for a in arch_ids() for s in SHAPES]
    else:
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    n_ok = n_skip = n_fail = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            tag = f"{args.tag}_" if args.tag else ""
            fname = out_dir / f"{tag}{arch}_{shape}_{mesh_name}.json"
            if fname.exists():
                print(f"[dryrun] SKIP (exists) {fname.name}", flush=True)
                continue
            print(f"[dryrun] {arch} x {shape} on {mesh_name} ...", flush=True)
            try:
                art = lower_cell(
                    arch, shape, multi_pod=mp, zero1=args.zero1,
                    microbatches=args.microbatches, param_dtype=args.param_dtype,
                    remat=args.remat, logits_mode=args.logits_mode,
                    moment_dtype=args.moment_dtype,
                    rule_overrides={"experts": ("pod",)} if args.experts_pod else None,
                )
            except Exception:
                art = {
                    "arch": arch, "shape": shape, "mesh": mesh_name,
                    "status": "failed", "traceback": traceback.format_exc(),
                }
            fname.write_text(json.dumps(art, indent=1))
            st = art["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_fail += st == "failed"
            msg = f"[dryrun]   -> {st}"
            if st == "ok":
                msg += (f" (trees {art['lower_s']}s, FLOP count {art['compile_s']}s, "
                        f"{art['memory_analysis']['argument_size_in_bytes'] / 1e9:.2f} GB a rank, "
                        f"coll {art['collectives']['total_bytes'] / 1e9:.2f} GB)")
            elif st == "failed":
                msg += "\n" + art["traceback"].splitlines()[-1]
            print(msg, flush=True)
    print(f"[dryrun] done: ok={n_ok} skipped={n_skip} failed={n_fail}", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
