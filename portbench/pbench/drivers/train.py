"""Training cells: ``repro_torch.train.Trainer`` steps over its own loader.

Set-up builds one ``Trainer`` with the benchmark's weights, drives it
through its first steps (the checked ones, then warm-up ones) with its own
``run``, and hands that same object to the window, which runs whole steps
until ``--seconds`` have passed. ``train_tokens_per_s`` is every token of
every step the window completed over the time those steps took.

The check: the reference follows the checked steps from the same weights
and rows (its own copy of the loader's arithmetic), in fp32. Compared, as
the optimizer sees them: each checked step's loss; each leaf's norm of the
first gradient after clipping, read from the program's AdamW state after
step 1 (m = (1 - b1) g from zero); each leaf's norm of the parameters'
change over the checked steps. A leaf's gap is |‖program‖ - ‖reference‖|
over the larger of the reference's norm of that leaf and of the median
leaf; the worst leaf's gap, and for the first gradient also the median
leaf's. Leaves whose reference gradient is under ``GRAD_FLOOR`` of the
median leaf's move by round-off alone and are left out of the change.
"""
from __future__ import annotations

import gc
import math
import time

from .. import harness, traffic, weights
from ..reference.common import adamw, clip_global, cosine_lr, cross_entropy_sum, strict_fp32

GRAD_FLOOR = 1e-3


def _name(path) -> str:
    return ".".join(path)


def _norms(tree: dict, scale: float = 1.0) -> dict:
    import torch

    return {_name(p): float(torch.linalg.vector_norm(x.detach().float())) * scale
            for p, x in weights.flat(tree)}


def _change_norms(tree: dict, leaves: list, seed: int, device) -> dict:
    """‖p - p0‖ a leaf, p0 the starting weights made again from the seed."""
    import torch

    start = weights.make(leaves, seed, device)
    out = {}
    with torch.no_grad():
        for (p, x), (_, x0) in zip(weights.flat(tree), weights.flat(start)):
            out[_name(p)] = float(torch.linalg.vector_norm(x.detach().float() - x0))
    return out


def optimizer(mix: dict) -> dict:
    return {k: mix[k] for k in ("b1", "b2", "eps", "weight_decay", "clip")}


def _trainer(cell, seed: int, device):
    """The program's trainer, with the benchmark's weights in place of its own."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, TrainerConfig

    conf, mix, m = cell.config, cell.traffic, cell.model
    rows, mb = conf["train_global_batch"], conf["train_microbatch_rows"]
    tc = TrainerConfig(steps=mix["schedule_steps"], batch_size=rows, seq_len=mix["seq_len"],
                       peak_lr=mix["peak_lr"], warmup=mix["warmup"], microbatches=rows // mb,
                       n_shards=mix["n_shards"], seed=seed, log_every=1 << 30)
    tr = Trainer(harness.program_config(m), tc, verbose=False, device=device)
    theirs = {_name(p): tuple(x.shape) for p, x in weights.flat(tr.params)}
    leaves = harness.reference(cell).leaves(m)
    ours = {_name(p): tuple(s) for p, s, _ in leaves}
    if theirs != ours:
        raise RuntimeError(f"the program's parameter tree {theirs} is not the configuration's {ours}")
    tr.params = tr.opt_state = None
    gc.collect()
    tr.params = weights.make(leaves, seed, device)
    tr.opt_state = adamw_init(tr.params)
    return tr, leaves


def _steps(tr, n: int, on_step=None) -> None:
    tr.tc.steps = tr.step + n
    tr.run(on_step=on_step)


def first_steps(cell, seed: int, device) -> tuple:
    """The trainer after its checked steps, and the program's readings of
    them: {"loss": [...], "grad": {leaf: ‖g‖}, "change": {leaf: ‖Δp‖}}."""
    tr, leaves = _trainer(cell, seed, device)
    b1 = optimizer(cell.traffic)["b1"]
    checked = cell.traffic["checked_steps"]
    prog: dict = {}

    def first(step, metrics):
        if step == 1:
            prog["grad"] = _norms(tr.opt_state["m"], 1.0 / (1.0 - b1))

    _steps(tr, checked, first)
    prog["loss"] = [h["loss"] for h in tr.history[:checked]]
    prog["grad_norm"] = tr.history[0]["grad_norm"]
    prog["change"] = _change_norms(tr.params, leaves, seed, device)
    return tr, prog


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    import torch

    mix, conf = cell.traffic, cell.config
    tr, prog = first_steps(cell, seed, device)
    _steps(tr, mix["warm_steps"])
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    sync()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    first_step = tr.step
    while True:
        _steps(tr, 1)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    steps = tr.step - first_step
    losses = [h["loss"] for h in tr.history[first_step:]]
    tokens = steps * conf["train_global_batch"] * mix["seq_len"]

    tr_obj = None
    if trace:
        tr_obj = harness.traced(lambda: _steps(tr, mix["trace_steps"]), lambda: _steps(tr, 1),
                                mix["trace_steps"], device)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    tr.params = tr.opt_state = None
    del tr
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_steps(cell, seed, device)
    readings = compare(prog, ref)
    return {
        "e2e": {"train_tokens_per_s": tokens / elapsed, "setup_s": setup_s},
        "attempted": steps,
        "failed": sum(not math.isfinite(x) for x in losses),
        "readings": readings,
        "peak_bytes": peak,
        "ctx": {"kind": "train", "model": cell.model, "cell": cell.name, "steps": steps,
                "window_s": elapsed, "trace": tr_obj,
                "rows": conf["train_global_batch"],
                "microbatch_rows": conf["train_microbatch_rows"], "seq": mix["seq_len"]},
    }


def reference_steps(cell, seed: int, device, quant=None, keep_rows=None) -> dict:
    """The reference's checked steps: {"loss": [...], "grad": {leaf: ‖g‖},
    "change": {leaf: ‖Δp‖}}. ``quant`` computes its products in fp8 (the
    control); ``keep_rows`` trains on only the first rows of each batch
    (a planted fault: half of the batch left out)."""
    import torch

    strict_fp32()
    m, mix, conf = cell.model, cell.traffic, cell.config
    ref = harness.reference(cell)
    opt = optimizer(mix)
    leaves = ref.leaves(m)
    W = weights.make(leaves, seed, device, requires_grad=True)
    params = [x for _, x in weights.flat(W)]
    mom = [torch.zeros_like(p) for p in params]
    vel = [torch.zeros_like(p) for p in params]
    rows = conf["train_global_batch"] if keep_rows is None else keep_rows
    out = {"loss": []}
    for step in range(mix["checked_steps"]):
        batch = traffic.train_batch(m["vocab_size"], mix["seq_len"], seed, mix["n_shards"],
                                    conf["train_global_batch"], step)
        tokens = torch.from_numpy(batch["tokens"][:rows]).to(device)
        labels = torch.from_numpy(batch["labels"][:rows]).to(device)
        total = tokens.numel()
        loss = 0.0
        for r in range(rows):
            h = ref.hidden(m, W, tokens[r:r + 1], quant=quant, remat=True)
            part = cross_entropy_sum(ref.logits(m, W, h, quant)[0], labels[r]) / total
            part.backward()
            loss += float(part.detach())
            del h, part
        out["loss"].append(loss)
        grads = [p.grad for p in params]
        if step == 0:
            out["grad_norm"] = float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads])))
        clip_global(grads, opt["clip"])
        if step == 0:
            out["grad"] = {_name(p): float(torch.linalg.vector_norm(x.grad))
                           for p, x in weights.flat(W)}
        lr = cosine_lr(step, mix["peak_lr"], mix["warmup"], mix["schedule_steps"])
        adamw([p.detach() for p in params], grads, mom, vel, step + 1, lr, opt["b1"], opt["b2"],
              opt["eps"], opt["weight_decay"])
        for p in params:
            p.grad = None
    del mom, vel
    gc.collect()
    out["change"] = _change_norms(W, leaves, seed, device)
    del W, params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def _gaps(prog: dict, ref: dict, keep) -> list:
    median = sorted(ref.values())[len(ref) // 2]
    return [abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in ref if keep(k)]


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's loss gap (relative); the worst
    leaf's gap of first-gradient norms, and the median leaf's (steady where
    one small leaf's rounding swings the worst); the worst leaf's gap of
    change norms."""
    grad_median = sorted(ref["grad"].values())[len(ref["grad"]) // 2]
    moved = lambda k: ref["grad"][k] >= GRAD_FLOOR * grad_median  # noqa: E731
    grad = sorted(_gaps(prog["grad"], ref["grad"], lambda k: True))
    return {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": grad[-1],
        "grad_norm_median_gap": grad[len(grad) // 2],
        "change_norm_gap": max(_gaps(prog["change"], ref["change"], moved)),
    }
