"""Readings that set a cell's limits: the program's, the control's and the
planted faults', seed by seed, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--fault-seeds 1,2,3] [--leaves]

For every seed of ``--seeds`` it prints one JSON line with the program's
readings against the reference (the lower readings). For every seed of
``--control-seeds`` it adds the control's: the reference computed with fp8
products put in the program's place, against the fp32 reference; and, for
training cells, the reference trained on half of each batch (the fault
"half of the batch left out"), against the whole batch. For every seed of
``--fault-seeds`` of a training cell it adds the program's readings with
its keys' gradient doubled where the attention or WKV6 kernel produces it
(``key_gradient_doubled``). The limits in ``limits/<cell>.json`` lie
between the program's largest reading and the least upper reading, as
``PERF.md`` records. The runs of ``run.py`` never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run as bench  # noqa: F401  (puts src/ and portbench/ on the path)


def _free() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap of norms, beside the reference's norm."""
    med = sorted(ref.values())[len(ref) // 2]
    return {k: [abs(prog[k] - ref[k]) / max(ref[k], med), ref[k]] for k in ref}


@contextlib.contextmanager
def key_gradient_doubled():
    """A planted fault, an answer altered where it is produced: the gradient
    that the attention or WKV6 kernel returns for its keys comes out doubled;
    the forward is unchanged."""
    import torch

    from repro_torch.models import rwkv6, transformer

    class Doubled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, dx):
            return 2 * dx

    wkv6, flash = rwkv6.wkv6, transformer.flash_attention
    rwkv6.wkv6 = lambda r, k, *a, **kw: wkv6(r, Doubled.apply(k), *a, **kw)
    transformer.flash_attention = lambda q, k, *a, **kw: flash(q, Doubled.apply(k), *a, **kw)
    try:
        yield
    finally:
        rwkv6.wkv6, transformer.flash_attention = wkv6, flash


def _program_steps(cell, seed: int) -> dict:
    from pbench.drivers import train

    tr, prog = train.first_steps(cell, seed, "cuda")
    tr.params = tr.opt_state = None
    del tr
    _free()
    return prog


def train_seed(cell, seed: int, control: bool, leaves: bool = False, fault: bool = False) -> dict:
    from pbench.drivers import train

    t = time.perf_counter()
    prog = _program_steps(cell, seed)
    ref = train.reference_steps(cell, seed, "cuda")
    out = {"seed": seed, "program": train.compare(prog, ref), "ref_loss": ref["loss"]}
    if leaves:
        out["grad_leaves"] = _leaf_gaps(prog["grad"], ref["grad"])
        out["change_leaves"] = _leaf_gaps(prog["change"], ref["change"])
        out["global_grad_norm"] = {"program": prog["grad_norm"], "reference": ref["grad_norm"]}
    if fault:
        with key_gradient_doubled():
            bad = _program_steps(cell, seed)
        out["key_gradient_doubled"] = train.compare(bad, ref)
        if leaves:
            out["key_gradient_doubled_leaves"] = _leaf_gaps(bad["grad"], ref["grad"])
    if control:
        out["control"] = train.compare(train.reference_steps(cell, seed, "cuda", quant="fp8"), ref)
        rows = cell.config["train_global_batch"] // 2
        out["half_batch"] = train.compare(train.reference_steps(cell, seed, "cuda", keep_rows=rows),
                                          ref)
    out["seconds"] = time.perf_counter() - t
    return out


def prefill_seed(cell, seed: int, control: bool, leaves: bool = False, fault: bool = False) -> dict:
    import torch

    from pbench import harness, traffic, weights
    from pbench.drivers import prefill
    from repro_torch.launch.steps import make_prefill_step

    t = time.perf_counter()
    m = cell.model
    reqs = traffic.prompts(cell.traffic, m["vocab_size"], seed, "cuda")
    lengths = [n for n, _ in reqs]
    picked = traffic.sample(len(reqs), cell.traffic["checked_requests"],
                            lengths.index(max(lengths)), seed)
    params = weights.make(harness.reference(cell).leaves(m), seed, "cuda")
    step = make_prefill_step(harness.program_config(m))
    kept = {}
    for i in picked:
        logits, cache = step(params, {"tokens": reqs[i][1][None]})
        kept[i] = (logits[0, -1], cache, int(torch.argmax(logits[0, -1])))
    del params
    _free()
    out = {"seed": seed, "program": prefill.check(cell, seed, "cuda", reqs, picked, kept)}
    if leaves:  # the longest request, layer by layer
        i = lengths.index(max(lengths))
        W = weights.make(harness.reference(cell).leaves(m), seed, "cuda")
        want_logits, want_layers = prefill.reference_outputs(cell, W, reqs[i][1])
        out["layers"] = {name: [round(prefill._rel(kept[i][1][name][j].reshape(v[name].shape),
                                                   v[name]), 5) for j, v in sorted(want_layers.items())]
                         for name in want_layers[0]}
        del W, want_layers
    del kept
    _free()
    if control:
        W = weights.make(harness.reference(cell).leaves(m), seed, "cuda")
        kept = {}
        for i in picked:
            logits, layers = prefill.reference_outputs(cell, W, reqs[i][1], quant="fp8")
            cache = {k: torch.stack([layers[j][k] for j in sorted(layers)]) for k in layers[0]}
            kept[i] = (logits, cache, int(torch.argmax(logits)))
        del W
        _free()
        out["control"] = prefill.check(cell, seed, "cuda", reqs, picked, kept)
        del kept
        _free()
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="",
                    help="training cells: also the program with its keys' gradient doubled")
    ap.add_argument("--leaves", action="store_true",
                    help="also each leaf's gap (training) or each layer's (prefill)")
    args = ap.parse_args(argv)
    bench._environment()
    from pbench import harness

    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    per_seed = train_seed if cell.traffic["kind"] == "train" else prefill_seed
    for seed in seeds + sorted((controls | faults) - set(seeds)):
        out = per_seed(cell, seed, seed in controls, args.leaves, seed in faults)
        print(json.dumps({"cell": cell.name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
