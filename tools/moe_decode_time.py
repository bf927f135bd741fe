#!/usr/bin/env python3
"""Where mixtral-8x22b's bf16 steps spend their device time, on one card.

    python3 tools/moe_decode_time.py

mixtral-8x22b at its published widths, 4 of its 56 layers, as in
``chip_smoke.py``'s phases 25-28: random fp32 master weights from seed 0,
bf16 compute, a prefill of 1 x 8192 tokens and one decode step at batch 1,
position 8192, on the prefill's cache. It prints the card's name and power
limit, then:

* the cast of each layer's fp32 master weights to bf16, as
  ``transformer.layer_params`` makes it in every step: CUDA-event time, the
  bytes it must move (fp32 read, bf16 written) and the rate, per layer and
  for all four; beside it one ``copy_`` of the largest leaf into a bf16
  tensor made beforehand, the rate a cast reaches without allocation;
* for the prefill and the decode step, three profiler sessions each: the
  device events counted and summed by name, the runtime's launch calls
  counted, the union of the events' intervals (busy), and the CUDA-event
  span of the same call; the number of floating leaves the step casts,
  beside the event count of the cast kernel;
* the same two steps timed by CUDA events and on the host, with the fp32
  master weights and with weights cast to bf16 beforehand (the step's own
  cast is then no copy): their difference is the cast's share of the step.

The bytes floor of each step is the cast's bytes plus one read of the
layers' bf16 weights, at the card's 3.35 TB/s (HBM3).
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH, LAYERS, SEQ = "mixtral-8x22b", 4, 8192
HBM_BYTES_PER_MS = 3.35e9


def event_ms(fn, reps: int) -> float:
    """Mean device span of ``fn`` over ``reps`` calls (CUDA events), after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Mean host time of ``fn`` over ``reps`` synchronised calls, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_once(fn):
    """One call of ``fn`` under ``torch.profiler``: (CUDA-event span ms,
    device events, runtime launch calls, their summed ms, busy ms,
    {name: [count, ms]})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
    all_events = prof.events()
    events = [e for e in all_events if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.name in LAUNCH_CALLS for e in all_events
                   if e.device_type == torch.autograd.DeviceType.CPU)
    busy, end, total, by_name = 0.0, float("-inf"), 0.0, {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        us = e.time_range.elapsed_us()
        total += us
        slot = by_name.setdefault(e.name, [0, 0.0])
        slot[0] += 1
        slot[1] += us / 1e3
    return start.elapsed_time(stop), len(events), launches, total / 1e3, busy / 1e3, by_name


def report_sessions(name, fn, n_leaves):
    for session in range(3):
        span, n, launches, total, busy, by_name = profile_once(fn)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:4]
        print(f"{name}, profiler session {session}: CUDA-event span {span:.3f} ms; "
              f"{n} device events, {launches} runtime launch calls, summed {total:.3f} ms, "
              f"busy {busy:.3f} ms ({busy / span:.1%} of the span); the step casts "
              f"{n_leaves} leaves; largest: " + "; ".join(
                  f"{k[:90]} x{c} {v:.3f} ms" for k, (c, v) in top), flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("moe_decode_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_model, transformer
    from repro_torch.models.schema import leaf_paths

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    cfg = get_config(ARCH)
    cfg = dataclasses.replace(cfg, n_layers=LAYERS)
    print(f"{ARCH}, {LAYERS} of 56 layers, compute {cfg.dtype}, torch {torch.__version__}",
          flush=True)
    params = init_model(cfg, 0, device=dev)

    # ------------------------------------------------------------ the cast
    leaves = [x for _, x in leaf_paths(params["layers"]) if x.is_floating_point()]
    layer_elems = sum(x[0].numel() for x in leaves)
    cast_bytes = layer_elems * (4 + 2)
    per_layer = [event_ms(lambda l=l: transformer.layer_params(params, l, bf16), 5)
                 for l in range(LAYERS)]
    cast_ms = sum(per_layer)
    print(f"cast of one layer's {len(leaves)} floating leaves ({layer_elems / 1e9:.4f} G "
          f"elements, {cast_bytes / 1e9:.3f} GB moved): " + ", ".join(
              f"layer {l} {ms:.3f} ms ({cast_bytes / ms / 1e9:.3f} TB/s)"
              for l, ms in enumerate(per_layer))
          + f"; all {LAYERS}: {cast_ms:.3f} ms for {LAYERS * cast_bytes / 1e9:.2f} GB "
          f"(floor at 3.35 TB/s {LAYERS * cast_bytes / HBM_BYTES_PER_MS:.3f} ms)", flush=True)
    big = max(leaves, key=lambda x: x[0].numel())[0]
    dst = torch.empty(big.shape, dtype=bf16, device=dev)
    ms = event_ms(lambda: dst.copy_(big), 5)
    print(f"copy_ of the largest leaf {tuple(big.shape)} into bf16 made beforehand: {ms:.3f} ms "
          f"({big.numel() * 6 / ms / 1e9:.3f} TB/s)", flush=True)
    del dst

    # ---------------------------------------------------------- the steps
    toks = torch.from_numpy(np.random.default_rng(25).integers(
        0, cfg.vocab_size, (1, SEQ)).astype(np.int32)).to(dev)
    batch = {"tokens": toks}
    prefill, decode = make_prefill_step(cfg, logits_mode="last"), make_decode_step(cfg)
    _, cache = prefill(params, batch)
    weight_bytes = LAYERS * layer_elems * 2
    floor = (LAYERS * cast_bytes + weight_bytes) / HBM_BYTES_PER_MS
    steps = {"prefill_step 1 x 8192": lambda p: prefill(p, batch),
             "decode_step batch 1": lambda p: decode(p, cache, toks[:, :1], SEQ)}
    for name, step in steps.items():
        step(params)
        torch.cuda.synchronize()
        report_sessions(name, lambda: step(params), LAYERS * len(leaves))
        print(f"{name}: bytes floor (the cast and one read of the bf16 weights) "
              f"{floor:.3f} ms", flush=True)
    params_b = transformer.cast_tree(params, bf16)
    for name, step in steps.items():
        for label, p in (("fp32 master weights", params), ("weights cast beforehand", params_b),
                         ("fp32 master weights", params)):
            print(f"{name}, {label}: CUDA events {event_ms(lambda: step(p), 5):.3f} ms, "
                  f"host {host_ms(lambda: step(p), 5):.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
