#!/usr/bin/env python3
"""The batched lease wrappers' own host cost, on any machine.

    python3 tools/lease_wrapper_host_us.py [--src SRC] [--reps N]

At phase 19a's bench sweep of ``chip_smoke.py`` (1024 scenarios x 32 cells
x 16 ticks, A 3, P 4: zero delay for ``lease_window_sync_batched``, delay
<= 2 with drops for ``lease_window_delayed_batched``), in both collect
modes, it runs each batched wrapper on CPU tensors with its three device
hooks made inert: the CUDA-tensor check (``_cuda_device``) passes the
tensors' device through, ``_launch`` returns without calling the library,
and ``torch.cuda.device`` is a null context. What is left is the
wrapper's Python: the input checks, the launch plan, the outputs, the
pointer and integer arrays, the launch count. It prints, for each entry
and mode, the least over 7 blocks of the mean time of ``N`` calls (default
5000), in µs, and what one call (after a first one) executes, counted
by the interpreter's trace and profile hooks: Python function calls,
calls into C (torch's included) and bytecodes. The counts do not depend
on the machine or its load; the times do.

``--src SRC`` imports the port from another tree's ``src`` (an earlier
commit's, from ``git archive``); run it with and without, in turns, to
compare two commits' wrapper cost on one machine. Nothing here needs a
card, and no figure it prints is a device time.
"""
from __future__ import annotations

import contextlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ENTRIES = {"lease_window_sync_batched": False,
           "lease_window_delayed_batched": True}


def best_mean_us(fn, reps: int, blocks: int = 7) -> float:
    """Least over ``blocks`` of the mean host time (µs) of ``reps`` calls."""
    best = float("inf")
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e6 / reps)
    return best


def count_events(fn) -> dict:
    """Python calls, C calls and bytecodes executed by one call of ``fn``."""
    counts = {"call": 0, "c_call": 0, "opcode": 0}

    def tracer(frame, event, arg):
        frame.f_trace_opcodes = True
        if event == "opcode":
            counts["opcode"] += 1
        return tracer

    def profiler(frame, event, arg):
        if event in ("call", "c_call"):
            counts[event] += 1

    sys.settrace(tracer)
    sys.setprofile(profiler)
    try:
        fn()
    finally:
        sys.settrace(None)
        sys.setprofile(None)
    return counts


def main(argv: list[str]) -> int:
    src, reps = ROOT / "src", 5000
    while argv:
        flag, value, argv = argv[0], argv[1], argv[2:]
        if flag == "--src":
            src = Path(value).resolve()
        elif flag == "--reps":
            reps = int(value)
        else:
            print(__doc__, file=sys.stderr)
            return 2
    sys.path[:0] = [str(ROOT), str(src)]
    import torch

    import chip_smoke as CS
    from repro_torch.lease_array import kernel as K

    torch.set_num_threads(1)
    K._cuda_device = lambda t: t.device
    K._launch = lambda *a, **k: None
    torch.cuda.device = lambda d: contextlib.nullcontext()
    dev = torch.device("cpu")
    print(f"port from {src}; {reps} calls a block", flush=True)
    for entry, delayed in ENTRIES.items():
        eng, stacked = CS.bench_sweep_setup(dev, delayed)
        for collect in ("summary", "owners"):
            args, kw = CS.batched_kernel_args(eng, stacked, delayed, collect,
                                              dev)
            fn = getattr(K, entry)
            call = lambda: fn(*args, **kw)  # noqa: E731
            call()
            count_events(call)  # the hooks' own first use
            n = count_events(call)
            us = best_mean_us(call, reps)
            print(f"{entry} {collect}: wrapper host {us:.3f} us a call; "
                  f"{n['call']} Python calls, {n['c_call']} C calls, "
                  f"{n['opcode']} bytecodes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
