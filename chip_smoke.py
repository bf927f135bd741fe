#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA card and check it: the
lease plane (phases 1-7), internlm2-1.8b prefill and serving through the
flash-attention kernel (phases 8-12), and rwkv6-3b prefill and serving
through the WKV6 kernel (phases 13-17).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``); it exits nonzero
without them, and on any failed check.

Phases (one line each):
  1. build the lease kernels from ``src/repro_torch/lease_array/csrc``, the
     flash-attention kernel from
     ``src/repro_torch/kernels/flash_attention/csrc`` and the WKV6 kernel
     from ``src/repro_torch/kernels/rwkv6/csrc``, all nvcc runs at once;
  2. hold both kernels bit-exact against their plain PyTorch versions on
     small traces (delay 0/2/4, asymmetric links, drift, restarts, extends,
     stale/equiv corruption, windows 1/3/16, a ragged cell count, a trace
     split over two dispatches, quiescence skip on and off);
  3. the full-width renewal deployment (N = 2^20 cells, A = 5, P = 8,
     96-tick leases extended every 64 ticks over links of delay 4) through
     ``LeaseArrayEngine.run_trace``: kernel and plain bit-exact, at most
     one owner per cell, >= 95% of cell-ticks owned after the first round;
  4. a full-width chaos trace (drops, asymmetric delay, drift, restarts,
     renewals) through the delayed kernel, bit-exact against plain;
  5. a full-width zero-delay trace through the sync kernel, bit-exact;
  6. 32 ``engine.step`` calls equal one ``run_trace`` of the same ticks;
  7. per kernel: launches on the main path (phases 3-6), time at the
     phase-3/5 shapes, the plain version's time and the least time the card
     could take, as one JSON line. That bound is the larger of the bytes the
     call must move over the memory rate and the arithmetic instructions
     the compiled tick loop must issue (read from the built library with
     ``cuobjdump -sass``) over their pipes' rates.
  8. the flash kernel against its plain version on the reference's seven
     cases plus ragged, windowed and cross-attention lengths;
  9. internlm2-1.8b at full width, random weights from a seed: a 4 x 2048
     fp32 prefill through the kernel (24 launches) against the same prefill
     with plain attention on the card, last logits to a relative error
     below 2e-4;
 10. 16 greedy ``decode_step`` tokens after that prefill against
     ``forward`` over all 2064 tokens, relative error below 2e-4;
 11. ``ServeEngine`` in bf16: 8 requests on 4 slots, 16 new tokens each;
 12. the flash kernel's, the plain version's and
     ``scaled_dot_product_attention``'s times at the prefill shapes in bf16
     and the bound (the larger of the causal FLOPs over the bf16 peak and
     the bytes over the memory rate); bf16 prefill and decode step times.
 13. the WKV6 kernel against its plain chunked form on the reference's
     five cases, ragged lengths from nonzero states (final states
     compared), 128 tokens against two calls of 64 with the state carried,
     and the decay rates of rwkv6's own decay_base init;
 14. rwkv6-3b at full width, random weights from a seed: a 4 x 2048 fp32
     prefill through the kernel (32 launches) against the same prefill
     with the plain chunked form on the card, last logits and the emitted
     state to a relative error below 2e-4;
 15. 16 greedy ``decode_step`` tokens from that prefill's state against
     ``forward`` over all 2064 tokens, relative error below 2e-4;
 16. ``ServeEngine`` in bf16: 8 requests on 4 slots, 16 new tokens each;
 17. the WKV6 kernel's and the plain form's times at the prefill shapes
     (bf16 r/k/v) and the bound (the larger of the bytes over the memory
     rate and the chunked matrix form's FLOPs over the bf16 peak); bf16
     prefill and decode step times.
The line before the last holds every kernel's launches on its main path
(phases 3-6; the phase-9 prefill and phase-11 serving; the phase-14
prefill and phase-16 serving), time, plain time, bound and library time as
JSON;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import heapq
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

FULL_N = 1 << 20          # cells: a shard directory of ~1M leased resources
A, P = 5, 8               # configs/paxoslease_cell.py DEFAULT_CELL; 8 proposers
BUILD_ACCEPTORS = (A, 3)  # the deployment's cell, and a 3-acceptor cell in phase 2
RENEW_LEASE, RENEW_CADENCE, RENEW_DELAY = 96, 64, 4
RENEW_ROUND = 4 * RENEW_DELAY + 1   # benchmarks/bench_lease_array.py:343-369
RENEW_TICKS = 256
CHAOS_TICKS = SYNC_TICKS = 128
STEP_TICKS = 32
WARM = 2 * RENEW_DELAY + 1  # the first acquisition lands after one round trip

#: H100 SXM memory rate (NVIDIA data sheet), its 132 SMs at the 1980 MHz
#: maximum SM clock (nvidia-smi clocks.max.sm), and the per-SM per-clock
#: throughput of each pipe the tick loops issue to, for compute capability
#: 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput):
#: 32-bit integer add/compare/logic/shift/select 64, multiply-add 64,
#: population count 16, type conversions and special functions 16
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_LANES = {"alu": 64, "imad": 64, "popc": 16, "xu": 16}

SASS_LINE = re.compile(
    r"^\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
#: instructions that are not arithmetic on a thread's data: control flow,
#: barriers and votes, memory (whose bytes the byte bound counts), moves and
#: special-register reads
SASS_NOT_OPS = (
    "BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY", "BSYNC",
    "BREAK", "WARPSYNC", "BAR", "YIELD", "NOP", "DEPBAR", "MEMBAR", "FENCE",
    "VOTE", "MOV", "S2R", "CS2R", "SHFL",
)


def sass_pipe(op: str):
    """The pipe an arithmetic SASS instruction issues to, or None for one
    that does no arithmetic on the thread's data. Uniform-datapath (U*)
    instructions run once per warp and are left out too."""
    base = op.split(".")[0]
    if (base in SASS_NOT_OPS or op.startswith("IMAD.MOV") or base[0] == "U"
            or base.startswith(("LD", "ST", "ATOM", "RED", "S2U", "R2U"))):
        return None
    if base == "POPC":
        return "popc"
    if base in ("I2F", "F2I", "I2I", "F2F", "MUFU", "FLO", "BREV"):
        return "xu"
    return "imad" if base.startswith(("IMAD", "IMUL")) else "alu"


def sass_functions(text: str) -> dict:
    """{mangled kernel name: [(address, predicate, opcode, operands)]} from
    ``cuobjdump -sass`` output."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None and (m := SASS_LINE.match(line)):
            out[name].append((int(m[1], 16), (m[2] or "").strip(), m[3],
                              m[4].strip()))
    return out


def tick_loop_ops(ins: list) -> dict:
    """Arithmetic instructions per tick, by pipe, that every tick of the
    kernel's tick loop must issue: the fewest on any path from the loop's
    head to its back edge. The tick loop is the innermost loop that loads
    from and stores to global memory and holds no barrier. Each tick stores
    two rows (owner, count), so the path's stores give its tick count."""
    def target(args):
        return int(re.search(r"0x([0-9a-f]+)", args)[1], 16)

    leaders = {ins[0][0]}
    for i, (_, _, op, args) in enumerate(ins):
        if op.startswith("BRA") or op == "EXIT":
            if op.startswith("BRA"):
                leaders.add(target(args))
            if i + 1 < len(ins):
                leaders.add(ins[i + 1][0])
    blocks = []
    for x in ins:
        if x[0] in leaders or not blocks:
            blocks.append([])
        blocks[-1].append(x)
    first = {b[0][0]: i for i, b in enumerate(blocks)}
    succ = []
    for i, b in enumerate(blocks):
        _, pred, op, args = b[-1]
        always = pred in ("", "@PT")
        nxt = [i + 1] if i + 1 < len(blocks) else []
        if op.startswith("BRA"):
            succ.append([first[target(args)]] + ([] if always else nxt))
        else:
            succ.append([] if op == "EXIT" and always else nxt)
    loops = []  # (span, head address, back-edge address, back-edge block)
    for i, b in enumerate(blocks):
        addr, _, op, args = b[-1]
        if op.startswith("BRA") and target(args) <= addr:
            ops = [x[2] for x in ins if target(args) <= x[0] <= addr]
            if (any(o.startswith("STG") for o in ops)
                    and any(o.startswith("LDG") for o in ops)
                    and not any(o.startswith("BAR") for o in ops)):
                loops.append((addr - target(args), target(args), addr, i))
    if not loops:
        raise ValueError("no tick loop found in the kernel's SASS")
    _, head, tail, latch = min(loops)

    def weight(i):
        return sum(sass_pipe(x[2]) is not None for x in blocks[i])

    h = first[head]
    dist, prev, todo = {h: weight(h)}, {}, [(weight(h), h)]
    while todo:
        d, i = heapq.heappop(todo)
        if i == latch:
            break
        if d > dist[i]:
            continue
        for j in succ[i]:
            if j != h and head <= blocks[j][0][0] <= tail:
                if d + weight(j) < dist.get(j, float("inf")):
                    dist[j], prev[j] = d + weight(j), i
                    heapq.heappush(todo, (d + weight(j), j))
    path = [latch]
    while path[-1] != h:
        path.append(prev[path[-1]])
    on_path = [x[2] for i in path for x in blocks[i]]
    ticks = sum(o.startswith("STG") for o in on_path) // 2
    if ticks < 1:
        raise ValueError("the tick loop's shortest path stores no owner row")
    counts = {}
    for o in on_path:
        if (pipe := sass_pipe(o)) is not None:
            counts[pipe] = counts.get(pipe, 0) + 1
    return {k: v / ticks for k, v in counts.items()}


def kernel_tick_ops(lib: Path, kernel: str) -> dict:
    """tick_loop_ops of the one kernel in ``lib`` whose mangled name holds
    ``kernel`` (e.g. ``sync_window_kernelILi5E``), read with cuobjdump."""
    import shutil

    from repro_torch._nvcc import nvcc_path

    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    found = [ins for name, ins in sass_functions(sass).items()
             if kernel in name]
    if len(found) != 1:
        raise ValueError(f"{len(found)} kernels named like {kernel} in {lib}")
    return tick_loop_ops(found[0])


def ops_ms(cell_ticks: int, per_tick: dict) -> float:
    """The least time the SMs take to issue ``per_tick`` arithmetic
    instructions for each of ``cell_ticks``: the busiest pipe's count over
    its lanes (the pipes issue side by side)."""
    return max(cell_ticks * n / (PIPE_LANES[k] * SM_CLOCKS_PER_S)
               for k, n in per_tick.items()) * 1e3


def lease_kind(entry: str) -> str:
    return "delayed" if "delayed" in entry else "sync"


def flash_kind(entry: str) -> str:
    """'fp32/Dh128' for the instantiation named in a ptxas entry line."""
    m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
    return f"{'fp32' if m[1] == 'f' else 'bf16'}/Dh{16 * int(m[2])}"


def ptxas_summary(log: str, kind_of=lease_kind) -> str:
    """Most registers and total spill bytes per kernel family, from the
    ``-Xptxas -v`` report kept beside a built library."""
    regs, spills, kind = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kind = kind_of(line)
        elif kind and "registers" in line and "Used" in line:
            n = int(line.split("Used", 1)[1].split("registers")[0])
            regs[kind] = max(regs.get(kind, 0), n)
        elif kind and "spill stores" in line:
            words = line.replace(",", " ").split()
            n = sum(int(words[i - 2]) for i, w in enumerate(words)
                    if w == "spill")  # "<n> bytes spill stores|loads"
            spills[kind] = spills.get(kind, 0) + n
    return ", ".join(f"{k} {regs[k]} registers / {spills.get(k, 0)} B spilled"
                     for k in sorted(regs))


def run_trace_breakdown(run):
    """Times one call of ``run`` (a ``run_trace``) and, inside it, the
    scenario checks on the host, the copies of planes to the card and the
    kernel, each wrapped with a device synchronisation. Returns
    ({part: ms}, total ms)."""
    import torch

    from repro_torch.lease_array import ops
    from repro_torch.lease_array.scenario import Scenario

    spent = {}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    parts = ((Scenario, "validate_for", "plane checks"),
             (ops, "_as_i32", "copies to the card"),
             (ops, "lease_window_delayed", "kernel"))
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in parts]
    for owner, attr, name in parts:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    return spent, total


def check(ok, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), after
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


def host_ms(fn, reps: int = 1) -> float:
    """Mean host time of ``fn`` over ``reps`` calls, each ended by a device
    synchronisation, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


#: the LM slice: internlm2-1.8b at its published widths (configs/archs.py)
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 2048, 16  # prefill_32k's 32 x 32768, cut to size
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
#: the kernel against its plain version: tests/test_kernels_flash.py's
#: seven cases, then lengths no multiple of the 64-row tile
#: (b, sq, sk, hq, hkv, dh, causal, window, dtype)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, "bfloat16"),
    (2, 256, 256, 4, 1, 64, True, 96, "float32"),
    (1, 128, 256, 2, 2, 64, False, None, "float32"),
    (1, 64, 64, 6, 3, 112, True, None, "float32"),
    (1, 256, 256, 2, 2, 64, True, 32, "bfloat16"),
    (1, 300, 300, 16, 8, 128, True, None, "float32"),
    (1, 1000, 1000, 16, 8, 128, True, None, "float32"),
    (1, 1000, 1000, 16, 8, 128, True, None, "bfloat16"),
    (2, 300, 300, 16, 8, 128, True, 100, "float32"),
    (1, 77, 200, 4, 4, 16, False, None, "float32"),
]
FLASH_TOL = {"float32": 5e-5, "bfloat16": 2.5e-2}  # test_kernels_flash.py:42


def profile_call(fn):
    """One call of ``fn`` under ``torch.profiler`` (after a warm-up call):
    (wall ms, device busy ms, the three device kernels with the most time as
    (name, ms)). Busy is the union of the device events' intervals; (0, [])
    when the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return wall, busy / 1e3, [(name[:60], us / 1e3) for name, us in top]


def serve_requests(cfg, params):
    """``ServeEngine`` with the defaults of ``launch/serve.py``: 8 requests
    with prompts of 2-11 tokens from seed 0, 16 new tokens each, 4 slots,
    max_len 128. Checks that all are served; returns (engine steps, tokens,
    seconds)."""
    import numpy as np
    import torch

    from repro_torch.train.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=4, max_len=128)
    rng = np.random.default_rng(0)
    for rid in range(8):
        plen = int(rng.integers(2, 12))
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, plen)
                           .astype(np.int32), max_new=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(done) == 8 and all(len(r.out) == 16 for r in done),
          f"serving completed {len(done)} of 8 requests")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out), "token out of range")
    return eng.steps, sum(len(r.out) for r in done), seconds


def report_steps(phase: int, params, batch, prefill, decode, cache) -> None:
    """Prints the host time of a prefill_step over ``batch`` and of one
    decode_step after it (from ``cache``, updated in place), then a
    ``torch.profiler`` breakdown of one call of each (bf16)."""
    b, s = batch["tokens"].shape
    one = batch["tokens"][:, :1]
    calls = (("prefill_step", lambda: prefill(params, batch)),
             ("decode_step", lambda: decode(params, cache, one, s)))
    ms_prefill = host_ms(calls[0][1], 3)
    ms_decode = host_ms(calls[1][1], 5)
    print(f"phase {phase} end to end (bf16): prefill_step {b} x {s} "
          f"{ms_prefill:.1f} ms ({b * s / ms_prefill * 1e3:.0f} tokens/s); "
          f"one decode_step at batch {b}, position {s}: {ms_decode:.2f} ms", flush=True)
    for name, fn in calls:
        wall, busy, top = profile_call(fn)
        seen = (f"device busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
                "most device time: " + ", ".join(f"{n} {ms:.2f} ms" for n, ms in top)
                if busy else "the profiler saw no device activity (not measured)")
        print(f"phase {phase} profile of one {name} (bf16): {wall:.1f} ms wall under the "
              f"profiler, {seen}", flush=True)


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, the measure of test_decode_equiv.py."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-9))


class PlainAttention:
    """Within this block the model's sequence attention runs the plain
    version on the card (the yardstick of phase 9), not the kernel."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.kernels.flash_attention.ref import attention_ref

        self.ops, self.saved = ops, ops.flash_attention_bhsd
        ops.flash_attention_bhsd = (lambda q, k, v, *, causal, window:
                                    attention_ref(q, k, v, causal=causal, window=window))

    def __exit__(self, *exc):
        self.ops.flash_attention_bhsd = self.saved


def continue_cache(cfg, cache, new_len: int):
    """A decode cache of ``new_len`` slots holding a prefill cache in its
    first slots (slot_pos 0..S-1), the rest empty."""
    from repro_torch.models import init_cache

    out = init_cache(cfg, cache["k"].shape[1], new_len, device=cache["k"].device)
    s = cache["k"].shape[2]
    for name in ("k", "v", "slot_pos"):
        out[name][:, :, :s] = cache[name]
    return out


def lm_slice(dev) -> dict:
    """Phases 8-12: the internlm2-1.8b prefill and serve path through the
    flash kernel, at full width. Returns the kernel's JSON entry."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward, init_model
    from repro_torch.models.schema import leaf_paths

    # fp32 products in full fp32: the plain yardstick must not round to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    max_err = 0.0

    # ------------------------------------- 8. flash kernel vs plain, cases
    t_phase = time.perf_counter()
    worst = {}
    for n, (b, sq, sk, hq, hkv, dh, causal, window, dtn) in enumerate(FLASH_CASES):
        rng = np.random.default_rng(100 + n)
        q, k, v = (torch.from_numpy(rng.standard_normal((b * h, s, dh), np.float32))
                   .to(dev, dt[dtn]) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
        got = FK.flash_attention_bhsd(q, k, v, causal=causal, window=window)
        sync()
        want = attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        check(got.shape == q.shape and got.dtype == q.dtype, f"flash case {n}: shape/dtype")
        check(err < FLASH_TOL[dtn], f"flash case {n} {FLASH_CASES[n]}: max |err| {err:.3e}")
        worst[dtn] = max(worst.get(dtn, 0.0), err)
        max_err = max(max_err, err)
    print(f"phase 8 flash kernel vs plain: {len(FLASH_CASES)} cases (the reference's "
          f"7, ragged 300/1000, windowed, ragged cross) within 5e-5 fp32 / 2.5e-2 bf16; "
          f"max |err| fp32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # --------------------------- 9. full-width fp32 prefill, kernel vs plain
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_model(cfg, 0, device=dev)  # fp32 master weights
    n_params = sum(x.numel() for _, x in leaf_paths(params))
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)).to(dev)
    prefill32 = make_prefill_step(cfg32, logits_mode="last")
    FK.reset_launches()  # the LM main path: the prefill here and serving (11)
    sync()
    t0 = time.perf_counter()
    logits_k, cache_k = prefill32(params, {"tokens": toks})
    sync()
    ms_prefill32 = (time.perf_counter() - t0) * 1e3
    prefill_launches = FK.flash_attention_bhsd.launches
    check(prefill_launches == cfg.n_layers,
          f"prefill launched the flash kernel {prefill_launches} times, not {cfg.n_layers}")
    with PlainAttention():
        logits_p, cache_p = prefill32(params, {"tokens": toks})
    sync()
    check(FK.flash_attention_bhsd.launches == prefill_launches, "plain prefill launched")
    check(tuple(logits_k.shape) == (LM_BATCH, 1, cfg.vocab_size), "prefill logits shape")
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    err9 = rel_err(logits_k, logits_p)
    err9_kv = max(rel_err(cache_k[n], cache_p[n]) for n in ("k", "v"))
    check(err9 < 2e-4, f"prefill logits kernel vs plain: rel err {err9:.3e}")
    check(err9_kv < 2e-4, f"prefill cache kernel vs plain: rel err {err9_kv:.3e}")
    del logits_p, cache_p
    print(f"phase 9 prefill {LM_ARCH} ({n_params / 1e9:.3f} B params, fp32) "
          f"{LM_BATCH} x {LM_SEQ}: {ms_prefill32:.1f} ms, flash launches "
          f"{prefill_launches}; last logits vs plain attention rel err {err9:.3e}, "
          f"emitted K/V rel err {err9_kv:.3e}; {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # -------------------------------------- 10. decode continuation (fp32)
    t_phase = time.perf_counter()
    decode32 = make_decode_step(cfg32)
    cache = continue_cache(cfg32, cache_k, LM_SEQ + LM_DECODE)
    del cache_k
    tok = logits_k[:, -1].argmax(-1)
    fed, dec = [], []
    for i in range(LM_DECODE):
        fed.append(tok)
        lg, cache = decode32(params, cache, tok[:, None], LM_SEQ + i)
        dec.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)
    del cache
    FK.reset_launches()  # the yardstick forward below is no part of the main path
    full, _ = forward(cfg32, params, {"tokens": torch.cat([toks, torch.stack(fed, 1)
                                                           .to(toks.dtype)], 1)})
    err10 = rel_err(torch.stack(dec, 1), full[:, LM_SEQ:])
    check(err10 < 2e-4, f"decode continuation vs forward: rel err {err10:.3e}")
    del full
    print(f"phase 10 continuation: {LM_DECODE} greedy decode_steps after the prefill "
          f"equal forward over {LM_SEQ + LM_DECODE} tokens, rel err {err10:.3e}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ----------------------------------------------- 11. serving in bf16
    t_phase = time.perf_counter()
    FK.reset_launches()
    steps, n_tok, serve_s = serve_requests(cfg, params)
    lm_launches = prefill_launches + FK.flash_attention_bhsd.launches
    check(lm_launches > 0, "flash_attention_bhsd was never launched on the main path")
    print(f"phase 11 serving {LM_ARCH} in {cfg.dtype}: 8 requests / {n_tok} tokens in "
          f"{steps} engine steps, {serve_s:.2f} s ({n_tok / serve_s:.1f} tokens/s; "
          f"admission feeds prompts token by token through decode_step, which "
          f"launches no flash kernel); flash launches on the main path (the "
          f"phase-9 prefill and this phase): {lm_launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------------------------------- 12. timing at the prefill shapes
    bhq, bhkv, dh = LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn(bhq, LM_SEQ, dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(bhkv, LM_SEQ, dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(bhkv, LM_SEQ, dh, generator=g, device=dev).to(torch.bfloat16)
    err12 = float((FK.flash_attention_bhsd(q, k, v, causal=True).float()
                   - attention_ref(q, k, v, causal=True).float()).abs().max())
    check(err12 < FLASH_TOL["bfloat16"], f"flash at the prefill shapes: max |err| {err12:.3e}")
    max_err = max(max_err, err12)
    ms_k = time_ms(lambda: FK.flash_attention_bhsd(q, k, v, causal=True), 10)
    ms_plain = time_ms(lambda: attention_ref(q, k, v, causal=True), 3)
    q4, k4, v4 = (x.view(LM_BATCH, -1, LM_SEQ, dh) for x in (q, k, v))
    ms_lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 10)
    pairs = bhq * LM_SEQ * (LM_SEQ + 1) // 2  # live causal (q, k) pairs
    ops_ms = 4 * dh * pairs / BF16_FLOP_PER_S * 1e3
    bytes_ms = (2 * q.numel() + k.numel() + v.numel()) * 2 / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    prefill = make_prefill_step(cfg, logits_mode="last")
    batch = {"tokens": toks}
    _, cache_b = prefill(params, batch)
    cache_b = continue_cache(cfg, cache_b, LM_SEQ + LM_DECODE)
    print(f"phase 12 timing (bf16, BHq {bhq}, BHkv {bhkv}, S {LM_SEQ}, Dh {dh}, "
          f"causal): flash kernel {ms_k:.3f} ms ({4 * dh * pairs / ms_k / 1e9:.1f} "
          f"TFLOP/s), plain {ms_plain:.3f} ms, scaled_dot_product_attention "
          f"{ms_lib:.3f} ms; bound {bound:.4f} ms (operations {ops_ms:.4f} ms at "
          f"989 TFLOP/s bf16, bytes {bytes_ms:.4f} ms at 3.35 TB/s); max |err| vs "
          f"plain {err12:.3e}", flush=True)
    report_steps(12, params, batch, prefill, make_decode_step(cfg), cache_b)
    return dict(
        name="flash_attention_bhsd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:124",
        launches=lm_launches, max_abs_err=max_err, ms=ms_k, plain_ms=ms_plain,
        bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=ms_lib,
    )


#: the rwkv slice: rwkv6-3b at its published widths (configs/archs.py), at the
#: LM slice's prefill size
RWKV_ARCH = "rwkv6-3b"
#: the WKV6 kernel against its plain version: tests/test_kernels_rwkv6.py's
#: five cases, then ragged lengths from nonzero states and the reduced
#: configs' head size (b, s, h, n, omega_hi, dtype, initial state)
WKV_CASES = [
    (2, 64, 4, 64, 0.5, "float32", False),
    (1, 128, 2, 64, 1.0, "float32", False),
    (1, 96, 2, 64, 0.5, "float32", False),
    (2, 96, 3, 32, 0.5, "bfloat16", False),
    (1, 64, 1, 128, 0.0, "float32", False),
    (1, 77, 4, 64, 0.5, "float32", True),
    (2, 1000, 2, 64, 0.5, "bfloat16", True),
    (1, 1000, 4, 64, 1.0, "float32", True),
    (3, 45, 4, 16, 0.5, "float32", True),
]
WKV_TOL = {"float32": 5e-4, "bfloat16": 3e-2}  # test_kernels_rwkv6.py:45-47
WKV_CHUNK = 32  # the Pallas kernel's chunk, for the matrix form's operation count


def wkv_kind(entry: str) -> str:
    """'fp32/N64' for the instantiation named in a ptxas entry line."""
    m = re.search(r"wkv6_kernelI(f|13__nv_bfloat16)Li(\d+)E", entry)
    return f"{'fp32' if m[1] == 'f' else 'bf16'}/N{m[2]}"


def wkv_inputs(dev, b, s, h, n, omega_hi, dt, with_state, seed, omega=None):
    """(r, k, v, logw, u, state) on the kernel's (B·H, S, N) layout from
    numpy: r, k, v in ``dt``, the rest fp32; ``omega`` (broadcast to
    (B, S, H, N)) replaces the uniform [-6, omega_hi] decay draw."""
    import numpy as np
    import torch

    from repro_torch.kernels.rwkv6.ref import fold_heads

    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n), np.float32) for _ in range(3))
    if omega is None:
        omega = rng.uniform(-6.0, omega_hi, (b, s, h, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = np.broadcast_to(rng.standard_normal((h, n)) * 0.3, (b, h, n)).reshape(b * h, n)
    st = (rng.standard_normal((b * h, n, n)) * 0.1).astype(np.float32) if with_state else None

    def t(a, d=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, d)

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    return (*(fold_heads(t(a, tdt)).contiguous() for a in (r, k, v)),
            fold_heads(t(logw)).contiguous(), t(u), None if st is None else t(st))


def decay_base_omega(b, s, h, n, seed):
    """rwkv6's decay_base init spread over a head's channels (-6 + 7
    linspace(0, 1)^1.5), plus 0.1 noise per element: the decay rates at
    which the Pallas kernel's clamp is wrong."""
    import numpy as np

    base = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5
    return base + 0.1 * np.random.default_rng(seed).standard_normal((b, s, h, n))


class PlainWKV:
    """Within this block the model's WKV6 recurrence runs the plain chunked
    form on the card (the yardstick of phase 14), not the kernel."""

    def __enter__(self):
        from repro_torch.kernels.rwkv6 import ops
        from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

        self.ops, self.saved = ops, ops.wkv6_bhsn
        ops.wkv6_bhsn = wkv_chunked_bhsn

    def __exit__(self, *exc):
        self.ops.wkv6_bhsn = self.saved


def rwkv_slice(dev) -> dict:
    """Phases 13-17: the rwkv6-3b prefill and serve path through the WKV6
    kernel, at full width. Returns the kernel's JSON entry."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward, init_model
    from repro_torch.models.schema import leaf_paths

    sync = torch.cuda.synchronize
    max_err = 0.0

    def against_plain(args, tol, what):
        """The kernel and the plain chunked form on the same inputs:
        outputs and final states to ``tol`` relative; returns max |err|."""
        out, st = WK.wkv6_bhsn(*args)
        sync()
        want, want_st = wkv_chunked_bhsn(*args)
        check(out.shape == args[0].shape and out.dtype == torch.float32, f"{what}: shape/dtype")
        err, err_st = rel_err(out, want), rel_err(st, want_st)
        check(err < tol and err_st < tol,
              f"{what}: rel err {err:.3e}, state {err_st:.3e} (tolerance {tol})")
        return float((out - want).abs().max()), max(err, err_st)

    # ------------------------------------------ 13. WKV6 kernel vs plain
    t_phase = time.perf_counter()
    worst = {}
    for i, case in enumerate(WKV_CASES):
        args = wkv_inputs(dev, *case, seed=130 + i)
        abs_err, rel = against_plain(args, WKV_TOL[case[5]], f"wkv case {i} {case}")
        worst[case[5]] = max(worst.get(case[5], 0.0), rel)
        max_err = max(max_err, abs_err)
    r, k, v, logw, u, _ = wkv_inputs(dev, 1, 128, 2, 64, 0.5, "float32", False, seed=139)
    full, full_st = WK.wkv6_bhsn(r, k, v, logw, u)
    o1, st = WK.wkv6_bhsn(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u)
    o2, st = WK.wkv6_bhsn(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, st)
    err_carry = max(rel_err(torch.cat([o1, o2], 1), full), rel_err(st, full_st))
    check(err_carry < WKV_TOL["float32"], f"wkv 128 vs 2 x 64 carried: rel err {err_carry:.3e}")
    b, s, h, n = 2, 512, 4, 64
    spread = wkv_inputs(dev, b, s, h, n, None, "float32", True, seed=140,
                        omega=decay_base_omega(b, s, h, n, 141))
    abs_err, err_spread = against_plain(spread, WKV_TOL["float32"], "wkv decay_base spread")
    max_err = max(max_err, abs_err)
    print(f"phase 13 WKV6 kernel vs plain: {len(WKV_CASES)} cases (the reference's 5, "
          f"ragged 77/1000/45 from nonzero states, N 16/32/64/128) within 5e-4 fp32 / "
          f"3e-2 bf16, outputs and final states; worst rel err fp32 "
          f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; 128 tokens vs 2 x 64 "
          f"carried {err_carry:.3e}; decay_base spread {err_spread:.3e}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # --------------------------- 14. full-width fp32 prefill, kernel vs plain
    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_model(cfg, 0, device=dev)  # fp32 master weights
    n_params = sum(x.numel() for _, x in leaf_paths(params))
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_SEQ)).astype(np.int32)).to(dev)
    prefill32 = make_prefill_step(cfg32, logits_mode="last")
    WK.reset_launches()  # the rwkv main path: the prefill here and serving (16)
    sync()
    t0 = time.perf_counter()
    logits_k, cache_k = prefill32(params, {"tokens": toks})
    sync()
    ms_prefill32 = (time.perf_counter() - t0) * 1e3
    prefill_launches = WK.wkv6_bhsn.launches
    check(prefill_launches == cfg.n_layers,
          f"prefill launched the WKV6 kernel {prefill_launches} times, not {cfg.n_layers}")
    with PlainWKV():
        logits_p, cache_p = prefill32(params, {"tokens": toks})
    sync()
    check(WK.wkv6_bhsn.launches == prefill_launches, "plain prefill launched")
    check(tuple(logits_k.shape) == (LM_BATCH, 1, cfg.vocab_size), "prefill logits shape")
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    err14 = rel_err(logits_k, logits_p)
    err14_state = {name: rel_err(cache_k[name], cache_p[name]) for name in cache_k}
    check(err14 < 2e-4, f"prefill logits kernel vs plain: rel err {err14:.3e}")
    check(max(err14_state.values()) < 2e-4, f"prefill state kernel vs plain: {err14_state}")
    del logits_p, cache_p
    print(f"phase 14 prefill {RWKV_ARCH} ({n_params / 1e9:.3f} B params, fp32) "
          f"{LM_BATCH} x {LM_SEQ}: {ms_prefill32:.1f} ms, WKV6 launches "
          f"{prefill_launches}; last logits vs the plain chunked form rel err "
          f"{err14:.3e}, emitted state rel err " + ", ".join(
              f"{k} {v:.3e}" for k, v in err14_state.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -------------------------------------- 15. decode continuation (fp32)
    t_phase = time.perf_counter()
    decode32 = make_decode_step(cfg32)
    cache = cache_k  # the recurrent state is the whole decode cache
    tok = logits_k[:, -1].argmax(-1)
    fed, dec = [], []
    for i in range(LM_DECODE):
        fed.append(tok)
        lg, cache = decode32(params, cache, tok[:, None], LM_SEQ + i)
        dec.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)
    del cache, cache_k
    WK.reset_launches()  # the yardstick forward below is no part of the main path
    full, _ = forward(cfg32, params, {"tokens": torch.cat([toks, torch.stack(fed, 1)
                                                           .to(toks.dtype)], 1)})
    err15 = rel_err(torch.stack(dec, 1), full[:, LM_SEQ:])
    check(err15 < 2e-4, f"decode continuation vs forward: rel err {err15:.3e}")
    del full
    print(f"phase 15 continuation: {LM_DECODE} greedy decode_steps from the kernel "
          f"prefill's state equal forward over {LM_SEQ + LM_DECODE} tokens, rel err "
          f"{err15:.3e}; {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ----------------------------------------------- 16. serving in bf16
    t_phase = time.perf_counter()
    WK.reset_launches()
    steps, n_tok, serve_s = serve_requests(cfg, params)
    rwkv_launches = prefill_launches + WK.wkv6_bhsn.launches
    check(rwkv_launches > 0, "wkv6_bhsn was never launched on the main path")
    print(f"phase 16 serving {RWKV_ARCH} in {cfg.dtype}: 8 requests / {n_tok} tokens in "
          f"{steps} engine steps, {serve_s:.2f} s ({n_tok / serve_s:.1f} tokens/s; "
          f"admission feeds prompts token by token through decode_step, which "
          f"launches no WKV6 kernel); WKV6 launches on the main path (the phase-14 "
          f"prefill and this phase): {rwkv_launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------------------------------- 17. timing at the prefill shapes
    h, n = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    args = wkv_inputs(dev, LM_BATCH, LM_SEQ, h, n, None, "bfloat16", False, seed=17,
                      omega=decay_base_omega(LM_BATCH, LM_SEQ, h, n, 18))
    abs_err, err17 = against_plain(args, WKV_TOL["bfloat16"], "wkv at the prefill shapes")
    max_err = max(max_err, abs_err)
    ms_k = time_ms(lambda: WK.wkv6_bhsn(*args), 10)
    ms_plain = time_ms(lambda: wkv_chunked_bhsn(*args), 3)
    bh, seq = args[0].shape[:2]
    # inputs read once (r, k, v in bf16, logw and u in fp32), outputs written
    # once (out and the final state, fp32); the zero initial state is no input
    n_bytes = (sum(x.numel() * x.element_size() for x in args[:5])
               + bh * seq * n * 4 + bh * n * n * 4)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    # the chunked matrix form, per token and head: scores and intra-chunk
    # products 2 x 2·C·N, inter-chunk output and state update 2 x 2·N·N
    flop = bh * seq * 4 * n * (WKV_CHUNK + n)
    ops_ms = flop / BF16_FLOP_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    print(f"phase 17 timing (bf16 r/k/v, BH {bh}, S {seq}, N {n}, decay_base spread): "
          f"WKV6 kernel {ms_k:.3f} ms ({n_bytes / ms_k / 1e6:.1f} GB/s), plain chunked "
          f"form {ms_plain:.3f} ms; no single PyTorch call computes WKV6 (library_ms "
          f"null); bound {bound:.4f} ms (bytes {bytes_ms:.4f} ms: {n_bytes / 1e6:.1f} MB "
          f"at 3.35 TB/s; operations {ops_ms:.4f} ms: {flop:.3e} FLOP of the chunked "
          f"matrix form at 989 TFLOP/s bf16); rel err vs plain {err17:.3e}", flush=True)
    del args
    prefill = make_prefill_step(cfg, logits_mode="last")
    batch = {"tokens": toks}
    _, cache_b = prefill(params, batch)
    report_steps(17, params, batch, prefill, make_decode_step(cfg), cache_b)
    return dict(
        name="wkv6_bhsn", route="cuda",
        source="src/repro_torch/kernels/rwkv6/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6/kernel.py:94",
        launches=rwkv_launches, max_abs_err=max_err, ms=ms_k, plain_ms=ms_plain,
        bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
        library_ms=None,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.lease_array import (
        LeaseArrayEngine,
        Scenario,
        engine_from_reference,
        engine_to_arrays,
        random_trace,
    )
    from repro_torch.kernels.flash_attention import _build as flash_build
    from repro_torch.kernels.rwkv6 import _build as wkv_build
    from repro_torch.lease_array import _build
    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array.netplane import init_netplane, pack_link
    from repro_torch.lease_array.ops import _as_i32, _local_clock_planes
    from repro_torch.lease_array.state import init_state, pack_state

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    max_err = {"lease_window_delayed": 0, "lease_window_sync": 0}

    def equal(a, b, what, kernel):
        """Bit-exact comparison of two tensor tuples; tracks max |err|."""
        for i, (x, y) in enumerate(zip(a, b)):
            err = int((x.long() - y.long()).abs().max()) if x.numel() else 0
            max_err[kernel] = max(max_err[kernel], err)
            check(x.shape == y.shape and err == 0,
                  f"{what}: field {i} differs (max |err| {err})")

    # ------------------------------------------------------------ 1. build
    # one library per acceptor count (A is a compile-time constant); the
    # nvcc runs go together
    # and the flash-attention library beside them
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILD_ACCEPTORS) + 2) as pool:
        flash_lib = pool.submit(flash_build.build)
        wkv_lib = pool.submit(wkv_build.build)
        libs = list(pool.map(_build.build, BUILD_ACCEPTORS))
        flash_lib, wkv_lib = flash_lib.result(), wkv_lib.result()
    for a in BUILD_ACCEPTORS:
        _build.load(a)
    flash_build.load()
    wkv_build.load()
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.1f} s; " + "; ".join(
        f"{lib.name}: {ptxas_summary(lib.with_suffix('.log').read_text())}"
        for lib in libs), flush=True)
    print(f"phase 1 build: {flash_lib.name} (dynamic shared memory "
          f"{(3 * 128 + 64) * 64 * 4} B a block at Dh 128): " + ptxas_summary(
              flash_lib.with_suffix(".log").read_text(), flash_kind), flush=True)
    print(f"phase 1 build: {wkv_lib.name} (dynamic shared memory "
          f"{(3 * 32 * 64 + 5 * 32 * 32 + 64 + 32) * 4} B a block at N 64): " + ptxas_summary(
              wkv_lib.with_suffix(".log").read_text(), wkv_kind), flush=True)

    # ------------------------------------- 2. kernel vs plain, small traces
    t_phase = time.perf_counter()

    def small_cases():
        rng = np.random.default_rng(11)
        g = dict(n_cells=1000, n_acceptors=A, n_proposers=P)
        yield "delay0", random_trace(1, n_ticks=96, lease_ticks=5, **g), None
        yield "delay2-asym-drop", random_trace(
            2, n_ticks=96, max_delay_ticks=2, p_drop=0.1, asymmetric=True,
            **g), None
        yield "delay4-asym-drift-restart-renew", random_trace(
            3, n_ticks=128, lease_ticks=24, max_delay_ticks=4, p_drop=0.05,
            asymmetric=True, drift_eps=0.25, restarts=0.01, renew=0.5,
            **g), None
        corrupt = dict(
            acc_stale=(rng.random((96, A)) < 0.05).astype(np.int32),
            acc_equiv=(rng.random((96, A)) < 0.05).astype(np.int32),
        )
        yield "delay2-stale-equiv-restart", random_trace(
            4, n_ticks=96, lease_ticks=8, max_delay_ticks=2, p_drop=0.05,
            restarts=0.02, **g), corrupt
        yield "renewal", renewal_trace(1000, 384), None
        yield "a3-delay2-drift-restart-renew", random_trace(
            5, n_ticks=96, n_cells=1000, n_acceptors=3, n_proposers=5,
            lease_ticks=8, max_delay_ticks=2, p_drop=0.05, drift_eps=0.25,
            restarts=0.01, renew=0.5), None

    def renewal_trace(n, ticks, t_first=0):
        from repro_torch.lease_array.trace import Trace

        att = np.full((ticks, n), -1, np.int32)
        ext = np.full((ticks, n), -1, np.int32)
        cells = np.arange(n, dtype=np.int32) % P
        for tau in range(ticks):
            t = t_first + tau
            if t == 0:
                att[tau] = cells
            elif t % RENEW_CADENCE == 0:
                ext[tau] = cells
        return Trace(
            n, A, P, RENEW_LEASE, att, np.full((ticks, n), -1, np.int32),
            np.ones((ticks, A), np.int32),
            delay=np.full((ticks, A), RENEW_DELAY, np.int32),
            round_ticks=RENEW_ROUND, extends=ext,
        )

    def scenario_of(trace, extra):
        sc = trace.scenario()
        if extra:
            sc = Scenario.build(
                n_cells=trace.n_cells, n_acceptors=A, n_proposers=P,
                **{**sc.planes, **extra},
            )
        return sc

    def engine(trace, **kw):
        return LeaseArrayEngine(
            trace.n_cells, n_acceptors=trace.n_acceptors,
            n_proposers=trace.n_proposers, lease_ticks=trace.lease_ticks,
            round_ticks=trace.round_ticks, drift_eps=trace.drift_eps, **kw,
        )

    def replay(trace, sc, split=None, **kw):
        eng = engine(trace, **kw)
        parts = [sc] if split is None else [sc[:split], sc[split:]]
        outs = [eng.run_trace(part) for part in parts]
        sync()
        owners = torch.cat([o for o, _ in outs])
        counts = torch.cat([c for _, c in outs])
        return (owners, counts, *eng.state, *eng.net), eng

    n_small = 0
    for label, trace, extra in small_cases():
        sc = scenario_of(trace, extra)
        delayed = sc.delayed or sc.corrupted or sc.restarted or sc.extended
        kname = "lease_window_delayed" if delayed else "lease_window_sync"
        plain, _ = replay(trace, sc, backend="torch", skip_stable=False)
        if not extra:  # corruption may trip the §4 alarm on purpose
            check(int(plain[1].max()) <= 1, f"{label}: §4 violated in plain")
        for window in (1, 3, 16):
            for skip in (True, False):
                for split in (None, sc.n_ticks // 3):
                    got, _ = replay(trace, sc, split, backend="cuda",
                                    window=window, skip_stable=skip)
                    equal(got, plain,
                          f"{label} window={window} skip={skip} "
                          f"split={split}", kname)
                    n_small += 1
    print(f"phase 2 kernel vs plain: {n_small} small replays bit-exact "
          f"(delayed and sync, A=5 and A=3, windows 1/3/16, skip on/off, "
          f"split, N=1000), {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------------------- 3. full-width renewal deployment (delayed)
    K.reset_launches()  # the main path: phases 3-6
    t_phase = time.perf_counter()
    renew = renewal_trace(FULL_N, RENEW_TICKS)
    sc3 = renew.scenario()
    build3 = time.perf_counter() - t_phase
    eng3 = engine(renew)
    sync()
    t0 = time.perf_counter()
    ow_k, cn_k = eng3.run_trace(sc3)
    sync()
    ms_k = ms_run3 = (time.perf_counter() - t0) * 1e3
    plain3 = engine(renew, backend="torch", skip_stable=False)
    t0 = time.perf_counter()
    ow_p, cn_p = plain3.run_trace(sc3)
    sync()
    ms_p = (time.perf_counter() - t0) * 1e3
    equal((ow_k, cn_k, *eng3.state, *eng3.net),
          (ow_p, cn_p, *plain3.state, *plain3.net),
          "full-width renewal", "lease_window_delayed")
    max_count = int(cn_k.max())
    owned = float((ow_k[WARM:] >= 0).float().mean())
    check(max_count <= 1, f"renewal: §4 violated (max owner count {max_count})")
    check(owned >= 0.95, f"renewal: owned fraction {owned} < 0.95")
    cell_ticks = FULL_N * RENEW_TICKS
    print(f"phase 3 renewal N={FULL_N} T={RENEW_TICKS}: run_trace kernel "
          f"{ms_k:.1f} ms ({cell_ticks / ms_k * 1e3:.3e} cell-ticks/s), "
          f"plain {ms_p:.1f} ms ({cell_ticks / ms_p * 1e3:.3e} cell-ticks/s), "
          f"bit-exact, max owner count {max_count}, owned after tick "
          f"{WARM} {owned:.4f}; scenario build {build3:.1f} s", flush=True)
    del plain3, ow_p, cn_p

    # ----------------------------------------- 4. full-width chaos (delayed)
    t_phase = time.perf_counter()
    chaos = random_trace(
        7, n_ticks=CHAOS_TICKS, n_cells=FULL_N, n_acceptors=A, n_proposers=P,
        lease_ticks=24, max_delay_ticks=4, p_drop=0.05, asymmetric=True,
        drift_eps=0.25, restarts=0.002, renew=0.5, round_ticks=RENEW_ROUND,
    )
    sc4 = chaos.scenario()
    gen4 = time.perf_counter() - t_phase
    eng4 = engine(chaos)
    sync()
    t0 = time.perf_counter()
    ow_k, cn_k = eng4.run_trace(sc4)
    sync()
    ms_k = (time.perf_counter() - t0) * 1e3
    plain4 = engine(chaos, backend="torch", skip_stable=False)
    ow_p, cn_p = plain4.run_trace(sc4)
    sync()
    equal((ow_k, cn_k, *eng4.state, *eng4.net),
          (ow_p, cn_p, *plain4.state, *plain4.net),
          "full-width chaos", "lease_window_delayed")
    max_count = int(cn_k.max())
    check(max_count <= 1, f"chaos: §4 violated (max owner count {max_count})")
    print(f"phase 4 chaos N={FULL_N} T={CHAOS_TICKS}: run_trace kernel "
          f"{ms_k:.1f} ms, bit-exact vs plain, max owner count {max_count}, "
          f"owned {float((ow_k >= 0).float().mean()):.4f}; trace "
          f"generation {gen4:.1f} s", flush=True)
    del eng4, plain4, ow_k, cn_k, ow_p, cn_p, sc4

    # ------------------------------------------ 5. full-width sync kernel
    t_phase = time.perf_counter()
    zero = random_trace(
        8, n_ticks=SYNC_TICKS, n_cells=FULL_N, n_acceptors=A, n_proposers=P,
        lease_ticks=24,
    )
    sc5 = zero.scenario()
    gen5 = time.perf_counter() - t_phase
    eng5 = engine(zero)
    sync()
    t0 = time.perf_counter()
    ow_k, cn_k = eng5.run_trace(sc5)
    sync()
    ms_k = (time.perf_counter() - t0) * 1e3
    check(not eng5._netplane_active, "sync scenario ran the delayed model")
    plain5 = engine(zero, backend="torch")
    ow_p, cn_p = plain5.run_trace(sc5)
    sync()
    equal((ow_k, cn_k, *eng5.state), (ow_p, cn_p, *plain5.state),
          "full-width sync", "lease_window_sync")
    check(int(cn_k.max()) <= 1, "sync: §4 violated")
    print(f"phase 5 sync N={FULL_N} T={SYNC_TICKS}: run_trace kernel "
          f"{ms_k:.1f} ms, bit-exact vs plain, max owner count "
          f"{int(cn_k.max())}, owned {float((ow_k >= 0).float().mean()):.4f}; "
          f"trace generation {gen5:.1f} s", flush=True)
    del eng5, plain5, ow_k, cn_k, ow_p, cn_p

    # --------------------------------------------------------- 6. step
    t_phase = time.perf_counter()
    sc6 = renewal_trace(FULL_N, STEP_TICKS, t_first=RENEW_TICKS).scenario()
    twin = engine_from_reference(
        engine_to_arrays(eng3), lease_ticks=RENEW_LEASE,
        round_ticks=RENEW_ROUND,
    )
    rows, counts = [], []
    for tau in range(STEP_TICKS):
        rows.append(eng3.step(sc6[tau]))
        counts.append(eng3.last_owner_count)
    ow_t, cn_t = twin.run_trace(sc6)
    sync()
    equal((torch.stack(rows), torch.stack(counts), *eng3.state, *eng3.net),
          (ow_t, cn_t, *twin.state, *twin.net),
          "32 steps vs one run_trace", "lease_window_delayed")
    print(f"phase 6 step: {STEP_TICKS} engine.step calls equal one run_trace "
          f"at N={FULL_N}, {time.perf_counter() - t_phase:.1f} s", flush=True)
    launches = {
        "lease_window_delayed": K.lease_window_delayed.launches,
        "lease_window_sync": K.lease_window_sync.launches,
    }
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the main path")
    del twin, eng3

    # ------------------------------------------------- 7. kernel timing
    # delayed kernel at the phase-3 shapes, from a fresh engine's state
    st = init_state(FULL_N, A, P, device=dev)
    packed = pack_state(st)
    net = init_netplane(FULL_N, A, device=dev)
    pl = sc3.planes
    att = _as_i32(pl["attempts"], dev)
    rel = _as_i32(pl["releases"], dev)
    ext = _as_i32(pl["extends"], dev)
    up = _as_i32(pl["acc_up"], dev)
    link = pack_link(_as_i32(pl["delay"], dev), _as_i32(pl["drop"], dev))
    pclk, aclk = _local_clock_planes(0, RENEW_TICKS, None, {}, P, A, dev)
    kw = dict(majority=A // 2 + 1, lease_q4=4 * RENEW_LEASE + 1,
              round_q4=4 * RENEW_ROUND, n_proposers=P, extends=ext)
    args = (packed, net, 0, att, rel, up, pclk, aclk, link)
    ticked = torch.zeros(1, dtype=torch.int64, device=dev)
    K.lease_window_delayed(*args, ticked=ticked, **kw)
    sync()
    ticked_cells = int(ticked)
    ms_d = time_ms(lambda: K.lease_window_delayed(*args, **kw), 5)
    ms_d_noskip = time_ms(
        lambda: K.lease_window_delayed(*args, skip_stable=False, **kw), 3)
    t0 = time.perf_counter()
    K.lease_window_delayed_torch(*args, **kw)
    sync()
    plain_d = (time.perf_counter() - t0) * 1e3
    state_words = 2 * (8 * A + 8) * FULL_N          # state in + out
    stream_words = RENEW_TICKS * FULL_N * (3 + 2)   # att/rel/ext in, owners/counts out
    bcast_words = RENEW_TICKS * (2 * A + P + P * A)
    bytes_d = 4 * (state_words + stream_words + bcast_words)
    # the renewal launch is the extend-only variant <A, EXT, !CORRUPT, !RESTART>
    tick_d = kernel_tick_ops(_build.library_path(A),
                             f"delayed_window_kernelILi{A}ELb1ELb0ELb0E")
    ops_ms_d = ops_ms(ticked_cells, tick_d)
    bound_d = max(bytes_d / HBM_BYTES_PER_S * 1e3, ops_ms_d)
    by_d = "operations" if ops_ms_d > bytes_d / HBM_BYTES_PER_S * 1e3 else "bytes"
    del att, rel, ext, args, packed, net, st

    # sync kernel at the phase-5 shapes
    st = init_state(FULL_N, A, P, device=dev)
    packed = pack_state(st)
    pl = sc5.planes
    att = _as_i32(pl["attempts"], dev)
    rel = _as_i32(pl["releases"], dev)
    up = _as_i32(pl["acc_up"], dev)
    pclk, aclk = _local_clock_planes(0, SYNC_TICKS, None, {}, P, A, dev)
    kw = dict(majority=A // 2 + 1, lease_q4=4 * 24 + 1, n_proposers=P)
    args = (packed, 0, att, rel, up, pclk, aclk)
    ms_s = time_ms(lambda: K.lease_window_sync(*args, **kw), 5)
    t0 = time.perf_counter()
    K.lease_window_sync_torch(*args, **kw)
    sync()
    plain_s = (time.perf_counter() - t0) * 1e3
    bytes_s = 4 * (2 * (2 * A + 2) * FULL_N + SYNC_TICKS * FULL_N * 4
                   + SYNC_TICKS * (2 * A + P))
    tick_s = kernel_tick_ops(_build.library_path(A), f"sync_window_kernelILi{A}E")
    ops_ms_s = ops_ms(SYNC_TICKS * FULL_N, tick_s)
    bound_s = max(bytes_s / HBM_BYTES_PER_S * 1e3, ops_ms_s)
    by_s = "operations" if ops_ms_s > bytes_s / HBM_BYTES_PER_S * 1e3 else "bytes"
    spent, ms_run = run_trace_breakdown(lambda: engine(renew).run_trace(sc3))
    print(f"phase 7 where one renewal run_trace's {ms_run:.1f} ms go "
          f"(phase 3 took {ms_run3:.1f} ms): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in spent.items())
          + f", the rest {ms_run - sum(spent.values()):.1f} ms (mask scans "
          f"of the numpy planes, clock planes, packing)", flush=True)
    print(f"phase 7 timing: delayed {ms_d:.3f} ms (skip off "
          f"{ms_d_noskip:.3f} ms; {ticked_cells} of "
          f"{FULL_N * RENEW_TICKS} cell-ticks ran the tick math), sync "
          f"{ms_s:.3f} ms; no single PyTorch call computes a lease tick, so "
          f"there is no library yardstick (library_ms null)", flush=True)
    print(f"phase 7 bounds: arithmetic SASS instructions per tick on the "
          f"shortest path through the tick loop, delayed {tick_d}, sync "
          f"{tick_s}; delayed ops {ops_ms_d:.3f} ms / bytes "
          f"{bytes_d / HBM_BYTES_PER_S * 1e3:.3f} ms, sync ops "
          f"{ops_ms_s:.3f} ms / bytes {bytes_s / HBM_BYTES_PER_S * 1e3:.3f} ms",
          flush=True)
    source = "src/repro_torch/lease_array/csrc/lease_window.cu"
    kernels = [
        dict(name="lease_window_delayed", route="cuda", source=source,
             replaces="src/repro/lease_array/kernel.py:536",
             launches=launches["lease_window_delayed"],
             max_abs_err=max_err["lease_window_delayed"], ms=ms_d,
             plain_ms=plain_d, bound_ms=bound_d, bound_by=by_d,
             library_ms=None),
        dict(name="lease_window_sync", route="cuda", source=source,
             replaces="src/repro/lease_array/kernel.py:447",
             launches=launches["lease_window_sync"],
             max_abs_err=max_err["lease_window_sync"], ms=ms_s,
             plain_ms=plain_s, bound_ms=bound_s, bound_by=by_s,
             library_ms=None),
    ]
    del att, rel, up, args, packed, st
    torch.cuda.empty_cache()
    kernels.append(lm_slice(dev))
    torch.cuda.empty_cache()  # the internlm weights are gone; rwkv6-3b's take 12.4 GB
    kernels.append(rwkv_slice(dev))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
