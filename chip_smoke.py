#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on an NVIDIA card and check it: the
lease plane (phases 1-7), internlm2-1.8b prefill and serving through the
flash-attention kernels (phases 8-12), rwkv6-3b prefill and serving
through the WKV6 kernels (phases 13-17), the differential referee against
the lease kernels (phase 18), the scenario sweep through the batched
lease kernels (phase 19), the §4 falsifier (phase 20), the shard
directory (phase 21), the cluster services (phase 22), the port's
leaselint (phase 23), the MoE and hybrid families through the
flash-attention kernels (phases 24-32: mixtral-8x22b at full width, its
depth cut to 4 of 56 layers, and hymba-1.5b whole), and the
encoder-decoder and vision-frontend families through them (phases 33-41:
whisper-large-v3 and internvl2-2b whole), training (phases 42-45: the
flash backward kernel, internlm2-1.8b trained whole through the flash
kernels forward and backward, an fp32 step, a checkpoint), rwkv6
training (phases 46-49: the WKV6 backward kernel, rwkv6-3b trained whole
through the WKV6 kernels forward and backward, an fp32 step) and the
static pack-budget gate in front of the lease kernels (phase 50).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``); it exits nonzero
without them, and on any failed check.

Phases (one line each):
  1. build the lease kernels from ``src/repro_torch/lease_array/csrc``, the
     flash-attention kernels (forward and backward) from
     ``src/repro_torch/kernels/flash_attention/csrc`` and the WKV6 kernels
     from ``src/repro_torch/kernels/rwkv6/csrc`` and an empty kernel (phase
     19's launch floor), all nvcc runs at once; check from ``cuobjdump
     -sass`` that every fp32 flash entry, forward and backward passes,
     holds HMMA (of the TF32 form only) and LDGSTS and no HGMMA or UTMALDG,
     that the bf16 backward's passes hold HGMMA (wgmma) and UTMALDG (TMA)
     and no HMMA, that D's holds none of them, that only the bf16 WKV6
     kernel holds HMMA and LDGSTS and only the fp32 one bulk copies
     (UBLKCP), that the WKV6 backward's state and chunk passes hold HMMA
     (of the TF32 form only) and LDGSTS, its sum pass neither, and none of
     its passes UBLKCP, and print each entry's registers, spills and
     dynamic shared memory (the fp32 flash backward passes and every WKV6
     backward pass must spill nothing);
  2. hold both kernels bit-exact against their plain PyTorch versions on
     small traces (delay 0/2/4, asymmetric links, drift, restarts, extends,
     stale/equiv corruption, windows 1/3/16, a ragged cell count, a trace
     split over two dispatches, quiescence skip on and off);
  3. the full-width renewal deployment (N = 2^20 cells, A = 5, P = 8,
     96-tick leases extended every 64 ticks over links of delay 4) through
     ``LeaseArrayEngine.run_trace``: kernel and plain bit-exact, at most
     one owner per cell, >= 95% of cell-ticks owned after the first round;
     and the cost of the static gate ``run_trace`` passes first (the
     interval analysis of the traced tick core): cold (trace and first
     walk), a cache hit, a fresh walk for a new end tick;
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
  8. the flash kernels against their plain version on the reference's
     seven cases plus ragged, windowed and cross-attention lengths, and
     bf16 cases through the wgmma kernel at Dh 64, 112 and 128
     (windowed, ragged, a fully masked first live tile); fp32 within 5e-5;
  9. internlm2-1.8b at full width, random weights from a seed: a 4 x 2048
     fp32 prefill through the 3xTF32 kernel (24 launches) against the same prefill
     with plain attention on the card, last logits to a relative error
     below 2e-4;
 10. 16 greedy ``decode_step`` tokens after that prefill against
     ``forward`` over all 2064 tokens, relative error below 2e-4;
 11. ``ServeEngine`` in bf16: 8 requests on 4 slots, 16 new tokens each;
 12. a 4 x 2048 bf16 prefill through the tensor-core kernel (24 launches)
     against the same prefill with plain attention, last logits to a
     relative error below 5e-2; then, for each flash kernel (bf16 on
     wgmma, fp32 as three TF32 products on mma.sync), its, the plain
     version's and ``scaled_dot_product_attention``'s times at the prefill
     shapes and the bound (the larger of the causal FLOPs over the dtype's
     peak and the bytes over the memory rate; for fp32 the lesser of two
     ways to the same accuracy: the FLOPs on the CUDA cores' fp32 FMAs, or
     three times them at the TF32 tensor-core peak); bf16 prefill and
     decode step times.
 13. the WKV6 kernels (fp32: the CUDA-core kernel; bf16: the tensor-core
     kernel) against their plain chunked form on the reference's five
     cases, ragged lengths from nonzero states (final states compared),
     bf16 at N 32/64/128 and the extreme decay, fp32 at the lengths about
     its 16- and 32-token stages (1 to 95, and 2049) at every N, two calls
     with the state carried, and the decay rates of rwkv6's own
     decay_base init;
 14. rwkv6-3b at full width, random weights from a seed: a 4 x 2048 fp32
     prefill through the CUDA-core kernel (32 launches, all of them
     ``wkv6_fwd_f32``) against the same prefill with the plain chunked
     form on the card, last logits and the emitted state to a relative
     error below 2e-4;
 15. 16 greedy ``decode_step`` tokens from that prefill's state against
     ``forward`` over all 2064 tokens, relative error below 2e-4;
 16. ``ServeEngine`` in bf16: 8 requests on 4 slots, 16 new tokens each;
 17. a 4 x 2048 bf16 prefill through the tensor-core kernel (32 launches of
     ``wkv6_fwd_bf16``, none of ``wkv6_fwd_f32``) against the same prefill
     with the plain chunked form: the emitted wkv state (the kernel's own
     output) to a relative error below 5e-3; the last logits (also below
     5e-2) and the token-shift leaves of the state to the error of the same
     prefill with an fp32-exact WKV (the bf16 model's own spread) plus one
     bf16 step; then, for each WKV6
     kernel, its and the plain form's times at the prefill shapes (bf16
     r/k/v for the tensor-core kernel, their fp32 cast for the CUDA-core
     one) and the bound (the larger of the bytes over the memory rate and
     the chunked matrix form's FLOPs over the dtype's peak; for fp32 also the
     recurrence's own issue floor, 3 fp32 instructions per token, key and
     value column); bf16 prefill and decode step times.
 18. the differential referee on the card: 1000-tick traces of the
     reference's four differential mixes (zero delay; crash, drift, delay
     and drop; drift; renewal chaos), several seeds each, through the
     port's event-driven ``replay_event_sim`` and through
     ``replay_array(backend="cuda")``: owners bit-exact, at most one owner
     per cell and tick;
 19. ``LeaseArrayEngine.sweep`` through the batched kernels: (a) the
     reference bench's sweep (1024 scenarios x 32 cells x 16 ticks, A 3,
     P 4), zero-delay (sync kernel) and with delay <= 2 and drops (delayed
     kernel), both collect modes, bit-exact against the plain batched
     version on the first 64 scenarios (the plain version loops over
     scenarios one at a time); (b) 64 chaos scenarios (phase 4's mix) x
     2^14 cells x 128 ticks at A 5, P 8 in summary mode from a warmed
     engine, equal to 64 separate ``run_trace`` calls from the same state,
     bit-exact against the plain batched version on the first 8, max owner
     count <= 1, the engine unchanged; then each batched kernel's time, launches
     and bound (at the bench sweep three ways: the kernel's own device time
     under the profiler, a call in a CUDA graph, and host-paced calls from
     Python, beside an empty kernel's, the launch floor), and where one
     sweep's host time goes.
 20. the falsifier (``repro_torch.lease_array.falsify``) on its canonical
     cell (4 cells, A 3, P 4, 16 ticks): margins sweeps of 4096 scenarios
     (honest, corrupt, restarts with extends) bit-exact against the same
     sweeps on the CPU; each corpus fixture at its recorded margin; the
     corrupt control (seed 7, pop 128 x 6) finds a violation and the
     shrinker keeps it violating, its probes through the batched kernels,
     both as on the CPU; the honest search at pop 4096 x 8 and the
     reference's 8192 x 128 acceptance run (1,048,576 scenarios) find none
     and concentrate; each run's scenarios/s and generation split, and one
     margins sweep's device busy time under the profiler;
 21. ``LeaseArrayDirectory`` on the bench's failover handoff (1024 shards,
     8 workers, A 5, lease 24, delay <= 2): owners tick for tick equal to
     the CPU's, worker 0's shards re-owned in the recorded 31 ticks, max
     owner count <= 1; ticks/s and a tick's split (policy, step host, the
     kernel's device time).
 22. the cluster services, host only: the master-lease failover of
     ``benchmarks/bench_failover.py`` (MASTER_CELL, 30 seeds; the gaps' n,
     median, p95), the contention of ``benchmarks/bench_contention.py``
     (60 seeds, 3 and 5 proposers: the naive baseline's deadlocks at 10 s,
     PaxosLease's time to its first owner) and ``tests/test_autoscale.py``'s
     join-and-silence run, every monitor clean;
 23. leaselint (``repro_torch.analysis.staticcheck``): ``run_all()``
     clean; every distinct launch plan the lease entries launched in this
     run passes the launch audit; one profiled launch of each of the four
     entries has its plan's grid, block and shared memory; the SASS of
     each lease library holds no floating-point instruction outside the
     integer-division idiom.
 24. both flash kernels at the slice's prefill shapes (mixtral: 1 x 8192,
     48/8 heads of 128, window 4096; hymba: 4 x 2048, 25/5 heads of 64,
     window 1024) against plain (5e-5 fp32, 2.5e-2 bf16), timed beside
     the plain version, ``scaled_dot_product_attention`` with the
     window as a mask and the model's wrapper ``ops.flash_attention``
     (its (B, S, H, Dh) transposes included), with their bounds;
 25. mixtral-8x22b at its published widths, 4 of 56 layers, random fp32
     weights from a seed (41.7 GB): a 1 x 8192 fp32 prefill through the
     3xTF32 kernel (4 launches) against the same prefill with plain
     attention (blocked by query rows: the full score matrix does not fit
     beside the weights), last logits and the emitted cache below 2e-4,
     each layer's share of tokens routed alike printed;
 26. 16 greedy fp32 ``decode_step`` tokens after a prefill against
     ``forward`` over all 8208 tokens, below 2e-4, at capacity factor
     E / k (nothing drops; decode never drops, forward may);
 27. ``ServeEngine`` in bf16: 8 requests on 4 slots, 16 new tokens each;
 28. the bf16 prefill through the wgmma kernel (4 launches) against plain,
     last logits below 5e-2, routes compared by layer; prefill and decode
     step times and idle shares; one ``moe_dispatch``'s device time at
     the prefill's shapes;
 29-32. the same for hymba-1.5b whole (32 layers), prefill 4 x 2048 (32
     launches a prefill), the SSM state in the cache checked with K/V;
     serving also checks that each request's tokens equal those it gets
     served alone; one ``ssm_scan``'s device time at the prefill's shapes.
 33. both flash kernels at whisper's prefill shapes (8 x 20 heads of 64:
     the encoder's non-causal 1500 x 1500, the cross-attention's 448 x
     1500, the decoder's causal 448) against plain, timed as in phase 24;
 34-37. whisper-large-v3 whole (32 encoder and 32 decoder layers, random
     fp32 weights from a seed, random frame embeddings: the conv frontend
     is a stub, as in the reference): an 8-clip prefill of 1500 frames and
     448 tokens through the kernels (96 launches: encoder, self- and
     cross-attention) against plain, last logits and the emitted cache
     (k, v, ck, cv) below 2e-4; 16 greedy decode steps after a 432-token
     prefill against ``forward`` over 448, below 2e-4; ``ServeEngine``
     refuses it (as the reference's); the bf16 prefill against plain below
     5e-2, timed, the encoder's share, the decode step's time and idle
     share;
 38-41. the same as 25-28 for internvl2-2b whole (24 layers), 4 x (256
     random patch embeddings + 1792 text tokens), served on text prompts.
 42. the flash backward kernels (D, then dK/dV and dQ: bf16 on wgmma in
     ``csrc/flash_attention_bwd_wgmma.cu``, fp32 and D in
     ``csrc/flash_attention_bwd.cu``) and the forward kernels' row
     log-sum-exp against ``attention_bwd_ref`` and ``attention_lse_ref`` at
     internlm2's train shape, mixtral's, hymba's, whisper's two non-causal
     ones and ragged cases, bf16 and fp32 (fp32 below 1e-4 per gradient;
     bf16 at most twice the bf16 plain run's error against the fp32 plain
     run plus 1e-3), two runs bit-identical;
 43. the backward kernel's time at the train shape beside its bound (10 Dh
     FLOP a live pair), the plain version and scaled_dot_product_attention's
     backward; the forward kernels with and without the LSE, in turns;
 44. internlm2-1.8b whole (bf16 compute, fp32 master weights, remat
     "dots"), train_4k's 4096 tokens, the global batch cut to 8 in 4
     microbatches of 2: step 1's gradients through the kernels against a
     plain-attention run on the same batch (per leaf below 5e-2, the loss
     within 1e-2), then ``Trainer`` for 4 steps (every loss finite, every
     parameter moved), step time, tokens/s, peak memory and a profiled
     step's idle share;
 45. an fp32 step at full width and 4 layers through the kernels against
     plain (per leaf below 1e-4), its state checkpointed, restored and
     compared leaf by leaf.
 46. the WKV6 backward kernel (``csrc/wkv6_bwd.cu``: passes state, chunk,
     sum) against ``wkv6_bwd_ref`` in fp32 and bf16 r/k/v at the reference's
     five cases, ragged lengths at every head size (63, 65 and 129 about
     the 64-token chunk at N 64 and 128), states, decays down to
     -33 and the training microbatch (per gradient below 1e-4; bf16's dr,
     dk, dv twice their bf16 rounding), two runs bit-identical, and a
     planted fault (the plain backward with dlogw's sum a token off) caught;
 47. its time at the training microbatch (40 heads of 64, S 4096), each
     pass and in total, beside its bound and the plain version (autograd of
     the chunked form's backward);
 48. rwkv6-3b whole (bf16 compute, fp32 master weights, remat "dots"),
     train_4k's 4096 tokens, the global batch cut to 8 in 8 microbatches of
     1: each WKV6 forward kernel at the training microbatch against a
     float64 witness (the chunked form in float64; below phase 13's
     tolerance), then step 1's gradients on its first microbatch through
     the kernels against the same witness under autograd (the loss within
     1e-2; per leaf below 5e-2 or twice the floor, whichever is larger: the
     floor is a plain-WKV run's distance from the witness), then
     ``Trainer`` for 4
     steps (every loss finite, every parameter moved, the forward kernel
     launched twice a layer and microbatch, each backward pass once, no
     fp32 entry), step time, tokens/s, peak memory and a profiled step's
     idle share;
 49. fp32 at full width and 4 layers: the gradients as in 48 (the loss
     within 1e-5, per leaf below 1e-4 or twice the floor), then a train
     step;
 50. the static pack-budget gate: the interval analysis's derived bounds
     beside ``state.max_pack_tick`` (P 8, rates 4 and 9, 0/1/3 restarts)
     and each traced core's trace and walk times; then on the card a
     restart-mode replay ending at the bound (P 8, 3-tick leases, proposer
     7 restarted three times and attempting at the last tick, 2^16 cells,
     1022 ticks) through the delayed kernel, bit-exact against plain, its
     top ballot ((1022 << 2) | 3) * 8 + 7; a replay one tick longer and a
     100-tick replay at a round horizon that overflows int32 (which the
     hand check cannot see) refused before any allocation on the card or
     launch; that horizon at 3 ticks bit-exact against plain.
The line before the last holds every kernel's launches on its main path
(phases 3-6, the phase-21 directory ticks and the phase-50 replays for the
unbatched delayed kernel; the phase-12, 28, 32, 37 and 41 bf16 prefills for the wgmma
flash kernel, the phase-9, 25, 29, 34 and 38 prefills and phase-11
serving for the fp32 3xTF32 one; the phase-17 bf16
prefill for the tensor-core WKV6 kernel, the phase-14 prefill and
phase-16 serving for the CUDA-core one; the phase-19 sweeps and the
phase-20 shrinker probes for the batched lease kernels; the phase-44 and
45 training steps for the backward kernel's bf16 and fp32 entries, whose
forward launches join the forward rows; the phase-48 and 49 training
steps for the WKV6 backward's bf16 and fp32 passes, whose forward launches
join the WKV6 forward rows), time, plain time, bound and library time as
JSON;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import heapq
import json
import math
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


def library_sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    import shutil

    from repro_torch._nvcc import nvcc_path

    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name("cuobjdump"))
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def kernel_tick_ops(lib: Path, kernel: str) -> dict:
    """tick_loop_ops of the one kernel in ``lib`` whose mangled name holds
    ``kernel`` (e.g. ``sync_window_kernelILi5EE``), read with cuobjdump."""
    sass = library_sass(lib)
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
    if "delayed" in entry:
        return "delayed"
    return "sync-batched" if "sync_batched" in entry else "sync"


def flash_kind(entry: str) -> str:
    """'fp32-3xtf32/Dh128' (the forward's mma.sync kernel, per head width),
    'bf16-wgmma/Dh<=128' (the forward's wgmma kernel, per padded width),
    'bwd-wgmma-dkdv/Dh<=128' and the like (the bf16 backward's passes, per
    padded width), 'bwd-f32-dq/Dh128' and the like (the fp32 backward's, per
    head width) or 'bwd-pre' for the instantiation named in a ptxas entry
    line or a SASS function name."""
    if m := re.search(r"flash_wgmma_kernelILi(\d+)E", entry):
        return f"bf16-wgmma/Dh<={m[1]}"
    if m := re.search(r"flash_fwd_kernelILi(\d+)E", entry):
        return f"fp32-3xtf32/Dh{m[1]}"
    if m := re.search(r"bwd_(dkdv|dq)_wgmma_kernelILi(\d+)E", entry):
        return f"bwd-wgmma-{m[1]}/Dh<={m[2]}"
    if m := re.search(r"bwd_(dkdv|dq)_f32_kernelILi(\d+)E", entry):
        return f"bwd-f32-{m[1]}/Dh{m[2]}"
    return "bwd-pre"


def wgmma_smem_bytes(dh_padded: int) -> int:
    """Dynamic shared memory of a tensor-core flash block
    (``Smem<DHP>::BYTES`` of ``csrc/flash_attention_wgmma.cu``): the 128-row
    Q tile and two stages of 128-row K and V tiles, in 64-column panels of
    128 bytes a row, the mbarriers and 1024 bytes of alignment slack."""
    panel, stages = 128 * 128, 2
    return dh_padded // 64 * panel * (1 + 2 * stages) + 8 * (1 + 2 * stages) + 1024


def ptxas_table(log: str, kind_of=lease_kind) -> dict:
    """{kernel family: (most registers, total spill bytes)} from the
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
    return {k: (regs[k], spills.get(k, 0)) for k in sorted(regs)}


def ptxas_summary(log: str, kind_of=lease_kind) -> str:
    """Most registers and total spill bytes per kernel family, as text."""
    return ", ".join(f"{k} {r} registers / {s} B spilled"
                     for k, (r, s) in ptxas_table(log, kind_of).items())


def run_trace_breakdown(run, kernel="lease_window_delayed"):
    """Times one call of ``run`` (a ``run_trace`` or a ``sweep``) and,
    inside it, the scenario checks on the host, the stacking of a sweep's
    scenarios, the copies of planes to the card and the kernel (the entry
    of ``ops`` named ``kernel``), each wrapped with a device
    synchronisation. Returns ({part: ms}, total ms)."""
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
             (Scenario, "stack", "stacking"),
             (ops, "_as_i32", "copies to the card"),
             (ops, kernel, "kernel"))
    # the attributes as the owners hold them (None: inherited), restored after
    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _ in parts]
    for owner, attr, name in parts:
        setattr(owner, attr, timed(name, getattr(owner, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, attr, raw in saved:
            if raw is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, raw)
    return spent, total


T_START = time.perf_counter()


def stamp(after: str) -> None:
    """Prints the run's wall time so far, after the phases named."""
    print(f"{time.perf_counter() - T_START:.1f} s since the start, after {after}", flush=True)


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


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time a call of ``fn`` takes inside a CUDA graph of
    ``launches`` back-to-back calls (CUDA events around ``reps`` replays):
    the host does not pace it, the launch gap between kernels stays in."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * launches)


def kernel_device_ms(fn, match: str, reps: int = 20):
    """Mean duration of the device kernels whose name holds ``match`` over
    ``reps`` calls of ``fn`` under ``torch.profiler`` (the kernel's own
    time, no launch gap), after a warm-up call. A session that records no
    such kernel is run again, three times at most; then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


#: a kernel that does nothing: the launch floor of a stream
EMPTY_KERNEL_SRC = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def build_empty_kernel() -> Path:
    """Build ``EMPTY_KERNEL_SRC`` into ``build/repro_torch/`` with the port's
    nvcc flags (named by a hash of the source)."""
    import hashlib

    from repro_torch._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

    tag = hashlib.sha256(EMPTY_KERNEL_SRC.encode()).hexdigest()[:16]
    src = BUILD_DIR / f"empty_kernel_{tag}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_KERNEL_SRC)
    return compile_library(BUILD_DIR / f"libempty_kernel_{tag}.so", [src], list(NVCC_FLAGS))


def launch_floor() -> dict:
    """The empty kernel's times on the current stream: in a CUDA graph of
    back-to-back launches (``graph_ms``: the least time between two
    launches, which no kernel's launch goes under), under the profiler, and
    host-paced (``time_ms`` around launches from Python)."""
    import ctypes

    import torch

    lib = ctypes.CDLL(str(build_empty_kernel()))
    lib.empty_launch.argtypes = [ctypes.c_void_p]

    def launch():
        check(lib.empty_launch(torch.cuda.current_stream().cuda_stream) == 0,
              "empty kernel launch failed")

    return {"graph": graph_ms(launch, 100), "device": kernel_device_ms(launch, "empty_kernel"),
            "host-paced": time_ms(launch, 100)}


#: the LM slice: internlm2-1.8b at its published widths (configs/archs.py)
LM_ARCH = "internlm2-1.8b"
LM_BATCH, LM_SEQ, LM_DECODE = 4, 2048, 16  # prefill_32k's 32 x 32768, cut to size
#: H100 SXM dense bf16 and TF32 tensor-core peaks and the fp32 peak outside
#: the tensor cores (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 494.7e12
FP32_FLOP_PER_S = 67e12
#: the kernels against their plain version: tests/test_kernels_flash.py's
#: seven cases, then lengths no multiple of the tiles, then bf16 (the
#: tensor-core kernel) at widths 64, 112 and 128, windowed and ragged (the
#: 512-row windowed cases have rows whose first live tile is fully masked)
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
    (2, 300, 300, 16, 8, 128, True, 100, "bfloat16"),
    (1, 512, 512, 16, 8, 128, True, 100, "bfloat16"),
    (1, 1000, 1000, 16, 8, 112, True, None, "bfloat16"),
    (1, 150, 130, 2, 1, 112, True, 40, "bfloat16"),
    (2, 300, 300, 4, 1, 64, True, 96, "bfloat16"),
    (1, 512, 512, 4, 2, 64, True, 100, "bfloat16"),
    (1, 77, 200, 4, 4, 64, False, None, "bfloat16"),
]
FLASH_TOL = {"float32": 5e-5, "bfloat16": 2.5e-2}  # test_kernels_flash.py:42
#: bf16 also within ||got - want||_2 / ||want||_2 of this: a bf16 output
#: rounds by ~2e-3 of itself, which an absolute limit at 2.5e-2 cannot see
#: where outputs are means over 1500 keys (~0.04). The kernel's arithmetic
#: (P rounded to bf16, l from fp32 P) reads 2.0-2.4e-3; the 36 zero keys of
#: a 1500-key row's last 128-key tile counted in its softmax read 1.44e-2
#: (tests/test_torch_flash_kernel.py)
BF16_REL_TOL = 5e-3


def flash_err(dtn: str, got, want, label: str) -> tuple:
    """Holds a flash output against its plain version: max |err| within
    ``FLASH_TOL``, and in bf16 the relative 2-norm within ``BF16_REL_TOL``.
    Returns (max |err|, the relative 2-norm)."""
    d = got.float() - want.float()
    err, rel = float(d.abs().max()), float(d.norm() / want.float().norm().clamp_min(1e-30))
    check(err < FLASH_TOL[dtn], f"{label}: max |err| {err:.3e}")
    check(dtn != "bfloat16" or rel < BF16_REL_TOL,
          f"{label}: ||err|| / ||want|| {rel:.3e} (limit {BF16_REL_TOL})")
    return err, rel


#: runtime calls that put a kernel, a copy or a fill on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_call(fn, warm: bool = True, host_ops: bool = True):
    """One call of ``fn`` under ``torch.profiler``: (wall ms, device busy
    ms, the three device kernels with the most time as (name, events, ms),
    device events, runtime launch calls). Busy is the union of the device
    events' intervals. Late in a long process a session leaves its first
    ~30 device events unrecorded, so each session traces a warm-up call of
    ``fn`` first and keeps only the second call's events (``warm``). A
    session that records no device event is taken again (the check fails
    after four); the two counts are returned for the reader to compare (a
    launch call of zero bytes puts nothing on the device). ``host_ops``
    records the host's operator events beside the device's and the
    runtime's; a training step of ~10^5 launches is traced without them
    and without the warm-up (rwkv6-3b's step took 111 s to profile with
    both, ~20 s of it the two traced steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CUDA] + [ProfilerActivity.CPU] * host_ops
    for _ in range(4):
        with profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1) if warm else None) as prof:
            if warm:
                fn()
                torch.cuda.synchronize()
                prof.step()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            if warm:
                prof.step()
        events = prof.events()
        launches = sum(e.name in LAUNCH_CALLS for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU)
        events = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        if events:
            break
    else:
        check(False, f"four profiler sessions in a row recorded no device event "
              f"({launches} runtime launch calls in the last)")
    busy, end, by_name = 0.0, float("-inf"), {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:3]
    return (wall, busy / 1e3, [(name[:60], n, us / 1e3) for name, (n, us) in top],
            len(events), launches)


def serve_requests(cfg, params, prompts=None):
    """``ServeEngine`` with the defaults of ``launch/serve.py``: 8 requests
    with prompts of 2-11 tokens from seed 0 (or ``prompts``), 16 new tokens
    each, 4 slots, max_len 128. Checks that all are served; returns (engine
    steps, tokens, seconds, the served requests)."""
    import numpy as np
    import torch

    from repro_torch.train.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, slots=4, max_len=128)
    if prompts is None:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))).astype(np.int32)
                   for _ in range(8)]
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new=16))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(done) == len(prompts) and all(len(r.out) == 16 for r in done),
          f"serving completed {len(done)} of {len(prompts)} requests")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out), "token out of range")
    return eng.steps, sum(len(r.out) for r in done), seconds, done


def report_steps(phase: int, params, batch, prefill, decode, cache) -> float:
    """Prints the host time of a prefill_step over ``batch`` and of one
    decode_step after it (from ``cache``, updated in place), then a
    ``torch.profiler`` breakdown of one call of each (bf16). Returns the
    prefill_step's device busy ms."""
    b, s = batch["tokens"].shape
    if "patch_embeds" in batch:  # the patches come first: positions P + S_text
        s += batch["patch_embeds"].shape[1]
    one = batch["tokens"][:, :1]
    calls = (("prefill_step", lambda: prefill(params, batch)),
             ("decode_step", lambda: decode(params, cache, one, s)))
    ms_prefill = host_ms(calls[0][1], 3)
    ms_decode = host_ms(calls[1][1], 5)
    print(f"phase {phase} end to end (bf16): prefill_step {b} x {s} "
          f"{ms_prefill:.1f} ms ({b * s / ms_prefill * 1e3:.0f} tokens/s); "
          f"one decode_step at batch {b}, position {s}: {ms_decode:.2f} ms", flush=True)
    busy = {}
    for name, fn in calls:
        text, busy[name] = profiled(fn)
        print(f"phase {phase} profile of one {name} (bf16): {text}", flush=True)
    return busy["prefill_step"]


def profiled(fn, **kw) -> tuple:
    """(``profile_call(fn, **kw)`` as text: wall, device busy and idle
    shares, the device events beside the runtime's launch calls, the
    kernels with the most device time; the device busy ms)."""
    wall, busy, top, n_events, launches = profile_call(fn, **kw)
    return (f"{wall:.1f} ms wall under the profiler, device busy {busy:.2f} ms "
            f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; {n_events} device events for "
            f"{launches} runtime launch calls; most device time: "
            + ", ".join(f"{name} x{n} {ms:.2f} ms" for name, n, ms in top)), busy


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, the measure of test_decode_equiv.py."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-9))


class PlainAttention:
    """Within this block the model's sequence attention runs ``fn``, by
    default the plain version ``attention_ref``, on the card (the yardstick
    of phases 9, 12 and 25-32), not the kernel."""

    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        from repro_torch.kernels.flash_attention.ref import attention_ref

        fn = self.fn or attention_ref
        self.ops, self.saved = ops, ops.flash_attention_bhsd
        ops.flash_attention_bhsd = (lambda q, k, v, *, causal, window:
                                    fn(q, k, v, causal=causal, window=window))

    def __exit__(self, *exc):
        self.ops.flash_attention_bhsd = self.saved


def continue_cache(cfg, cache, new_len: int):
    """A decode cache of ``new_len`` slots holding a prefill cache's K/V ring
    in its first slots, the rest empty, and its recurrent state (hymba's
    ``ssm``) as it is."""
    from repro_torch.models import init_cache

    out = init_cache(cfg, cache["k"].shape[1], new_len, device=cache["k"].device)
    s = cache["k"].shape[2]
    for name, leaf in cache.items():
        if name in ("k", "v", "slot_pos"):
            out[name][:, :, :s] = leaf
        else:
            out[name].copy_(leaf)
    return out


def lm_slice(dev) -> list:
    """Phases 8-12: the internlm2-1.8b prefill and serve path through the
    flash kernels, at full width. Returns the kernels' JSON entries: the
    wgmma kernel (bf16; its main path the phase-12 bf16 prefill) and the
    3xTF32 mma.sync kernel (fp32; the phase-9 prefill and phase-11
    serving)."""
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
    f32, bf16 = FK.KERNELS[torch.float32], FK.KERNELS[torch.bfloat16]

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
        check(got.shape == q.shape and got.dtype == q.dtype, f"flash case {n}: shape/dtype")
        err, _ = flash_err(dtn, got, want, f"flash case {n} {FLASH_CASES[n]}")
        worst[dtn] = max(worst.get(dtn, 0.0), err)
    # outside the contract: rows with no key in reach (Sq >= Sk + window - 1
    # under a causal window). attention_ref averages V over all Sk keys; the
    # kernels over the keys of their block's live tiles, or give 0 where a
    # block has none. Printed, not checked
    sq, sk, w = 300, 127, 32
    rng = np.random.default_rng(99)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 128), np.float32)).to(dev)
               for n in (sq, sk, sk))
    unreached = torch.arange(sq, device=dev) >= sk + w - 1
    no_key = []
    for dtn in ("float32", "bfloat16"):
        qx, kx, vx = (x.to(dt[dtn]) for x in (q, k, v))
        got = FK.flash_attention_bhsd(qx, kx, vx, causal=True, window=w).float()[:, unreached]
        want = attention_ref(qx, kx, vx, causal=True, window=w).float()[:, unreached]
        no_key.append(f"{dtn} {int((got.abs().amax(-1) == 0).sum())} of "
                      f"{got.shape[0] * got.shape[1]} rows exactly 0, max |kernel - plain| "
                      f"{float((got - want).abs().max()):.3e}")
    n_bf16 = sum(c[-1] == "bfloat16" for c in FLASH_CASES)
    print(f"phase 8 flash kernels vs plain: {len(FLASH_CASES)} cases (the reference's "
          f"7, ragged 300/1000, windowed, ragged cross; {n_bf16} bf16 through the "
          f"wgmma kernel at Dh 64/112/128) within 5e-5 fp32 / 2.5e-2 bf16 max |err|, "
          f"bf16 also within {BF16_REL_TOL} relative 2-norm; "
          f"max |err| fp32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    print(f"phase 8 rows with no key in reach (Sq {sq}, Sk {sk}, window {w}, causal; outside "
          f"the contract, not checked): " + "; ".join(no_key), flush=True)

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
    prefill_launches = FK.flash_attention_bhsd.launches_by_kernel[f32]
    check(prefill_launches == FK.flash_attention_bhsd.launches == cfg.n_layers,
          f"prefill launched the fp32 flash kernel {prefill_launches} times, not "
          f"{cfg.n_layers}")
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
    steps, n_tok, serve_s, _ = serve_requests(cfg, params)
    lm_launches = prefill_launches + FK.flash_attention_bhsd.launches_by_kernel[f32]
    check(lm_launches > 0, "the fp32 flash kernel was never launched on the main path")
    print(f"phase 11 serving {LM_ARCH} in {cfg.dtype}: 8 requests / {n_tok} tokens in "
          f"{steps} engine steps, {serve_s:.2f} s ({n_tok / serve_s:.1f} tokens/s; "
          f"admission feeds prompts token by token through decode_step, which "
          f"launches no flash kernel); fp32 flash launches on its main path (the "
          f"phase-9 prefill and this phase): {lm_launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------- 12. bf16 prefill through the tensor-core kernel; timing
    t_phase = time.perf_counter()
    prefill = make_prefill_step(cfg, logits_mode="last")
    batch = {"tokens": toks}
    FK.reset_launches()  # the bf16 kernel's main path: this prefill
    logits_b, cache_b = prefill(params, batch)
    sync()
    bf16_launches = FK.flash_attention_bhsd.launches_by_kernel[bf16]
    check(bf16_launches == FK.flash_attention_bhsd.launches == cfg.n_layers,
          f"bf16 prefill launched the tensor-core kernel {bf16_launches} times, not "
          f"{cfg.n_layers}")
    with PlainAttention():
        logits_bp, _ = prefill(params, batch)
    sync()
    check(bool(torch.isfinite(logits_b).all()), "bf16 prefill logits not finite")
    err12_logits = rel_err(logits_b, logits_bp)
    # bf16 keeps 8 mantissa bits (3.9e-3 a rounding), over 24 layers of a
    # bf16 residual stream: a lost tile or mask shows far above this
    check(err12_logits < 5e-2,
          f"bf16 prefill logits kernel vs plain: rel err {err12_logits:.3e}")
    del logits_bp
    print(f"phase 12 bf16 prefill {LM_BATCH} x {LM_SEQ}: tensor-core flash launches "
          f"{bf16_launches}; last logits vs plain attention rel err {err12_logits:.3e} "
          f"(limit 5e-2)", flush=True)

    bhq, bhkv, dh = LM_BATCH * cfg.n_heads, LM_BATCH * cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn(bhq, LM_SEQ, dh, generator=g, device=dev)
    k = torch.randn(bhkv, LM_SEQ, dh, generator=g, device=dev)
    v = torch.randn(bhkv, LM_SEQ, dh, generator=g, device=dev)
    pairs = bhq * LM_SEQ * (LM_SEQ + 1) // 2  # live causal (q, k) pairs
    flop = 4 * dh * pairs
    # the least time for each dtype's work: bf16 at the bf16 tensor-core
    # peak; fp32 to fp32 accuracy the lesser of the FLOPs on the CUDA cores'
    # fp32 FMAs and three TF32 products (3xTF32) at the TF32 peak
    ways = {"bfloat16": [(flop / BF16_FLOP_PER_S, "989 TFLOP/s bf16 tensor cores")],
            "float32": [(flop / FP32_FLOP_PER_S, "67 TFLOP/s fp32 FMA on the CUDA cores"),
                        (3 * flop / TF32_FLOP_PER_S,
                         "3 x FLOP at 494.7 TFLOP/s dense TF32 tensor cores")]}
    rows = []
    for dtn, entry, launches in (("bfloat16", bf16, bf16_launches),
                                 ("float32", f32, lm_launches)):
        qx, kx, vx = (x.to(dt[dtn]) for x in (q, k, v))
        err, _ = flash_err(dtn, FK.flash_attention_bhsd(qx, kx, vx, causal=True),
                           attention_ref(qx, kx, vx, causal=True),
                           f"{dtn} flash at the prefill shapes")
        q4, k4, v4 = (x.view(LM_BATCH, -1, LM_SEQ, dh) for x in (qx, kx, vx))

        def kernel():
            return FK.flash_attention_bhsd(qx, kx, vx, causal=True)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, enable_gqa=True)

        # in turns, library, kernel, kernel, library: one card, one call
        ms_lib1, ms_k1, ms_k2, ms_lib2 = (time_ms(f, 10) for f in (library, kernel, kernel,
                                                                     library))
        ms_k, ms_lib = (ms_k1 + ms_k2) / 2, (ms_lib1 + ms_lib2) / 2
        ms_plain = time_ms(lambda: attention_ref(qx, kx, vx, causal=True), 3)
        ops_s, peak_name = min(ways[dtn])
        ops_ms = ops_s * 1e3
        bytes_ms = (2 * q.numel() + k.numel() + v.numel()) * qx.element_size() / HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, bytes_ms)
        others = "".join(f"; not taken: {s * 1e3:.4f} ms at {name}"
                         for s, name in ways[dtn] if name != peak_name)
        route = {"bfloat16": "wgmma", "float32": "3xTF32 on mma.sync"}[dtn]
        print(f"phase 12 timing ({dtn}, {entry}, {route}, BHq {bhq}, BHkv {bhkv}, S {LM_SEQ}, "
              f"Dh {dh}, "
              f"causal): flash kernel {ms_k:.4f} ms ({ms_k1:.4f} / {ms_k2:.4f}; "
              f"{flop / ms_k / 1e9:.1f} TFLOP/s), plain {ms_plain:.3f} ms, "
              f"scaled_dot_product_attention {ms_lib:.4f} ms ({ms_lib1:.4f} / {ms_lib2:.4f}; "
              f"kernel / library {ms_k / ms_lib:.2f}); bound {bound:.4f} ms (operations "
              f"{ops_ms:.4f} ms at {peak_name}, bytes {bytes_ms:.4f} ms at 3.35 TB/s"
              f"{others}); "
              f"max |err| vs plain {err:.3e}", flush=True)
        rows.append(dict(
            name="flash_attention_bhsd" if dtn == "bfloat16" else "flash_attention_bhsd_fp32",
            route="cuda", source=f"src/repro_torch/kernels/flash_attention/csrc/"
            f"{'flash_attention_wgmma.cu' if dtn == 'bfloat16' else 'flash_attention.cu'}",
            replaces="src/repro/kernels/flash_attention/kernel.py:124",
            launches=launches, max_abs_err=max(worst[dtn], err), ms=ms_k, plain_ms=ms_plain,
            bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=ms_lib))
        del qx, kx, vx, q4, k4, v4
    cache_b = continue_cache(cfg, cache_b, LM_SEQ + LM_DECODE)
    report_steps(12, params, batch, prefill, make_decode_step(cfg), cache_b)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows


#: the rwkv slice: rwkv6-3b at its published widths (configs/archs.py), at the
#: LM slice's prefill size
RWKV_ARCH = "rwkv6-3b"
#: the WKV6 kernels against their plain version: tests/test_kernels_rwkv6.py's
#: five cases, then ragged lengths from nonzero states and the reduced
#: configs' head size (b, s, h, n, omega_hi, dtype, initial state); omega_hi
#: 3.5 is the extreme decay (logw down to -33 a token)
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
#: bf16 through the tensor-core kernel at N 32, 64 and 128, ragged, with and
#: without a state, at the extreme decay
WKV_BF16_CASES = [
    (1, 1000, 4, 32, 0.5, "bfloat16", True),
    (2, 777, 4, 64, 3.5, "bfloat16", True),
    (1, 130, 4, 64, 0.5, "bfloat16", False),
    (1, 500, 4, 128, 0.5, "bfloat16", False),
    (1, 301, 4, 128, 3.5, "bfloat16", True),
    (2, 65, 4, 32, 3.5, "bfloat16", False),
]
#: fp32 through the CUDA-core kernel at the ragged lengths of its 16- and
#: 32-token stages, every head size, from a state; N 64 at the extreme decay
WKV_F32_RING_CASES = [(1, s, 3, n, 3.5 if n == 64 else 0.5, "float32", True)
                      for s, n in ((1, 16), (31, 32), (33, 64), (95, 128), (2049, 64))]
WKV_TOL = {"float32": 5e-4, "bfloat16": 3e-2}  # test_kernels_rwkv6.py:45-47
#: phase 17: the bf16 prefill's wkv state (the kernel's fp32 output) against
#: plain, and one bf16 step relative to the largest value, at most
WKV_STATE_TOL, BF16_STEP = 5e-3, 2.0 ** -7
WKV_CHUNK = 32  # the Pallas kernel's chunk, for the matrix form's operation count


def wkv_kind(entry: str) -> str:
    """'fp32/N64' (the CUDA-core forward kernel), 'bf16-mma/N64' (the
    tensor-core one) or 'bwd-chunk-bf16/N64' and the like (the backward's
    passes state, chunk and sum by dtype) for the instantiation named in a
    ptxas entry line or a SASS function name."""
    if m := re.search(r"wkv6_bwd_(state|chunk|sum)_kernelILi(\d+)E(13__nv_bfloat16|f)", entry):
        return f"bwd-{m[1]}-{'fp32' if m[3] == 'f' else 'bf16'}/N{m[2]}"
    m = re.search(r"wkv6_(mma_)?kernelILi(\d+)E", entry)
    return f"{'bf16-mma' if m[1] else 'fp32'}/N{m[2]}"


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


class SwapWKV:
    """Within this block the model's WKV6 recurrence runs ``fn`` in place of
    the kernel wrapper: by default the plain chunked form on the card (the
    yardstick of phases 14 and 17, beside the witness of 48 and 49;
    autograd differentiates it)."""

    def __init__(self, fn=None):
        self.fn = fn

    def __enter__(self):
        from repro_torch.kernels.rwkv6 import ops
        from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

        self.ops, self.saved = ops, ops.wkv6_bhsn
        ops.wkv6_bhsn = self.fn or wkv_chunked_bhsn

    def __exit__(self, *exc):
        self.ops.wkv6_bhsn = self.saved


def rwkv_slice(dev) -> list:
    """Phases 13-17: the rwkv6-3b prefill and serve path through the WKV6
    kernels, at full width. Returns the kernels' JSON entries: the
    tensor-core kernel (bf16; its main path the phase-17 bf16 prefill) and
    the CUDA-core kernel (fp32; the phase-14 prefill and phase-16 serving)."""
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
    f32, bf16 = WK.KERNELS[torch.float32], WK.KERNELS[torch.bfloat16]
    max_err = {"float32": 0.0, "bfloat16": 0.0}

    def against_plain(args, tol, what):
        """The kernel and the plain chunked form on the same inputs:
        outputs and final states to ``tol`` relative; returns (max |err|,
        worst rel err)."""
        out, st = WK.wkv6_bhsn(*args)
        sync()
        want, want_st = wkv_chunked_bhsn(*args)
        check(out.shape == args[0].shape and out.dtype == torch.float32, f"{what}: shape/dtype")
        check(bool(torch.isfinite(out).all() and torch.isfinite(st).all()), f"{what}: not finite")
        err, err_st = rel_err(out, want), rel_err(st, want_st)
        check(err < tol and err_st < tol,
              f"{what}: rel err {err:.3e}, state {err_st:.3e} (tolerance {tol})")
        return float((out - want).abs().max()), max(err, err_st)

    # ------------------------------------------ 13. WKV6 kernels vs plain
    t_phase = time.perf_counter()
    worst = {}
    for i, case in enumerate(WKV_CASES + WKV_BF16_CASES + WKV_F32_RING_CASES):
        args = wkv_inputs(dev, *case, seed=130 + i)
        before = dict(WK.wkv6_bhsn.launches_by_kernel)
        abs_err, rel = against_plain(args, WKV_TOL[case[5]], f"wkv case {i} {case}")
        entry = WK.KERNELS[args[0].dtype]
        check(WK.wkv6_bhsn.launches_by_kernel[entry] == before[entry] + 1,
              f"wkv case {i}: {entry} not launched")
        worst[case[5]] = max(worst.get(case[5], 0.0), rel)
        max_err[case[5]] = max(max_err[case[5]], abs_err)
    r, k, v, logw, u, _ = wkv_inputs(dev, 1, 128, 2, 64, 0.5, "float32", False, seed=139)
    full, full_st = WK.wkv6_bhsn(r, k, v, logw, u)
    o1, st = WK.wkv6_bhsn(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u)
    o2, st = WK.wkv6_bhsn(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, st)
    err_carry = max(rel_err(torch.cat([o1, o2], 1), full), rel_err(st, full_st))
    check(err_carry < WKV_TOL["float32"], f"wkv 128 vs 2 x 64 carried: rel err {err_carry:.3e}")
    r, k, v = (x.bfloat16() for x in (r, k, v))
    want, want_st = wkv_chunked_bhsn(r, k, v, logw, u)
    o1, st = WK.wkv6_bhsn(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u)
    o2, st = WK.wkv6_bhsn(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, st)
    err_carry_bf16 = max(rel_err(torch.cat([o1, o2], 1), want), rel_err(st, want_st))
    check(err_carry_bf16 < WKV_TOL["bfloat16"],
          f"bf16 wkv 2 x 64 carried vs plain: rel err {err_carry_bf16:.3e}")
    b, s, h, n = 2, 512, 4, 64
    err_spread = {}
    for dtn in ("float32", "bfloat16"):
        spread = wkv_inputs(dev, b, s, h, n, None, dtn, True, seed=140,
                            omega=decay_base_omega(b, s, h, n, 141))
        abs_err, err_spread[dtn] = against_plain(spread, WKV_TOL[dtn],
                                                 f"wkv decay_base spread {dtn}")
        max_err[dtn] = max(max_err[dtn], abs_err)
    print(f"phase 13 WKV6 kernels vs plain: {len(WKV_CASES)} cases (the reference's 5, "
          f"ragged 77/1000/45 from nonzero states, N 16/32/64/128), "
          f"{len(WKV_BF16_CASES)} bf16 (N 32/64/128, ragged, extreme decay) and "
          f"{len(WKV_F32_RING_CASES)} fp32 at the stages' ragged lengths 1/31/33/95/2049 "
          f"(N 16/32/128/64, extreme decay at N 64) within 5e-4 "
          f"fp32 ({f32}) / 3e-2 bf16 ({bf16}), outputs and final states; worst rel err "
          f"fp32 {worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}; 128 tokens vs 2 x 64 "
          f"carried fp32 {err_carry:.3e}, bf16 {err_carry_bf16:.3e}; decay_base spread "
          f"fp32 {err_spread['float32']:.3e}, bf16 {err_spread['bfloat16']:.3e}; "
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
    WK.reset_launches()  # the fp32 kernel's main path: the prefill here and serving (16)
    sync()
    t0 = time.perf_counter()
    logits_k, cache_k = prefill32(params, {"tokens": toks})
    sync()
    ms_prefill32 = (time.perf_counter() - t0) * 1e3
    prefill_launches = WK.wkv6_bhsn.launches_by_kernel[f32]
    check(prefill_launches == WK.wkv6_bhsn.launches == cfg.n_layers,
          f"fp32 prefill launched {f32} {prefill_launches} times (all WKV6 kernels "
          f"{WK.wkv6_bhsn.launches}), not {cfg.n_layers}")
    with SwapWKV():
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
    all_launches = WK.wkv6_bhsn.launches
    ms_warm32 = host_ms(lambda: prefill32(params, {"tokens": toks}), 2)
    print(f"phase 14 prefill {RWKV_ARCH} ({n_params / 1e9:.3f} B params, fp32) "
          f"{LM_BATCH} x {LM_SEQ}: {ms_prefill32:.1f} ms (warmed: {ms_warm32:.1f} ms), "
          f"{f32} launches {prefill_launches} of {all_launches}; last logits vs the plain chunked "
          f"form rel err {err14:.3e}, emitted state rel err " + ", ".join(
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
    steps, n_tok, serve_s, _ = serve_requests(cfg, params)
    rwkv_launches = prefill_launches + WK.wkv6_bhsn.launches_by_kernel[f32]
    check(rwkv_launches > 0, f"{f32} was never launched on its main path")
    print(f"phase 16 serving {RWKV_ARCH} in {cfg.dtype}: 8 requests / {n_tok} tokens in "
          f"{steps} engine steps, {serve_s:.2f} s ({n_tok / serve_s:.1f} tokens/s; "
          f"admission feeds prompts token by token through decode_step, which "
          f"launches no WKV6 kernel); {f32} launches on its main path (the phase-14 "
          f"prefill and this phase): {rwkv_launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # --------- 17. bf16 prefill through the tensor-core kernel; timing
    t_phase = time.perf_counter()
    prefill = make_prefill_step(cfg, logits_mode="last")
    batch = {"tokens": toks}
    WK.reset_launches()  # the bf16 kernel's main path: this prefill
    logits_b, cache_b = prefill(params, batch)
    sync()
    bf16_launches = WK.wkv6_bhsn.launches_by_kernel[bf16]
    check(bf16_launches == WK.wkv6_bhsn.launches == cfg.n_layers
          and WK.wkv6_bhsn.launches_by_kernel[f32] == 0,
          f"bf16 prefill launched {bf16} {bf16_launches} times and {f32} "
          f"{WK.wkv6_bhsn.launches_by_kernel[f32]} times, not {cfg.n_layers} and 0")
    with SwapWKV():
        logits_bp, cache_bp = prefill(params, batch)
    sync()
    check(WK.wkv6_bhsn.launches == bf16_launches, "plain bf16 prefill launched")
    check(bool(torch.isfinite(logits_b).all()), "bf16 prefill logits not finite")
    err17_logits = rel_err(logits_b, logits_bp)
    err17_state = {name: rel_err(cache_b[name], cache_bp[name]) for name in cache_b}

    # the bf16 model's own spread: the same prefill with a WKV exact to fp32
    # (the CUDA-core kernel on the fp32 cast), against the same plain run
    def exact_wkv(r, k, v, logw, u, state=None):
        return WK.wkv6_bhsn(r.float(), k.float(), v.float(), logw, u, state)

    with SwapWKV(exact_wkv):
        logits_bx, cache_bx = prefill(params, batch)
    sync()
    floor_logits = rel_err(logits_bx, logits_bp)
    floor_state = {name: rel_err(cache_bx[name], cache_bp[name]) for name in cache_bx}
    del logits_bp, cache_bp, logits_bx, cache_bx
    # The wkv leaf, the kernel's own fp32 output, is held tightly. The logits
    # and the token-shift leaves (bf16 activations after 32 layers) lie a few
    # bf16 steps from plain whatever WKV runs: each is held to the exact
    # run's error plus one bf16 step (at most 2^-7 of the largest value), the
    # logits also below 5e-2. A lost block or a wrong decay lands far above.
    beyond = {name: (err, floor) for name, err, floor in
              [("logits", err17_logits, floor_logits)]
              + [(k, err17_state[k], floor_state[k]) for k in err17_state if k != "wkv"]
              if err > floor + BF16_STEP}
    check(err17_logits < 5e-2 and err17_state["wkv"] < WKV_STATE_TOL and not beyond,
          f"bf16 prefill kernel vs plain: logits rel err {err17_logits:.3e}, state "
          f"{err17_state}; beyond the fp32-exact WKV's error plus a bf16 step: {beyond}")
    print(f"phase 17 bf16 prefill {LM_BATCH} x {LM_SEQ}: {bf16} launches {bf16_launches}, "
          f"{f32} 0; last logits vs the plain chunked form rel err {err17_logits:.3e}, "
          "emitted state rel err " + ", ".join(f"{k} {v:.3e}" for k, v in err17_state.items())
          + f"; with an fp32-exact WKV in place of the kernel: logits {floor_logits:.3e}, "
          "state " + ", ".join(f"{k} {v:.3e}" for k, v in floor_state.items())
          + f" (limits: wkv {WKV_STATE_TOL:.0e}; logits and the token-shift leaves the "
          f"exact run's plus {BF16_STEP:.3e}, logits also 5e-2)", flush=True)

    h, n = cfg.d_model // cfg.rwkv.head_size, cfg.rwkv.head_size
    args = wkv_inputs(dev, LM_BATCH, LM_SEQ, h, n, None, "bfloat16", False, seed=17,
                      omega=decay_base_omega(LM_BATCH, LM_SEQ, h, n, 18))
    bh, seq = args[0].shape[:2]
    # the chunked matrix form, per token and head: scores and intra-chunk
    # products 2 x 2·C·N, inter-chunk output and state update 2 x 2·N·N
    flop = bh * seq * 4 * n * (WKV_CHUNK + n)
    # the recurrence token by token (the fp32 kernel): an FFMA for o, an FMUL
    # for k v and an FFMA for S per (token, key, value column)
    rec_ins = 3 * bh * seq * n * n
    rec_ms = rec_ins / (FP32_FLOP_PER_S / 2) * 1e3
    rows = []
    for dtn, entry, peak, peak_name, launches in (
            ("bfloat16", bf16, BF16_FLOP_PER_S, "989 TFLOP/s bf16", bf16_launches),
            ("float32", f32, FP32_FLOP_PER_S, "67 TFLOP/s fp32", rwkv_launches)):
        x = (*(a.to(torch.float32 if dtn == "float32" else torch.bfloat16) for a in args[:3]),
             *args[3:])
        abs_err, err = against_plain(x, WKV_TOL[dtn], f"{dtn} wkv at the prefill shapes")
        max_err[dtn] = max(max_err[dtn], abs_err)
        ms_k1, ms_k2 = (time_ms(lambda: WK.wkv6_bhsn(*x), 10) for _ in range(2))
        ms_k = (ms_k1 + ms_k2) / 2
        ms_plain = time_ms(lambda: wkv_chunked_bhsn(*x), 3)
        # inputs read once (r, k, v in their dtype, logw and u in fp32),
        # outputs written once (out and the final state, fp32); the zero
        # initial state is no input
        n_bytes = (sum(a.numel() * a.element_size() for a in x[:5])
                   + bh * seq * n * 4 + bh * n * n * 4)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flop / peak * 1e3
        bound = max(ops_ms, bytes_ms)
        print(f"phase 17 timing ({dtn} r/k/v, {entry}, BH {bh}, S {seq}, N {n}, decay_base "
              f"spread): WKV6 kernel {ms_k:.4f} ms ({ms_k1:.4f} / {ms_k2:.4f}; "
              f"{n_bytes / ms_k / 1e6:.1f} GB/s), plain chunked form {ms_plain:.3f} ms; no "
              f"single PyTorch call computes WKV6 (library_ms null); bound {bound:.4f} ms "
              f"(bytes {bytes_ms:.4f} ms: {n_bytes / 1e6:.1f} MB at 3.35 TB/s; operations "
              f"{ops_ms:.4f} ms: {flop:.3e} FLOP of the chunked matrix form at {peak_name})"
              + ("" if dtn == "bfloat16" else
                 f"; the recurrence's issue floor {rec_ms:.4f} ms ({rec_ins:.3e} fp32 "
                 f"instructions, 3 per token, key and value column, at the fp32 lanes' "
                 f"{FP32_FLOP_PER_S / 2:.3e} a second, before any shared load)")
              + f"; rel err vs plain {err:.3e}", flush=True)
        rows.append(dict(
            name="wkv6_bhsn" if dtn == "bfloat16" else "wkv6_bhsn_fp32", route="cuda",
            source=f"src/repro_torch/kernels/rwkv6/csrc/"
            f"{'wkv6_mma.cu' if dtn == 'bfloat16' else 'wkv6.cu'}",
            replaces="src/repro/kernels/rwkv6/kernel.py:94",
            launches=launches, max_abs_err=max_err[dtn], ms=ms_k, plain_ms=ms_plain,
            bound_ms=bound, bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            library_ms=None))
        del x
    del args
    report_steps(17, params, batch, prefill, make_decode_step(cfg), cache_b)
    print(f"phase 17 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return rows

#: phase 18: the reference's four differential mixes
#: (tests/test_lease_array_{differential,restart,drift,extend}.py) at their
#: geometries, 1000 ticks each: name -> (seeds, random_trace options)
REFEREE_TICKS = 1000
REFEREE_MIXES = {
    "zero-delay": ((1234, 1, 2), dict(n_cells=16, n_acceptors=5, n_proposers=4,
                                      lease_ticks=3, p_attempt=0.35,
                                      p_release=0.06, p_down_flip=0.02)),
    "crash-drift-delay-drop": ((42, 3, 4), dict(max_delay_ticks=2, p_drop=0.05,
                                                drift_eps=0.25, asymmetric=True,
                                                restarts=0.02)),
    "drift": ((4242, 5, 6), dict(n_cells=8, n_acceptors=5, n_proposers=4,
                                 lease_ticks=8, p_attempt=0.8, p_release=0.06,
                                 p_down_flip=0.03, max_delay_ticks=1,
                                 p_drop=0.08, drift_eps=0.25, round_ticks=3)),
    "renew-chaos": ((1234, 7, 8), dict(n_cells=8, n_acceptors=3, n_proposers=4,
                                       lease_ticks=6, p_attempt=0.12,
                                       p_release=0.04, renew=0.5,
                                       max_delay_ticks=1, p_drop=0.05,
                                       drift_eps=0.25, round_ticks=5)),
}
#: phase 19a: the reference bench's sweep (benchmarks/bench_lease_array.py
#: run_sweep): 1024 scenarios x 32 cells x 16 ticks, A 3, P 4
BENCH_SWEEP = dict(scenarios=1024, n_cells=32, n_ticks=16, n_acceptors=3,
                   n_proposers=4, lease_ticks=3, p_attempt=0.5, p_release=0.05,
                   p_down_flip=0.05)
#: phase 19b: 64 scenarios x 2^14 cells x 128 ticks at DEFAULT_CELL, phase
#: 4's fault mix
CHAOS_SWEEP_B, CHAOS_SWEEP_N = 64, 1 << 14
#: the scenarios of each phase-19 sweep held against the plain batched
#: version, which loops over scenarios one at a time (the whole bench
#: sweep's plain run took 135 s, the chaos sweep's 71 s): the first 64
#: of the bench sweep's 1024 and the first 8 of the chaos sweep's 64
BENCH_PLAIN_B, CHAOS_PLAIN_B = 64, 8


def first_scenarios(args, kw, delayed, b):
    """``batched_kernel_args``' arguments cut to the sweep's first ``b``
    scenarios: the planes' leading axis (the state is shared)."""
    import torch

    lead = 3 if delayed else 2  # (packed, net, t0) or (packed, t0)
    return ((*args[:lead], *(x[:b] for x in args[lead:])),
            {k: x[:b] if isinstance(x, torch.Tensor) else x for k, x in kw.items()})


def bench_sweep_setup(dev, delayed: bool):
    """Phase 19a's inputs: an engine of the bench sweep's geometry and its
    1024 scenarios stacked (zero delay, or delay <= 2 with drops)."""
    from repro_torch.lease_array import LeaseArrayEngine, Scenario, random_trace

    g = {k: v for k, v in BENCH_SWEEP.items() if k != "scenarios"}
    extra = dict(max_delay_ticks=2, p_drop=0.05) if delayed else {}
    traces = [random_trace(s, **g, **extra) for s in range(BENCH_SWEEP["scenarios"])]
    eng = LeaseArrayEngine(BENCH_SWEEP["n_cells"], n_acceptors=3, n_proposers=4,
                           lease_ticks=3, round_ticks=traces[0].round_ticks, device=dev)
    return eng, Scenario.stack([t.scenario() for t in traces])


def batched_kernel_args(eng, stacked, delayed, collect, dev):
    """The batched kernel's and its plain version's arguments for a sweep
    of ``stacked`` from ``eng``, as ``ops`` builds them."""
    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array.netplane import NetPlaneState
    from repro_torch.lease_array.ops import _device_planes, strip_default_planes
    from repro_torch.lease_array.state import PackedLeaseState, pack_state

    d = _device_planes(
        strip_default_planes(stacked.planes), dev, eng._clk0(), eng._rst0(),
        eng.t, n_proposers=eng.n_proposers, n_acceptors=eng.n_acceptors,
        lease_q4=eng.lease_q4, restart_guard=eng.restart_guard,
        sync=not delayed)
    packed = PackedLeaseState(*(x.contiguous() for x in pack_state(eng.state)))
    cols = [d[k] for k in ("attempts", "releases", "acc_up", "pclk", "aclk")]
    kw = dict(majority=eng.majority, lease_q4=eng.lease_q4,
              n_proposers=eng.n_proposers, guard_q4=eng.guard_q4,
              collect=collect)
    if not delayed:
        return (packed, eng.t, *cols), kw
    kw.update(round_q4=eng.round_q4,
              **{k: d.get(k) for k in K.DELAYED_OPTIONAL})
    net = NetPlaneState(*(x.contiguous() for x in eng.net))
    return (packed, net, eng.t, *cols, d["link"]), kw


def referee_phase(dev) -> None:
    """Phase 18: owners of the port's event-driven referee against the
    lease kernels (``replay_array(backend="cuda")``), bit-exact."""
    import torch

    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array import random_trace, replay_array, replay_event_sim

    t_phase = time.perf_counter()
    K.reset_launches()
    n, cell_ticks, sim_s, kernel_s = 0, 0, 0.0, 0.0
    for name, (seeds, opts) in REFEREE_MIXES.items():
        for seed in seeds:
            tr = random_trace(seed, n_ticks=REFEREE_TICKS, **opts)
            t0 = time.perf_counter()
            ow, cn = replay_array(tr, backend="cuda", device=dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref = replay_event_sim(tr)
            sim_s += time.perf_counter() - t1
            kernel_s += t1 - t0
            got = ow.cpu().numpy()
            bad = int((got != ref).sum())
            check(bad == 0, f"referee {name} seed {seed}: {bad} owners differ "
                  f"from the event sim")
            check(int(cn.max()) <= 1, f"referee {name} seed {seed}: §4 violated")
            check((ref >= 0).any() and (ref < 0).any(),
                  f"referee {name} seed {seed}: no ownership or no vacancy")
            n += 1
            cell_ticks += tr.n_ticks * tr.n_cells
    launches = (K.lease_window_delayed.launches, K.lease_window_sync.launches)
    check(min(launches) > 0, f"referee path launches (delayed, sync) {launches}")
    print(f"phase 18 referee: {n} traces of {REFEREE_TICKS} ticks "
          f"({', '.join(REFEREE_MIXES)}; {cell_ticks} cell-ticks), "
          f"replay_array on the card equals replay_event_sim on every owner, "
          f"max owner count <= 1; launches on this path: delayed {launches[0]}, "
          f"sync {launches[1]}; event sim {sim_s:.1f} s, replay_array "
          f"{kernel_s:.1f} s; {time.perf_counter() - t_phase:.1f} s", flush=True)


def sweep_slice(dev) -> list:
    """Phase 19: ``sweep`` through the batched kernels. Returns their JSON
    entries (launches: the phase's sweeps)."""
    import numpy as np
    import torch

    from repro_torch.lease_array import (
        Scenario,
        _build,
        engine_from_reference,
        engine_to_arrays,
    )
    from repro_torch.lease_array import kernel as K

    sync = torch.cuda.synchronize
    max_err = {"lease_window_delayed_batched": 0, "lease_window_sync_batched": 0}

    def equal(a, b, what, kernel):
        for i, (x, y) in enumerate(zip(a, b)):
            err = int((x.long() - y.long()).abs().max()) if x.numel() else 0
            max_err[kernel] = max(max_err[kernel], err)
            check(x.shape == y.shape and err == 0,
                  f"{what}: output {i} differs (max |err| {err})")

    # ------------------------------------ 19a. the bench's sweep geometry
    t_phase = time.perf_counter()
    bench = {delayed: bench_sweep_setup(dev, delayed) for delayed in (False, True)}
    t0 = time.perf_counter()
    eng_c, scs_c, before_c = chaos_sweep_setup(dev)
    setup_c = time.perf_counter() - t0
    K.reset_launches()  # the main path: phase 19's sweeps
    results = {}
    for delayed, (eng, stacked) in bench.items():
        for collect in ("summary", "owners"):
            results[delayed, collect] = eng.sweep(stacked, collect=collect)
    t_main = time.perf_counter()
    res_c = eng_c.sweep(scs_c)
    sync()
    main_s = time.perf_counter() - t_main
    launches = {"lease_window_delayed_batched": K.lease_window_delayed_batched.launches,
                "lease_window_sync_batched": K.lease_window_sync_batched.launches}
    for k, v in launches.items():
        check(v > 0, f"{k} was never launched on the sweep path")
    check(K.lease_window_delayed.launches + K.lease_window_sync.launches == 0,
          "a sweep launched an unbatched kernel")

    plain_ms, times = {}, {}
    for delayed, (eng, stacked) in bench.items():
        kname = ("lease_window_delayed_batched" if delayed
                 else "lease_window_sync_batched")
        kfn = K.lease_window_delayed_batched if delayed else K.lease_window_sync_batched
        pfn = (K.lease_window_delayed_batched_torch if delayed
               else K.lease_window_sync_batched_torch)
        for collect in ("owners", "summary"):
            args, kw = batched_kernel_args(eng, stacked, delayed, collect, dev)
            got = kfn(*args, **kw)
            sync()
            if delayed and collect == "summary":
                # the plain batched summary is window_summary of the plain
                # loop's rows, which the owners run just gave
                want = K.window_summary(*rows)
            else:
                p_args, p_kw = first_scenarios(args, kw, delayed, BENCH_PLAIN_B)
                t0 = time.perf_counter()
                want = pfn(*p_args, **p_kw)
                sync()
                plain_ms[kname, collect] = (time.perf_counter() - t0) * 1e3
                rows = want
            equal([x[:BENCH_PLAIN_B] for x in got], want,
                  f"bench sweep delayed={delayed} {collect}", kname)
            # the kernel's own device time (profiler), a call in a CUDA
            # graph of back-to-back calls, and host-paced calls from Python
            call = (lambda a, k: lambda: kfn(*a, **k))(args, kw)
            times[kname, collect] = {
                "device": kernel_device_ms(call, "delayed_" if delayed else "sync_"),
                "graph": graph_ms(call), "host-paced": time_ms(call, 20)}
            if delayed and collect == "summary":  # the cell-ticks the tick math ran
                ticked_b = torch.zeros(1, dtype=torch.int64, device=dev)
                kfn(*args, ticked=ticked_b, **kw)
                sync()
            res = results[delayed, collect]
            check(int(res.max_owner_count.max()) <= 1,
                  f"bench sweep delayed={delayed}: §4 violated")
            # the sweep's path against the kernel on all its scenarios (the
            # kernel equals plain on the first BENCH_PLAIN_B above)
            if collect == "owners":
                equal((res.owners, res.counts), got,
                      f"bench sweep delayed={delayed} path vs kernel", kname)
                smax, sown, sfin = K.window_summary(*got)
            else:
                smax, sown, sfin = got
            # the reference's owned_frac: float32 owned count times the
            # float32 reciprocal of T·N (its compiled jnp mean)
            T, N = BENCH_SWEEP["n_ticks"], BENCH_SWEEP["n_cells"]
            frac = sown.sum(-1).to(torch.float32) * torch.tensor(
                np.float32(1) / np.float32(T * N), device=dev)
            check(torch.equal(res.owned_frac, frac)
                  and torch.equal(res.max_owner_count, smax.amax(-1))
                  and torch.equal(res.final_owners, sfin),
                  f"bench sweep delayed={delayed} {collect}: verdicts differ")
        check(torch.equal(results[delayed, "summary"].owned_frac,
                          results[delayed, "owners"].owned_frac),
              "summary and owners sweeps disagree")
        owned = float(results[delayed, "summary"].owned_frac.mean())
        check(owned > 0.1, f"bench sweep delayed={delayed}: owned {owned}")
        print(f"phase 19a sweep {BENCH_SWEEP['scenarios']} x "
              f"{BENCH_SWEEP['n_cells']} cells x {BENCH_SWEEP['n_ticks']} "
              f"ticks ({'delay <= 2, drops' if delayed else 'zero delay'}): "
              f"{kname} bit-exact vs plain in summary and owners mode (the first "
              f"{BENCH_PLAIN_B} scenarios), the sweep's path vs the kernel on all; kernel "
              + "; ".join(f"{c} " + ", ".join(f"{k} {fmt_ms(v)}"
                                              for k, v in times[kname, c].items())
                          for c in ("summary", "owners")) + "; plain " + " / ".join(
                  f"{plain_ms[kname, c]:.1f} ms {c}" for c in ("summary", "owners")
                  if (kname, c) in plain_ms) + f" ({BENCH_PLAIN_B} scenarios); owned "
              f"{owned:.4f}", flush=True)
    print(f"phase 19a took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # -------------------------- 19b. the full-width chaos sweep, checked
    t_phase = time.perf_counter()
    after = engine_to_arrays(eng_c)
    for k in before_c:
        check(np.array_equal(before_c[k], after[k]), f"sweep changed the engine's {k}")
    check(int(res_c.max_owner_count.max()) <= 1, "chaos sweep: §4 violated")
    cfg = dict(lease_ticks=24, round_ticks=RENEW_ROUND, drift_eps=0.25, device=dev)
    T, N = CHAOS_TICKS, CHAOS_SWEEP_N
    inv = torch.tensor(np.float32(1) / np.float32(T * N), device=dev)
    owned_counts = []
    for b, sc in enumerate(scs_c):
        twin = engine_from_reference(before_c, **cfg)
        ow, cn = twin.run_trace(sc)
        owned_counts.append((ow >= 0).sum())
        check(int(res_c.max_owner_count[b]) == int(cn.max())
              and torch.equal(res_c.final_owners[b], ow[-1])
              and torch.equal(res_c.owned_frac[b],
                              owned_counts[-1].to(torch.float32) * inv),
              f"chaos sweep scenario {b} differs from its run_trace")
    sync()
    solo_s = time.perf_counter() - t_phase
    stacked_c = Scenario.stack(scs_c)
    args, kw = batched_kernel_args(eng_c, stacked_c, True, "summary", dev)
    got = K.lease_window_delayed_batched(*args, **kw)
    check(torch.equal(got[1].sum(-1), torch.stack(owned_counts)),
          "chaos sweep: owned counts differ from the run_trace calls")
    p_args, p_kw = first_scenarios(args, kw, True, CHAOS_PLAIN_B)
    t0 = time.perf_counter()
    want = K.lease_window_delayed_batched_torch(*p_args, **p_kw)
    sync()
    plain_chaos = (time.perf_counter() - t0) * 1e3
    equal([x[:CHAOS_PLAIN_B] for x in got], want, "chaos sweep kernel vs plain",
          "lease_window_delayed_batched")
    del p_args, p_kw, want
    ticked = torch.zeros(1, dtype=torch.int64, device=dev)
    K.lease_window_delayed_batched(*args, ticked=ticked, **kw)
    sync()
    ticked_cells = int(ticked)
    ms_chaos = time_ms(lambda: K.lease_window_delayed_batched(*args, **kw), 5)
    args_o, kw_o = batched_kernel_args(eng_c, stacked_c, True, "owners", dev)
    ms_chaos_owners = time_ms(lambda: K.lease_window_delayed_batched(*args_o, **kw_o), 3)
    del args_o, kw_o
    spent, ms_sweep = run_trace_breakdown(lambda: eng_c.sweep(scs_c),
                                          "lease_window_delayed_batched")
    print(f"phase 19b chaos sweep {CHAOS_SWEEP_B} x {N} cells x {T} ticks "
          f"(A {eng_c.n_acceptors}, P {eng_c.n_proposers}, from tick "
          f"{eng_c.t}): summary equals {CHAOS_SWEEP_B} run_trace calls from the "
          f"same state (max owner count, owned count, final owners), max owner "
          f"count {int(res_c.max_owner_count.max())}, owned "
          f"{float(res_c.owned_frac.mean()):.4f}, engine unchanged; kernel "
          f"bit-exact vs plain on the first {CHAOS_PLAIN_B} scenarios (plain "
          f"{plain_chaos:.1f} ms); scenario generation {setup_c:.1f} s, the sweep "
          f"{main_s:.2f} s, the run_trace calls {solo_s:.1f} s", flush=True)
    print(f"phase 19b where one sweep's {ms_sweep:.1f} ms go: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in spent.items())
          + f", the rest {ms_sweep - sum(spent.values()):.1f} ms (plane scans, "
          f"clock and restart planes, reductions)", flush=True)

    def bound(ops, n_bytes):
        """(bound ms, what bounds it, the bytes' ms)"""
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        return max(ops, bytes_ms), "operations" if ops > bytes_ms else "bytes", bytes_ms

    # bounds: the unbatched kernels' SASS-counted arithmetic per cell-tick
    # (the same tick math), times the cell-ticks that ran it
    b_lib = _build.library_path(BENCH_SWEEP["n_acceptors"])
    Bb, Tb, Nb = BENCH_SWEEP["scenarios"], BENCH_SWEEP["n_ticks"], BENCH_SWEEP["n_cells"]
    A3, P4 = BENCH_SWEEP["n_acceptors"], BENCH_SWEEP["n_proposers"]
    tick_s = kernel_tick_ops(b_lib, "sync_window_kernelILi3EE")
    ops_s = ops_ms(Bb * Tb * Nb, tick_s)
    bound_s, by_s, bytes_s = bound(ops_s, 4 * (2 * Bb * Tb * Nb + Bb * Tb * (2 * A3 + P4)
                                               + (2 * A3 + 2) * Nb + 3 * Bb * Nb))
    # the bench sweep's delayed scenarios: the variant of their planes
    args_db, kw_db = batched_kernel_args(*bench[True], True, "summary", dev)
    variant = "".join(f"ELb{int(kw_db[k] is not None)}"
                      for k in ("extends", "stale", "acc_restart"))
    tick_db = kernel_tick_ops(b_lib, f"delayed_window_kernelILi3{variant}ELi0E")
    ops_db = ops_ms(int(ticked_b), tick_db)
    bound_db, by_db, bytes_db = bound(
        ops_db, 4 * (2 * Bb * Tb * Nb + Bb * Tb * (2 * A3 + P4 + P4 * A3) + (8 * A3 + 8) * Nb
                     + 3 * Bb * Nb))
    del args_db, kw_db
    # the chaos sweep runs the extend + restart variant
    tick_d = kernel_tick_ops(_build.library_path(A),
                             f"delayed_window_kernelILi{A}ELb1ELb0ELb1ELi0E")
    ops_d = ops_ms(ticked_cells, tick_d)
    B = CHAOS_SWEEP_B
    bound_d, by_d, bytes_d = bound(
        ops_d, 4 * (3 * B * T * N + B * T * (2 * A + 2 * P + P * A + 2 * A + 2 * P)
                    + (8 * A + 8) * N + 3 * B * N))
    floor = launch_floor()
    t_s = times["lease_window_sync_batched", "summary"]
    # the row's ms is the kernel's own device time, and nothing else
    check(t_s["device"] is not None,
          "the profiler recorded no sync_batched_kernel at the bench sweep")
    ms_s = t_s["device"]
    t_db = times["lease_window_delayed_batched", "summary"]
    print(f"phase 19 timing: delayed batched {ms_chaos:.3f} ms at the chaos sweep "
          f"(summary; owners {ms_chaos_owners:.3f} ms; {ticked_cells} of "
          f"{B * T * N} cell-ticks ran the tick math), bound {bound_d:.3f} ms "
          f"({by_d}: ops {ops_d:.3f}, bytes {bytes_d:.3f}), plain {plain_chaos:.1f} ms on "
          f"its first {CHAOS_PLAIN_B} scenarios; "
          f"at the bench sweep (summary; device: the kernel's own time under the "
          f"profiler; graph: a call in a CUDA graph of 20; host-paced: 20 calls from "
          f"Python): sync batched " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in t_s.items())
          + f", bound {bound_s:.5f} ms ({by_s}: ops {ops_s:.5f}, bytes {bytes_s:.5f}); "
          f"delayed batched " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in t_db.items())
          + f", bound {bound_db:.5f} ms ({by_db}: ops {ops_db:.5f}, bytes {bytes_db:.5f}; "
          f"{int(ticked_b)} of {Bb * Tb * Nb} cell-ticks ran the tick math); the launch "
          f"floor, an empty kernel: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in floor.items())
          + f"; SASS ops per tick, sync {tick_s}, delayed bench {tick_db}, delayed chaos "
          f"{tick_d}", flush=True)
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s (19b)", flush=True)
    source = "src/repro_torch/lease_array/csrc/lease_window.cu"
    return [
        dict(name="lease_window_delayed_batched", route="cuda", source=source,
             replaces="src/repro/lease_array/kernel.py:536",
             launches=launches["lease_window_delayed_batched"],
             max_abs_err=max_err["lease_window_delayed_batched"], ms=ms_chaos,
             plain_ms=plain_chaos, bound_ms=bound_d, bound_by=by_d,
             library_ms=None),
        dict(name="lease_window_sync_batched", route="cuda", source=source,
             replaces="src/repro/lease_array/kernel.py:447",
             launches=launches["lease_window_sync_batched"],
             max_abs_err=max_err["lease_window_sync_batched"], ms=ms_s,
             plain_ms=plain_ms["lease_window_sync_batched", "summary"],
             bound_ms=bound_s, bound_by=by_s, library_ms=None),
    ]


def chaos_sweep_setup(dev):
    """Phase 19b's inputs: an engine at DEFAULT_CELL warmed by 16 chaos
    ticks (acceptor restarts only, so each scenario's own proposer
    restarts fit the restart-counter carve), its carried state as arrays,
    and 64 chaos scenarios of phase 4's mix."""
    from repro_torch.lease_array import LeaseArrayEngine, engine_to_arrays, random_trace

    mix = dict(n_cells=CHAOS_SWEEP_N, n_acceptors=A, n_proposers=P,
               lease_ticks=24, max_delay_ticks=4, p_drop=0.05, asymmetric=True,
               drift_eps=0.25, restarts=0.002, renew=0.5, round_ticks=RENEW_ROUND)
    eng = LeaseArrayEngine(CHAOS_SWEEP_N, n_acceptors=A, n_proposers=P,
                           lease_ticks=24, round_ticks=RENEW_ROUND,
                           drift_eps=0.25, device=dev)
    warm = random_trace(70, n_ticks=16, **mix)
    warm.prop_restarts[:] = 0
    eng.run_trace(warm.scenario())
    scs = [random_trace(700 + b, n_ticks=CHAOS_TICKS, **mix).scenario()
           for b in range(CHAOS_SWEEP_B)]
    return eng, scs, engine_to_arrays(eng)


#: phase 20: the canonical falsifier cell (``FalsifyConfig``'s defaults,
#: src/repro/lease_array/falsify/search.py:44-96: 4 cells, A 3, P 4, 16
#: ticks, lease 2, round 3, drift 0.25, every honest fault plane) at the
#: bench's generation size (benchmarks/bench_lease_array.py:485-527) and as
#: the reference's acceptance run (tests/test_falsify.py:282-296)
FALSIFY_POP = 4096
FALSIFY_POP_GENERATIONS = 8
FALSIFY_RUN = (8192, 128)  # population x generations: 1,048,576 scenarios
FALSIFY_MIXES = {"honest": {}, "corrupt": dict(corrupt=True),
                 "restarts-extends": dict(restarts=True, extends=True)}
#: phase 21: the bench's failover handoff (benchmarks/bench_lease_array.py:
#: 417-441) and the handoff's tick count there (BENCH_lease_array.json)
HANDOFF = dict(n_acceptors=5, lease_ticks=24, max_workers=8, max_delay_ticks=2)
HANDOFF_SHARDS, HANDOFF_WARM, HANDOFF_TICKS = 1024, 40, 31


def timed_search(cfg, dev):
    """``falsify.search(cfg)`` with its parts timed: the margins sweep
    (ended by a device synchronisation; its uploads of the planes apart),
    the copy of verdicts and margins to the host, the mutation, and the
    rest (selection, lineage tags). Returns (result, wall s, {part: s})."""
    import importlib

    import torch

    from repro_torch.lease_array import ops

    # the module (the package's ``search`` is the function)
    S = importlib.import_module("repro_torch.lease_array.falsify.search")
    spent = {}

    def timed(name, fn, sync=False):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    eng = cfg.engine()
    eng.sweep = timed("margins sweep", eng.sweep, sync=True)
    parts = ((ops, "_as_i32", "uploads", True), (S, "mutate", "mutation", False),
             (torch.Tensor, "cpu", "copy to host", False))
    # the attributes as the owners hold them (None: inherited), restored after
    saved = [(owner, attr, vars(owner).get(attr)) for owner, attr, _, _ in parts]
    for owner, attr, name, sync in parts:
        setattr(owner, attr, timed(name, getattr(owner, attr), sync))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = S.search(cfg, engine=eng)
        wall = time.perf_counter() - t0
    finally:
        for owner, attr, raw in saved:
            if raw is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, raw)
    spent["margins sweep"] -= spent.get("uploads", 0.0)
    spent["selection and the rest"] = wall - sum(spent.values())
    return res, wall, spent


def falsify_phase(dev) -> dict:
    """Phase 20: the §4 falsifier on the card. Returns the launches of the
    batched lease kernels on its path (the shrinker's probes) by kernel
    name; every comparison with the CPU is exact or fails."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.lease_array import MARGIN_NAMES, Scenario
    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array.falsify import (
        FalsifyConfig,
        load_corpus,
        random_population,
        search,
        shrink,
    )
    from repro_torch.lease_array.scenario import plane_digest

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def same(a, b, what):
        fields = ("max_owner_count", "owned_frac", "final_owners")
        pairs = [(getattr(a, f), getattr(b, f)) for f in fields]
        if a.margins is not None:
            pairs += [(a.margins[k], b.margins[k]) for k in MARGIN_NAMES]
        for x, y in pairs:
            check(torch.equal(x.cpu(), y.cpu()), f"{what}: card and CPU differ")

    # 20a. margins at the bench's generation size, the card against the CPU
    margin_s = {}
    for name, kw in FALSIFY_MIXES.items():
        planes = random_population(np.random.default_rng(0),
                                   FalsifyConfig(pop_size=FALSIFY_POP, **kw))
        res = {}
        for where, d in (("card", dev), ("CPU", cpu)):
            eng = FalsifyConfig(device=d, **kw).engine()
            t0 = time.perf_counter()
            res[where] = eng.sweep(Scenario(planes), collect="margins", verify=False)
            res[where].max_owner_count.cpu()
            margin_s[name, where] = time.perf_counter() - t0
        same(res["card"], res["CPU"], f"margins {name} at pop {FALSIFY_POP}")
        if name != "corrupt":
            check(int(res["card"].max_owner_count.max()) <= 1,
                  f"margins {name}: §4 violated")
    # 20b. each corpus fixture at its recorded boundary distance
    corpus = {}
    for name, (sc, meta) in load_corpus().items():
        cfg = FalsifyConfig(n_cells=sc.n_cells, n_acceptors=sc.n_acceptors,
                            n_proposers=sc.n_proposers, n_ticks=sc.n_ticks,
                            device=dev.type, **meta["engine"])
        got = cfg.engine().sweep([sc], collect="margins", verify=False)
        for comp, want in meta["expect_margins"].items():
            corpus[name, comp] = int(got.margins[comp][0])
            check(corpus[name, comp] == want, f"corpus {name}: {comp} "
                  f"{corpus[name, comp]}, recorded {want}")
    # 20c. the corrupt control finds a violation; the shrinker keeps it,
    # its probes through the batched kernels
    control = dict(corrupt=True, seed=7, pop_size=128, generations=6)
    found = search(FalsifyConfig(device=dev.type, **control))
    check(found.found, "the corrupt control found no violation on the card")
    eng = FalsifyConfig(device=dev.type).engine()
    K.reset_launches()  # the main path: the shrinker's probes
    small = shrink(found.violation, eng, budget=120)
    launches = {k: getattr(K, k).launches
                for k in ("lease_window_delayed_batched", "lease_window_sync_batched")}
    check(launches["lease_window_delayed_batched"] > 0,
          "no shrinker probe launched the delayed batched kernel")
    check(K.lease_window_delayed_batched_torch.launches
          + K.lease_window_sync_batched_torch.launches == 0,
          "a shrinker probe on the card ran the plain loop")
    cpu_found = search(FalsifyConfig(device="cpu", **control))
    small_cpu = shrink(cpu_found.violation, FalsifyConfig(device="cpu").engine(), budget=120)
    check((found.lineage, found.digest) == (cpu_found.lineage, cpu_found.digest)
          and plane_digest(small.planes) == plane_digest(small_cpu.planes),
          "the card's search or shrink differs from the CPU's")
    one = Scenario({k: v[None] for k, v in small.planes.items()})
    got = eng.sweep(one, verify=False)
    want = FalsifyConfig(device="cpu").engine().sweep(one, verify=False)
    same(got, want, "the shrunk violation")
    check(int(got.max_owner_count[0]) > 1, "the shrunk scenario no longer violates")
    print(f"phase 20 falsifier: margins at pop {FALSIFY_POP} (" + ", ".join(
        f"{n} card {margin_s[n, 'card']:.3f} s / CPU {margin_s[n, 'CPU']:.3f} s"
        for n in FALSIFY_MIXES) + ") bit-exact against the CPU; corpus "
        + ", ".join(f"{n} {c}={v}" for (n, c), v in corpus.items())
        + f" as recorded; corrupt control (seed 7, pop 128 x 6) found "
        f"{found.digest} ({found.lineage}) as on the CPU, shrunk to "
        f"{small.n_ticks} ticks ({plane_digest(small.planes)}, as on the CPU), "
        f"still violating; shrinker launches: " + ", ".join(
            f"{k} {v}" for k, v in launches.items()), flush=True)

    # 20d. throughput: a short run at the bench's generation size, then
    # the reference's million-scenario honest run, its generation split
    t_run = time.perf_counter()
    rows = {}
    for pop, gens in ((FALSIFY_POP, FALSIFY_POP_GENERATIONS), FALSIFY_RUN):
        res, wall, spent = timed_search(
            FalsifyConfig(pop_size=pop, generations=gens, device=dev.type), dev)
        check(not res.found, f"the honest run at pop {pop} violated §4: {res.digest}")
        check(res.evaluations == pop * gens, f"evaluations {res.evaluations}")
        rows[pop] = (res, wall, spent)
    res, wall, spent = rows[FALSIFY_RUN[0]]
    check(res.concentrated(), "the honest run's survivors are not closer to §4 "
          "than its random generation")
    # one margins sweep at the run's population under the profiler: its
    # device busy time and kernel launches against its wall
    pop = FALSIFY_RUN[0]
    planes = random_population(np.random.default_rng(1), FalsifyConfig(pop_size=pop))
    eng = FalsifyConfig(pop_size=pop, device=dev.type).engine()
    eng.sweep(Scenario(planes), collect="margins", verify=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.sweep(Scenario(planes), collect="margins", verify=False).max_owner_count.cpu()
        sweep_wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    n = FALSIFY_RUN[0] * FALSIFY_RUN[1]
    for p, (r, w, sp) in rows.items():
        gens = r.generations
        print(f"phase 20 honest run pop {p} x {gens} generations ({p * gens} "
              f"scenarios): no violation, {p * gens / w:.1f} scenarios/s, wall "
              f"{w:.2f} s; a generation {w / gens * 1e3:.1f} ms: " + ", ".join(
                  f"{k} {v / gens * 1e3:.2f} ms" for k, v in sp.items())
              + f"; median score random {int(np.median(r.random_scores))} -> "
              f"survivors {int(np.median(r.survivor_scores))}", flush=True)
    print(f"phase 20 the {n}-scenario run: {wall:.2f} s, concentrated; one "
          f"margins sweep at pop {pop} under the profiler: {len(dev_events)} "
          f"device kernels, busy {busy:.2f} ms of {sweep_wall:.2f} ms wall "
          f"({100 * (1 - busy / sweep_wall):.1f} % idle); throughput runs "
          f"{time.perf_counter() - t_run:.1f} s", flush=True)
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def directory_phase(dev) -> int:
    """Phase 21: the bench's failover handoff through ``LeaseArrayDirectory``
    on the card, owners tick for tick against the CPU. Returns the
    unbatched delayed kernel's launches on its path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.lease_array import LeaseArrayDirectory
    from repro_torch.lease_array import kernel as K

    t_phase = time.perf_counter()

    def handoff(device, spent=None):
        """(owner rows, handoff ticks, max owner count, wall s)"""
        d = LeaseArrayDirectory(HANDOFF_SHARDS, device=device, **HANDOFF)
        if spent is not None:  # the step, its kernel and host part together
            step = d.engine.step

            def timed_step(tick):
                t0 = time.perf_counter()
                out = step(tick)
                torch.cuda.synchronize()
                spent["step"] += time.perf_counter() - t0
                return out
            d.engine.step = timed_step
        for i in range(8):
            d.add_worker(i, HANDOFF_SHARDS // 8)
        worst = torch.zeros(HANDOFF_SHARDS, dtype=torch.int32, device=device)
        rows, ticks = [], 0
        t0 = time.perf_counter()

        def tick():
            nonlocal worst
            rows.append(d.tick(1).copy())
            worst = torch.maximum(worst, d.engine.last_owner_count)

        for _ in range(HANDOFF_WARM):
            tick()
        check(d.coverage() == 1.0, f"handoff warm-up on {device}: coverage "
              f"{d.coverage()}")
        d.stall(0)
        for i in range(1, 8):
            d.set_target(i, HANDOFF_SHARDS // 7 + 1)
        while (d.owned_count(0) > 0 or d.coverage() < 0.95) and ticks < 400:
            tick()
            ticks += 1
        return np.stack(rows), ticks, int(worst.max()), time.perf_counter() - t0

    K.reset_launches()  # the main path: the directory's ticks
    spent = {"step": 0.0}
    rows, ticks, worst, wall = handoff(dev, spent)
    launches = K.lease_window_delayed.launches
    check(launches > 0, "the directory never launched lease_window_delayed")
    check(K.lease_window_delayed_torch.launches == 0, "a directory tick ran the plain loop")
    cpu_rows, cpu_ticks, _, cpu_wall = handoff(torch.device("cpu"))
    check(rows.shape == cpu_rows.shape and (rows == cpu_rows).all(),
          "directory owners on the card differ from the CPU's")
    check(ticks == cpu_ticks == HANDOFF_TICKS,
          f"handoff took {ticks} ticks (CPU {cpu_ticks}), recorded {HANDOFF_TICKS}")
    check(worst <= 1, f"directory: §4 violated (max owner count {worst})")
    # the kernel's device time a tick, from a run under the profiler
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        handoff(dev)
        torch.cuda.synchronize()
    kernel_ms = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "delayed_window_kernel" in e.name) / 1e3
    n_ticks = len(rows)
    tick_ms = wall / n_ticks * 1e3
    step_ms = spent["step"] / n_ticks * 1e3
    kern_ms = kernel_ms / n_ticks
    print(f"phase 21 directory handoff ({HANDOFF_SHARDS} shards, 8 workers, A "
          f"{HANDOFF['n_acceptors']}, lease {HANDOFF['lease_ticks']}, delay <= "
          f"{HANDOFF['max_delay_ticks']}): worker 0's shards re-owned in {ticks} "
          f"ticks after {HANDOFF_WARM} of warm-up, as on the CPU and as recorded; "
          f"owners equal the CPU's on all {n_ticks} ticks, max owner count {worst}; "
          f"{n_ticks / wall:.1f} ticks/s, {HANDOFF_SHARDS * n_ticks / wall:.4e} "
          f"cell-ticks/s (CPU {n_ticks / cpu_wall:.1f} ticks/s); a tick "
          f"{tick_ms:.3f} ms: policy {tick_ms - step_ms:.3f}, step host "
          f"{step_ms - kern_ms:.3f}, kernel {kern_ms:.4f} ms (device, profiler); "
          f"lease_window_delayed launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


#: phase 22: the paper's two experiments on the port's services, at the
#: reference benches' deployments: bench_failover.py (MASTER_CELL, 30 seeds,
#: delay 5-30 ms, 2 % loss, the master crashed at 5 + seed % 7 s, 4 T more)
#: and bench_contention.py (60 seeds; 3 proposers on 3 acceptors, 5 on 5;
#: T 15 s; delay 10-20 ms), and test_autoscale.py's join-and-silence run
FAILOVER_SEEDS, CONTENTION_SEEDS = 30, 60


def services_phase() -> None:
    """Phase 22: the §9 master-lease failover, the §1 contention baseline
    (naive majority against PaxosLease) and one autoscale run, through the
    port's ``cluster`` and ``core.naive`` (host-only; this machine has no
    JAX). ``monitor.assert_clean()`` holds in every run."""
    import numpy as np

    from repro_torch.cluster import AutoscaleController, ShardLeaseManager
    from repro_torch.cluster.coordinator import build_coordinated_cluster
    from repro_torch.cluster.membership import HeartbeatSender, MembershipTracker
    from repro_torch.configs.paxoslease_cell import MASTER_CELL, CellConfig
    from repro_torch.core import build_cell
    from repro_torch.core.naive import build_naive_cell
    from repro_torch.sim.network import NetConfig

    t_phase = time.perf_counter()
    check(not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules),
          "phase 22 runs with JAX or the reference loaded")
    net = NetConfig(delay_min=0.005, delay_max=0.03, loss=0.02)
    gaps = []
    for seed in range(FAILOVER_SEEDS):
        cell, coord = build_coordinated_cluster(MASTER_CELL, n_workers=0,
                                                seed=seed, net=net)
        for n in cell.proposers:
            coord.campaign(n)
        cell.env.run_until(5.0)
        if coord.master() is None:
            continue
        t_crash = 5.0 + seed % 7
        cell.env.run_until(t_crash)
        if coord.master() is not None:
            cell.nodes[coord.master()].crash()
        cell.env.run_until(t_crash + 4 * MASTER_CELL.lease_timespan)
        cell.monitor.assert_clean()
        gaps.extend(coord.failover_times())
    check(len(gaps) >= FAILOVER_SEEDS // 2, f"failover: {len(gaps)} gaps")
    g = np.array(gaps)
    bound = MASTER_CELL.lease_timespan + MASTER_CELL.backoff_max
    rows = []
    net = NetConfig(delay_min=0.01, delay_max=0.02)
    for n_prop in (3, 5):
        cfg = CellConfig(n_acceptors=n_prop, max_lease_time=60.0,
                         lease_timespan=15.0, backoff_min=0.05, backoff_max=0.3)
        blocked, first = 0, []
        for seed in range(CONTENTION_SEEDS):
            env, monitor, _, props = build_naive_cell(cfg, n_proposers=n_prop,
                                                      seed=seed, net=net)
            for p in props:
                p.acquire()
            env.run_until(10.0)
            check(not monitor.violations, f"naive cell seed {seed}: §4 violated")
            blocked += monitor.owner_of("R") is None
            cell = build_cell(cfg, n_proposers=n_prop, seed=seed, net=net)
            for p in cell.proposers:
                p.proposer.acquire()
            cell.env.run_until(10.0)
            cell.monitor.assert_clean()
            first.append(cell.monitor.acquire_times[0]
                         if cell.monitor.acquire_times else float("inf"))
        first = np.array(first)
        check(np.isfinite(first).all(), f"PaxosLease blocked with {n_prop} proposers")
        check(blocked > 0, f"the naive baseline never deadlocked with {n_prop} "
              f"proposers (bench_contention)")
        rows.append(f"{n_prop} proposers on {n_prop} acceptors: naive P(deadlock at "
                    f"10 s) {blocked / CONTENTION_SEEDS:.4f} ({blocked} of "
                    f"{CONTENTION_SEEDS}), PaxosLease first owner median "
                    f"{np.median(first):.4f} s, max {first.max():.4f} s")
    # test_autoscale.py's join-and-silence run
    cfg = CellConfig(n_acceptors=3, max_lease_time=30.0, lease_timespan=4.0,
                     backoff_min=0.1, backoff_max=0.4)
    cell, coord = build_coordinated_cluster(
        cfg, n_workers=3, seed=5, net=NetConfig(delay_min=0.005, delay_max=0.03))
    master = cell.nodes[0]
    coord.campaign(master)
    mgr = ShardLeaseManager(cell, n_shards=6, shard_timespan=3.0, scan_period=0.4)
    tracker = MembershipTracker(cell.env, master.addr, suspect_after=4.0)
    cell.env.network._handlers[master.addr + ":hb"] = lambda m, s: tracker.on_heartbeat(m)

    def settle(cond, t_max):
        while cell.env.now < t_max and not cond():
            cell.env.run_until(cell.env.now + 1.0)

    workers, senders = [], []

    def join(node):
        workers.append(mgr.add_worker(node, target=0))
        senders.append(HeartbeatSender(cell.env, node.addr, node.node_id,
                                       [master.addr + ":hb"], period=1.0))

    join(cell.proposers[3])
    join(cell.proposers[4])
    ctl = AutoscaleController(cell, mgr, tracker, master_node=master, period=1.0)
    settle(lambda: mgr.coverage() == 1.0, 30.0)
    check(mgr.coverage() == 1.0 and [w.target for w in workers] == [3, 3],
          "autoscale: 6 shards on 2 workers")
    join(cell.proposers[5])  # a third worker joins
    settle(lambda: len(workers[2].owned) >= 1 and mgr.coverage() == 1.0,
           cell.env.now + 40.0)
    check([w.target for w in workers] == [2, 2, 2] and workers[2].owned,
          "autoscale: the joining worker took no shards")
    senders[0].stop()
    mgr.stall(workers[0].node.node_id)
    settle(lambda: mgr.coverage() == 1.0 and not workers[0].owned, cell.env.now + 60.0)
    check(workers[0].target == 0 and mgr.coverage() == 1.0 and not workers[0].owned,
          "autoscale: the silent worker kept its shards")
    cell.monitor.assert_clean()
    print(f"phase 22 services (host only, the port's cluster and core.naive): "
          f"master failover at bench_failover's deployment, {FAILOVER_SEEDS} seeds: "
          f"n={len(g)}, median={np.median(g):.4f} s, p95={np.percentile(g, 95):.4f} s "
          f"(bound T + backoff {bound:.1f} s); contention at bench_contention's, "
          f"{CONTENTION_SEEDS} seeds: " + "; ".join(rows)
          + f"; autoscale join and silence: {len(ctl.decisions)} decisions, "
          f"coverage {mgr.coverage()}, the silent worker's target 0 at "
          f"{cell.env.now:.1f} s; no violation; {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def profiled_plans() -> int:
    """Phase 23's profiled launches, in a process of its own
    (``chip_smoke.py --profiled-plans``, started by :func:`leaselint_phase`):
    each of the four lease entries at a small geometry, up to five
    ``torch.profiler`` sessions of 20 calls until one records its kernel.
    Prints one JSON line: for each entry its plan's grid, block and shared
    bytes, those of every profiled kernel event, and the empty sessions.
    (Late in the smoke's own process, after the earlier phases' profiler
    sessions, five sessions in a row came back without a kernel; in a
    fresh process none did.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array.netplane import init_netplane
    from repro_torch.lease_array.state import init_state, pack_state

    dev = torch.device("cuda")
    N, T, B = 1000, 20, 3
    packed = pack_state(init_state(N, A, P, device=dev))
    net = init_netplane(N, A, device=dev)

    def planes(*lead):
        full = lambda *s, v: torch.full((*lead, *s), v, dtype=torch.int32, device=dev)  # noqa: E731
        clk = torch.arange(T, dtype=torch.int32, device=dev)[:, None] * 4
        return (full(T, N, v=-1), full(T, N, v=-1), full(T, A, v=1),
                clk.expand(*lead, T, P).contiguous(), clk.expand(*lead, T, A).contiguous(),
                full(T, P, A, v=0))

    kw = dict(majority=A // 2 + 1, lease_q4=33, n_proposers=P)
    one, many = planes(), planes(B)
    calls = {
        "lease_window_sync": lambda: K.lease_window_sync(packed, 0, *one[:5], **kw),
        "lease_window_delayed": lambda: K.lease_window_delayed(
            packed, net, 0, *one, round_q4=12, **kw),
        "lease_window_sync_batched": lambda: K.lease_window_sync_batched(
            packed, 0, *many[:5], **kw),
        "lease_window_delayed_batched": lambda: K.lease_window_delayed_batched(
            packed, net, 0, *many, round_q4=12, **kw),
    }
    trace = ROOT / "build" / "leaselint_trace.json"
    trace.parent.mkdir(exist_ok=True)
    names = ("sync_window_kernel", "delayed_window_kernel", "sync_batched_kernel")
    out = {}
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        (plan,) = getattr(K, name).plans
        empty = 0
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
            prof.export_chrome_trace(str(trace))
            kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
                       if e.get("cat") == "kernel"
                       and any(k in e.get("name", "") for k in names)]
            if kernels:
                break
            empty += 1
        args = [e.get("args", {}) for e in kernels]
        out[name] = {
            "plan": [[*plan.grid, 1], [plan.threads, 1, 1], plan.smem_bytes],
            "kernels": len(kernels), "empty": empty,
            "shown": [[a["grid"], a["block"], a.get("shared memory")]
                      for a in args if "grid" in a and "block" in a]}
    trace.unlink(missing_ok=True)
    print(json.dumps(out), flush=True)
    return 0


def leaselint_phase(libs: list) -> None:
    """Phase 23: the port's leaselint on the card. ``run_all()`` is clean;
    every distinct plan the lease entries launched in this process (phases
    2-21, recorded beside their launch counts) passes the launch audit; a
    profiled launch of each of the four entries (:func:`profiled_plans`, in
    a process of its own) has its plan's grid, block and dynamic shared
    memory; the SASS of each built lease library holds no floating-point
    instruction."""
    from repro_torch.analysis import staticcheck as lint
    from repro_torch.lease_array import kernel as K

    t_phase = time.perf_counter()
    findings = lint.run_all()
    check(findings == [], f"leaselint: {[str(f) for f in findings[:3]]}")
    plans = K.launched_plans()
    by_entry = {fn.__name__: len(fn.plans) for fn in K.ENTRIES}
    check(all(by_entry.values()), f"plans recorded per entry: {by_entry}")
    for plan in plans:
        bad = lint.check_launch_plan(plan)
        check(bad == [], f"a launched plan fails the audit: {[str(f) for f in bad[:2]]}")
    run = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--profiled-plans"],
                         capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"--profiled-plans failed: {run.stderr[-2000:]}")
    profiled = json.loads(run.stdout.strip().splitlines()[-1])
    check(set(profiled) == {fn.__name__ for fn in K.ENTRIES}, f"profiled {sorted(profiled)}")
    matched, empty = [], 0
    for name, got in profiled.items():
        empty += got["empty"]
        check(got["kernels"] > 0, f"{name}: no lease kernel event in five profiler "
              f"sessions of 20 launches each")
        for shown in got["shown"]:
            check(shown == got["plan"], f"{name}: profiled grid/block/shared {shown}, "
                  f"plan {got['plan']}")
        grid, block, smem = got["plan"]
        matched.append(
            f"{name} grid {grid[:2]} block {block[0]} shared {smem} B "
            f"({len(got['shown'])} profiled launches)" if got["shown"] else
            f"{name}: not measured ({got['kernels']} kernel events carry no grid "
            f"and block)")
    sass = []
    for lib in libs:
        text = library_sass(lib)
        bad = lint.check_sass(text, lib.name)
        check(bad == [], f"{lib.name}: {[str(f) for f in bad[:2]]}")
        ops = lint.floating_instructions(text)
        sass.append(f"{lib.name}: {len({k for k, _, _ in ops})} kernels with "
                    f"{len(ops)} floating-unit instructions, all in the "
                    f"integer-division idiom")
    print(f"phase 23 leaselint: run_all clean ({', '.join(n for n, _ in lint.cli._CHECKERS)}); "
          f"{len(plans)} distinct launched plans pass the launch audit "
          f"({', '.join(f'{k} {v}' for k, v in by_entry.items())}); profiled in a "
          f"process of its own: " + "; ".join(matched) + f" ({empty} profiler "
          f"sessions recorded no kernel and were run again); SASS: " + "; ".join(sass)
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)


#: the MoE and hybrid slice (phases 24-32; configs/archs.py): mixtral-8x22b
#: at its published widths with its depth cut from 56 to 4 layers (one layer
#: is 2.504 B parameters, 10.02 GB in fp32; four and the embeddings are 41.7
#: GB), prefill 1 x 8192 (past its 4096 window); hymba-1.5b whole, prefill
#: 4 x 2048 (past its 1024 window). kimi-k2-1t-a32b does not fit one card
#: (one layer's experts are 67.6 GB in fp32) and runs in the CPU tests only
MOE_ARCH, MOE_LAYERS, MOE_BATCH, MOE_SEQ = "mixtral-8x22b", 4, 1, 8192
HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ = "hymba-1.5b", 4, 2048
#: query rows a block of the blocked plain attention (the yardstick of
#: phases 25 and 28, where the (48, 8192, 8192) scores do not fit beside
#: mixtral's weights)
PLAIN_BLOCK = 1024


def attention_blocked(q, k, v, *, causal=True, window=None):
    """``attention_ref``'s function (causal self-attention, Sq = Sk),
    ``PLAIN_BLOCK`` query rows at a time over the keys those rows can reach:
    a masked key adds exactly 0 to a row's softmax, so leaving it out changes
    no term, and no (Sq, Sk) matrix is held."""
    import math

    import torch

    from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

    bhq, sq, dh = q.shape
    if not causal or k.shape[1] != sq:
        return attention_ref(q, k, v, causal=causal, window=window)
    g = bhq // k.shape[0]
    out = torch.empty_like(q)
    for q0 in range(0, sq, PLAIN_BLOCK):
        q1 = min(q0 + PLAIN_BLOCK, sq)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        kf, vf = (x[:, k0:q1].float().repeat_interleave(g, dim=0) for x in (k, v))
        s = torch.einsum("hqd,hkd->hqk", q[:, q0:q1].float(), kf) / math.sqrt(dh)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        p = torch.softmax(torch.where(mask[None], s, NEG_INF), dim=-1)
        out[:, q0:q1] = torch.einsum("hqk,hkd->hqd", p, vf).to(q.dtype)
    return out


class RouteRecorder:
    """Within this block every ``moe.router_topk`` call's expert indices are
    kept (``idx``, one (tokens, k) tensor a call: a call a layer in a
    forward), with each token's gate margin, the k-th softmax gate less the
    (k+1)-th (``margin``). Given ``follow`` (an earlier recorder), call i
    routes as that recorder's call i did, its gates the softmax's at those
    experts, renormalized: a yardstick run then differs from the run it
    follows in its attention alone, where a near-tie would otherwise send a
    token to another expert."""

    def __init__(self, follow=None):
        self.follow = follow

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.moe, self.saved, self.idx, self.margin = moe, moe.router_topk, [], []

        def record(cfg, params, x):
            gates, idx, aux = self.saved(cfg, params, x)
            k = idx.shape[-1]
            probs = torch.softmax(x.float() @ params["router"].float(), dim=-1)
            top = probs.topk(k + 1, dim=-1).values
            self.idx.append(idx.reshape(-1, k))
            self.margin.append((top[..., k - 1] - top[..., k]).reshape(-1))
            if self.follow is not None:
                idx = self.follow.idx[len(self.idx) - 1].reshape(idx.shape)
                gates = probs.gather(-1, idx)
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            return gates, idx, aux

        moe.router_topk = record
        return self

    def __exit__(self, *exc):
        self.moe.router_topk = self.saved


#: phase 25: a route of the kernel run that the plain run's own top-k does
#: not share must be a near-tie: gate margin below this (as in
#: tests/test_torch_moe.py)
FLIP_MARGIN = 1e-5


def route_agreement(a: RouteRecorder, b: RouteRecorder):
    """(each layer's share of tokens that ``a`` and ``b``'s own top-k send to
    the same experts, the first layer where one differs or None, [(layer,
    token, b's gate margin there)] for every token routed apart)."""
    shares, flips = [], []
    for layer, (x, y, m) in enumerate(zip(a.idx, b.idx, b.margin)):
        apart = (x.sort(-1).values != y.sort(-1).values).any(-1)  # expert sets
        shares.append(1.0 - float(apart.float().mean()))
        flips += [(layer, int(t), float(m[t])) for t in apart.nonzero().flatten()]
    return shares, (flips[0][0] if flips else None), flips


def live_pairs(b, h, s, window):
    """(q, k) pairs a causal windowed self-attention keeps: sum over the rows
    of min(q + 1, window)."""
    w = s if window is None else min(window, s)
    return b * h * (w * (w + 1) // 2 + (s - w) * w)


def flash_at_shapes(dev, phase: int, cases: list) -> dict:
    """Both flash kernels at a slice's prefill shapes, each case (label, b,
    hq, hkv, sq, sk, dh, causal, window) held against ``attention_ref``
    and timed beside it, beside ``scaled_dot_product_attention`` (a window
    as a boolean mask; ``enable_gqa`` where the heads are grouped) and
    beside the model's wrapper ``ops.flash_attention``, which takes (B, S,
    H, Dh) and transposes to the kernel's (B·H, S, Dh) and back. Returns
    each dtype's max |err|."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t_phase = time.perf_counter()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for label, b, hq, hkv, sq, sk, dh, causal, w in cases:
        rng = np.random.default_rng(phase)
        q0, k0, v0 = (torch.from_numpy(rng.standard_normal((b * h, n, dh), np.float32)).to(dev)
                      for h, n in ((hq, sq), (hkv, sk), (hkv, sk)))
        sdpa = dict(enable_gqa=hq != hkv, is_causal=causal and w is None)
        if w is not None:  # causal self-attention (Sq = Sk) behind a window
            pos = torch.arange(sq, device=dev)
            sdpa["attn_mask"] = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
        pairs = live_pairs(b, hq, sq, w) if causal else b * hq * sq * sk
        flop = 4 * dh * pairs
        for dtn in ("bfloat16", "float32"):
            q, k, v = (x.to(dt[dtn]) for x in (q0, k0, v0))
            got = FK.flash_attention_bhsd(q, k, v, causal=causal, window=w)
            want = attention_ref(q, k, v, causal=causal, window=w)
            err, rel = flash_err(dtn, got, want, f"{label} {dtn} flash")
            worst[dtn] = max(worst[dtn], err)
            leak = ""
            if dtn == "bfloat16" and not causal and sk % 128:
                # a planted fault: the zero-filled keys of the last 128-key
                # tile counted in every row's softmax; the check must fail it
                pad = (0, 0, 0, (-sk) % 128)
                kp, vp = (torch.nn.functional.pad(x, pad) for x in (k, v))
                bad = attention_ref(q, kp, vp, causal=False)
                leak_rel = float((bad.float() - want.float()).norm() / want.float().norm())
                leak_err = float((bad.float() - want.float()).abs().max())
                check(leak_rel >= BF16_REL_TOL, f"{label}: a planted tail leak reads "
                      f"{leak_rel:.3e}, within the bf16 limit {BF16_REL_TOL}")
                leak = (f"; a planted tail leak ({pad[3]} zero keys in the softmax) reads "
                        f"{leak_rel:.3e} relative, {leak_err:.3e} max |err|: caught")
                del kp, vp, bad
            del got, want
            q4, k4, v4 = (x.view(b, -1, x.shape[1], dh) for x in (q, k, v))
            qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q4, k4, v4))

            def kernel():
                return FK.flash_attention_bhsd(q, k, v, causal=causal, window=w)

            def library():
                return torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, **sdpa)

            ms_lib1, ms_k1, ms_k2, ms_lib2 = (time_ms(f, 5) for f in (library, kernel, kernel,
                                                                        library))
            ms_wrap = time_ms(lambda: ops.flash_attention(qs, ks, vs, causal=causal, window=w), 5)
            ms_plain = time_ms(lambda: attention_ref(q, k, v, causal=causal, window=w), 2)
            if dtn == "bfloat16":
                ops_ms = flop / BF16_FLOP_PER_S * 1e3
            else:
                ops_ms = min(flop / FP32_FLOP_PER_S, 3 * flop / TF32_FLOP_PER_S) * 1e3
            bytes_ms = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
                / HBM_BYTES_PER_S * 1e3
            ms_k, bound = (ms_k1 + ms_k2) / 2, max(ops_ms, bytes_ms)
            print(f"phase {phase} flash at the {label} ({dtn}, BHq {b * hq}, BHkv {b * hkv}, "
                  f"Sq {sq}, Sk {sk}, Dh {dh}, {'causal' if causal else 'non-causal'}, window "
                  f"{w}, group {hq // hkv}; {pairs:.4e} live pairs): kernel {ms_k:.4f} ms "
                  f"({ms_k1:.4f} / {ms_k2:.4f}; the bound is {bound / ms_k:.0%} of it), "
                  f"scaled_dot_product_attention{' (mask)' if w else ''} "
                  f"{(ms_lib1 + ms_lib2) / 2:.4f} ms ({ms_lib1:.4f} / {ms_lib2:.4f}), plain "
                  f"{ms_plain:.3f} ms, ops.flash_attention on (B, S, H, Dh) with its "
                  f"transposes {ms_wrap:.4f} ms; bound {bound:.4f} ms (operations "
                  f"{ops_ms:.4f}, bytes {bytes_ms:.4f}); max |err| vs plain {err:.3e}, "
                  f"||err|| / ||plain|| {rel:.3e}{leak}", flush=True)
            del q, k, v, q4, k4, v4, qs, ks, vs
        del q0, k0, v0, sdpa
        torch.cuda.empty_cache()
    print(f"phase {phase} took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return worst


def model_flash_cases(arch: str, b: int, s: int) -> list:
    """A model's prefill self-attention as ``flash_at_shapes`` cases:
    causal over ``s``, behind its window (whisper adds its encoder's
    non-causal self-attention and its decoder's cross-attention)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    heads = (b, cfg.n_heads, cfg.n_kv_heads)
    cases = [(f"{arch} prefill", *heads, s, s, cfg.head_dim, True, cfg.sliding_window)]
    if cfg.enc_dec:
        f = cfg.encoder_seq
        cases = [(f"{arch} encoder", *heads, f, f, cfg.head_dim, False, None),
                 (f"{arch} cross-attention", *heads, s, f, cfg.head_dim, False, None),
                 (f"{arch} decoder", *heads, s, s, cfg.head_dim, True, None)]
    return cases


def family_slice(dev, arch: str, batch: int, seq: int, first: int, n_layers=None) -> dict:
    """Four phases of one model at its published widths (``n_layers``: its
    depth, where it is cut), random fp32 weights from seed 0:
    ``first``: a ``batch`` x ``seq`` fp32 prefill through the 3xTF32 flash
    kernel (a launch an attention layer) against the same prefill with the
    plain attention, last logits and the emitted cache below 2e-4, each
    layer's expert routes compared; ``first + 1``: 16 greedy decode steps
    after a prefill against ``forward`` over all tokens, below 2e-4 (MoE at
    a capacity that drops nothing: decode never drops, forward may);
    ``first + 2``: ``ServeEngine`` in bf16, 8 requests on 4 slots (hymba:
    each request's tokens equal to it served alone; whisper: refused, as
    the reference's engine refuses it); ``first + 3``: the bf16 prefill
    through the wgmma kernel against plain, last logits below 5e-2, then
    step times, idle shares and the device time of the MoE dispatch, the
    SSM scan or whisper's encoder at the prefill's shapes. internvl2's
    ``seq`` positions are its 256 patch embeddings and ``seq - 256`` text
    tokens; whisper's decoder takes ``seq`` tokens beside its encoder's
    frames, and its decode steps end at ``seq`` (whisper's
    ``max_target_positions``). Frames and patches are ``synth_inputs``'
    random embeddings (the reference stubs both frontends). Returns each
    flash entry's launches on this main path (the two kernel prefills)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import forward, init_model, moe, ssm, synth_inputs, transformer
    from repro_torch.models.schema import leaf_paths
    from repro_torch.train.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize
    f32, bf16 = FK.KERNELS[torch.float32], FK.KERNELS[torch.bfloat16]
    launches = {}
    cfg = get_config(arch)
    depth = "" if n_layers is None else f" of {cfg.n_layers}"
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    is_moe = cfg.moe is not None
    plain = PlainAttention(attention_blocked)
    # flash launches a prefill: each decoder layer's self-attention, and an
    # encoder-decoder's encoder layers and cross-attention
    attn_layers = cfg.n_layers + (cfg.n_encoder_layers + cfg.n_layers if cfg.enc_dec else 0)
    n_patches = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    text = seq - n_patches

    def prefill_against_plain(c, batch_, phase, dtn, tol, cache_tol=None):
        """The kernel prefill and the plain one on the same batch, last
        logits within ``tol`` and (where given) the emitted cache within
        ``cache_tol``; returns (the kernel's cache, its launches). With
        ``cache_tol`` (fp32) the plain run follows the kernel run's expert
        routes, and every token its own top-k routes elsewhere must be a
        near-tie (``FLIP_MARGIN``); in bf16 each run routes by its own."""
        prefill = make_prefill_step(c, logits_mode="last")
        entry = FK.KERNELS[transformer.torch_dtype(c.dtype)]
        FK.reset_launches()
        with RouteRecorder() as rk:
            logits, cache = prefill(params, batch_)
        sync()
        n = FK.flash_attention_bhsd.launches_by_kernel[entry]
        check(n == FK.flash_attention_bhsd.launches == attn_layers,
              f"{arch} {dtn} prefill launched {entry} {n} times, not {attn_layers}")
        with plain, RouteRecorder(rk if cache_tol is not None else None) as rp:
            logits_p, cache_p = prefill(params, batch_)
        sync()
        check(FK.flash_attention_bhsd.launches == n, "the plain prefill launched the kernel")
        check(tuple(logits.shape) == (batch_["tokens"].shape[0], 1, c.vocab_size),
              f"{arch} prefill logits shape")
        check(bool(torch.isfinite(logits).all()), f"{arch} {dtn} prefill logits not finite")
        err = rel_err(logits, logits_p)
        err_cache = max(rel_err(cache[x], cache_p[x]) for x in cache if x != "slot_pos")
        routes = ""
        first_flip, flips = None, []
        if is_moe:
            shares, first_flip, flips = route_agreement(rk, rp)
            routes = ("; expert routes kernel vs plain (the plain run's own top-k), share "
                      "of tokens alike by layer: " + ", ".join(f"{x:.6f}" for x in shares)
                      + f"; first layer with a flip: {first_flip}; flips (layer, token, "
                      f"gate margin): {flips[:8]}"
                      + (" (the plain run took the kernel run's routes)"
                         if cache_tol is not None else ""))
        print(f"phase {phase} {dtn} prefill {arch} {tuple(batch_['tokens'].shape)}: flash "
              f"launches {n}; last logits vs plain attention rel err {err:.3e} (limit {tol}), "
              f"emitted cache rel err {err_cache:.3e}{routes}", flush=True)
        check(err < tol, f"{arch} {dtn} prefill logits kernel vs plain: rel err {err:.3e}, "
              f"first layer with a flipped route {first_flip}")
        check(cache_tol is None or err_cache < cache_tol, f"{arch} {dtn} prefill cache kernel "
              f"vs plain: rel err {err_cache:.3e}, first layer with a flipped route {first_flip}")
        check(cache_tol is None or all(m < FLIP_MARGIN for *_, m in flips),
              f"{arch} {dtn}: a route flipped at a gate margin of {FLIP_MARGIN} or more: "
              f"{flips}")
        return cache, n

    # --------------------------------- first: fp32 prefill, kernel vs plain
    t_phase = time.perf_counter()
    params = init_model(cfg, 0, device=dev)
    n_params = sum(x.numel() for _, x in leaf_paths(params))
    toks = torch.from_numpy(np.random.default_rng(first).integers(
        0, cfg.vocab_size, (batch, text)).astype(np.int32)).to(dev)
    # whisper's frames or internvl2's patches (fp32; the model casts them)
    stub = {k: x for k, x in synth_inputs(cfg32, ShapeConfig("stub", "prefill", seq, batch),
                                          first, device=dev)["batch"].items() if k != "tokens"}
    layers = f"{cfg.n_layers} layers{depth}"
    if cfg.enc_dec:
        layers = f"{cfg.n_encoder_layers} encoder and {cfg.n_layers} decoder layers"
    stubbed = "".join(f"; {k} {tuple(x.shape)} random (its frontend is a stub, as in the "
                      f"reference)" for k, x in stub.items())
    sync()
    t0 = time.perf_counter()
    _, launches[f32] = prefill_against_plain(cfg32, {"tokens": toks, **stub}, first,
                                             "float32", 2e-4, 2e-4)
    print(f"phase {first} {arch} ({n_params / 1e9:.3f} B params, fp32, {layers}{stubbed}) "
          f"kernel and plain "
          f"prefills {time.perf_counter() - t0:.1f} s; {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ------------------------------------ first + 1: decode against forward
    t_phase = time.perf_counter()
    c = cfg32
    if is_moe:  # capacity_factor E / k: a buffer holds a whole group
        c = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    # whisper's decoder ends at seq: its prefill stops LM_DECODE short
    head = toks[:, :text - LM_DECODE] if cfg.enc_dec else toks
    pre = n_patches + head.shape[1]
    logits, cache = make_prefill_step(c, logits_mode="last")(params, {"tokens": head, **stub})
    cache = continue_cache(c, cache, pre + LM_DECODE)
    decode = make_decode_step(c)
    tok = logits[:, -1].argmax(-1)
    fed, dec = [], []
    for i in range(LM_DECODE):
        fed.append(tok)
        lg, cache = decode(params, cache, tok[:, None], pre + i)
        dec.append(lg[:, 0])
        tok = lg[:, 0].argmax(-1)
    del cache
    full, _ = forward(c, params, {"tokens": torch.cat([head, torch.stack(fed, 1)
                                                       .to(toks.dtype)], 1), **stub})
    err = rel_err(torch.stack(dec, 1), full[:, pre:])
    del full
    print(f"phase {first + 1} continuation: {LM_DECODE} greedy fp32 decode_steps after a "
          f"{pre}-position prefill equal forward over {pre + LM_DECODE} positions, "
          f"rel err {err:.3e}"
          f"{' (capacity factor ' + str(c.moe.capacity_factor) + ')' if is_moe else ''}; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(err < 2e-4, f"{arch} decode continuation vs forward: rel err {err:.3e}")

    # --------------------------------------------- first + 2: bf16 serving
    t_phase = time.perf_counter()
    if cfg.enc_dec:
        try:
            ServeEngine(cfg, params)
        except ValueError as e:
            print(f"phase {first + 2} serving {arch}: refused ({e}), as the reference's "
                  f"engine refuses an encoder-decoder; not served", flush=True)
        else:
            check(False, f"ServeEngine took {arch}, which the reference does not serve")
    else:
        FK.reset_launches()
        steps, n_tok, serve_s, served = serve_requests(cfg, params)
        check(FK.flash_attention_bhsd.launches == 0, "serving launched the flash kernel")
        alone = ""
        if cfg.hybrid_parallel_ssm:  # each request alone in a 4-slot engine
            t0 = time.perf_counter()
            for req in served:
                _, _, _, [solo] = serve_requests(cfg, params, [req.prompt])
                check(solo.out == req.out, f"{arch} request {req.rid}: {req.out} served "
                      f"beside others, {solo.out} alone")
            alone = (f"; each request's tokens equal to it served alone "
                     f"({time.perf_counter() - t0:.1f} s)")
        print(f"phase {first + 2} serving {arch} in {cfg.dtype}: 8 requests / {n_tok} tokens "
              f"in {steps} engine steps, {serve_s:.2f} s ({n_tok / serve_s:.1f} tokens/s)"
              f"{alone}; {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------------------- first + 3: bf16 prefill, kernel vs plain; times
    t_phase = time.perf_counter()
    batch_ = {"tokens": toks, **{k: x.to(torch.bfloat16) for k, x in stub.items()}}
    # bf16 keeps 8 mantissa bits (3.9e-3 a rounding) over a bf16 residual
    # stream; a lost tile or mask shows far above 5e-2 (PERF.md §2)
    cache_b, launches[bf16] = prefill_against_plain(cfg, batch_, first + 3, "bfloat16", 5e-2)
    cache_b = continue_cache(cfg, cache_b, seq + LM_DECODE)
    prefill = make_prefill_step(cfg, logits_mode="last")
    busy_prefill = report_steps(first + 3, params, batch_, prefill, make_decode_step(cfg),
                                cache_b)
    del cache_b
    p0 = transformer.layer_params(params, 0, torch.bfloat16)
    part = None
    if is_moe:
        tg, cap = moe.group_and_capacity(cfg, batch * seq)
        name = f"moe_dispatch (t {batch * seq}, groups of {tg}, capacity {cap})"
        x = torch.randn(batch, seq, cfg.d_model, device=dev).to(torch.bfloat16)

        def part():
            return moe.moe_dispatch(cfg, p0["moe"], x)
    elif cfg.hybrid_parallel_ssm:
        di, st = cfg.ssm.d_inner, cfg.ssm.state_size
        name = f"ssm_scan (B {batch}, S {seq}, d_inner {di}, state {st})"
        xs = torch.randn(batch, seq, di, device=dev).to(torch.bfloat16)
        s0 = torch.zeros(batch, di, st, device=dev)

        def part():
            return ssm.ssm_scan(p0["ssm"], xs, s0, cfg)
    elif cfg.enc_dec:
        name = f"run_encoder (B {batch}, {cfg.encoder_seq} frames)"

        def part():
            return transformer.run_encoder(cfg, params, batch_["frames"])

    if part is not None:
        text, busy = profiled(part)
        print(f"phase {first + 3} one {name} in bf16 at the prefill's shapes: {text}; its "
              f"device busy time is {busy / busy_prefill:.1%} of one prefill_step's",
              flush=True)
    del p0, params, part
    torch.cuda.empty_cache()
    print(f"phase {first + 3} took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


#: the encoder-decoder and vision slice at published widths: whisper-large-v3
#: whole (8 clips of 1500 frames, a decoder of 448 tokens: whisper's
#: max_target_positions) and internvl2-2b whole (prefill_32k's 32 x 32768
#: cut to 4 x 2048 positions, 256 patches and 1792 text tokens, as internlm2)
WHISPER_ARCH, WHISPER_BATCH, WHISPER_SEQ = "whisper-large-v3", 8, 448
VLM_ARCH, VLM_BATCH, VLM_SEQ = "internvl2-2b", 4, 2048


def enc_dec_vision_slice(dev) -> tuple:
    """Phases 33-41: the flash kernels at whisper's shapes, then
    whisper-large-v3 (phases 34-37) and internvl2-2b (38-41), both whole.
    Returns (each dtype's max |err| of phase 33, each flash entry's
    launches on the two models' main paths)."""
    t_slice = time.perf_counter()
    worst = flash_at_shapes(dev, 33, model_flash_cases(WHISPER_ARCH, WHISPER_BATCH,
                                                       WHISPER_SEQ))
    launches = family_slice(dev, WHISPER_ARCH, WHISPER_BATCH, WHISPER_SEQ, 34)
    for entry, n in family_slice(dev, VLM_ARCH, VLM_BATCH, VLM_SEQ, 38).items():
        launches[entry] += n
    print(f"phases 33-41 took {time.perf_counter() - t_slice:.1f} s", flush=True)
    return worst, launches


def moe_hybrid_slice(dev) -> tuple:
    """Phases 24-32: the flash kernels at the slice's shapes, then mixtral-8x22b
    (phases 25-28) and hymba-1.5b (29-32). Returns (each dtype's max |err|
    of phase 24, each flash entry's launches on the two models' main
    paths)."""
    t_slice = time.perf_counter()
    worst = flash_at_shapes(dev, 24, model_flash_cases(MOE_ARCH, MOE_BATCH, MOE_SEQ)
                            + model_flash_cases(HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ))
    launches = family_slice(dev, MOE_ARCH, MOE_BATCH, MOE_SEQ, 25, n_layers=MOE_LAYERS)
    for entry, n in family_slice(dev, HYBRID_ARCH, HYBRID_BATCH, HYBRID_SEQ, 29).items():
        launches[entry] += n
    print(f"phases 24-32 took {time.perf_counter() - t_slice:.1f} s", flush=True)
    return worst, launches


#: the training slice (phases 42-45): internlm2-1.8b whole (configs/archs.py:9:
#: 24 layers, d_model 2048, 16/8 heads of 128, d_ff 8192, vocab 92544, bf16
#: compute over fp32 master weights, remat "dots") at train_4k's sequence of
#: 4096 (configs/base.py:198); the global batch cut from 256 to 8, in 4
#: microbatches of 2, to fit the card; 4 steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_MICRO, TRAIN_SEQ, TRAIN_STEPS = "internlm2-1.8b", 8, 4, 4096, 4
#: the fp32 step of phase 45: the same widths, 4 of the 24 layers, 2 x 4096
#: in 2 microbatches
TRAIN_FP32_LAYERS, TRAIN_FP32_BATCH = 4, 2
#: step 1's gradients, kernel run against the plain-attention run, per leaf
#: ||d||_2 / ||g||_2: bf16 below PERF.md §2's bf16 logits limit, fp32 below
#: the fp32 gradient limit of tests/test_torch_train.py
TRAIN_BF16_TOL, TRAIN_FP32_TOL = 5e-2, 1e-4
#: the backward kernel against attention_bwd_ref (tests/test_torch_flash_bwd_cuda.py):
#: fp32 per gradient; bf16 at most twice the bf16 plain run's error against
#: the fp32 plain run, plus BWD_BF16_SLACK (FlashAttention's own rule); the
#: LSE's max |err| by dtype
BWD_FP32_TOL, BWD_BF16_SLACK = 1e-4, 1e-3
LSE_TOL = {"float32": 1e-4, "bfloat16": 5e-4}
#: (label, bhq, bhkv, sq, sk, dh, causal, window): the slice's train shape,
#: the other families' attention shapes, ragged cases
BWD_CASES = [
    ("internlm2-1.8b train", 32, 16, 4096, 4096, 128, True, None),
    ("mixtral-8x22b 1 x 8192", 48, 8, 8192, 8192, 128, True, 4096),
    ("hymba-1.5b 4 x 2048", 100, 20, 2048, 2048, 64, True, 1024),
    ("whisper encoder", 160, 160, 1500, 1500, 64, False, None),
    ("whisper cross-attention", 160, 160, 448, 1500, 64, False, None),
    ("ragged causal 1500", 6, 2, 1500, 1500, 128, True, None),
    ("ragged window, group 5", 5, 1, 333, 333, 48, True, 100),
    ("ragged Sq < Sk", 4, 2, 65, 300, 80, True, None),
]


def grad_rel(got, want) -> float:
    """||got - want||_2 / ||want||_2 in fp32."""
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def grad_leaves(tree):
    """("a/b/c", leaf) of a nested dict, in ``leaf_paths`` order."""
    from repro_torch.models.schema import leaf_paths

    return [("/".join(path), x) for path, x in leaf_paths(tree)]


def bwd_phase(dev) -> dict:
    """Phase 42: the backward kernel (and the forward's LSE) against the
    plain versions at ``BWD_CASES`` in both dtypes, two runs bit-identical.
    Returns each dtype's max |err| of the gradients against the fp32 plain
    run."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref

    t_phase = time.perf_counter()
    worst = {"float32": 0.0, "bfloat16": 0.0}
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for n, (label, bhq, bhkv, sq, sk, dh, causal, w) in enumerate(BWD_CASES):
        g = torch.Generator(device=dev).manual_seed(420 + n)
        x32 = [torch.randn(h, s, dh, generator=g, device=dev)
               for h, s in ((bhq, sq), (bhkv, sk), (bhkv, sk), (bhq, sq))]
        readings = []
        for dtn in ("bfloat16", "float32"):
            q, k, v, do = (x.to(dt[dtn]) for x in x32)
            with torch.no_grad():
                o, lse = FK.flash_attention_fwd(q, k, v, causal=causal, window=w, with_lse=True)
                lse_err = float((lse - attention_lse_ref(q, k, causal=causal, window=w))
                                .abs().max())
                got = FK.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=w)
                again = FK.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=w)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                want = attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)), lse,
                                         causal=causal, window=w)
                errs = [grad_rel(a, b) for a, b in zip(got, want)]
                if dtn == "float32":
                    limits = [BWD_FP32_TOL] * 3
                else:
                    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=w)
                    limits = [2 * grad_rel(a, b) + BWD_BF16_SLACK for a, b in zip(plain, want)]
                    del plain
                worst[dtn] = max(worst[dtn], *(float((a.float() - b).abs().max())
                                               for a, b in zip(got, want)))
            for name, e, lim in zip(("dq", "dk", "dv"), errs, limits):
                check(e < lim, f"phase 42 {label} {dtn}: {name} rel err {e:.3e} (limit {lim:.3e})")
            check(lse_err < LSE_TOL[dtn], f"phase 42 {label} {dtn}: LSE max |err| {lse_err:.3e}")
            check(same, f"phase 42 {label} {dtn}: two runs of the backward kernel differ")
            readings.append(f"{dtn} dq/dk/dv " + "/".join(f"{e:.3e}" for e in errs)
                            + " (limits " + "/".join(f"{x:.3e}" for x in limits)
                            + f"), LSE max |err| {lse_err:.2e}")
            del q, k, v, do, o, lse, got, again, want
        print(f"phase 42 backward at {label} (BHq {bhq}, BHkv {bhkv}, Sq {sq}, Sk {sk}, "
              f"Dh {dh}, {'causal' if causal else 'non-causal'}, window {w}): "
              + "; ".join(readings) + "; two runs bit-identical", flush=True)
        del x32
        torch.cuda.empty_cache()
    print(f"phase 42 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return worst


def bwd_timing_phase(dev) -> dict:
    """Phase 43: the backward kernel's time at the train shape (internlm2,
    one microbatch: BHq 32, BHkv 16, S 4096, Dh 128, causal) beside its
    bound, the plain version and scaled_dot_product_attention's backward
    (forward and backward less forward); the forward kernels with and
    without the LSE, in turns, at that shape and at phase 12's prefill
    shape. Returns {dtype: (ms, plain ms, bound ms, bound by, library ms)}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    b = TRAIN_BATCH // TRAIN_MICRO
    bhq, bhkv, s, dh = b * cfg.n_heads, b * cfg.n_kv_heads, TRAIN_SEQ, cfg.head_dim
    pairs = bhq * s * (s + 1) // 2
    flop = 10 * dh * pairs  # five products of 2 Dh a live pair
    g = torch.Generator(device=dev).manual_seed(43)
    x32 = [torch.randn(h, s, dh, generator=g, device=dev) for h in (bhq, bhkv, bhkv, bhq)]
    out, sdpa_fwd = {}, {}
    for dtn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        q, k, v, do = (x.to(dtype) for x in x32)
        with torch.no_grad():
            o, lse = FK.flash_attention_fwd(q, k, v, causal=True, with_lse=True)

            def kernel():
                return FK.flash_attention_bwd(q, k, v, o, do, lse, causal=True)

            ms_k1 = time_ms(kernel, 3)
            ms_k2 = time_ms(kernel, 3)
            ms_plain = time_ms(lambda: attention_bwd_ref(q, k, v, o, do, lse, causal=True), 1)
        q4, k4, v4, do4 = (x.view(b, -1, s, dh) for x in (q, k, v, do))
        leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]

        def sdpa():
            return F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)

        def sdpa_grad():
            return torch.autograd.grad(sdpa(), leaves, do4)

        ms_fb, ms_f = time_ms(sdpa_grad, 3), time_ms(sdpa, 3)
        ms_lib, sdpa_fwd[dtn] = ms_fb - ms_f, ms_f
        elt = q.element_size()
        bytes_ms = ((4 * q.numel() + 4 * k.numel()) * elt + 4 * lse.numel()) \
            / HBM_BYTES_PER_S * 1e3  # q o do k v lse read, dq dk dv written
        if dtn == "bfloat16":
            ops_ms = flop / BF16_FLOP_PER_S * 1e3
        else:
            ops_ms = min(flop / FP32_FLOP_PER_S, 3 * flop / TF32_FLOP_PER_S) * 1e3
        bound = max(ops_ms, bytes_ms)
        ms_k = (ms_k1 + ms_k2) / 2
        out[dtn] = (ms_k, ms_plain, bound, "operations" if ops_ms >= bytes_ms else "bytes",
                    ms_lib)
        print(f"phase 43 backward timing ({dtn}, BHq {bhq}, BHkv {bhkv}, S {s}, Dh {dh}, "
              f"causal; {pairs:.4e} live pairs, {flop:.3e} FLOP): kernel {ms_k:.4f} ms "
              f"({ms_k1:.4f} / {ms_k2:.4f}; three launches; the bound is "
              f"{bound / ms_k:.0%} of it), plain {ms_plain:.3f} ms, "
              f"scaled_dot_product_attention backward {ms_lib:.4f} ms (forward and "
              f"backward {ms_fb:.4f} less forward {ms_f:.4f}); bound {bound:.4f} ms "
              f"(operations {ops_ms:.4f}, bytes {bytes_ms:.4f})", flush=True)
        del q, k, v, do, o, lse, q4, k4, v4, do4, leaves
        torch.cuda.empty_cache()
    # the forward with and without the LSE, in turns: inference must not slow
    for label, bb, ss in (("train", b, s), ("phase-12 prefill", LM_BATCH, LM_SEQ)):
        bq, bk = bb * cfg.n_heads, bb * cfg.n_kv_heads
        y = [torch.randn(h, ss, dh, generator=g, device=dev) for h in (bq, bk, bk)]
        for dtn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            q, k, v = (x.to(dtype) for x in y)
            with torch.no_grad():
                def plain_fwd():
                    return FK.flash_attention_fwd(q, k, v, causal=True)

                def lse_fwd():
                    return FK.flash_attention_fwd(q, k, v, causal=True, with_lse=True)

                t = [time_ms(f, 10) for f in (plain_fwd, lse_fwd, lse_fwd, plain_fwd)]
            no_lse, with_lse = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            lib = (f", scaled_dot_product_attention forward {sdpa_fwd[dtn]:.4f} ms"
                   if label == "train" else "")
            print(f"phase 43 forward at the {label} shape ({dtn}, BHq {bq}, BHkv {bk}, S {ss}): "
                  f"no LSE {no_lse:.4f} ms ({t[0]:.4f} / {t[3]:.4f}), with the LSE "
                  f"{with_lse:.4f} ms ({t[1]:.4f} / {t[2]:.4f}), ratio "
                  f"{with_lse / no_lse:.4f}{lib}", flush=True)
            del q, k, v
        del y
    print(f"phase 43 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def train_slice(dev) -> tuple:
    """Phases 42-45. 42-43: the backward kernel against plain and timed.
    44: internlm2-1.8b whole, bf16 compute over fp32 master weights:
    step 1's gradients through the kernels against a ``PlainAttention`` run
    on the same batch, then ``Trainer`` for ``TRAIN_STEPS`` steps of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in ``TRAIN_MICRO`` microbatches (the
    bf16 kernels' main path): every loss finite, every parameter moved;
    step time, tokens/s, peak memory, a profiled step's idle share. 45: the
    fp32 step at full width and ``TRAIN_FP32_LAYERS`` layers against plain,
    then a checkpoint of its state saved, restored and compared. Returns
    (the kernels' rows for the JSON line, each forward entry's launches on
    the training paths)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokens
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import accumulate_grads, make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = torch.cuda.synchronize
    t_slice = time.perf_counter()
    worst = bwd_phase(dev)
    timing = bwd_timing_phase(dev)
    torch.cuda.empty_cache()

    # ------------------------ 44. internlm2-1.8b whole: gradients, 4 steps
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    tc = TrainerConfig(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       microbatches=TRAIN_MICRO, warmup=1, peak_lr=1e-4, log_every=1,
                       seed=0)
    # the trainer's first batch: its loader's, from the same seed
    batch1 = ShardedLoader(SyntheticTokens(cfg.vocab_size, tc.seq_len, seed=tc.seed),
                           tc.n_shards, tc.batch_size).next_batch()
    params = init_model(cfg, tc.seed, device=dev)
    n_params = sum(x.numel() for _, x in grad_leaves(params))
    t0 = time.perf_counter()
    grads, loss_k, _ = accumulate_grads(cfg, params, batch1, microbatches=TRAIN_MICRO)
    sync()
    grad_s = time.perf_counter() - t0
    kernel_grads = {k: g.clone() for k, g in grad_leaves(grads)}
    del grads
    with PlainAttention():
        t0 = time.perf_counter()
        grads, loss_p, _ = accumulate_grads(cfg, params, batch1, microbatches=TRAIN_MICRO)
        sync()
        plain_s = time.perf_counter() - t0
    check(bool(torch.isfinite(loss_k)), "phase 44: step-1 loss not finite")
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(loss_rel < 1e-2, f"phase 44: step-1 loss kernel {float(loss_k):.6f} vs plain "
          f"{float(loss_p):.6f} (rel {loss_rel:.3e}, limit 1e-2)")
    readings = {k: grad_rel(kernel_grads[k], g) for k, g in grad_leaves(grads)}
    for k, e in readings.items():
        check(e < TRAIN_BF16_TOL, f"phase 44: gradient {k} kernel vs plain {e:.3e} "
              f"(limit {TRAIN_BF16_TOL})")
    print(f"phase 44 {TRAIN_ARCH} whole ({cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, bf16 compute, fp32 master weights, remat {cfg.remat_policy!r}): step "
          f"1's gradients over {TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches, "
          f"kernels {grad_s:.2f} s, plain attention {plain_s:.2f} s; loss kernel "
          f"{float(loss_k):.6f}, plain {float(loss_p):.6f} (rel {loss_rel:.3e}); per leaf "
          f"||d|| / ||g|| (limit {TRAIN_BF16_TOL}): "
          + ", ".join(f"{k} {e:.3e}" for k, e in readings.items()), flush=True)
    del grads, kernel_grads, params
    torch.cuda.empty_cache()

    tr = Trainer(cfg, tc, verbose=False, device=dev)
    before = {k: x.to("cpu", copy=True) for k, x in grad_leaves(tr.params)}
    stamps = []
    FK.reset_launches()  # the bf16 kernels' training path: these 4 steps
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    hist = tr.run(on_step=lambda step, m: (sync(), stamps.append(time.perf_counter())))
    counts = dict(FK.flash_attention_bhsd.launches_by_kernel)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"phase 44: losses {losses}")
    moved = {k: float((x.cpu() != before[k]).float().mean()) for k, x in grad_leaves(tr.params)}
    check(all(f > 0 for f in moved.values()), f"phase 44: parameters that did not move: "
          f"{[k for k, f in moved.items() if f == 0]}")
    bf16_fwd = FK.KERNELS[torch.bfloat16]
    want_fwd = 2 * cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS  # forward and its recompute
    check(counts[bf16_fwd] == want_fwd, f"phase 44: {counts[bf16_fwd]} bf16 forward "
          f"launches, not {want_fwd}")
    for e in FK.BWD_KERNELS[torch.bfloat16]:
        check(counts[e] == cfg.n_layers * TRAIN_MICRO * TRAIN_STEPS,
              f"phase 44: {e} launched {counts[e]} times")
    check(all(counts[e] == 0 for e in (*FK.BWD_KERNELS[torch.float32],
                                        FK.KERNELS[torch.float32])),
          "phase 44: a bf16 step launched an fp32 kernel")
    mean_s = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 44 Trainer: {TRAIN_STEPS} steps, losses " + ", ".join(f"{x:.4f}" for x in losses)
          + f"; grad norms " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist)
          + f"; step times " + ", ".join(f"{x:.3f}" for x in step_s)
          + f" s (steps 2-{TRAIN_STEPS}: {mean_s:.3f} s, {tokens / mean_s:.0f} tokens/s); "
          f"peak memory {peak_gb:.2f} GB; every leaf moved (least share of elements changed "
          f"{min(moved.values()):.4f}); launches " + ", ".join(
              f"{e} {counts[e]}" for e in (bf16_fwd, *FK.BWD_KERNELS[torch.bfloat16])),
          flush=True)
    batch = tr.loader.next_batch()
    text, busy = profiled(lambda: tr._train_step(tr.params, tr.opt_state, batch),
                          warm=False, host_ops=False)
    print(f"phase 44 profile of one train step (bf16; device and runtime events, no "
          f"warm-up call): {text}", flush=True)
    launches = {bf16_fwd: counts[bf16_fwd]}
    bwd_launches = {"bfloat16": sum(counts[e] for e in FK.BWD_KERNELS[torch.bfloat16])}
    del tr, before, batch
    torch.cuda.empty_cache()
    print(f"phase 44 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---------- 45. fp32 at full width, 4 layers: kernels vs plain; checkpoint
    t_phase = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=TRAIN_FP32_LAYERS)
    batch = ShardedLoader(SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, seed=1), 8,
                          TRAIN_FP32_BATCH).next_batch()
    params = init_model(cfg32, 1, device=dev)
    FK.reset_launches()  # the fp32 kernels' training path: this phase's kernel runs
    sync()
    t0 = time.perf_counter()
    grads, loss_k, _ = accumulate_grads(cfg32, params, batch, microbatches=TRAIN_FP32_BATCH)
    sync()
    grad_s = time.perf_counter() - t0
    kernel_grads = {k: g.clone() for k, g in grad_leaves(grads)}
    with PlainAttention():
        sync()
        t0 = time.perf_counter()
        grads, loss_p, _ = accumulate_grads(cfg32, params, batch, microbatches=TRAIN_FP32_BATCH)
        sync()
        plain_s = time.perf_counter() - t0
    readings = {k: grad_rel(kernel_grads[k], g) for k, g in grad_leaves(grads)}
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(loss_rel < 1e-5, f"phase 45: fp32 loss kernel vs plain rel {loss_rel:.3e}")
    for k, e in readings.items():
        check(e < TRAIN_FP32_TOL, f"phase 45: fp32 gradient {k} kernel vs plain {e:.3e}")
    del grads, kernel_grads
    opt = adamw_init(params)
    step = make_train_step(cfg32, peak_lr=1e-4, warmup=1, total=10,
                           microbatches=TRAIN_FP32_BATCH)
    sync()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    sync()
    step_s = time.perf_counter() - t0
    check(math.isfinite(float(m["loss"])), "phase 45: fp32 step loss not finite")
    counts = dict(FK.flash_attention_bhsd.launches_by_kernel)
    for e in FK.BWD_KERNELS[torch.float32]:
        check(counts[e] == 2 * TRAIN_FP32_LAYERS * TRAIN_FP32_BATCH,
              f"phase 45: {e} launched {counts[e]} times")
    launches[FK.KERNELS[torch.float32]] = counts[FK.KERNELS[torch.float32]]
    bwd_launches["float32"] = sum(counts[e] for e in FK.BWD_KERNELS[torch.float32])
    print(f"phase 45 fp32 at full width, {TRAIN_FP32_LAYERS} layers, {TRAIN_FP32_BATCH} x "
          f"{TRAIN_SEQ} in {TRAIN_FP32_BATCH} microbatches: gradients through the kernels "
          f"{grad_s:.3f} s, through plain attention {plain_s:.3f} s; loss kernel {float(loss_k):.7f}, "
          f"plain {float(loss_p):.7f} (rel {loss_rel:.3e}); per leaf ||d|| / ||g|| (limit "
          f"{TRAIN_FP32_TOL}): " + ", ".join(f"{k} {e:.3e}" for k, e in readings.items())
          + f"; a train step in {step_s:.3f} s: loss {float(m['loss']):.6f}, grad norm "
          f"{float(m['grad_norm']):.4f}; launches " + ", ".join(
              f"{e} {counts[e]}" for e in (FK.KERNELS[torch.float32],
                                            *FK.BWD_KERNELS[torch.float32])), flush=True)
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    state = {"params": params, "opt": opt}
    mgr = CheckpointManager(str(ckpt_dir), every_steps=1, keep=1, lease_guard=lambda: True)
    t0 = time.perf_counter()
    check(mgr.maybe_save(1, lambda: state), "phase 45: the checkpoint was not written")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, at = restore_checkpoint(ckpt_dir, device=dev)
    load_s = time.perf_counter() - t0
    got, want = dict(grad_leaves(restored)), dict(grad_leaves(state))
    check(at == 1 and set(got) == set(want), "phase 45: restored keys differ")
    check(all(got[k].dtype == x.dtype and torch.equal(got[k], x) for k, x in want.items()),
          "phase 45: the restored state differs")
    size_gb = sum(p.stat().st_size for p in ckpt_dir.rglob("*") if p.is_file()) / 1e9
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"phase 45 checkpoint of that state ({len(want)} leaves, {size_gb:.2f} GB on disk): "
          f"saved in {save_s:.1f} s, restored to the card in {load_s:.1f} s, every leaf "
          f"identical", flush=True)
    del params, opt, state, restored, got, want
    torch.cuda.empty_cache()
    print(f"phase 45 took {time.perf_counter() - t_phase:.1f} s; phases 42-45 "
          f"{time.perf_counter() - t_slice:.1f} s", flush=True)

    rows = []
    csrc = "src/repro_torch/kernels/flash_attention/csrc/"
    for dtn, name, src in (("bfloat16", "flash_attention_bwd", "flash_attention_bwd_wgmma.cu"),
                           ("float32", "flash_attention_bwd_fp32", "flash_attention_bwd_tf32.cu")):
        ms, plain_ms, bound, by, lib = timing[dtn]
        rows.append(dict(name=name, route="cuda", source=csrc + src,
                         replaces="src/repro/kernels/flash_attention/kernel.py:124",
                         launches=bwd_launches[dtn], max_abs_err=worst[dtn], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib))
    return rows, launches


#: phases 46-49: rwkv6-3b training (configs/archs.py:149: 32 layers, d_model
#: 2560, 40 heads of 64, d_ff 8960, vocab 65536, bf16 compute over fp32
#: master weights, remat "dots") at train_4k's sequence of 4096
#: (configs/base.py:198), the global batch cut from 256 to 8 to fit the card
#: as for internlm2, in RWKV_TRAIN_MICRO microbatches of 1: beside the fp32
#: weights, AdamW's moments and the gradients (49.2 GB) a microbatch of 2
#: ran out of the card's 80 GB in the train step
RWKV_TRAIN_MICRO = 8
#: phase 49: fp32 at the same widths, 4 of the 32 layers, 2 x 4096 in 2
#: microbatches
RWKV_FP32_LAYERS, RWKV_FP32_BATCH = 4, 2
#: phase 46, the WKV6 backward against wkv6_bwd_ref (tests/test_torch_rwkv6_bwd_cuda.py),
#: (bh, s, n, decay, initial state, final-state gradient): the reference's
#: five cases as B·H rows, lengths ragged about the kernel's 64-token chunks
#: (32 at N 128: 1 to 300, and 2049) at every head size from a state, with and
#: without dS_T, rwkv6's decay_base spread, decays down to -33 a token
#: ("extreme": omega up to 3.5), and the training microbatch (1 x 40 heads
#: of 64, S 4096) and twice it
WKV_BWD_CASES = [
    (8, 64, 64, 0.5, False, False),
    (2, 128, 64, 1.0, False, False),
    (2, 96, 64, 0.5, False, False),
    (6, 96, 32, 0.5, False, False),
    (1, 64, 128, 0.0, False, False),
    (3, 1, 16, 0.5, True, True),
    (3, 31, 32, "spread", True, False),
    (3, 33, 64, "extreme", True, True),
    (3, 95, 128, "spread", False, True),
    (2, 2049, 64, "spread", True, True),
    (2, 300, 128, "extreme", True, True),
    (2, 63, 64, "extreme", True, True),
    (2, 65, 64, "spread", False, True),
    (2, 129, 64, 0.5, True, False),
    (2, 63, 128, "spread", True, True),
    (2, 65, 128, "extreme", False, True),
    (2, 129, 128, 0.5, True, True),
    (40, 4096, 64, "spread", False, False),
    (80, 4096, 64, "spread", True, True),
]
WKV_BWD_TOL = 1e-4


def wkv_bwd_inputs(dev, bh, s, n, decay, with_state, with_dstate, dtype, seed):
    """(r, k, v, logw, u, state, dout, dstate) on the kernel's (B·H, S, N)
    layout from numpy: r, k, v in ``dtype``, the rest fp32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((bh, s, n), np.float32) for _ in range(4))
    if decay == "spread":
        omega = decay_base_omega(1, s, bh, n, seed + 1)[0].transpose(1, 0, 2)
    else:
        omega = rng.uniform(-6.0, 3.5 if decay == "extreme" else decay, (bh, s, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = (rng.standard_normal((bh, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((bh, n, n)) * 0.1).astype(np.float32) if with_state else None
    ds = rng.standard_normal((bh, n, n)).astype(np.float32) if with_dstate else None

    def t(a, d=torch.float32):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev, d)

    return (*(t(a, dtype) for a in (r, k, v)), t(logw), t(u), t(st), t(do), t(ds))


def shifted_plain_bwd(*args):
    """The planted fault of phase 46: the plain backward with dlogw's
    reverse sum one token off (each token given its successor's)."""
    import torch

    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

    out = list(wkv6_bwd_ref(*args))
    out[3] = torch.cat([out[3][:, 1:], out[3][:, -1:]], 1)
    return out


def wkv_bwd_phase(dev) -> dict:
    """Phase 46: the WKV6 backward kernel against ``wkv6_bwd_ref`` at
    ``WKV_BWD_CASES`` in both dtypes, two runs bit-identical, and a planted
    fault caught. Returns each dtype's max |err| over the gradients."""
    import torch

    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

    t_phase = time.perf_counter()
    worst = {"float32": 0.0, "bfloat16": 0.0}
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    names = ("dr", "dk", "dv", "dlogw", "du", "dS0")
    caught = {}
    for i, case in enumerate(WKV_BWD_CASES):
        readings = []
        for dtn in ("float32", "bfloat16"):
            x = wkv_bwd_inputs(dev, *case, dts[dtn], seed=460 + i)
            with torch.no_grad():
                got = WK.wkv6_bwd(*x)
                again = WK.wkv6_bwd(*x)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                want = wkv6_bwd_ref(*x)
            errs = [grad_rel(a, b) for a, b in zip(got, want)]
            limits = [WKV_BWD_TOL] * 6
            if dtn == "bfloat16":  # dr, dk, dv rounded to bf16: twice that rounding
                limits[:3] = [2 * grad_rel(w.bfloat16(), w) for w in want[:3]]
            worst[dtn] = max(worst[dtn], *(float((a.float() - b).abs().max())
                                           for a, b in zip(got, want)))
            for name, e, lim in zip(names, errs, limits):
                check(e < lim, f"phase 46 {case} {dtn}: {name} rel err {e:.3e} (limit {lim:.3e})")
            check(same, f"phase 46 {case} {dtn}: two runs of the backward kernel differ")
            if case[3] == "spread" and case[5] and dtn not in caught:
                fault = grad_rel(got[3], shifted_plain_bwd(*x)[3])
                check(fault > WKV_BWD_TOL, f"phase 46: the planted fault (dlogw's sum a token "
                      f"off) reads {fault:.3e}, inside the limit {WKV_BWD_TOL}")
                caught[dtn] = fault
            readings.append(f"{dtn} " + "/".join(f"{e:.2e}" for e in errs) + " (limits "
                            + "/".join(f"{x:.1e}" for x in limits) + ")")
            del x, got, again, want
        print(f"phase 46 WKV6 backward at BH {case[0]}, S {case[1]}, N {case[2]}, decay "
              f"{case[3]}, state {case[4]}, dS_T {case[5]}: dr/dk/dv/dlogw/du/dS0 rel err "
              + "; ".join(readings) + "; two runs bit-identical", flush=True)
        torch.cuda.empty_cache()
    check(set(caught) == {"float32", "bfloat16"}, "phase 46: the planted fault was not run")
    print("phase 46 planted fault, a copy of the plain backward with dlogw's sum shifted by "
          "one token, against the kernel: " + ", ".join(f"{k} {v:.3e}" for k, v in caught.items())
          + f" (limit {WKV_BWD_TOL}: caught); max |err| " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items())
          + f"; {time.perf_counter() - t_phase:.1f} s", flush=True)
    return worst


def wkv_bwd_variant(source: Path):
    """A variant of ``csrc/wkv6_bwd.cu`` (an earlier commit's, from ``git
    show``, or an edited copy) built into a library of its own beside the
    port's, its entry points declared as the port's; its includes resolve
    as from ``csrc/``."""
    import ctypes
    import hashlib

    from repro_torch._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library
    from repro_torch.kernels.flash_attention._build import TF32_HEADER
    from repro_torch.kernels.rwkv6 import _build as wkv_build

    flags = [*NVCC_FLAGS, "-I", str(wkv_build.CSRC)]
    h = hashlib.sha256(source.read_bytes() + TF32_HEADER.read_bytes() + " ".join(flags).encode())
    lib = ctypes.CDLL(str(compile_library(
        BUILD_DIR / f"libwkv6_bwd_variant_{h.hexdigest()[:16]}.so", [source], flags)))
    for name in wkv_build.BWD_ENTRY_POINTS:
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        getattr(lib, name).restype = ctypes.c_int
    lib.wkv6_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.wkv6_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib


def wkv_bwd_timing_phase(dev, sources=()) -> dict:
    """Phase 47: the WKV6 backward's time at the training microbatch (one
    sequence's 40 heads of 64, S 4096, decay_base spread), each pass and in
    total, beside its bound and the plain version's time (the backward of
    autograd through ``wkv_chunked_bhsn`` on the card). ``sources``: other
    versions of ``csrc/wkv6_bwd.cu`` (``wkv_bwd_variant``), each timed with
    the port's kernel in turns (port, variants, variants, port), its
    gradients held to the port's at 1e-4. Returns {dtype: (ms, plain ms,
    bound ms, bound by)}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import _build as wkv_build
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv_chunked_bhsn

    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    n = cfg.rwkv.head_size
    bh, s = TRAIN_BATCH // RWKV_TRAIN_MICRO * cfg.d_model // n, TRAIN_SEQ
    lib = wkv_build.load()
    variants = [(Path(src).name, wkv_bwd_variant(Path(src))) for src in sources]
    out = {}
    for dtn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        x = wkv_bwd_inputs(dev, bh, s, n, "spread", False, False, dtype, seed=47)
        r, k, v, logw, u, _, do, _ = x
        stream = torch.cuda.current_stream().cuda_stream

        def launcher(library):
            """The three passes of ``library`` on this call's inputs into
            outputs of their own; (launch all, launch one pass, outputs)."""
            scratch = torch.empty(library.wkv6_bwd_scratch_bytes(bh, s, n) // 4, device=dev)
            outs = [torch.empty_like(r) for _ in range(3)] + [
                torch.empty(bh, s, n, device=dev), torch.empty(bh, n, device=dev),
                torch.empty(bh, n, n, device=dev)]
            ptrs = [a.data_ptr() for a in (r, k, v, logw, u)] + [None, do.data_ptr(), None] + [
                o.data_ptr() for o in outs] + [scratch.data_ptr()]

            def one(entry, keep=(scratch, outs)):  # the buffers live while it does
                check(getattr(library, entry)(*ptrs, bh, s, n, stream) == 0, f"{entry} failed")

            def every():
                for entry in WK.BWD_KERNELS[dtype]:
                    one(entry)

            return every, one, outs

        every, launch, port_outs = launcher(lib)
        passes = {}
        for entry in WK.BWD_KERNELS[dtype]:  # in order: each pass's inputs are in
            passes[entry] = time_ms(lambda e=entry: launch(e), 10)
        if variants:
            others = [(name, launcher(vl)) for name, vl in variants]
            every()
            for name, (run, _, outs) in others:
                run()
                torch.cuda.synchronize()
                errs = [grad_rel(a, b) for a, b in zip(outs, port_outs)]
                check(max(errs) < WKV_BWD_TOL, f"phase 47 variant {name} ({dtn}) differs from "
                      f"the port's kernel: {errs}")
            runs = [("port", every)] + [(name, run) for name, (run, _, _) in others]
            turns = {name: [] for name, _ in runs}
            for name, run in runs + runs[::-1]:
                turns[name].append(time_ms(run, 10))
            print(f"phase 47 variants in turns ({dtn}; ms, three passes): " + "; ".join(
                f"{name} " + " / ".join(f"{t_:.4f}" for t_ in ts) for name, ts in turns.items()),
                flush=True)
        with torch.no_grad():
            t1 = time_ms(lambda: WK.wkv6_bwd(*x), 10)
            t2 = time_ms(lambda: WK.wkv6_bwd(*x), 10)
            ms_ref = time_ms(lambda: wkv6_bwd_ref(*x), 1)
        leaves = [a.detach().clone().requires_grad_(True) for a in (r, k, v, logw, u)]
        o_plain, _ = wkv_chunked_bhsn(*leaves)
        ms_plain = time_ms(lambda: torch.autograd.grad(o_plain, leaves, do, retain_graph=True), 2)
        del o_plain, leaves
        ms = (t1 + t2) / 2
        elt = r.element_size()
        # r, k, v in their dtype, logw and do fp32 read once; dr, dk, dv in
        # r's dtype and dlogw fp32 written once (u, du and the zero states
        # are B·H x N or N x N a row: under 0.1 % of it)
        n_bytes = bh * s * n * (6 * elt + 12)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        # the chunked form's backward: its forward's products again and two
        # products for each of them (phase 17's 4·N·(C + N) FLOP a token and
        # head, three times); for fp32 the least of that on the CUDA cores,
        # as three TF32 products, or the recurrence's 7 instructions per
        # token, key and column at the fp32 lanes' rate
        flop = 3 * bh * s * 4 * n * (WKV_CHUNK + n)
        rec_ins = 7 * bh * s * n * n
        if dtn == "bfloat16":
            ops_ms = flop / BF16_FLOP_PER_S * 1e3
        else:
            ops_ms = min(flop / FP32_FLOP_PER_S, 3 * flop / TF32_FLOP_PER_S,
                         rec_ins / (FP32_FLOP_PER_S / 2)) * 1e3
        bound = max(ops_ms, bytes_ms)
        out[dtn] = (ms, ms_plain, bound, "operations" if ops_ms >= bytes_ms else "bytes")
        print(f"phase 47 WKV6 backward timing ({dtn} r/k/v, BH {bh}, S {s}, N {n}, decay_base "
              f"spread): kernel {ms:.4f} ms ({t1:.4f} / {t2:.4f}; passes " + ", ".join(
                  f"{e} {t:.4f}" for e, t in passes.items())
              + f"; the bound is {bound / ms:.0%} of it), plain: autograd of wkv_chunked_bhsn's "
              f"backward {ms_plain:.3f} ms, wkv6_bwd_ref {ms_ref:.1f} ms; no PyTorch call "
              f"computes WKV6's gradient (library_ms null); bound {bound:.4f} ms (bytes "
              f"{bytes_ms:.4f} ms: {n_bytes / 1e6:.1f} MB at 3.35 TB/s; operations "
              f"{ops_ms:.4f} ms: {flop:.3e} FLOP of the chunked form's backward, "
              f"{rec_ins:.3e} instructions of the recurrence); registers, spills and shared "
              f"memory: phase 1", flush=True)
        del x, r, k, v, logw, u, do, port_outs, every, launch
        torch.cuda.empty_cache()
    print(f"phase 47 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def float64_wkv(r, k, v, logw, u, state=None):
    """Phases 48-49's witness: the chunked form in float64 under autograd
    (the exact recurrence to ~1e-15 at any chunk, independent of the
    kernels and of the fp32 form's rounding), its outputs in fp32 as the
    kernel wrapper's. Chunks of 64 tokens: its time is the chunk loop's."""
    import torch

    from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

    out, st = wkv_chunked_bhsn(r, k, v, logw, u, state, chunk=64, dtype=torch.float64)
    return out.float(), st.float()


def wkv_forward_witness(dev) -> str:
    """Phase 48's first check: at the training microbatch (decay_base
    spread, a nonzero initial state) each forward kernel and the plain fp32
    chunked form against the float64 witness, the kernels below their
    phase-13 tolerance. Returns the readings as text."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

    cfg = get_config(RWKV_ARCH)
    n = cfg.rwkv.head_size
    bh = TRAIN_BATCH // RWKV_TRAIN_MICRO * cfg.d_model // n
    parts = []
    for dtn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        r, k, v, logw, u, st, _, _ = wkv_bwd_inputs(dev, bh, TRAIN_SEQ, n, "spread", True, False,
                                                    dtype, seed=48)
        with torch.no_grad():
            want, want_st = wkv_chunked_bhsn(r, k, v, logw, u, st, dtype=torch.float64)
            errs = [(grad_rel(o, want), grad_rel(s, want_st)) for o, s in (
                WK.wkv6_fwd(r, k, v, logw, u, st), wkv_chunked_bhsn(r, k, v, logw, u, st))]
        (ek, ek_st), (ep, ep_st) = errs
        check(ek < WKV_TOL[dtn] and ek_st < WKV_TOL[dtn], f"phase 48: the {dtn} forward kernel "
              f"vs the float64 witness {ek:.3e}, state {ek_st:.3e} (limit {WKV_TOL[dtn]:g})")
        parts.append(f"{dtn} kernel {ek:.3e} (state {ek_st:.3e}; limit {WKV_TOL[dtn]:g}), plain "
                     f"fp32 form {ep:.3e} (state {ep_st:.3e})")
        del r, k, v, logw, u, st, want, want_st
    text = "; ".join(parts)
    print(f"phase 48 WKV6 forward against the float64 witness (BH {bh}, S {TRAIN_SEQ}, N {n}, "
          f"decay_base spread, from a state), ||d|| / ||want||: {text}", flush=True)
    torch.cuda.empty_cache()
    return text


def wkv_gradient_runs(phase: int, cfg, params, batch, loss_tol: float, leaf_tol: float,
                      **kw) -> str:
    """Phases 48-49: a step's gradients three ways on the card: the witness
    (``SwapWKV(float64_wkv)``), through the kernels (twice: bit-identical)
    and plain (``SwapWKV``: the chunked form in fp32).
    A leaf's floor is plain's distance from the witness: what the model
    makes of a WKV that uses no kernel and is right to fp32 rounding.
    Holds the kernels to the witness: the loss to
    ``loss_tol`` relative, each leaf's ||d|| / ||g|| below ``leaf_tol`` or
    twice its floor, whichever is larger; prints the kernels against plain
    beside them. Returns the readings as text."""
    import torch

    from repro_torch.launch.steps import accumulate_grads

    seconds, losses, rel = {}, {}, {}
    keep = {}
    for name, fn in (("float64 witness", float64_wkv), ("kernels", None), ("kernels again", None),
                     ("plain", None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name.startswith("kernels"):
            grads, loss, _ = accumulate_grads(cfg, params, batch, **kw)
        else:
            with SwapWKV(fn):
                grads, loss, _ = accumulate_grads(cfg, params, batch, **kw)
        torch.cuda.synchronize()
        seconds[name], losses[name] = time.perf_counter() - t0, float(loss)
        leaves = dict(grad_leaves(grads))
        if name in ("float64 witness", "kernels"):
            keep[name] = leaves
        wit = keep["float64 witness"]
        if name == "kernels again":
            same = all(torch.equal(g, keep["kernels"][k]) for k, g in leaves.items())
            check(same and losses[name] == losses["kernels"],
                  f"phase {phase}: two runs through the kernels differ")
        elif name != "float64 witness":
            for k, g in leaves.items():
                rel.setdefault(k, {})[name] = grad_rel(g, wit[k])
        if name == "plain":
            for k, g in leaves.items():
                rel[k]["kernels vs plain"] = grad_rel(keep["kernels"][k], g)
        del grads, leaves
    del keep, wit
    loss_k, loss_w = losses["kernels"], losses["float64 witness"]
    loss_rel = abs(loss_k - loss_w) / abs(loss_w)
    floor = {k: x["plain"] for k, x in rel.items()}
    limit = {k: max(leaf_tol, 2 * f) for k, f in floor.items()}
    text = (", ".join(f"{k} {s:.2f} s" for k, s in seconds.items()) + "; loss "
            + ", ".join(f"{k} {x:.7f}" for k, x in losses.items())
            + f" (kernels rel {loss_rel:.3e}, limit {loss_tol:g}); per leaf ||d|| / ||g|| against "
            f"the witness, kernels (limit: {leaf_tol:g} or twice the floor) / plain (the "
            f"floor), then kernels against plain: "
            + ", ".join(f"{k} {x['kernels']:.3e} / {x['plain']:.3e}, "
                        f"{x['kernels vs plain']:.3e}"
                        for k, x in rel.items()))
    print(f"phase {phase} gradients: {text}", flush=True)
    check(math.isfinite(loss_k), f"phase {phase}: loss not finite")
    check(loss_rel < loss_tol, f"phase {phase}: loss kernels {loss_k:.7f} vs the float64 "
          f"witness {loss_w:.7f} (rel {loss_rel:.3e}, limit {loss_tol:g})")
    for k, x in rel.items():
        check(x["kernels"] < limit[k], f"phase {phase}: gradient {k} kernels vs the float64 "
              f"witness {x['kernels']:.3e} (limit {limit[k]:.3e}: {leaf_tol:g} or twice the "
              f"floor {floor[k]:.3e})")
    torch.cuda.empty_cache()
    return text


def rwkv_train_slice(dev) -> tuple:
    """Phases 46-49. 46-47: the WKV6 backward kernel against plain and timed.
    48: rwkv6-3b whole, bf16 compute over fp32 master weights: step 1's
    forward kernels against the float64 witness (``wkv_forward_witness``),
    step 1's gradients through the kernels on its first microbatch against
    it, plain beside them (``wkv_gradient_runs``), then
    ``Trainer`` for
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in
    ``RWKV_TRAIN_MICRO`` microbatches (the bf16 kernels' main path): every
    loss finite, every parameter moved, the launches counted; step time,
    tokens/s, peak memory, a profiled step's idle share. 49: fp32 at full
    width and ``RWKV_FP32_LAYERS`` layers, the gradients as in 48, then
    a train step. Returns (the backward's rows for the JSON line, each
    forward entry's launches on the training paths)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import ShardedLoader, SyntheticTokens
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adamw_init
    from repro_torch.train import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize
    t_slice = time.perf_counter()
    worst = wkv_bwd_phase(dev)
    timing = wkv_bwd_timing_phase(dev)
    torch.cuda.empty_cache()

    # -------------------------- 48. rwkv6-3b whole: gradients, TRAIN_STEPS steps
    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    tc = TrainerConfig(steps=TRAIN_STEPS, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                       microbatches=RWKV_TRAIN_MICRO, warmup=1, peak_lr=1e-4, log_every=1,
                       seed=0)
    # the trainer's first batch, its loader's from the same seed; the
    # gradients are compared on its first microbatch
    batch1 = ShardedLoader(SyntheticTokens(cfg.vocab_size, tc.seq_len, seed=tc.seed),
                           tc.n_shards, tc.batch_size).next_batch()
    part = {k: x[:TRAIN_BATCH // RWKV_TRAIN_MICRO] for k, x in batch1.items()}
    params = init_model(cfg, tc.seed, device=dev)
    n_params = sum(x.numel() for _, x in grad_leaves(params))
    print(f"phase 48 {RWKV_ARCH} whole ({cfg.n_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters, bf16 compute, fp32 master weights, remat {cfg.remat_policy!r}): step "
          f"1's gradients over its first microbatch ({TRAIN_BATCH // RWKV_TRAIN_MICRO} x "
          f"{TRAIN_SEQ}) follow", flush=True)
    wkv_forward_witness(dev)
    wkv_gradient_runs(48, cfg, params, part, 1e-2, TRAIN_BF16_TOL)
    del params
    torch.cuda.empty_cache()
    t_checks = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, verbose=False, device=dev)
    before = {k: x.to("cpu", copy=True) for k, x in grad_leaves(tr.params)}
    t_setup = time.perf_counter() - t0
    stamps = []
    WK.reset_launches()  # the bf16 kernels' training path: these steps
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    hist = tr.run(on_step=lambda step, m: (sync(), stamps.append(time.perf_counter())))
    counts = dict(WK.wkv6_bhsn.launches_by_kernel)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"phase 48: losses {losses}")
    t_run = time.perf_counter() - t0
    t0 = time.perf_counter()
    moved = {k: float((x != before[k].to(dev)).float().mean())
             for k, x in grad_leaves(tr.params)}
    t_moved = time.perf_counter() - t0
    check(all(f > 0 for f in moved.values()), f"phase 48: parameters that did not move: "
          f"{[k for k, f in moved.items() if f == 0]}")
    bf16_fwd = WK.KERNELS[torch.bfloat16]
    runs = cfg.n_layers * RWKV_TRAIN_MICRO * TRAIN_STEPS
    check(counts[bf16_fwd] == 2 * runs, f"phase 48: {counts[bf16_fwd]} bf16 forward launches, "
          f"not {2 * runs} (the forward and its recompute a layer and microbatch)")
    for e in WK.BWD_KERNELS[torch.bfloat16]:  # the backward runs once a layer and microbatch
        check(counts[e] == runs, f"phase 48: {e} launched {counts[e]} times, not {runs}")
    check(all(counts[e] == 0 for e in (*WK.BWD_KERNELS[torch.float32],
                                        WK.KERNELS[torch.float32])),
          "phase 48: a bf16 step launched an fp32 kernel")
    mean_s = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"phase 48 Trainer: {TRAIN_STEPS} steps, losses " + ", ".join(f"{x:.4f}" for x in losses)
          + "; grad norms " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist)
          + "; step times " + ", ".join(f"{x:.3f}" for x in step_s)
          + f" s (steps 2-{TRAIN_STEPS}: {mean_s:.3f} s, {tokens / mean_s:.0f} tokens/s); "
          f"peak memory {peak_gb:.2f} GB; every leaf moved (least share of elements changed "
          f"{min(moved.values()):.4f}); launches " + ", ".join(
              f"{e} {counts[e]}" for e in (bf16_fwd, *WK.BWD_KERNELS[torch.bfloat16])),
          flush=True)
    batch = tr.loader.next_batch()
    t0 = time.perf_counter()
    text, _ = profiled(lambda: tr._train_step(tr.params, tr.opt_state, batch),
                       warm=False, host_ops=False)
    print(f"phase 48 profile of one train step (bf16; device and runtime events, no "
          f"warm-up call): {text}", flush=True)
    print(f"phase 48 wall: the checks against the witness {t_checks:.1f} s, the Trainer's "
          f"set-up {t_setup:.1f} s, its {TRAIN_STEPS} steps {t_run:.1f} s, the moved check "
          f"{t_moved:.1f} s, the profiled step {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {bf16_fwd: counts[bf16_fwd]}
    bwd_launches = {"bfloat16": sum(counts[e] for e in WK.BWD_KERNELS[torch.bfloat16])}
    del tr, before, batch
    torch.cuda.empty_cache()
    print(f"phase 48 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ------------------- 49. fp32 at full width, 4 layers: kernels vs plain; a step
    t_phase = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=RWKV_FP32_LAYERS)
    batch = ShardedLoader(SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, seed=1), 8,
                          RWKV_FP32_BATCH).next_batch()
    params = init_model(cfg32, 1, device=dev)
    wkv_gradient_runs(49, cfg32, params, batch, 1e-5, TRAIN_FP32_TOL,
                      microbatches=RWKV_FP32_BATCH)
    WK.reset_launches()  # the fp32 kernels' training path: this train step
    opt = adamw_init(params)
    step = make_train_step(cfg32, peak_lr=1e-4, warmup=1, total=10,
                           microbatches=RWKV_FP32_BATCH)
    sync()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    sync()
    step_s = time.perf_counter() - t0
    check(math.isfinite(float(m["loss"])), "phase 49: fp32 step loss not finite")
    counts = dict(WK.wkv6_bhsn.launches_by_kernel)
    runs = RWKV_FP32_LAYERS * RWKV_FP32_BATCH
    check(counts[WK.KERNELS[torch.float32]] == 2 * runs,
          f"phase 49: {counts[WK.KERNELS[torch.float32]]} fp32 forward launches, not {2 * runs}")
    for e in WK.BWD_KERNELS[torch.float32]:
        check(counts[e] == runs, f"phase 49: {e} launched {counts[e]} times, not {runs}")
    check(all(counts[e] == 0 for e in (*WK.BWD_KERNELS[torch.bfloat16],
                                        WK.KERNELS[torch.bfloat16])),
          "phase 49: an fp32 step launched a bf16 kernel")
    launches[WK.KERNELS[torch.float32]] = counts[WK.KERNELS[torch.float32]]
    bwd_launches["float32"] = sum(counts[e] for e in WK.BWD_KERNELS[torch.float32])
    print(f"phase 49 fp32 at full width, {RWKV_FP32_LAYERS} layers, {RWKV_FP32_BATCH} x "
          f"{TRAIN_SEQ} in {RWKV_FP32_BATCH} microbatches: the gradients as above; a train "
          f"step in {step_s:.3f} s: loss {float(m['loss']):.6f}, grad norm "
          f"{float(m['grad_norm']):.4f}; launches " + ", ".join(
              f"{e} {counts[e]}" for e in (WK.KERNELS[torch.float32],
                                            *WK.BWD_KERNELS[torch.float32])), flush=True)
    del params, opt, batch
    torch.cuda.empty_cache()
    print(f"phase 49 took {time.perf_counter() - t_phase:.1f} s; phases 46-49 "
          f"{time.perf_counter() - t_slice:.1f} s", flush=True)

    rows = []
    for dtn, name in (("bfloat16", "wkv6_bwd"), ("float32", "wkv6_bwd_fp32")):
        ms, plain_ms, bound, by = timing[dtn]
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/kernels/rwkv6/csrc/wkv6_bwd.cu",
                         replaces="src/repro/kernels/rwkv6/kernel.py:94",
                         launches=bwd_launches[dtn], max_abs_err=worst[dtn], ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None))
    return rows, launches


#: phase 50: the restart-mode replay at the pack bound's edge (P 8, 3-tick
#: leases, proposer 7 restarted three times): 1022 ticks, the derived and
#: hand bound at 3 restarts, on 2^16 cells (a [1022, N] int32 plane is
#: 4.3 GB at 2^20; phase 3's 2^20 x 256 run_trace is the gate at full width)
EDGE_N, EDGE_TICKS, EDGE_LEASE, EDGE_RESTARTS = 1 << 16, 1022, 3, (100, 400, 700)
#: a round horizon whose deadlines (the round owner's clock + 4 x this)
#: pass 2^31 - 1 within 100 ticks (tests/test_staticcheck.py:45-49)
HUGE_ROUND_TICKS = 536_870_900


def gate_costs(eng, sc) -> dict:
    """Host time (ms) of the static gate ``eng.run_trace(sc)`` passes
    first: cold (both caches cleared: the trace and a first walk), a cache
    hit, and a fresh walk for a new end tick, with the trace alone."""
    import numpy as np

    from repro_torch.analysis.staticcheck import intervals as IA
    from repro_torch.lease_array import engine as lease_engine

    rmax = max(int(np.asarray(sc.planes[k]).max()) for k in ("prop_rate", "acc_rate"))
    args = (eng.t + sc.n_ticks, int(np.asarray(sc.planes["delay"]).max()), rmax,
            eng._max_restarts(sc.planes["prop_restart"]), eng._clk_slack(rmax))

    def ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    IA.trace_tick_core.cache_clear()
    lease_engine._static_pack_findings.cache_clear()
    out = dict(cold=ms(lambda: eng._static_bound_check(*args)),
               hit=ms(lambda: eng._static_bound_check(*args)),
               walk=ms(lambda: eng._static_bound_check(args[0] + 1, *args[1:])))
    out["trace"] = ms(lambda: IA.trace_tick_core.__wrapped__(
        eng.n_proposers, eng.n_acceptors, eng.lease_q4, eng.round_q4, eng.guard_q4,
        eng.majority, restart=args[3] > 0))
    check(lease_engine._static_pack_findings.cache_info().hits == 1,
          "phase 3: the gate's second call was no cache hit")
    return out


def edge_scenario(n_cells: int, n_ticks: int = EDGE_TICKS):
    """Restart-mode traffic to the pack bound's edge: each cell attempted
    every 32 ticks by a rotating proposer; proposer P-1 restarted at
    EDGE_RESTARTS and attempting on every cell at the last tick."""
    import numpy as np

    from repro_torch.lease_array import Scenario

    t = np.arange(n_ticks, dtype=np.int64)[:, None]
    n = np.arange(n_cells, dtype=np.int64)[None, :]
    att = np.where((t + n) % 32 == 0, (n + t // 32) % P, -1).astype(np.int32)
    att[-1] = P - 1
    prst = np.zeros((n_ticks, P), np.int32)
    prst[list(EDGE_RESTARTS), P - 1] = 1
    return Scenario.build(n_cells=n_cells, n_acceptors=A, n_proposers=P,
                          attempts=att, prop_restart=prst)


def interval_gate_phase(dev) -> int:
    """Phase 50; returns the unbatched delayed kernel's launches in it."""
    import numpy as np
    import torch

    from repro_torch.analysis.staticcheck import intervals as IA
    from repro_torch.analysis.staticcheck.purity import DELAYED_VARIANTS
    from repro_torch.lease_array import LeaseArrayEngine, Scenario
    from repro_torch.lease_array import engine as lease_engine
    from repro_torch.lease_array import kernel as K
    from repro_torch.lease_array.state import (
        MAX_RESTARTS,
        PACK_MASK,
        RESTART_SHIFT,
        lease_quarters,
        max_pack_tick,
    )

    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize
    lease_q4 = lease_quarters(EDGE_LEASE)
    # the bounds first: derived against the hand formula on the CLI's grid
    bounds = []
    for rate in (4, 9):
        for mr in (0, 1, MAX_RESTARTS):
            hand = max_pack_tick(P, lease_q4, 0, max_rate=rate, max_restarts=mr)
            t0 = time.perf_counter()
            derived = IA.derived_max_pack_tick(P, lease_q4, 0, max_rate=rate,
                                               max_restarts=mr)
            s = time.perf_counter() - t0
            check(derived == hand, f"phase 50: derived bound {derived} != "
                  f"max_pack_tick {hand} at rate {rate}, {mr} restarts")
            bounds.append(f"rate {rate} restarts {mr}: {derived} = {hand} ({s:.2f} s)")
    print(f"phase 50 bounds at P {P}, lease_q4 {lease_q4} (derived = state.max_pack_tick, "
          f"search time): " + "; ".join(bounds), flush=True)
    # each traced core: trace time (uncached) and one walk at the edge's end tick
    cores = [("sync", dict(sync=True), "gather")] + [
        (f"delayed[legs_{legs}" + "".join(f",{n}" for n, on in (
            ("corrupt", c), ("restart", r), ("extend", e)) if on) + "]",
         dict(legs=legs, corrupt=c, restart=r, extend=e), legs)
        for legs, c, r, e in DELAYED_VARIANTS]
    times = []
    for label, kw, legs in cores:
        t0 = time.perf_counter()
        gm = IA.trace_tick_core.__wrapped__(P, A, lease_q4, 4, lease_q4, A // 2 + 1, **kw)
        trace_ms = (time.perf_counter() - t0) * 1e3
        cfg = IA.TickConfig(t_end=EDGE_TICKS, n_proposers=P, n_acceptors=A,
                            lease_q4=lease_q4, sync=kw.get("sync", False),
                            corrupt=kw.get("corrupt", False),
                            max_restarts=MAX_RESTARTS if kw.get("restart") else 0,
                            extend=kw.get("extend", False))
        t0 = time.perf_counter()
        findings = IA.analyze_tick_config(cfg, legs=legs, core=gm,
                                          layout=IA.core_layout(cfg))
        walk_ms = (time.perf_counter() - t0) * 1e3
        check(findings == [], f"phase 50: {label} at t_end {EDGE_TICKS}: {findings}")
        times.append(f"{label} {len(gm.graph.nodes)} nodes, trace {trace_ms:.0f} ms, "
                     f"walk {walk_ms:.1f} ms")
    print("phase 50 traced cores (nodes, make_fx trace, one fixpoint walk at t_end "
          f"{EDGE_TICKS}, no finding): " + "; ".join(times), flush=True)

    def engine(backend, **kw):
        return LeaseArrayEngine(EDGE_N, n_acceptors=A, n_proposers=P,
                                lease_ticks=EDGE_LEASE, backend=backend,
                                device=dev, **kw)

    def replay(sc, **kw):
        """(owners, counts, state..., net...) of the kernel and of plain."""
        outs = []
        for backend in ("cuda", "torch"):
            eng = engine(backend, **kw)
            ow, cn = eng.run_trace(sc)
            sync()
            outs.append((ow, cn, *eng.state, *eng.net))
        for i, (x, y) in enumerate(zip(*outs)):
            check(x.shape == y.shape and torch.equal(x, y),
                  f"phase 50: field {i} of the kernel's replay differs from plain")
        return outs[0], eng

    def refused(sc, match: str, **kw) -> str:
        """The replay raises ``match`` with no allocation on the card and
        no lease launch; returns the message."""
        eng = engine("cuda", **kw)
        sync()
        allocs = torch.cuda.memory_stats().get("allocation.all.allocated", 0)
        launches = (K.lease_window_delayed.launches, K.lease_window_sync.launches)
        try:
            eng.run_trace(sc)
        except ValueError as e:
            msg = str(e)
        else:
            raise AssertionError(f"phase 50: a replay that must be refused ran ({match})")
        check(match in msg, f"phase 50: refused with {msg!r}, not {match!r}")
        check(torch.cuda.memory_stats().get("allocation.all.allocated", 0) == allocs,
              f"phase 50: the refused replay ({match}) allocated on the card")
        check((K.lease_window_delayed.launches, K.lease_window_sync.launches) == launches,
              f"phase 50: the refused replay ({match}) launched a lease kernel")
        check(eng.t == 0, "phase 50: a refused replay advanced the engine")
        return msg

    K.reset_launches()
    # (a) the edge: a restart-mode replay ending at the derived bound
    sc = edge_scenario(EDGE_N)
    hand = max_pack_tick(P, lease_q4, 0, max_restarts=MAX_RESTARTS)
    check(hand == EDGE_TICKS, f"phase 50: max_pack_tick {hand} != {EDGE_TICKS}")
    t0 = time.perf_counter()
    got, eng = replay(sc)
    edge_s = time.perf_counter() - t0
    check(K.lease_window_delayed.launches == 1,
          f"phase 50: the edge replay made {K.lease_window_delayed.launches} delayed launches")
    top = int(got[2].max())  # highest promised ballot
    want = (((EDGE_TICKS) << RESTART_SHIFT) | MAX_RESTARTS) * P + P - 1
    check(top == want, f"phase 50: top ballot {top} != ((1022 << 2) | 3) * 8 + 7 = {want}")
    at_bound = (((EDGE_TICKS + 1) << RESTART_SHIFT) | MAX_RESTARTS) * P + P - 1
    check(int(got[1].max()) <= 1, "phase 50: §4 violated in the edge replay")
    longer = edge_scenario(EDGE_N, EDGE_TICKS + 1)
    msg = refused(longer, "exceeds the packed int32 layout's budget")
    gate = lease_engine._static_pack_findings(
        EDGE_TICKS + 1, P, A, lease_q4, 4, lease_q4, 0, 4, 0, MAX_RESTARTS)
    check(any("pack-budget" in f for f in gate),
          f"phase 50: the gate passes a {EDGE_TICKS + 1}-tick replay: {gate}")
    check(lease_engine._static_pack_findings(
        EDGE_TICKS, P, A, lease_q4, 4, lease_q4, 0, 4, 0, MAX_RESTARTS) == (),
          f"phase 50: the gate refuses the {EDGE_TICKS}-tick edge")
    print(f"phase 50 edge replay (N {EDGE_N}, T {EDGE_TICKS} from t 0, restart mode, "
          f"proposer {P - 1} restarted at ticks {list(EDGE_RESTARTS)}): kernel and plain "
          f"bit-exact in owners, counts, state and net ({edge_s:.1f} s for both); top "
          f"ballot {top} = ((1022 << {RESTART_SHIFT}) | {MAX_RESTARTS}) * {P} + {P - 1}, "
          f"{PACK_MASK - top} below PACK_MASK {PACK_MASK} (the bound counts t_end "
          f"{EDGE_TICKS} inclusively, whose ballot would be {at_bound}: one tick "
          f"conservative here); {EDGE_TICKS + 1} ticks refused by the hand check "
          f"({msg.split(';')[0]}) and by the gate ({len(gate)} finding(s), the first: "
          f"{gate[0]}), nothing allocated on the card, no launch", flush=True)
    del got, eng, sc, longer

    # (b) the round horizon the hand check cannot see
    t = np.arange(100)[:, None]
    n = np.arange(EDGE_N)[None, :]
    hot = Scenario.build(
        n_cells=EDGE_N, n_acceptors=A, n_proposers=P,
        attempts=np.where(t == n % 3, n % P, -1).astype(np.int32),
        delay=np.ones((100, A), np.int32))
    msg = refused(hot, "static analysis refused", round_ticks=HUGE_ROUND_TICKS)
    before = K.lease_window_delayed.launches
    got, eng = replay(hot[:3], round_ticks=HUGE_ROUND_TICKS)
    check(K.lease_window_delayed.launches == before + 1,
          "phase 50: the 3-tick round-horizon replay did not launch the delayed kernel")
    check(int(got[1].max()) <= 1, "phase 50: §4 violated at the huge round horizon")
    print(f"phase 50 round horizon {HUGE_ROUND_TICKS} ticks (N {EDGE_N}, delay 1): 100 "
          f"ticks refused before any allocation or launch ({msg.splitlines()[0]} / "
          f"{msg.splitlines()[1].strip()[:120]}); 3 ticks through the delayed kernel "
          f"bit-exact against plain", flush=True)
    check(lease_engine._STATIC_CHECK_FAILED is False,
          "phase 50: the static analyzer failed (and warned) on some configuration")
    launches = K.lease_window_delayed.launches
    print(f"phase 50 took {time.perf_counter() - t_phase:.1f} s; delayed kernel launches "
          f"{launches}", flush=True)
    return launches


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
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.rwkv6 import _build as wkv_build
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
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
    with ThreadPoolExecutor(len(BUILD_ACCEPTORS) + 3) as pool:
        flash_lib = pool.submit(flash_build.build)
        wkv_lib = pool.submit(wkv_build.build)
        empty_lib = pool.submit(build_empty_kernel)  # phase 19's launch floor
        libs = list(pool.map(_build.build, BUILD_ACCEPTORS))
        flash_lib, wkv_lib = flash_lib.result(), wkv_lib.result()
        empty_lib.result()
    for a in BUILD_ACCEPTORS:
        _build.load(a)
    flash_build.load()
    wkv_build.load()
    build_s = time.perf_counter() - t0
    stamp("the build")
    print(f"phase 1 build: {build_s:.1f} s; " + "; ".join(
        f"{lib.name}: {ptxas_summary(lib.with_suffix('.log').read_text())}"
        for lib in libs), flush=True)
    flash_log = flash_lib.with_suffix(".log").read_text()
    serialized = sorted({flash_kind(line) for line in flash_log.splitlines()
                         if "C7512" in line and "wgmma_kernel" in line})
    # the fp32 kernel takes its products on the tensor cores (HMMA, TF32)
    # and its tiles by cp.async (LDGSTS), at every head width
    flash_ops, hmma_forms = {}, set()
    flash_sass = sass_functions(library_sass(flash_lib))
    for name, ins in flash_sass.items():
        if "flash_fwd_kernel" in name:
            flash_ops[flash_kind(name)] = {op: sum(o.startswith(op) for _, _, o, _ in ins)
                                           for op in ("HMMA", "LDGSTS", "LDSM")}
            hmma_forms |= {o for _, _, o, _ in ins if o.startswith("HMMA")}
    check(len(flash_ops) == len(flash_kernel.HEAD_DIMS), f"{flash_lib.name}: fp32 entries "
          f"{sorted(flash_ops)}")
    for kind, ops in flash_ops.items():
        check(ops["HMMA"] > 0 and ops["LDGSTS"] > 0,
              f"{flash_lib.name}: {kind} holds {ops['HMMA']} HMMA, {ops['LDGSTS']} LDGSTS")
    check(all("TF32" in form for form in hmma_forms),
          f"{flash_lib.name}: fp32 entries issue {sorted(hmma_forms)}, not only TF32 HMMA")
    # the backward's bf16 passes take their products on wgmma (HGMMA) and
    # their tiles by TMA (UTMALDG), with no mma.sync (HMMA); its fp32
    # passes take theirs as TF32 mma.sync (HMMA) and their tiles by
    # cp.async (LDGSTS), with neither HGMMA nor UTMALDG; D's holds none
    bwd_ops, bwd_forms = {}, set()
    for name, ins in flash_sass.items():
        if "bwd_" in name:
            kind = flash_kind(name)
            bwd_ops[kind] = {op: sum(o.startswith(op) for _, _, o, _ in ins)
                             for op in ("HGMMA", "UTMALDG", "HMMA", "LDGSTS")}
            if kind.startswith("bwd-f32"):
                bwd_forms |= {o for _, _, o, _ in ins if o.startswith("HMMA")}
    check(len(bwd_ops) == 2 * len(flash_kernel.HEAD_DIMS) + 2 * 2 + 1,
          f"{flash_lib.name}: backward entries {sorted(bwd_ops)}")
    for kind, ops in bwd_ops.items():
        wgmma, tf32 = kind.startswith("bwd-wgmma"), kind.startswith("bwd-f32")
        check((ops["HGMMA"] > 0) == (ops["UTMALDG"] > 0) == wgmma
              and (ops["HMMA"] > 0) == (ops["LDGSTS"] > 0) == tf32,
              f"{flash_lib.name}: {kind} holds {ops}")
    check(bwd_forms and all("TF32" in form for form in bwd_forms),
          f"{flash_lib.name}: fp32 backward passes issue {sorted(bwd_forms)}, not only TF32 HMMA")
    # the fp32 passes at every head width: registers, spills (none), and
    # the dynamic shared memory a block, as the library reports it
    flash_dll = flash_build.load()
    bwd32 = {k: v for k, v in ptxas_table(flash_log, flash_kind).items()
             if k.startswith("bwd-f32")}
    check(len(bwd32) == 2 * len(flash_kernel.HEAD_DIMS)
          and all(s == 0 for _, s in bwd32.values()),
          f"{flash_lib.name}: fp32 backward passes spill: {bwd32}")
    print(f"phase 1 build: {flash_lib.name} fp32 backward passes (3xTF32 on mma.sync; "
          f"registers / spilled / dynamic shared memory a block, SASS HMMA / LDGSTS): "
          + ", ".join(f"{k} {r} / {s} B / "
                      f"{flash_dll.flash_bwd_f32_smem_bytes(int(k.split('Dh')[1]), 'dq/' in k)}"
                      f" B, {bwd_ops[k]['HMMA']} / {bwd_ops[k]['LDGSTS']}"
                      for k, (r, s) in sorted(bwd32.items(), key=lambda kv: (
                          kv[0].split("/")[0], int(kv[0].split("Dh")[1]))))
          + f" ({', '.join(sorted(bwd_forms))})", flush=True)
    print(f"phase 1 build: {flash_lib.name} (dynamic shared memory a block, as the "
          f"library reports it: fp32-3xtf32 " + ", ".join(
              f"{flash_dll.flash_fwd_f32_smem_bytes(dh)} B at Dh {dh}" for dh in (64, 128))
          + f"; bf16-wgmma {wgmma_smem_bytes(64)} B at Dh<=64, {wgmma_smem_bytes(128)} B at "
          f"Dh<=128; fp32 SASS HMMA / LDGSTS / LDSM at Dh 128: "
          + " / ".join(str(flash_ops["fp32-3xtf32/Dh128"][op]) for op in ("HMMA", "LDGSTS", "LDSM"))
          + f" ({', '.join(sorted(hmma_forms))})"
          + "; bf16 backward SASS HGMMA / UTMALDG: " + ", ".join(
              f"{k} {v['HGMMA']} / {v['UTMALDG']}" for k, v in sorted(bwd_ops.items())
              if k.startswith("bwd-wgmma"))
          + f"; wgmma serialized by ptxas (C7512) in: {', '.join(serialized) or 'none'}): "
          + ptxas_summary(flash_log, flash_kind), flush=True)
    # the tensor-core kernel issues mma.sync (HMMA) and cp.async (LDGSTS);
    # the CUDA-core one takes its stages by bulk copies (UBLKCP) and issues
    # neither
    wkv_ops, wkv_sass_ops = {}, ("HMMA", "LDGSTS", "UBLKCP")
    wkv_sass = sass_functions(library_sass(wkv_lib))
    for name, ins in wkv_sass.items():
        kind = wkv_kind(name)
        for op in wkv_sass_ops:
            wkv_ops[kind, op] = wkv_ops.get((kind, op), 0) + sum(
                o.startswith(op) for _, _, o, _ in ins)
    # the backward's state and chunk passes take their products on the
    # tensor cores (HMMA, of the TF32 form only) and their tiles by cp.async
    # (LDGSTS); its sum pass issues neither, and none of its passes bulk
    # copies
    wkv_bwd_forms = set()
    for name, ins in wkv_sass.items():
        if wkv_kind(name).startswith("bwd"):
            wkv_bwd_forms |= {o for _, _, o, _ in ins if o.startswith("HMMA")}
    for (kind, op), count in wkv_ops.items():
        if kind.startswith("bwd"):
            want = op != "UBLKCP" and not kind.startswith("bwd-sum")
        else:
            want = kind.startswith("bf16-mma") != (op == "UBLKCP")
        check((count > 0) == want, f"{wkv_lib.name}: {kind} holds {count} {op} instructions")
    check(wkv_bwd_forms and all("TF32" in form for form in wkv_bwd_forms),
          f"{wkv_lib.name}: backward passes issue {sorted(wkv_bwd_forms)}, not only TF32 HMMA")
    wkv_log = wkv_lib.with_suffix(".log").read_text()
    wkv_bwd = {k: v for k, v in ptxas_table(wkv_log, wkv_kind).items() if k.startswith("bwd")}
    check(len(wkv_bwd) == 3 * 2 * len(wkv_kernel.HEAD_SIZES)
          and all(s == 0 for _, s in wkv_bwd.values()),
          f"{wkv_lib.name}: backward passes {sorted(wkv_bwd)} spill: {wkv_bwd}")
    # the dynamic shared memory each entry launches a block with, as the
    # built library reports it
    wkv_dll = wkv_build.load()
    print(f"phase 1 build: {wkv_lib.name} (dynamic shared memory a block: " + "; ".join(
        f"{entry} " + ", ".join(f"{getattr(wkv_dll, entry + '_smem_bytes')(n)} B at N {n}"
                                for n in (16, 32, 64, 128))
        for entry in wkv_build.ENTRY_POINTS)
          + "; backward passes state / chunk, fp32 and bf16: " + ", ".join(
              f"N {n} " + " / ".join(f"{wkv_dll.wkv6_bwd_smem_bytes(n, c, p)}"
                                     for c in (0, 1) for p in (0, 1)) + " B"
              for n in (16, 32, 64, 128))
          + "; SASS " + " / ".join(wkv_sass_ops) + " " + ", ".join(
              f"{kind} " + " / ".join(str(wkv_ops[kind, op]) for op in wkv_sass_ops)
              for kind in sorted({k for k, _ in wkv_ops}))
          + "): " + ptxas_summary(wkv_log, wkv_kind), flush=True)

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
    gate = gate_costs(eng3, sc3)
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
    print(f"phase 3 static gate (interval analysis of the traced delayed tick core, "
          f"before the run_trace above): cold {gate['cold']:.1f} ms (the trace "
          f"{gate['trace']:.1f} ms and the first walk; caches cleared, torch's tracer "
          f"already warm from phase 2), a cache hit {gate['hit']:.4f} ms, a fresh walk "
          f"for a new end tick {gate['walk']:.1f} ms ({gate['walk'] / ms_run3 * 100:.2f} % "
          f"of the run_trace's {ms_run3:.1f} ms)", flush=True)
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
                             f"delayed_window_kernelILi{A}ELb1ELb0ELb0ELi0E")
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
    tick_s = kernel_tick_ops(_build.library_path(A),
                             f"sync_window_kernelILi{A}EE")
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
    stamp("phases 1-7")
    kernels.extend(lm_slice(dev))
    torch.cuda.empty_cache()  # the internlm weights are gone; rwkv6-3b's take 12.4 GB
    stamp("phases 8-12")
    kernels.extend(rwkv_slice(dev))
    torch.cuda.empty_cache()
    stamp("phases 13-17")
    referee_phase(dev)
    kernels.extend(sweep_slice(dev))
    stamp("phases 18-19")
    t_new = time.perf_counter()
    by_name = {k["name"]: k for k in kernels}
    for name, n in falsify_phase(dev).items():
        by_name[name]["launches"] += n
    by_name["lease_window_delayed"]["launches"] += directory_phase(dev)
    print(f"phases 20-21 took {time.perf_counter() - t_new:.1f} s", flush=True)
    services_phase()
    stamp("phases 20-22")
    leaselint_phase(libs)
    torch.cuda.empty_cache()
    stamp("phase 23")
    for slice_ in (moe_hybrid_slice, enc_dec_vision_slice):
        worst, launches = slice_(dev)
        for dtn, name in (("bfloat16", "flash_attention_bhsd"),
                          ("float32", "flash_attention_bhsd_fp32")):
            entry = flash_kernel.KERNELS[{"bfloat16": torch.bfloat16,
                                          "float32": torch.float32}[dtn]]
            by_name[name]["launches"] += launches[entry]
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], worst[dtn])
        torch.cuda.empty_cache()
    stamp("phases 24-41")
    train_rows, launches = train_slice(dev)
    for entry, name in ((flash_kernel.KERNELS[torch.bfloat16], "flash_attention_bhsd"),
                        (flash_kernel.KERNELS[torch.float32], "flash_attention_bhsd_fp32")):
        by_name[name]["launches"] += launches[entry]
    kernels.extend(train_rows)
    torch.cuda.empty_cache()
    stamp("phases 42-45")
    rwkv_rows, launches = rwkv_train_slice(dev)
    for entry, name in ((wkv_kernel.KERNELS[torch.bfloat16], "wkv6_bhsn"),
                        (wkv_kernel.KERNELS[torch.float32], "wkv6_bhsn_fp32")):
        by_name[name]["launches"] += launches[entry]
    kernels.extend(rwkv_rows)
    stamp("phases 46-49")
    by_name["lease_window_delayed"]["launches"] += interval_gate_phase(dev)
    stamp("phase 50")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(profiled_plans() if sys.argv[1:] == ["--profiled-plans"] else main())
