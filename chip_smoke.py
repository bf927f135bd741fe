#!/usr/bin/env python3
"""Drive the PyTorch/CUDA lease plane once on an NVIDIA card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (``nvcc``); it exits nonzero
without them, and on any failed check.

Phases (one line each):
  1. build the lease kernels from ``src/repro_torch/lease_array/csrc``;
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
The last line is ``{"ok": true, "device": {...}}``.
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

    from repro_torch.lease_array import _build

    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc_path()).with_name("cuobjdump"))
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


def ptxas_summary(log: str) -> str:
    """Most registers and total spill bytes per kernel family, from the
    ``-Xptxas -v`` report kept beside a built library."""
    regs, spills, kind = {}, {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kind = "delayed" if "delayed" in line else "sync"
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
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILD_ACCEPTORS)) as pool:
        libs = list(pool.map(_build.build, BUILD_ACCEPTORS))
    for a in BUILD_ACCEPTORS:
        _build.load(a)
    build_s = time.perf_counter() - t0
    print(f"phase 1 build: {build_s:.1f} s; " + "; ".join(
        f"{lib.name}: {ptxas_summary(lib.with_suffix('.log').read_text())}"
        for lib in libs), flush=True)

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
    def time_ms(fn, reps):
        fn()  # warm
        sync()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        sync()
        return start.elapsed_time(stop) / reps

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
