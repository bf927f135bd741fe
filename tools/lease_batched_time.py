#!/usr/bin/env python3
"""The batched lease entries' own device time on the card, and another
source of ``lease_window.cu`` timed against the port's in turns.

    python3 tools/lease_batched_time.py [--src SRC] [--lanes] [OTHER.cu ...]

At phase 19a's bench sweep of ``chip_smoke.py`` (1024 scenarios x 32 cells
x 16 ticks, A 3, P 4: zero delay for ``lease_window_sync_batched``, delay
<= 2 with drops for ``lease_window_delayed_batched``), in both collect
modes, it prints each entry's time three ways: the kernel's own duration
under ``torch.profiler`` ("device"), a call inside a CUDA graph of 20
back-to-back calls ("graph": the launch gap stays in, the host does not
pace it), and CUDA events around 20 calls from Python ("host-paced", the
per-call figure ``chip_smoke.py`` printed before), and the wrapper's own
host cost ("wrapper": the median over 5 blocks of the mean host time of
400 back-to-back calls with no synchronisation between them, which is
the Python cost of a call wherever it exceeds the kernel's); and the
same for an empty kernel, the launch floor. At phase 19b's chaos sweep (64
scenarios x 2^14 cells x 128 ticks, A 5, P 8, extends and restarts,
summary) it prints the delayed entry's device time and its time by CUDA
events over 5 calls. Each delayed line also gives ``ticked``, the
cell-ticks that ran the tick math. ``--lanes`` adds the delayed entry at
every lane count G of ``kernel.lane_counts`` at both sweeps and at the
smaller sweeps where the plan's rule leaves G 1 (``BENCH_LADDER``: the
bench sweep's first b scenarios; ``CHAOS_CELLS``: the chaos sweep's first
scenario cut to n cells, and its first 1 and 4 scenarios whole; "shrink":
the falsifier's shrinker, one scenario of ``FalsifyConfig``'s canonical
cell, 4 cells, A 3, 16 ticks), beside the plan's own choice
(``lanes=None``): the times the plan's rule is taken from (it needs this
tree's Python, not ``--src``'s); and the host time of the shrinker's
``LeaseArrayEngine.sweep`` with the plan held at each G in turns
(1, 2, 4, 4, 2, 1). Then, end to end,
the host time of one ``LeaseArrayEngine.sweep`` of the zero-delay bench
sweep in each collect mode (``host_ms`` over 100 calls, each ended by a
device synchronisation).

``--src SRC`` imports the port from another tree's ``src`` (an earlier
commit's, from ``git archive``), so that its Python is timed by this
script. Each OTHER.cu (an earlier commit's ``csrc/lease_window.cu``, from
``git show``) is built for A 3 and 5 into its own libraries, held
bit-exact against the port's and timed in turns with it (port, the
others, the others in reverse, port), the kernels and the sweeps alike.
An OTHER.cu without ``delayed_batched_kernel`` (one written before it)
takes its batched delayed launches in the geometry it was built for: a
thread a cell, min(kBlock, N rounded up to a warp) threads a block,
blockIdx.y the scenario. The card's name and power limit come first.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "lease_batched_time"
ENTRIES = {"lease_window_sync_batched": (False, "sync_"),
           "lease_window_delayed_batched": (True, "delayed_")}
#: the bench sweep's first scenarios (32 cells each) the lane sweep also
#: times, and the cell counts its chaos scenario is cut to
BENCH_LADDER = (1, 8, 32, 128, 256, 512)
CHAOS_CELLS = (4, 256, 1024, 4096)


def build_other(src: Path, name: str, n_acceptors: int) -> ctypes.CDLL:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library
    from repro_torch.lease_array import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}_a{n_acceptors}.so"
    lib.unlink(missing_ok=True)
    compile_library(lib, [src], [*NVCC_FLAGS, f"-DLEASE_ACCEPTORS={n_acceptors}"])
    dll = ctypes.CDLL(str(lib))
    for entry in _build.ENTRY_POINTS:
        getattr(dll, entry).argtypes = [ctypes.c_void_p] * 3
        getattr(dll, entry).restype = ctypes.c_int
    return dll


def cell_batched_plan(plan):
    """The batched delayed launch of a source from before
    ``delayed_batched_kernel``: ``kernel._cell_plan``'s one-cell-a-thread
    geometry with the scenario as grid.y."""
    from repro_torch.lease_array import kernel as K

    one = K._cell_plan(plan.entry, plan.n_acceptors, plan.n_cells, plan.n_proposers,
                       plan.n_ticks, plan.tw, True, plan.variant)
    return one._replace(batch=plan.batch, collect=plan.collect,
                        grid=(one.grid[0], plan.batch))


def first_cells(args, kw, n):
    """The batched delayed kernel's arguments cut to each scenario's first
    ``n`` cells: the state's columns and the per-cell planes (attempts,
    releases, extends) on their trailing cell axis."""
    def cut(x):
        return None if x is None else x[..., :n].contiguous()

    packed, net, t0, att, rel, *rest = args
    return ((type(packed)(*map(cut, packed)), type(net)(*map(cut, net)), t0,
             cut(att), cut(rel), *rest),
            {k: cut(x) if k == "extends" else x for k, x in kw.items()})


def shrink_setup():
    """The falsifier shrinker's sweep: an engine of ``FalsifyConfig``'s
    canonical cell and one generation-0 scenario of it."""
    import numpy as np

    from repro_torch.lease_array import Scenario
    from repro_torch.lease_array.falsify.search import FalsifyConfig, random_population

    cfg = FalsifyConfig(pop_size=1)
    return cfg.engine(), Scenario(random_population(np.random.default_rng(cfg.seed), cfg))


@contextlib.contextmanager
def held_lanes(held: int):
    """The batched delayed wrapper launches at ``held`` lanes a cell
    whatever its caller asks."""
    from unittest import mock

    from repro_torch.lease_array import kernel as K

    plan_fn = K.delayed_batched_launch_plan

    def plan(*args, lanes=None, **kw):
        return plan_fn(*args, lanes=held, **kw)

    with mock.patch.object(K, "delayed_batched_launch_plan", plan):
        yield


@contextlib.contextmanager
def using(libs: dict, one_cell: bool):
    """The lease wrappers launch ``libs`` ({A: CDLL}); the batched delayed
    one in the one-cell-a-thread geometry where ``one_cell``."""
    from unittest import mock

    from repro_torch.lease_array import _build
    from repro_torch.lease_array import kernel as K

    plan_fn = K.delayed_batched_launch_plan
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(_build, "load", lambda a: libs[a]))
        if one_cell:
            stack.enter_context(mock.patch.object(
                K, "delayed_batched_launch_plan",
                lambda *a, **k: cell_batched_plan(plan_fn(*a, **k))))
        yield


def wrapper_us(fn, calls: int = 400, blocks: int = 5) -> float:
    """Median over ``blocks`` of the mean host time (µs) of ``calls``
    back-to-back calls of ``fn``, synchronised only between blocks."""
    import statistics
    import time

    import torch

    means = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return statistics.median(means)


def main() -> int:
    import torch

    argv = sys.argv[1:]
    src = ROOT / "src"
    if argv[:1] == ["--src"]:
        src, argv = Path(argv[1]).resolve(), argv[2:]
    lanes_sweep = "--lanes" in argv
    argv = [a for a in argv if a != "--lanes"]
    sys.path[:0] = [str(ROOT), str(src)]
    import chip_smoke as CS
    from repro_torch.lease_array import Scenario, _build
    from repro_torch.lease_array import kernel as K

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = {"port": ({a: _build.load(a) for a in (3, 5)}, False)}
    print(f"port from {src}", flush=True)
    for a in (3, 5):
        log = _build.library_path(a).with_suffix(".log")
        print(f"port A {a}: {CS.ptxas_summary(log.read_text())}", flush=True)
    with ThreadPoolExecutor(2 * len(argv) or 1) as pool:  # one nvcc a library, together
        built = {(i, a): pool.submit(build_other, Path(other), f"other{i}", a)
                 for i, other in enumerate(argv) for a in (3, 5)}
        for i, other in enumerate(map(Path, argv)):
            one_cell = "delayed_batched_kernel" not in other.read_text()
            libs[f"other{i}"] = ({a: built[i, a].result() for a in (3, 5)}, one_cell)
            print(f"other{i}: {other}" + (" (one cell a thread)" if one_cell else "")
                  + "".join(f"; A {a}: " + CS.ptxas_summary(
                      (OUT / f"libother{i}_a{a}.log").read_text()) for a in (3, 5)),
                  flush=True)

    # (sweep, entry, collect, lanes) -> (call, ticked call or None)
    calls, sweeps = {}, {}

    def add(sweep, entry, collect, args, kw, lanes=None):
        fn = getattr(K, entry)
        extra = {} if lanes is None else {"lanes": lanes}
        ticked = torch.zeros(1, dtype=torch.int64, device=dev)
        calls[sweep, entry, collect, lanes] = (
            lambda: fn(*args, **kw, **extra),
            (lambda: (ticked.zero_(), fn(*args, **kw, **extra, ticked=ticked), int(ticked))[2])
            if entry == "lease_window_delayed_batched" else None)
        if entry == "lease_window_delayed_batched" and lanes is None and lanes_sweep:
            (n_acc, n), (b, t) = args[0].promised.shape, args[3].shape[:2]
            plan = K.delayed_batched_launch_plan(
                n_acc, n, kw["n_proposers"], t, b, variant=K.plane_groups(kw),
                collect=collect, sms=K._sm_count(dev))
            print(f"{sweep} sweep, {collect}: the plan takes G {plan.lanes} "
                  f"({K._sm_count(dev)} SMs)", flush=True)

    for entry, (delayed, _) in ENTRIES.items():
        eng, stacked = CS.bench_sweep_setup(dev, delayed)
        if not delayed:
            for collect in ("summary", "owners"):
                sweeps[collect] = (lambda e, sc, c: lambda: e.sweep(sc, collect=c))(
                    eng, stacked, collect)
        for collect in ("summary", "owners"):
            args, kw = CS.batched_kernel_args(eng, stacked, delayed, collect, dev)
            add("bench", entry, collect, args, kw)
            if delayed and collect == "summary" and lanes_sweep:
                for g in K.lane_counts(3):
                    add("bench", entry, collect, args, kw, g)
                # fewer scenarios: where spreading a cell over lanes could pay
                for b in BENCH_LADDER:
                    few = CS.first_scenarios(args, kw, True, b)
                    for g in (None, *K.lane_counts(3)):
                        add(f"bench/{b}", entry, collect, *few, g)
    delayed_entry = "lease_window_delayed_batched"
    eng_c, scs_c, _ = CS.chaos_sweep_setup(dev)
    args, kw = CS.batched_kernel_args(eng_c, Scenario.stack(scs_c), True, "summary", dev)
    add("chaos", delayed_entry, "summary", args, kw)
    if lanes_sweep:
        for g in K.lane_counts(5):
            add("chaos", delayed_entry, "summary", args, kw, g)
        cuts = {f"chaos/1x{n}": first_cells(*CS.first_scenarios(args, kw, True, 1), n)
                for n in CHAOS_CELLS}
        cuts.update({f"chaos/{b}": CS.first_scenarios(args, kw, True, b) for b in (1, 4)})
        eng_s, sc_s = shrink_setup()
        cuts["shrink"] = CS.batched_kernel_args(eng_s, sc_s, True, "summary", dev)
        for sweep, (a, k) in cuts.items():
            for g in (None, *K.lane_counts(a[0].promised.shape[0])):
                add(sweep, delayed_entry, "summary", a, k, g)

    want = {}
    order = list(libs) + list(libs)[:0:-1] + ["port"] if len(libs) > 1 else ["port"]
    for name in order:
        lib, one_cell = libs[name]
        with using(lib, one_cell):
            for key, (fn, ticked_fn) in calls.items():
                sweep, entry, collect, lanes = key
                if lanes is not None and name != "port":
                    continue
                got = fn()
                torch.cuda.synchronize()
                base = (sweep, entry, collect, None)
                if name == "port" and lanes is None:
                    want[base] = got
                else:
                    CS.check(all(torch.equal(x, y) for x, y in zip(got, want[base])),
                             f"{name} {key}: differs from the port's")
                device = CS.kernel_device_ms(fn, ENTRIES[entry][1])
                text = (f"{name} {sweep} {entry} {collect}"
                        + ("" if lanes is None else f" G {lanes}") + ": device "
                        + ("not measured" if device is None else f"{device:.5f}") + " ms")
                if sweep in ("bench", "bench/128"):
                    text += (f", graph {CS.graph_ms(fn):.5f} ms, host-paced "
                             f"{CS.time_ms(fn, 20):.5f} ms, wrapper {wrapper_us(fn):.2f} us")
                else:
                    text += f", events {CS.time_ms(fn, 5):.4f} ms"
                if ticked_fn is not None:
                    text += f", ticked {ticked_fn()}"
                print(text, flush=True)
    want_sweep, times = {}, {}
    for name in order:
        lib, one_cell = libs[name]
        with using(lib, one_cell):
            for collect, fn in sweeps.items():
                res = fn()
                got = (res.owned_frac, res.max_owner_count, res.final_owners)
                if name == "port":
                    want_sweep[collect] = got
                else:
                    CS.check(all(torch.equal(x, y) for x, y in zip(got, want_sweep[collect])),
                             f"{name} sweep {collect}: verdicts differ from the port's")
                times.setdefault(collect, []).append(f"{name} {CS.host_ms(fn, 100):.4f}")
    for collect, ts in times.items():
        print(f"LeaseArrayEngine.sweep, bench sweep, zero delay, {collect}: host ms a call "
              "in turns: " + ", ".join(ts), flush=True)
    if lanes_sweep:
        eng_s, sc_s = shrink_setup()
        gs = K.lane_counts(3)
        verdicts, ts = {}, []
        for g in (*gs, *gs[::-1]):
            with held_lanes(g):
                def fn():
                    return eng_s.sweep(sc_s, verify=False)

                res = fn()
                verdicts.setdefault("want", (res.max_owner_count, res.final_owners))
                CS.check(all(torch.equal(x, y) for x, y in zip(
                    (res.max_owner_count, res.final_owners), verdicts["want"])),
                    f"shrinker's sweep at G {g}: verdicts differ")
                ts.append(f"G {g} {CS.host_ms(fn, 100):.4f}")
        print("LeaseArrayEngine.sweep, the shrinker's scenario (1 x 4 cells, A 3), summary: "
              "host ms a call in turns: " + ", ".join(ts), flush=True)
    floor = CS.launch_floor()
    print("empty kernel: " + ", ".join(
        f"{k} " + ("not measured" if v is None else f"{v:.5f}") + " ms"
        for k, v in floor.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
