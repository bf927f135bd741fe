#!/usr/bin/env python3
"""The batched lease entries' own device time at the bench sweep, on the card.

    python3 tools/lease_batched_time.py [--src SRC] [OTHER.cu ...]

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
same for an empty kernel, the launch floor. Then, end to end, the host
time of one ``LeaseArrayEngine.sweep`` of the zero-delay bench sweep in
each collect mode (the path that launches the sync entry once;
``host_ms`` over 100 calls, each ended by a device synchronisation).
``--src SRC`` imports the port from another tree's ``src`` (an earlier
commit's, from ``git archive``), so that its Python is timed by this
script: run it with and without, in turns, to compare two commits. Each OTHER.cu (an earlier
commit's ``csrc/lease_window.cu``, from ``git show``) is built for A 3 into
its own library, held bit-exact against the port's and timed in turns with
it (port, the others, the others in reverse, port), the kernels and the
sweeps alike. The card's name and power limit come first.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "lease_batched_time"
ENTRIES = {"lease_window_sync_batched": (False, "sync_"),
           "lease_window_delayed_batched": (True, "delayed_")}


def build_other(src: Path, name: str) -> ctypes.CDLL:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library
    from repro_torch.lease_array import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    lib.unlink(missing_ok=True)
    compile_library(lib, [src], [*NVCC_FLAGS, "-DLEASE_ACCEPTORS=3"])
    dll = ctypes.CDLL(str(lib))
    for entry in _build.ENTRY_POINTS:
        getattr(dll, entry).argtypes = [ctypes.c_void_p] * 3
        getattr(dll, entry).restype = ctypes.c_int
    return dll


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
    sys.path[:0] = [str(ROOT), str(src)]
    import chip_smoke as CS
    from repro_torch.lease_array import _build
    from repro_torch.lease_array import kernel as K

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = {"port": _build.load(3)}
    print(f"port from {src}", flush=True)
    for i, other in enumerate(map(Path, argv)):
        libs[f"other{i}"] = build_other(other, f"other{i}")
        print(f"other{i}: {other}", flush=True)
    calls, sweeps = {}, {}
    for entry, (delayed, _) in ENTRIES.items():
        eng, stacked = CS.bench_sweep_setup(dev, delayed)
        if not delayed:
            for collect in ("summary", "owners"):
                sweeps[collect] = (lambda e, sc, c: lambda: e.sweep(sc, collect=c))(
                    eng, stacked, collect)
        for collect in ("summary", "owners"):
            args, kw = CS.batched_kernel_args(eng, stacked, delayed, collect, dev)
            calls[entry, collect] = (lambda fn, a, k: lambda: fn(*a, **k))(
                getattr(K, entry), args, kw)
    load = _build.load
    want = {}
    order = list(libs) + list(libs)[:0:-1] + ["port"] if len(libs) > 1 else ["port"]
    try:
        for name in order:
            _build.load = lambda a, lib=libs[name]: lib
            for (entry, collect), fn in calls.items():
                got = fn()
                torch.cuda.synchronize()
                if name == "port":
                    want[entry, collect] = got
                else:
                    CS.check(all(torch.equal(x, y) for x, y in zip(got, want[entry, collect])),
                             f"{name} {entry} {collect}: differs from the port's")
                device = CS.kernel_device_ms(fn, ENTRIES[entry][1])
                print(f"{name} {entry} {collect}: device "
                      + ("not measured" if device is None else f"{device:.5f}")
                      + f" ms, graph {CS.graph_ms(fn):.5f} ms, host-paced "
                      f"{CS.time_ms(fn, 20):.5f} ms, wrapper {wrapper_us(fn):.2f} us",
                      flush=True)
        want_sweep, times = {}, {}
        for name in order:
            _build.load = lambda a, lib=libs[name]: lib
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
    finally:
        _build.load = load
    floor = CS.launch_floor()
    print("empty kernel: " + ", ".join(
        f"{k} " + ("not measured" if v is None else f"{v:.5f}") + " ms"
        for k, v in floor.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
