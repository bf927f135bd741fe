"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
everything it names is found by name under ``portbench/`` (see
``pbench/harness.py``). The system under test is ``repro_torch`` under
``src/``, which this script puts on the path; nothing here imports JAX or
the package the port was made from, and a run that finds either loaded
fails. Caches of the program's builds stay inside the checkout.

The last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, last, ``checks``: every number
compared beside its limit, which also end standard error. Without a card,
or with fewer cards than the cell asks for, the run exits with 2 and
prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "portbench_cache"


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[key] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    for path in (str(ROOT / "src"), str(BENCH)):
        if path not in sys.path:
            sys.path.insert(0, path)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        cell=None, t_start: float = T_START) -> dict:
    """One run; returns the result dict (without printing it). ``cell`` may
    be given in place of its name (tests pass a small one)."""
    import math

    from pbench import harness

    if cell is None:
        cell = harness.load_cell(cell_name)
    out = harness.driver(cell).run(cell, seed, seconds, trace, device, t_start)
    correct, checks = harness.judge(out["readings"], cell.limits)
    if trace:
        ctx = dict(out["ctx"], cell_spec=cell.spec)
        metrics = {}
        for m in cell.per_layer:
            value = harness.read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_info = harness.device_info(cell.spec["chips"], out["peak_bytes"])
    result = {"correct": bool(correct and out["failed"] == 0
                              and all(math.isfinite(v["value"]) for v in metrics.values())),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    tr = out["ctx"].get("trace")
    if trace and tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from pbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.spec["chips"]:
        print(f"portbench: needs {cell.spec['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: modules that may not be loaded in a run: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
