"""What every cell shares: the cell's files found by name, the program's
configuration built from the configuration file, the device trace reduced
to busy time, kernel time by name and idle gaps, the per-layer readers,
the checks against their limits, and the result line.

The harness is driven by data. A cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration, whose file is
``configs/<config>.json`` and whose plain reference is
``pbench/reference/<its "reference">.py``, and a traffic mix,
``traffic/<traffic>.json``, whose ``kind`` names the driver
``pbench/drivers/<kind>.py``. Its limits are ``limits/<cell>.json``, and
each per-layer metric is read by ``metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
#: top-level module names that may not be loaded in a run: the JAX stack and
#: the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
TOP_OPS = 10
TOP_GAPS = 10


@dataclass
class Cell:
    name: str
    spec: dict          # the workloads entry
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<cell>.json
    end_to_end: list    # the cell's end-to-end metric entries
    per_layer: list     # the cell's per-layer metric entries

    @property
    def model(self) -> dict:
        return self.config["model"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read_json(root / "BENCHMARK.json")
    spec = next((w for w in bench["workloads"] if w["name"] == name), None)
    if spec is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    return Cell(name=name, spec=spec, config=_read_json(root / conf["file"]),
                traffic=_read_json(BENCH_DIR / "traffic" / f"{spec['traffic']}.json"),
                limits=_read_json(BENCH_DIR / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer)


def reference(cell: Cell):
    return importlib.import_module(f"pbench.reference.{cell.config['reference']}")


def driver(cell: Cell):
    return importlib.import_module(f"pbench.drivers.{cell.traffic['kind']}")


def program_config(model: dict):
    """The program's ``ModelConfig`` for the configuration file's model."""
    from repro_torch.configs.base import ModelConfig, RWKVConfig

    fields = dict(model)
    if fields.get("rwkv") is not None:
        fields["rwkv"] = RWKVConfig(**fields["rwkv"])
    return ModelConfig(**fields)


# ---------------------------------------------------------------------------
# The device trace
# ---------------------------------------------------------------------------
@dataclass
class Trace:
    """A traced window: device kernels (name, start s, seconds), the
    host's events (name, start, end), its length, and what ran in it."""
    window_s: float
    kernels: list
    host: list
    units: int                       # steps or requests traced
    extra: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, -math.inf
        for _, start, dur in sorted(self.kernels, key=lambda k: k[1]):
            stop = start + dur
            if stop > end:
                busy += stop - max(start, end)
                end = stop
        return busy

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match(name)`` accepts."""
        return sum(dur for name, _, dur in self.kernels if match(name))

    def launches(self) -> int:
        return sum(1 for name, _, _ in self.kernels if not name.startswith(("Memcpy", "Memset")))

    def top_ops(self) -> list:
        by: dict = {}
        for name, _, dur in self.kernels:
            by[name] = by.get(name, 0.0) + dur
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP_OPS]]

    def idle_gaps(self) -> list:
        """The device's idle time, summed by what the host was doing in it:
        the innermost host event running at each gap's middle."""
        ks = sorted(self.kernels, key=lambda k: k[1])
        gaps, end = [], self.extra.get("t0", ks[0][1] if ks else 0.0)
        for _, start, dur in ks:
            if start > end:
                gaps.append((end, start))
            end = max(end, start + dur)
        if self.extra.get("t1", end) > end:
            gaps.append((end, self.extra["t1"]))
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by: dict = {}
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
            mid = 0.5 * (a + b)
            name = "host: no event"
            for j in range(bisect_right(starts, mid) - 1, max(-1, bisect_right(starts, mid) - 4000), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            by[name] = by.get(name, 0.0) + (b - a)
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP_GAPS]]


def traced(run_units, warm_unit, units: int, device="cuda") -> Trace:
    """``run_units()`` under ``torch.profiler`` (device and host events),
    after one traced ``warm_unit()`` whose events are dropped: a session
    can lose its first device events. Read from the profiler's raw events,
    without building its tree of function events."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=activities, schedule=sched) as prof:
        warm_unit()
        sync()
        prof.step()
        t0 = time.perf_counter_ns()
        run_units()
        sync()
        t1 = time.perf_counter_ns()
        prof.step()
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if _annotation(e):  # a host span drawn on the device's line
                continue
            kernels.append((e.name(), start * 1e-9, dur * 1e-9))
        else:
            host.append((e.name(), start * 1e-9, (start + dur) * 1e-9))
    # the profiler's clock and perf_counter_ns differ by an offset: the
    # window is the traced unit's span, from its host events
    if host:
        lo, hi = min(h[1] for h in host), max(h[2] for h in host)
    else:
        lo, hi = 0.0, (t1 - t0) * 1e-9
    if kernels:
        hi = max(hi, max(s + d for _, s, d in kernels))
    return Trace(window_s=(t1 - t0) * 1e-9, kernels=kernels, host=host, units=units,
                 extra={"t0": lo, "t1": hi})


def _annotation(e) -> bool:
    kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    return (e.is_user_annotation() or "annotation" in kind.lower()
            or e.name().startswith("ProfilerStep"))


# ---------------------------------------------------------------------------
# Per-layer readers and checks
# ---------------------------------------------------------------------------
def metric_file(name: str) -> Path:
    """``metrics/<name>.py``; for a name ``<base>.<kind>`` without a file of
    its own, the reader ``metrics/<base>.py`` that all kinds share."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


def read_metric(name: str, ctx: dict):
    """The metric's reader's ``read(ctx)``: a number, or None where the cell
    holds nothing for it to read. A shared reader reads only a metric of the
    run's kind (``mfu.train`` in a training cell)."""
    path = metric_file(name)
    if path.stem != name and name.rsplit(".", 1)[1] != ctx["kind"]:
        return None
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, checks): every reading named in ``limits`` at or under its
    limit, and finite. A reading with no limit, or a limit with no reading,
    is not correct."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok &= good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind, "count": count,
            "memory_peak_bytes": int(peak_bytes)}
