"""Vectorized lease plane on PyTorch (§8: PaxosLease for many resources).

N independent PaxosLease cells x A acceptors x P proposers as dense int32
tensors, advanced in lockstep — the PyTorch/CUDA counterpart of
``repro.lease_array``, bit-exact against it. Every fault dimension is a
named plane of one ``Scenario`` (``scenario.py``); the engine consumes a
Scenario whole (``run_trace``), a stacked batch of them (``sweep``) or one
``TickInputs`` at a time (``step``).

  scenario.py — the Scenario/TickInputs bundles + the plane registry
  state.py    — array layout, quarter-tick time base, ballots, the packed
                int32 compute format and its budget
  netplane.py — in-flight message + proposer round planes, the delayed tick
  ref.py      — the synchronous tick and public-format one-tick wrappers
  kernel.py   — the CUDA window kernels' wrappers and plain versions
  _build.py   — nvcc build + ctypes binding of csrc/lease_window.cu
  ops.py      — backend dispatch ("torch" | "cuda"), lease_window_scan,
                and the batched §4 margin scan of sweep(collect="margins")
  engine.py   — the stateful engine: step, run_trace and sweep, on CUDA by
                default
  trace.py    — random fault/timing traces (seed-compatible with repro's)
                and the differential referee (replay_event_sim against
                replay_array)
  carry.py    — engine state to/from numpy arrays (carry across packages)
  directory.py— shard-ownership directory on top (cluster/shards.py's
                path at thousands of shards)
  falsify/    — the coverage-guided §4 falsifier over margins sweeps
                (search, mutation, shrinker, corpus, CLI)
"""
from .carry import engine_from_reference, engine_to_arrays
from .directory import LeaseArrayDirectory
from .engine import LeaseArrayEngine, SweepResult
from .kernel import (
    lease_window_delayed,
    lease_window_delayed_batched,
    lease_window_delayed_batched_torch,
    lease_window_delayed_torch,
    lease_window_sync,
    lease_window_sync_batched,
    lease_window_sync_batched_torch,
    lease_window_sync_torch,
)
from .netplane import NetPlaneState, init_netplane, pack_link, pack_slot
from .ops import (
    BACKENDS,
    MARGIN_BIG,
    MARGIN_NAMES,
    lease_plane_tick,
    lease_window_scan,
)
from .scenario import (
    PLANES,
    PlaneSpec,
    Scenario,
    TickInputs,
    make_tick,
    plane_digest,
    register_plane,
)
from .state import (
    DEFAULT_RATE,
    NO_PROPOSER,
    LeaseArrayState,
    PackedLeaseState,
    ballot_of,
    check_pack_budget,
    guarded_lease_q4,
    init_state,
    lease_quarters,
    max_pack_tick,
    pack_state,
    unpack_state,
)
from .trace import (
    Trace,
    cell_resource,
    random_trace,
    replay_array,
    replay_event_sim,
    trace_from_scenario,
)

__all__ = [
    "BACKENDS",
    "DEFAULT_RATE",
    "LeaseArrayDirectory",
    "LeaseArrayEngine",
    "LeaseArrayState",
    "MARGIN_BIG",
    "MARGIN_NAMES",
    "NO_PROPOSER",
    "NetPlaneState",
    "PLANES",
    "PackedLeaseState",
    "PlaneSpec",
    "Scenario",
    "SweepResult",
    "TickInputs",
    "Trace",
    "ballot_of",
    "cell_resource",
    "check_pack_budget",
    "engine_from_reference",
    "engine_to_arrays",
    "guarded_lease_q4",
    "init_netplane",
    "init_state",
    "lease_plane_tick",
    "lease_quarters",
    "lease_window_delayed",
    "lease_window_delayed_batched",
    "lease_window_delayed_batched_torch",
    "lease_window_delayed_torch",
    "lease_window_scan",
    "lease_window_sync",
    "lease_window_sync_batched",
    "lease_window_sync_batched_torch",
    "lease_window_sync_torch",
    "make_tick",
    "max_pack_tick",
    "pack_link",
    "pack_slot",
    "pack_state",
    "plane_digest",
    "random_trace",
    "register_plane",
    "replay_array",
    "replay_event_sim",
    "trace_from_scenario",
    "unpack_state",
]
