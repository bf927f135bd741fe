"""leaselint for the port: static proofs of the pack budget of the traced
tick cores, over the CUDA lease kernels' launch plans, the int32 purity of
their tick math, and the port's conventions.

Four passes and the mutation self-test, one finding currency:

- :mod:`.intervals`: an interval abstract interpretation of the aten graphs
  ``make_fx`` traces of the tick cores, proving every int32 intermediate
  stays in int32 and every pack inside its field (``derived_max_pack_tick``
  re-derives ``state.max_pack_tick``); the engine runs it before every
  ``run_trace`` and ``sweep``;
- :mod:`.launch` audits each :class:`~repro_torch.lease_array.kernel.
  LaunchPlan`, the one description of a lease launch the C entries take
  their geometry from: bounds, write races, coverage, shared memory, limits
  and plane accounting, and the kernels' layout constants against the
  plans';
- :mod:`.purity` lints the kernels' CUDA source and the tick math for
  floating types, the traced cores for floating and int64 nodes (on the
  CPU), and the built libraries' SASS for floating-point instructions (on
  the card);
- :mod:`.conventions`: the plane table, no deprecated shims, deadline
  comparisons in the local clock domain;
- :mod:`.fixtures` mutation-tests every rule (seeded mutants must be
  caught, clean twins must pass); :mod:`.cli` is the ``python -m`` entry.
"""
from .cli import main, run_all, write_plane_table
from .conventions import check_conventions, check_plane_docs, check_source_text
from .findings import Finding, findings_to_json
from .fixtures import run_mutation_tests
from .intervals import TickConfig, analyze_tick_config, derived_max_pack_tick
from .launch import (
    check_kernel_constants,
    check_launch_plan,
    check_window_launches,
    window_launch_plans,
)
from .purity import (
    check_cuda_source,
    check_graph_purity,
    check_sass,
    check_sources,
    check_tick_cores,
    check_torch_source,
    floating_instructions,
)

__all__ = [
    "Finding",
    "findings_to_json",
    "TickConfig",
    "analyze_tick_config",
    "derived_max_pack_tick",
    "check_kernel_constants",
    "check_launch_plan",
    "check_window_launches",
    "window_launch_plans",
    "check_cuda_source",
    "check_graph_purity",
    "check_tick_cores",
    "check_torch_source",
    "check_sources",
    "check_sass",
    "floating_instructions",
    "check_conventions",
    "check_plane_docs",
    "check_source_text",
    "run_mutation_tests",
    "run_all",
    "write_plane_table",
    "main",
]
