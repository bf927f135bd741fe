"""Static audit of the lease kernels' launch plans.

The CUDA lease kernels (``lease_array/csrc/lease_window.cu``) take their
grid, block and shared memory from a :class:`~repro_torch.lease_array.
kernel.LaunchPlan`, the one Python description of each launch; this checker
audits the same object, and holds it to the layout the C launchers were
compiled with. The rules are the reference's
(``repro.analysis.staticcheck.launch``), moved from BlockSpecs to threads:

  - **bounds**: every thread that writes maps inside its outputs; a thread
    whose cell lies past them writes only if the plan states no guard for
    it (the kernels test ``n < N``, the batched kernels ``tile < B *
    tiles``);
  - **write-race**: no two threads write one cell of one scenario, so none
    writes an element of another's ``(b, t, n)`` or ``(b, n)`` outputs (a
    thread writes every tick row and state row of its cell; of a cell's G
    lanes under ``LANE_MAP`` only lane 0, the guard ``lane == 0``);
  - **coverage**: every cell of every scenario has a thread, so every
    output element is written;
  - **shared memory**: a block's bytes are at most ``MAX_SMEM``; the
    launchers' opt-in threshold (``allow_smem``) is the 48 KiB above which
    a plan is marked ``smem_optin``;
  - **limits**: at most 1024 threads a block, whole warps, within the
    kernel's own block (kBlock, its ``__launch_bounds__``; 32 · kBatchWarps
    and kSub ticks for the batched sync kernel; for the batched delayed
    kernel kBlock lanes, G of the lane counts built at A, the tiles a block
    its layout gives and windows of at most kSub ticks), ``grid.y`` at most
    65535;
  - **plane accounting**: the words a plan stages a tick (the staged planes
    the entry's input checks accept, ``kernel.tick_planes``) equal the
    words its C launcher works out for the kernel's shared-memory columns
    (the ``words`` expression of ``launch_delayed``, ``launch_sync`` and
    ``launch_sync_batched``, read from the source and evaluated at the
    plan's A, P and plane groups); a plane that drops out of either side is
    found. This is the counterpart of the reference's roofline
    cross-check;
  - **layout constants**: kBlock, kBatchWarps, kSub, kMaxBatch and
    kMaxLanes in the kernels' source equal the constants the plans are made
    from (:func:`check_kernel_constants`).

Threads are enumerated (numpy, up to ``_MAX_THREADS``); the index maps are
the kernels' own, written out in :func:`thread_cells`.
"""
from __future__ import annotations

import ast
import functools
import re

import numpy as np

from ...lease_array import kernel as K
from .findings import Finding
from .purity import LEASE_CU

#: refuse to enumerate absurd grids instead of silently sampling
_MAX_THREADS = 1 << 24
MAX_BLOCK_THREADS = 1024
MAX_GRID_X, MAX_GRID_Y = 2**31 - 1, 65535
#: compile-time constants of the kernels -> the kernel.py constants the
#: plans are made from
_CU_CONSTANTS = {"kBlock": "BLOCK_THREADS", "kBatchWarps": "SYNC_BATCH_WARPS",
                 "kSub": "BATCH_SUB", "kMaxBatch": "MAX_BATCH",
                 "kMaxLanes": "MAX_LANES"}
#: the C launcher of each entry
LAUNCHERS = {"lease_window_delayed": "launch_delayed",
             "lease_window_delayed_batched": "launch_delayed_batched",
             "lease_window_sync": "launch_sync",
             "lease_window_sync_batched": "launch_sync_batched"}
#: the node types a launcher's words expression may hold, once its C
#: ternaries are written as Python's
_WORDS_NODES = (ast.Expression, ast.BinOp, ast.Add, ast.Mult, ast.IfExp,
                ast.Name, ast.Load, ast.Constant)


@functools.lru_cache(maxsize=1)
def lease_cu_text() -> str:
    """The kernels' CUDA source in this checkout."""
    from .conventions import _repo_root

    return (_repo_root() / LEASE_CU).read_text()


@functools.lru_cache(maxsize=8)
def launcher_words(text: str) -> dict[str, str]:
    """launcher -> the C expression of the words a tick its kernel stages
    (``const size_t words = ...;`` in its body), from the CUDA source
    ``text``; the first body of a launcher that has one."""
    starts = [(m.start(), m[1])
              for m in re.finditer(r"cudaError_t (launch_\w+)\(", text)]
    out: dict[str, str] = {}
    for (start, name), (end, _) in zip(starts, starts[1:] + [(len(text), "")]):
        m = re.search(r"\bwords\s*=\s*([^;]+);", text[start:end])
        if m and name not in out:
            out[name] = " ".join(m[1].split())
    return out


def eval_words(expr: str, plan) -> int:
    """A launcher's words expression at the plan's A, P (``p.P``) and plane
    groups (the CORRUPT and RESTART template flags): sums and products of
    integers and C ternaries on the flags, nothing else."""
    py = re.sub(r"\((\w+) \? ([^?:()]+) : ([^?:()]+)\)",
                r"((\2) if \1 else (\3))", expr.replace("p.P", "P"))
    tree = ast.parse(py, mode="eval")
    if not all(isinstance(node, _WORDS_NODES) for node in ast.walk(tree)):
        raise ValueError(f"cannot evaluate the words expression {expr!r}")
    env = dict(A=plan.n_acceptors, P=plan.n_proposers,
               CORRUPT="corrupt" in plan.variant,
               RESTART="restart" in plan.variant)
    return eval(compile(tree, "<words>", "eval"), {"__builtins__": {}}, env)


def check_kernel_constants(text: str, relpath: str = LEASE_CU) -> list[Finding]:
    """The kernels' compile-time layout in the CUDA source ``text`` against
    kernel.py's: the layout constants (``constexpr int kBlock = 128``, ...),
    the shared-memory opt-in threshold of ``allow_smem``, and a words
    expression in every launcher."""
    findings = []
    for cname, pyname in _CU_CONSTANTS.items():
        m = re.search(rf"\b{cname}\s*=\s*(\d+)", text)
        want = getattr(K, pyname)
        if m is None or int(m[1]) != want:
            findings.append(Finding(
                "launch", "layout-constant", relpath,
                f"{cname} is {m[1] if m else 'missing'} in the kernels' "
                f"source, kernel.{pyname} {want}; the plans would not match "
                f"the compiled layout",
            ))
    m = re.search(r"if \(bytes <= (\d+) \* 1024\) return cudaSuccess;", text)
    if m is None or int(m[1]) * 1024 != K.SMEM_NO_OPTIN:
        findings.append(Finding(
            "launch", "smem-optin", relpath,
            f"allow_smem asks for the opt-in above "
            f"{int(m[1]) * 1024 if m else 'an unknown number of'} bytes, the "
            f"plans mark smem_optin above kernel.SMEM_NO_OPTIN "
            f"{K.SMEM_NO_OPTIN}",
        ))
    words = launcher_words(text)
    for launcher in sorted(set(LAUNCHERS.values()) - set(words)):
        findings.append(Finding(
            "launch", "plane-accounting", relpath,
            f"{launcher} has no `words = ...;` expression; the plans' "
            f"staging cannot be held to it",
        ))
    return findings


def thread_cells(plan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(b, n, writes) for every thread of the grid, in launch order: the
    scenario and cell each thread owns under the plan's index map, and
    whether it writes (False where a guard the plan states stops it)."""
    gx, gy = plan.grid
    idx = np.arange(gx * gy * plan.threads, dtype=np.int64)
    tx = idx % plan.threads
    blk = idx // plan.threads
    bx, by = blk % gx, blk // gx
    writes = np.ones(idx.shape, bool)
    if plan.index_map == K.CELL_MAP:
        b, n = by, bx * plan.threads + tx
    elif plan.index_map == K.WARP_TILE_MAP:
        tiles = -(-plan.n_cells // 32)
        tile = bx * K.SYNC_BATCH_WARPS + tx // 32
        b, n = tile // tiles, (tile % tiles) * 32 + tx % 32
        if "tile < B * tiles" in plan.guards:
            writes &= tile < plan.batch * tiles
    elif plan.index_map == K.LANE_MAP:
        tile_lanes = plan.threads // plan.stage_copies
        cells = tile_lanes // plan.lanes
        tiles = -(-plan.n_cells // cells)
        tile, lane = bx * plan.stage_copies + tx // tile_lanes, tx % tile_lanes
        b, n = tile // tiles, (tile % tiles) * cells + lane // plan.lanes
        if "tile < B * tiles" in plan.guards:
            writes &= tile < plan.batch * tiles
        if "lane == 0" in plan.guards:
            writes &= lane % plan.lanes == 0
    else:
        raise ValueError(f"unknown index map {plan.index_map!r}")
    if "n < N" in plan.guards:
        writes &= n < plan.n_cells
    return b, n, writes


def check_launch_plan(plan, *, what: str | None = None,
                      cu_text: str | None = None) -> list[Finding]:
    """Audit one :class:`LaunchPlan` against the kernels' CUDA source
    ``cu_text`` (this checkout's by default). Pure host-side arithmetic:
    nothing is built or launched."""
    what = what or plan.entry
    findings: list[Finding] = []

    def find(rule, detail):
        findings.append(Finding("launch", rule, what, detail))

    B, N = plan.batch, plan.n_cells
    gx, gy = plan.grid

    # -- limits ----------------------------------------------------------
    if not (32 <= plan.threads <= MAX_BLOCK_THREADS and plan.threads % 32 == 0):
        find("thread-limit", f"{plan.threads} threads a block; a block takes "
             f"whole warps, at most {MAX_BLOCK_THREADS} threads")
    if plan.index_map == K.CELL_MAP and plan.threads > K.BLOCK_THREADS:
        find("thread-limit", f"{plan.threads} threads a block, over the "
             f"kernel's __launch_bounds__ of {K.BLOCK_THREADS} (kBlock)")
    if plan.index_map == K.WARP_TILE_MAP and (
            plan.threads != 32 * K.SYNC_BATCH_WARPS
            or plan.tw != K.BATCH_SUB
            or plan.stage_copies != K.SYNC_BATCH_WARPS):
        find("thread-limit", f"{plan.threads} threads, {plan.stage_copies} "
             f"staging areas of {plan.tw} ticks; the batched sync kernel is "
             f"compiled for {K.SYNC_BATCH_WARPS} warps (kBatchWarps) of "
             f"{K.BATCH_SUB} ticks (kSub)")
    if plan.index_map == K.LANE_MAP:
        counts = K.lane_counts(plan.n_acceptors)
        copies = (K.lane_tile_copies(N, plan.lanes) if plan.lanes in counts
                  else None)
        if (plan.threads != K.BLOCK_THREADS or plan.lanes not in counts
                or plan.stage_copies != copies or plan.tw > K.BATCH_SUB):
            find("thread-limit", f"{plan.threads} threads, {plan.lanes} lanes "
                 f"a cell, {plan.stage_copies} tiles of {plan.tw} ticks a "
                 f"block; the batched delayed kernel is compiled for blocks "
                 f"of {K.BLOCK_THREADS} (kBlock), {counts} lanes a cell at "
                 f"{plan.n_acceptors} acceptors, {copies} tiles a block at "
                 f"that G and N {N}, windows of at most {K.BATCH_SUB} ticks "
                 f"(kSub)")
    if not (1 <= gx <= MAX_GRID_X and 1 <= gy <= MAX_GRID_Y):
        find("grid-limit", f"grid {plan.grid}: grid.x must lie in "
             f"1..{MAX_GRID_X}, grid.y in 1..{MAX_GRID_Y}")
    if not 1 <= B <= K.MAX_BATCH:
        find("grid-limit", f"batch {B}: a launch takes 1..{K.MAX_BATCH} "
             f"scenarios")
    if plan.tw < 1:
        find("window", f"a window of {plan.tw} ticks")

    # -- shared memory ---------------------------------------------------
    if plan.smem_bytes > K.MAX_SMEM:
        find("smem-budget", f"{plan.smem_bytes} bytes of shared memory a "
             f"block, over the card's {K.MAX_SMEM}; use a smaller window")

    # -- plane accounting ------------------------------------------------
    launcher = LAUNCHERS[plan.entry]
    expr = launcher_words(lease_cu_text() if cu_text is None else cu_text
                          ).get(launcher)
    compiled = None if expr is None else eval_words(expr, plan)
    if plan.stage_words != compiled:
        find("plane-accounting", f"the plan stages {list(plan.staged)} "
             f"({plan.stage_words} words a tick); {launcher} stages "
             f"{compiled} ({expr}); a plane has fallen out of the plan or "
             f"of the launcher, or the two drifted")

    # -- outputs: bounds, write races, coverage --------------------------
    n_threads = gx * gy * plan.threads
    if n_threads > _MAX_THREADS:
        find("grid-too-large", f"{n_threads} threads, beyond the "
             f"{_MAX_THREADS} the checker will enumerate; audit a smaller "
             f"geometry (the rules do not depend on it)")
        return findings
    if n_threads == 0:
        return findings
    b, n, writes = thread_cells(plan)
    outside = writes & ((b < 0) | (b >= B) | (n < 0) | (n >= N))
    if outside.any():
        i = int(np.flatnonzero(outside)[0])
        find("out-of-bounds", f"{int(outside.sum())} writing threads map "
             f"outside [{B} scenarios, {N} cells], the first thread {i} to "
             f"(b {int(b[i])}, n {int(n[i])}); the plan states guards "
             f"{list(plan.guards)}")
    inside = writes & ~outside
    key = b[inside] * N + n[inside]
    counts = np.bincount(key, minlength=B * N)
    if (counts > 1).any():
        cell = int(np.flatnonzero(counts > 1)[0])
        owners = np.flatnonzero(inside)[key == cell][:2]
        find("write-race", f"{int((counts > 1).sum())} cells have more than "
             f"one writing thread: threads {owners.tolist()} both own "
             f"(b {cell // N}, n {cell % N}) and write its elements of every "
             f"output {list(plan.out_shapes)}")
    if (counts == 0).any():
        find("incomplete-coverage", f"{int((counts == 0).sum())} of {B * N} "
             f"cells have no thread, the first (b "
             f"{int(np.argmax(counts == 0)) // N}, n "
             f"{int(np.argmax(counts == 0)) % N}); their elements of every "
             f"output are left unwritten")
    return findings


def window_launch_plans(
    n_cells: int = 4096,
    n_acceptors: int = 5,
    n_proposers: int = 8,
    n_ticks: int = 64,
    *,
    window: int = 16,
    batch: int = 8,
) -> list[tuple[str, object]]:
    """(name, plan) of every lease kernel entry at one geometry: the
    unbatched sync entry, each of the delayed entries' eight plane-group
    variants (both collect modes for the batched one), and the batched sync
    entry in both collect modes."""
    A, N, P, T = n_acceptors, n_cells, n_proposers, n_ticks
    variants = [tuple(v for v, on in zip(K.VARIANTS, bits) if on)
                for bits in np.ndindex(2, 2, 2)]
    plans = [("lease_window_sync",
              K.sync_launch_plan(A, N, P, T, window=window))]
    for var in variants:
        tag = "[" + ",".join(var) + "]" if var else ""
        plans.append((f"lease_window_delayed{tag}", K.delayed_launch_plan(
            A, N, P, T, window=window, variant=var)))
        for collect in K.COLLECT:
            plans.append((
                f"lease_window_delayed_batched{tag}/{collect}",
                K.delayed_batched_launch_plan(A, N, P, T, batch, window=window,
                                              variant=var, collect=collect)))
    for collect in K.COLLECT:
        plans.append((f"lease_window_sync_batched/{collect}",
                       K.sync_batched_launch_plan(A, N, P, T, batch,
                                                  collect=collect)))
    return plans


def check_window_launches(*args, **kwargs) -> list[Finding]:
    """Audit every lease kernel entry's plan at one geometry (the arguments
    of :func:`window_launch_plans`; the reference's default N 4096, A 5,
    P 8, T 64)."""
    findings: list[Finding] = []
    for what, plan in window_launch_plans(*args, **kwargs):
        findings += check_launch_plan(plan, what=what)
    return findings
