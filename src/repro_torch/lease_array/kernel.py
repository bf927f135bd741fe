"""Time-resident window kernels of the lease plane: a whole ``[T, ...]``
scenario in ONE launch, and their plain PyTorch versions.

Two pairs of functions, one pair per kernel:

  ``lease_window_delayed`` / ``lease_window_delayed_torch`` — T ticks of the
      delayed in-flight model (``netplane.delayed_tick_math``);
  ``lease_window_sync`` / ``lease_window_sync_torch`` — T ticks of the
      zero-delay model (``ref.sync_tick_math``).

The first of each pair takes CUDA tensors only and launches the hand-written
kernel of ``csrc/lease_window.cu`` (one thread per cell, the cell's state in
registers for all T ticks; the batched delayed kernel spreads a cell over G
lanes; see the note at the top of that file) or raises.
The ``_torch`` plain version is a Python loop over ticks of the same tick
math, on any device — the CPU path and the yardstick the kernel is held
bit-exact against. It runs every tick: the kernel's window staging and
quiescence skip (``window``, ``skip_stable``) must not change a result, so
the plain version has neither, as ``repro``'s jnp path has neither. Each of
the four functions counts its calls in its ``launches`` attribute.

Each kernel also has a batched entry, the counterpart of the Pallas kernels
under ``jax.vmap`` in the reference's sweep: ``lease_window_delayed_batched``
/ ``lease_window_sync_batched`` replay B scenarios ([B, T, ...] planes) from
one shared start state in ONE launch (tiles of one scenario's cells), write no
final state, and either return the [B, T, N] owner/count rows
(``collect="owners"``) or reduce them inside the kernel to three [B, N]
planes (``collect="summary"``: max owner count, owned ticks, final owner;
see :func:`window_summary`). Their plain versions (``*_batched_torch``) run
the plain window loop scenario by scenario and reduce in torch.

Every launch is described once, by a :class:`LaunchPlan` (grid, block,
shared memory, staged planes, outputs) that the entry's plan function
(``sync_launch_plan``, ``delayed_launch_plan``,
``delayed_batched_launch_plan``, ``sync_batched_launch_plan``) works out
from the launch's shapes and planes. The wrapper hands the plan's geometry
to the C entry, which launches exactly it or refuses it, and keeps the plan
in its ``plans`` set beside its ``launches`` count; the port's leaselint
audits the same plans.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .netplane import NetPlaneState, delayed_tick_math, legs_select
from .ref import sync_tick_math
from .state import I32, PACK_SHIFT, PackedLeaseState

N_LEASE = len(PackedLeaseState._fields)
N_NET = len(NetPlaneState._fields)

#: max dynamic shared memory of one Hopper block (bytes)
MAX_SMEM = 232448
#: most acceptors the kernels are instantiated for (netplane's
#: MAX_VOTE_ACCEPTORS)
MAX_ACCEPTORS = PACK_SHIFT
#: most scenarios one batched launch takes
MAX_BATCH = 65535
#: the batched sync kernel's warps a block; the most ticks a batched kernel
#: stages at once (csrc kBatchWarps, kSub)
SYNC_BATCH_WARPS, BATCH_SUB = 4, 16
#: most threads a block of the one-cell-a-thread kernels (csrc kBlock, their
#: __launch_bounds__), and the block of the batched delayed kernel
BLOCK_THREADS = 128
#: most lanes a cell of the batched delayed kernel (csrc kMaxLanes); it is
#: built for the powers of two up to it (:func:`lane_counts`)
MAX_LANES = 8
#: dynamic shared memory a block may take without the opt-in attribute
SMEM_NO_OPTIN = 48 * 1024
#: lanes an SM (four warps) the batched delayed plan fills before it
#: spreads cells no further (:func:`delayed_batched_launch_plan`). Timed on
#: an H100 at every G (``tools/lease_batched_time.py --lanes``): one lane a
#: cell ran fastest from 32,768 cells (the bench and chaos sweeps), two at
#: 16,384 (A 3 and 5), the most there are from the shrinker's 4 cells up to
#: 8,192 (G 4 at A 3, G 8 at A 5); every value above 124 and at most 248
#: picks those, and 128 is the least power of two among them
FILL_LANES_PER_SM = 128
#: the index maps of the kernels, from (block, thread) to the cell they own:
#: CELL_MAP, cell blockIdx.x * blockDim.x + threadIdx.x (the unbatched
#: kernels); WARP_TILE_MAP, 32-cell tile blockIdx.x * kBatchWarps + warp of
#: the B · ceil(N / 32) tiles, a scenario's tiles in a row (the batched sync
#: kernel); LANE_MAP, G lanes a cell: tile blockIdx.x * copies + threadIdx.x
#: // (threads / copies) of the B · ceil(N / cells) tiles holds ``cells``
#: = threads / copies / G cells of one scenario, lane l of a tile cell l //
#: G, and a cell's lane 0 writes (the batched delayed kernel)
CELL_MAP, WARP_TILE_MAP, LANE_MAP = "cell", "warp_tile", "lane_group"
#: the optional plane groups a delayed launch may carry (the kernel's EXT,
#: CORRUPT and RESTART template flags)
VARIANTS = ("extends", "corrupt", "restart")


class LaunchPlan(NamedTuple):
    """The geometry of one launch of a lease kernel entry, worked out once
    from the launch's shapes and the planes it carries.

    The wrapper passes ``grid``, ``threads`` and ``smem_bytes`` to the C
    entry, which launches exactly that geometry, or refuses it
    (``cudaErrorInvalidValue``) when it disagrees with the kernel's
    compile-time layout (its staging words, kBlock, kBatchWarps); the port's
    leaselint (``repro_torch.analysis.staticcheck.launch``) audits the same
    object (bounds, write races, coverage, shared memory, limits, plane
    accounting). So there is no second description of the launch to drift
    out of sync. ``staged`` lists the cell-independent planes one staging
    area holds a tick, in the kernel's shared-memory order (the staged
    planes of :func:`tick_planes`); a block holds ``stage_copies`` areas of
    ``tw`` ticks. ``guards`` are the conditions under which a thread writes
    nothing (the kernel tests them). ``collect`` is a batched entry's
    collect mode, None for an unbatched one. ``lanes`` is the threads a
    cell (G of ``LANE_MAP``; 1 for the other maps)."""

    entry: str
    n_acceptors: int
    n_proposers: int
    n_cells: int
    n_ticks: int
    batch: int
    variant: tuple[str, ...]
    collect: str | None
    grid: tuple[int, int]
    threads: int
    tw: int
    staged: tuple[tuple[str, int], ...]
    stage_copies: int
    index_map: str
    guards: tuple[str, ...]
    lanes: int = 1

    @property
    def stage_words(self) -> int:
        """int32 words one staging area holds a tick."""
        return sum(w for _, w in self.staged)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block."""
        return 4 * self.stage_words * self.tw * self.stage_copies

    @property
    def smem_optin(self) -> bool:
        """Whether the block needs the opt-in attribute (over 48 KiB)."""
        return self.smem_bytes > SMEM_NO_OPTIN

    @property
    def n_windows(self) -> int:
        """Windows of ``tw`` ticks a launch stages."""
        return -(-self.n_ticks // self.tw)

    @property
    def out_shapes(self) -> tuple[tuple[int, ...], ...]:
        """The shapes of the outputs, in the entry's pointer order: the
        final state then the [T, N] owner and count rows of an unbatched
        entry; the [B, T, N] rows or the three [B, N] summary planes of a
        batched one."""
        A, N, T, B = self.n_acceptors, self.n_cells, self.n_ticks, self.batch
        if self.collect == "owners":
            return ((B, T, N),) * 2
        if self.collect == "summary":
            return ((B, N),) * 3
        state = [(A, N)] * 2 + [(1, N)] * 2
        if self.entry == "lease_window_delayed":
            state += [(A, N)] * 6 + [(1, N)] * 6
        return (*state, (T, N), (T, N))


@functools.lru_cache(maxsize=256)
def tick_planes(A: int, N: int, P: int, *, delayed: bool,
                variant: tuple = ()) -> tuple:
    """The [*lead, T, *shape] planes an entry's input checks accept, as
    (name, per-tick shape, staged): staged for a cell-independent plane a
    window stages in shared memory, in the kernels' shared-memory order
    (s_up, s_pclk, s_aclk, s_link, ...), else a row of one value a cell.
    A launch plan's ``staged`` is the staged ones."""
    planes = [("attempts", (N,), False), ("releases", (N,), False),
              ("acc_up", (A,), True), ("pclk", (P,), True),
              ("aclk", (A,), True)]
    if delayed:
        if "extends" in variant:
            planes.append(("extends", (N,), False))
        planes.append(("link", (P, A), True))
        if "corrupt" in variant:
            planes += [("stale", (A,), True), ("equiv", (A,), True)]
        if "restart" in variant:
            planes += [("acc_restart", (A,), True), ("acc_deaf", (A,), True),
                       ("prop_restart", (P,), True), ("prop_rc", (P,), True)]
    return tuple(planes)


def _plan(entry, A, N, P, T, batch, variant, collect, *, delayed, threads,
          grid_x, tw, copies, index_map, guards, lanes=1) -> LaunchPlan:
    if bad := set(variant) - set(VARIANTS):
        raise ValueError(f"unknown plane groups {sorted(bad)}; of {VARIANTS}")
    variant = tuple(v for v in VARIANTS if v in variant)
    staged = tuple((name, math.prod(shape)) for name, shape, on in tick_planes(
        A, N, P, delayed=delayed, variant=variant) if on)
    return LaunchPlan(
        entry, A, P, N, T, batch, variant, collect, (grid_x, 1), threads, tw,
        staged, copies, index_map, guards, lanes)


def _cell_plan(entry, A, N, P, T, window, delayed, variant):
    """A one-cell-a-thread launch of one scenario: blocks of min(kBlock, N
    rounded up to a warp) threads, ceil(N / threads) of them, a window of
    min(window, T) ticks (at least 1)."""
    threads = min(BLOCK_THREADS, max(32, -(-N // 32) * 32))
    return _plan(entry, A, N, P, T, 1, variant, None, delayed=delayed,
                 threads=threads, grid_x=-(-N // threads),
                 tw=max(1, min(int(window), T)), copies=1,
                 index_map=CELL_MAP, guards=("n < N",))


def lane_counts(n_acceptors: int) -> tuple[int, ...]:
    """The lanes a cell the batched delayed kernel is built for at
    ``n_acceptors``: the powers of two up to the first at or above A, at
    most MAX_LANES (csrc ``lane_cap``; a lane with no acceptor would only
    repeat the cell's scalars)."""
    counts = [1]
    while counts[-1] < min(n_acceptors, MAX_LANES):
        counts.append(2 * counts[-1])
    return tuple(counts)


def lane_tile_copies(n_cells: int, lanes: int) -> int:
    """Tiles a block of the batched delayed kernel (csrc ``lane_tile_warps``):
    a tile is a warp where a scenario's N · G lanes, rounded up to a warp,
    fill less than a block (BLOCK_THREADS // 32 tiles of any scenarios a
    block), else the whole block."""
    return (BLOCK_THREADS // 32 if -(-n_cells * lanes // 32) < BLOCK_THREADS // 32
            else 1)


# The plan functions are memoized: one geometry gives one plan, so a launch
# costs a cache lookup, and the wrappers' ``plans`` sets hold as many plans
# as there were geometries.
@functools.lru_cache(maxsize=256)
def sync_launch_plan(n_acceptors: int, n_cells: int, n_proposers: int,
                     n_ticks: int, *, window: int = 16) -> LaunchPlan:
    """Launch geometry of :func:`lease_window_sync` (``sync_window_kernel``):
    a thread a cell; a window stages acc_up, pclk and aclk; it writes the
    final lease state ([A, N] x 2, [1, N] x 2) and the [T, N] owner and
    count rows."""
    return _cell_plan("lease_window_sync", n_acceptors, n_cells, n_proposers,
                      n_ticks, window, False, ())


@functools.lru_cache(maxsize=256)
def delayed_launch_plan(n_acceptors: int, n_cells: int, n_proposers: int,
                        n_ticks: int, *, window: int = 16,
                        variant: tuple = ()) -> LaunchPlan:
    """Launch geometry of :func:`lease_window_delayed`
    (``delayed_window_kernel`` with kSingle): as sync, and a window also
    stages the [P, A] link matrices and, with ``"corrupt"`` or
    ``"restart"`` in ``variant``, their columns (``"extends"`` is a per-cell
    row, not staged); it writes the final lease and net state (8 [A, N]
    columns, 8 [1, N] rows) and the [T, N] rows."""
    return _cell_plan("lease_window_delayed", n_acceptors, n_cells,
                      n_proposers, n_ticks, window, True, variant)


@functools.lru_cache(maxsize=256)
def delayed_batched_launch_plan(n_acceptors: int, n_cells: int,
                                n_proposers: int, n_ticks: int, batch: int,
                                *, window: int = 16, variant: tuple = (),
                                collect: str = "summary", lanes: int = None,
                                sms: int = 132) -> LaunchPlan:
    """Launch geometry of :func:`lease_window_delayed_batched`
    (``delayed_batched_kernel``): G lanes a cell (``LANE_MAP``), blocks of
    BLOCK_THREADS lanes holding :func:`lane_tile_copies` tiles, each tile
    staging its own window of min(window, T, BATCH_SUB) ticks of the
    delayed kernel's columns; it writes the [B, T, N] rows or the three
    [B, N] summary planes. G is ``lanes`` where given (the tests and the
    timing runs hold every G against plain), else the fewest lanes of
    :func:`lane_counts` that give the card's ``sms`` SMs FILL_LANES_PER_SM
    lanes each, else the most there are."""
    counts = lane_counts(n_acceptors)
    if lanes is None:
        lanes = next((g for g in counts
                      if batch * n_cells * g >= sms * FILL_LANES_PER_SM),
                     counts[-1])
    elif lanes not in counts:
        raise ValueError(f"the batched delayed kernel takes {counts} lanes a "
                         f"cell at {n_acceptors} acceptors; got {lanes}")
    copies = lane_tile_copies(n_cells, lanes)
    cells = BLOCK_THREADS // copies // lanes
    tiles = batch * -(-n_cells // cells)
    return _plan("lease_window_delayed_batched", n_acceptors, n_cells,
                 n_proposers, n_ticks, batch, variant, collect, delayed=True,
                 threads=BLOCK_THREADS, grid_x=-(-tiles // copies),
                 tw=max(1, min(int(window), n_ticks, BATCH_SUB)),
                 copies=copies, index_map=LANE_MAP,
                 guards=("tile < B * tiles", "n < N", "lane == 0"),
                 lanes=lanes)


@functools.lru_cache(maxsize=256)
def sync_batched_launch_plan(n_acceptors: int, n_cells: int,
                             n_proposers: int, n_ticks: int, batch: int,
                             *, collect: str = "summary") -> LaunchPlan:
    """Launch geometry of :func:`lease_window_sync_batched`
    (``sync_batched_kernel``): a warp a 32-cell tile of one scenario,
    SYNC_BATCH_WARPS tiles a block, ceil(B · ceil(N / 32) / warps) blocks;
    each warp stages its own BATCH_SUB ticks of acc_up, pclk and aclk
    whatever the window (``tw`` is BATCH_SUB)."""
    tiles = batch * -(-n_cells // 32)
    return _plan("lease_window_sync_batched", n_acceptors, n_cells,
                 n_proposers, n_ticks, batch, (), collect, delayed=False,
                 threads=32 * SYNC_BATCH_WARPS,
                 grid_x=-(-tiles // SYNC_BATCH_WARPS), tw=BATCH_SUB,
                 copies=SYNC_BATCH_WARPS, index_map=WARP_TILE_MAP,
                 guards=("tile < B * tiles", "n < N"))


# ------------------------------------------------------------------ plain
def lease_window_sync_torch(
    packed: PackedLeaseState,
    t0: int,
    attempts,    # [T, N] int32
    releases,    # [T, N] int32
    acc_up,      # [T, A] int32
    pclk,        # [T, P] int32 proposer local clocks per tick
    aclk,        # [T, A] int32 acceptor local clocks per tick
    *,
    majority: int,
    lease_q4: int,
    n_proposers: int,
    guard_q4: int = None,
) -> tuple[PackedLeaseState, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lease_window_sync`: a loop over ticks of
    ``ref.sync_tick_math``. Returns (packed', owners [T, N], counts [T, N])."""
    T, N = attempts.shape
    dev = packed.promised.device
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    lease = tuple(packed)
    for tau in range(T):
        lease, count = sync_tick_math(
            lease, int(t0) + tau, attempts[tau:tau + 1], releases[tau:tau + 1],
            acc_up[tau][:, None], pclk[tau][:, None], aclk[tau][:, None],
            majority=majority, lease_q4=lease_q4, n_proposers=n_proposers,
            guard_q4=guard_q4,
        )
        owners[tau] = lease[2][0]
        counts[tau] = count[0]
    lease_window_sync_torch.launches += 1
    return PackedLeaseState(*lease), owners, counts


lease_window_sync_torch.launches = 0


def lease_window_delayed_torch(
    packed: PackedLeaseState,
    net: NetPlaneState,
    t0: int,
    attempts,    # [T, N] int32
    releases,    # [T, N] int32
    acc_up,      # [T, A] int32
    pclk,        # [T, P] int32 proposer local clocks per tick
    aclk,        # [T, A] int32 acceptor local clocks per tick
    link,        # [T, P, A] int32 fused link matrices (netplane.pack_link)
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    n_proposers: int,
    guard_q4: int = None,
    extends=None,       # [T, N] §6 owner-extension ids (None = none)
    stale=None,         # [T, A] adversarial stale-ballot mask (None = honest)
    equiv=None,         # [T, A] adversarial equivocation mask (None = honest)
    acc_restart=None,   # [T, A] acceptor crash+restart mask (None = honest)
    acc_deaf=None,      # [T, A] post-restart deaf-window mask
    prop_restart=None,  # [T, P] proposer crash+restart mask
    prop_rc=None,       # [T, P] running per-proposer restart counters
) -> tuple[PackedLeaseState, NetPlaneState, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lease_window_delayed`: a loop over ticks of
    ``netplane.delayed_tick_math``. Returns
    (packed', net', owners [T, N], counts [T, N])."""
    T, N = attempts.shape
    dev = packed.promised.device
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    corrupt = stale is not None or equiv is not None
    restart = any(
        x is not None for x in (acc_restart, acc_deaf, prop_restart, prop_rc)
    )
    if corrupt:
        stale = torch.zeros_like(acc_up) if stale is None else stale
        equiv = torch.zeros_like(acc_up) if equiv is None else equiv
    if restart:
        za, zp = torch.zeros_like(acc_up), torch.zeros_like(pclk)
        acc_restart = za if acc_restart is None else acc_restart
        acc_deaf = za if acc_deaf is None else acc_deaf
        prop_restart = zp if prop_restart is None else prop_restart
        prop_rc = zp if prop_rc is None else prop_rc
    lease, netc = tuple(packed), tuple(net)
    for tau in range(T):
        adv = {}
        if extends is not None:
            adv["extend"] = extends[tau:tau + 1]
        if corrupt:
            adv.update(stale=stale[tau][:, None], equiv=equiv[tau][:, None])
        if restart:
            adv.update(
                acc_restart=acc_restart[tau][:, None],
                acc_deaf=acc_deaf[tau][:, None],
                prop_restart=prop_restart[tau][:, None],
                prop_rc=prop_rc[tau][:, None],
            )
        lease, netc, count = delayed_tick_math(
            lease, netc, int(t0) + tau,
            attempts[tau:tau + 1], releases[tau:tau + 1],
            acc_up[tau][:, None], pclk[tau][:, None], aclk[tau][:, None],
            link[tau],
            majority=majority, lease_q4=lease_q4, round_q4=round_q4,
            n_proposers=n_proposers, guard_q4=guard_q4, legs=legs_select,
            **adv,
        )
        owners[tau] = lease[2][0]
        counts[tau] = count[0]
    lease_window_delayed_torch.launches += 1
    return (PackedLeaseState(*lease), NetPlaneState(*netc), owners, counts)


lease_window_delayed_torch.launches = 0

COLLECT = ("summary", "owners")


def window_summary(owners: torch.Tensor, counts: torch.Tensor):
    """The per-cell summary of [..., T, N] owner/count rows, as the batched
    kernels write it in ``collect="summary"``: (max owner count, ticks with
    an owner, owner row after the last tick), each [..., N] int32."""
    return (counts.amax(dim=-2), (owners >= 0).sum(dim=-2, dtype=I32),
            owners[..., -1, :].clone())


def _batched_plain(window_fn, collect: str, planes: tuple, **kw):
    """Runs ``window_fn`` (a plain window loop) on each scenario's planes
    (``planes``: [B, T, ...] tensors, or None for an absent one) and stacks
    the rows or their per-scenario summary."""
    if collect not in COLLECT:
        raise ValueError(f"unknown collect mode {collect!r}; one of {COLLECT}")
    outs = []
    for b in range(planes[0].shape[0]):
        *_, owners, counts = window_fn(
            *(None if x is None else x[b] for x in planes), **kw)
        outs.append((owners, counts) if collect == "owners"
                    else window_summary(owners, counts))
    return tuple(torch.stack(col) for col in zip(*outs))


def lease_window_sync_batched_torch(
    packed: PackedLeaseState, t0: int, attempts, releases, acc_up, pclk, aclk,
    *, majority: int, lease_q4: int, n_proposers: int, guard_q4: int = None,
    collect: str = "summary",
):
    """Plain version of :func:`lease_window_sync_batched`: the plain sync
    window loop on each scenario from ``packed``. Returns (owners, counts)
    [B, T, N] or the :func:`window_summary` planes [B, N]."""
    out = _batched_plain(
        lambda *pl: lease_window_sync_torch(packed, t0, *pl, majority=majority,
                                            lease_q4=lease_q4,
                                            n_proposers=n_proposers,
                                            guard_q4=guard_q4),
        collect, (attempts, releases, acc_up, pclk, aclk))
    lease_window_sync_batched_torch.launches += 1
    return out


lease_window_sync_batched_torch.launches = 0

#: the optional [B, T, ...] planes of the delayed batched entries, in the
#: order of the unbatched keyword arguments
DELAYED_OPTIONAL = ("extends", "stale", "equiv", "acc_restart", "acc_deaf",
                    "prop_restart", "prop_rc")


def lease_window_delayed_batched_torch(
    packed: PackedLeaseState, net: NetPlaneState, t0: int, attempts, releases,
    acc_up, pclk, aclk, link, *, majority: int, lease_q4: int, round_q4: int,
    n_proposers: int, guard_q4: int = None, collect: str = "summary",
    **optional,
):
    """Plain version of :func:`lease_window_delayed_batched`: the plain
    delayed window loop on each scenario from ``(packed, net)``. Optional
    planes (``DELAYED_OPTIONAL``) are [B, T, ...] or None. Returns (owners,
    counts) [B, T, N] or the :func:`window_summary` planes [B, N]."""
    names = [k for k in DELAYED_OPTIONAL if optional.get(k) is not None]
    if bad := set(optional) - set(DELAYED_OPTIONAL):
        raise TypeError(f"unknown optional planes {sorted(bad)}")

    def one(att, rel, up, pc, ac, lk, *opt):
        return lease_window_delayed_torch(
            packed, net, t0, att, rel, up, pc, ac, lk, majority=majority,
            lease_q4=lease_q4, round_q4=round_q4, n_proposers=n_proposers,
            guard_q4=guard_q4, **dict(zip(names, opt)))

    out = _batched_plain(one, collect, (attempts, releases, acc_up, pclk, aclk,
                                        link, *(optional[k] for k in names)))
    lease_window_delayed_batched_torch.launches += 1
    return out


lease_window_delayed_batched_torch.launches = 0


# ------------------------------------------------------------------- CUDA
def _check(x: torch.Tensor, name: str, shape: tuple, device) -> torch.Tensor:
    """The kernels read raw int32 rows: refuse anything else."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != I32:
        raise ValueError(f"{name} must be int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the state on {device}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, want {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(
            f"the CUDA lease kernels take CUDA tensors; got a tensor on "
            f"{t.device} (the plain *_torch versions run anywhere)"
        )
    return t.device


def _check_batch(B: int, collect: str) -> None:
    if collect not in COLLECT:
        raise ValueError(f"unknown collect mode {collect!r}; one of {COLLECT}")
    if not 1 <= B <= MAX_BATCH:
        raise ValueError(f"a batched launch takes 1..{MAX_BATCH} scenarios; "
                         f"got {B}")


def _batch_outputs(plan: LaunchPlan, dev):
    """The batched kernels' outputs (``plan.out_shapes``) and their
    pointers: (owners, counts) [B, T, N] rows, or the three [B, N] summary
    planes."""
    out = tuple(torch.empty(s, dtype=I32, device=dev) for s in plan.out_shapes)
    if plan.collect == "owners":
        return out, [*map(_ptr, out), 0, 0, 0]
    return out, [0, 0, *map(_ptr, out)]


def _check_geometry(plan: LaunchPlan) -> None:
    A, P = plan.n_acceptors, plan.n_proposers
    if not 1 <= A <= MAX_ACCEPTORS:
        raise ValueError(
            f"the lease kernels take 1..{MAX_ACCEPTORS} acceptors; got {A}"
        )
    if P < 1:
        raise ValueError(f"need at least one proposer; got {P}")
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(
            f"a {plan.tw}-tick window stages {plan.smem_bytes} bytes of "
            f"shared memory (max {MAX_SMEM}); use a smaller window"
        )


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _launch(plan: LaunchPlan, ptrs: list, ints: list, device) -> None:
    """Calls the C entry ``plan.entry`` with the plan's geometry (grid.x,
    grid.y, threads, shared bytes, lanes a cell) after ``ints``."""
    name = plan.entry
    ints = [*ints, *plan.grid, plan.threads, plan.smem_bytes, plan.lanes]
    lib = _build.load(ints[2])
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(
        ctypes.cast(c_ptrs, ctypes.c_void_p),
        ctypes.cast(c_ints, ctypes.c_void_p),
        ctypes.c_void_p(stream),
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _record(fn, plan: LaunchPlan) -> None:
    """Counts a launch of ``fn`` and keeps its plan: ``fn.plans`` holds the
    distinct plans it launched since the process started (reset_launches
    zeroes the counts only), for the launch audit."""
    fn.launches += 1
    fn.plans.add(plan)


def _check_sync_inputs(packed, cols, lead: tuple, P: int, window: int,
                       collect="summary"):
    """Checks a sync launch's state and [*lead, T, ...] planes (cols:
    attempts, releases, acc_up, pclk, aclk) and plans it (the batched entry
    where ``lead`` is (B,)). Returns (device, N, T, plan)."""
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    T = cols[0].shape[len(lead)]
    plan = (sync_batched_launch_plan(A, N, P, T, lead[0], collect=collect)
            if lead
            else sync_launch_plan(A, N, P, T, window=window))
    _check_geometry(plan)
    for name, x, shape in zip(
        PackedLeaseState._fields, packed, ((A, N), (A, N), (1, N), (1, N))
    ):
        _check(x, name, shape, dev)
    for (name, shape, _), x in zip(tick_planes(A, N, P, delayed=False), cols):
        _check(x, name, (*lead, T, *shape), dev)
    return dev, N, T, plan


def plane_groups(opt: dict) -> tuple[str, ...]:
    """The optional plane groups (of ``VARIANTS``) a delayed launch carries,
    from its ``DELAYED_OPTIONAL`` planes (None or missing = absent): the
    variant its launch plan is made for."""
    return tuple(v for v, present in zip(VARIANTS, (
        opt.get("extends") is not None,
        opt.get("stale") is not None or opt.get("equiv") is not None,
        any(opt.get(k) is not None
            for k in ("acc_restart", "acc_deaf", "prop_restart", "prop_rc")),
    )) if present)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    """The SMs of a CUDA device (the batched delayed plan fills them)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_delayed_inputs(packed, net, cols, link, opt: dict, lead: tuple,
                          P: int, window: int, ticked, collect="summary",
                          lanes=None):
    """Checks a delayed launch's state, net and [*lead, T, ...] planes
    (cols as for sync, then the link plane and the ``DELAYED_OPTIONAL``
    planes in ``opt``), fills the absent columns of a present group
    (corruption, restart) with zeros, in place in ``opt``, and plans the
    launch (the batched entry, ``lanes`` a cell, where ``lead`` is (B,)).
    Returns (device, N, T, plan)."""
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    T = cols[0].shape[len(lead)]
    variant = plane_groups(opt)
    plan = (delayed_batched_launch_plan(
        A, N, P, T, lead[0], window=window, variant=variant, collect=collect,
        lanes=lanes, sms=_sm_count(dev))
            if lead else
            delayed_launch_plan(A, N, P, T, window=window, variant=variant))
    _check_geometry(plan)
    for name, x, shape in zip(
        PackedLeaseState._fields, packed, ((A, N), (A, N), (1, N), (1, N))
    ):
        _check(x, name, shape, dev)
    for name, x in zip(NetPlaneState._fields, net):
        _check(x, name, (A, N) if name in NetPlaneState._fields[:6] else (1, N),
               dev)
    given = dict(zip(("attempts", "releases", "acc_up", "pclk", "aclk"), cols),
                 link=link, **opt)
    for name, shape, _ in tick_planes(A, N, P, delayed=True, variant=variant):
        if given[name] is None and name in opt:  # absent column of a present group
            opt[name] = torch.zeros((*lead, T, *shape), dtype=I32,
                                    device=dev)
        else:
            _check(given[name], name, (*lead, T, *shape), dev)
    if ticked is not None and (
        ticked.dtype != torch.int64 or ticked.device != dev
        or ticked.numel() != 1
    ):
        raise ValueError("ticked must be a one-element int64 tensor on the "
                         "state's device")
    return dev, N, T, plan


def lease_window_sync(
    packed: PackedLeaseState,
    t0: int,
    attempts: torch.Tensor,   # [T, N] int32
    releases: torch.Tensor,   # [T, N] int32
    acc_up: torch.Tensor,     # [T, A] int32
    pclk: torch.Tensor,       # [T, P] int32
    aclk: torch.Tensor,       # [T, A] int32
    *,
    majority: int,
    lease_q4: int,
    n_proposers: int,
    guard_q4: int = None,
    window: int = 16,
) -> tuple[PackedLeaseState, torch.Tensor, torch.Tensor]:
    """Replay T synchronous ticks in ONE launch of the CUDA sync window
    kernel. Returns (packed', owners [T, N], counts [T, N])."""
    cols = (attempts, releases, acc_up, pclk, aclk)
    dev, N, T, plan = _check_sync_inputs(packed, cols, (), n_proposers, window)
    out = PackedLeaseState(*(torch.empty_like(x) for x in packed))
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    if N == 0 or T == 0:
        return PackedLeaseState(*(x.clone() for x in packed)), owners, counts
    ptrs = [*map(_ptr, packed), *map(_ptr, out), *map(_ptr, cols),
            _ptr(owners), _ptr(counts)]
    ints = [N, T, plan.n_acceptors, n_proposers, int(t0), plan.tw, majority,
            lease_q4, 0, lease_q4 if guard_q4 is None else guard_q4, 0, 1, 0]
    with torch.cuda.device(dev):
        _launch(plan, ptrs, ints, dev)
    _record(lease_window_sync, plan)
    return out, owners, counts


lease_window_sync.launches, lease_window_sync.plans = 0, set()


def lease_window_delayed(
    packed: PackedLeaseState,
    net: NetPlaneState,
    t0: int,
    attempts: torch.Tensor,   # [T, N] int32
    releases: torch.Tensor,   # [T, N] int32
    acc_up: torch.Tensor,     # [T, A] int32
    pclk: torch.Tensor,       # [T, P] int32
    aclk: torch.Tensor,       # [T, A] int32
    link: torch.Tensor,       # [T, P, A] int32
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    n_proposers: int,
    guard_q4: int = None,
    window: int = 16,
    skip_stable: bool = True,
    extends=None,
    stale=None,
    equiv=None,
    acc_restart=None,
    acc_deaf=None,
    prop_restart=None,
    prop_rc=None,
    ticked: torch.Tensor = None,  # [1] int64: adds the cell-ticks that ran the tick math
) -> tuple[PackedLeaseState, NetPlaneState, torch.Tensor, torch.Tensor]:
    """Replay T delayed-model ticks in ONE launch of the CUDA delayed window
    kernel. Optional planes follow :func:`lease_window_delayed_torch`
    (``None`` = absent: the kernel does no work for it). Returns
    (packed', net', owners [T, N], counts [T, N])."""
    cols = (attempts, releases, acc_up, pclk, aclk)
    opt = dict(extends=extends, stale=stale, equiv=equiv,
               acc_restart=acc_restart, acc_deaf=acc_deaf,
               prop_restart=prop_restart, prop_rc=prop_rc)
    dev, N, T, plan = _check_delayed_inputs(packed, net, cols, link, opt, (),
                                            n_proposers, window, ticked)
    out_lease = PackedLeaseState(*(torch.empty_like(x) for x in packed))
    out_net = NetPlaneState(*(torch.empty_like(x) for x in net))
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    if N == 0 or T == 0:
        return (PackedLeaseState(*(x.clone() for x in packed)),
                NetPlaneState(*(x.clone() for x in net)), owners, counts)
    ptrs = [
        *map(_ptr, packed), *map(_ptr, net),
        *map(_ptr, out_lease), *map(_ptr, out_net),
        _ptr(attempts), _ptr(releases), _ptr(extends),
        _ptr(acc_up), _ptr(pclk), _ptr(aclk), _ptr(link),
        *(_ptr(opt[k]) for k in DELAYED_OPTIONAL[1:]),
        _ptr(owners), _ptr(counts), _ptr(ticked),
    ]
    ints = [N, T, plan.n_acceptors, n_proposers, int(t0), plan.tw, majority,
            lease_q4, round_q4, lease_q4 if guard_q4 is None else guard_q4,
            int(bool(skip_stable)), 1, 0]
    with torch.cuda.device(dev):
        _launch(plan, ptrs, ints, dev)
    _record(lease_window_delayed, plan)
    return out_lease, out_net, owners, counts


lease_window_delayed.launches, lease_window_delayed.plans = 0, set()


def lease_window_sync_batched(
    packed: PackedLeaseState,
    t0: int,
    attempts: torch.Tensor,   # [B, T, N] int32
    releases: torch.Tensor,   # [B, T, N] int32
    acc_up: torch.Tensor,     # [B, T, A] int32
    pclk: torch.Tensor,       # [B, T, P] int32
    aclk: torch.Tensor,       # [B, T, A] int32
    *,
    majority: int,
    lease_q4: int,
    n_proposers: int,
    guard_q4: int = None,
    window: int = 16,
    collect: str = "summary",
):
    """Replay B scenarios of T synchronous ticks from one start state in
    ONE launch of the CUDA batched sync kernel (no final state; it stages
    BATCH_SUB ticks at a time, so ``window`` changes no result and no
    launch). Returns (owners, counts) [B, T, N] with ``collect="owners"``,
    else the :func:`window_summary` planes [B, N]."""
    B = attempts.shape[0]
    _check_batch(B, collect)
    cols = (attempts, releases, acc_up, pclk, aclk)
    dev, N, T, plan = _check_sync_inputs(packed, cols, (B,), n_proposers,
                                         window, collect)
    out, out_ptrs = _batch_outputs(plan, dev)
    if N == 0 or T == 0:
        return out
    ptrs = [*map(_ptr, packed), 0, 0, 0, 0, *map(_ptr, cols), *out_ptrs]
    ints = [N, T, plan.n_acceptors, n_proposers, int(t0), plan.tw, majority,
            lease_q4, 0, lease_q4 if guard_q4 is None else guard_q4, 0, B,
            int(collect == "summary")]
    with torch.cuda.device(dev):
        _launch(plan, ptrs, ints, dev)
    _record(lease_window_sync_batched, plan)
    return out


lease_window_sync_batched.launches = 0
lease_window_sync_batched.plans = set()


def lease_window_delayed_batched(
    packed: PackedLeaseState,
    net: NetPlaneState,
    t0: int,
    attempts: torch.Tensor,   # [B, T, N] int32
    releases: torch.Tensor,   # [B, T, N] int32
    acc_up: torch.Tensor,     # [B, T, A] int32
    pclk: torch.Tensor,       # [B, T, P] int32
    aclk: torch.Tensor,       # [B, T, A] int32
    link: torch.Tensor,       # [B, T, P, A] int32
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    n_proposers: int,
    guard_q4: int = None,
    window: int = 16,
    skip_stable: bool = True,
    collect: str = "summary",
    extends=None,
    stale=None,
    equiv=None,
    acc_restart=None,
    acc_deaf=None,
    prop_restart=None,
    prop_rc=None,
    ticked: torch.Tensor = None,  # [1] int64: cell-ticks that ran the tick math, all scenarios
    lanes: int = None,
):
    """Replay B scenarios of T delayed-model ticks from one start state
    ``(packed, net)`` in ONE launch of the CUDA batched delayed kernel (no
    final state). Optional planes are [B, T, ...] or None, as in
    :func:`lease_window_delayed`. ``lanes`` (threads a cell, of
    :func:`lane_counts`) overrides the plan's choice; no result depends on
    it. Returns (owners, counts) [B, T, N] with ``collect="owners"``, else
    the :func:`window_summary` planes [B, N]."""
    B = attempts.shape[0]
    _check_batch(B, collect)
    cols = (attempts, releases, acc_up, pclk, aclk)
    opt = dict(extends=extends, stale=stale, equiv=equiv,
               acc_restart=acc_restart, acc_deaf=acc_deaf,
               prop_restart=prop_restart, prop_rc=prop_rc)
    dev, N, T, plan = _check_delayed_inputs(packed, net, cols, link, opt,
                                            (B,), n_proposers, window, ticked,
                                            collect, lanes)
    out, out_ptrs = _batch_outputs(plan, dev)
    if N == 0 or T == 0:
        return out
    ptrs = [
        *map(_ptr, packed), *map(_ptr, net), *([0] * 16),
        _ptr(attempts), _ptr(releases), _ptr(extends),
        _ptr(acc_up), _ptr(pclk), _ptr(aclk), _ptr(link),
        *(_ptr(opt[k]) for k in DELAYED_OPTIONAL[1:]),
        *out_ptrs[:2], _ptr(ticked), *out_ptrs[2:],
    ]
    ints = [N, T, plan.n_acceptors, n_proposers, int(t0), plan.tw, majority,
            lease_q4, round_q4, lease_q4 if guard_q4 is None else guard_q4,
            int(bool(skip_stable)), B, int(collect == "summary")]
    with torch.cuda.device(dev):
        _launch(plan, ptrs, ints, dev)
    _record(lease_window_delayed_batched, plan)
    return out


lease_window_delayed_batched.launches = 0
lease_window_delayed_batched.plans = set()


#: the four kernel entries
ENTRIES = (lease_window_delayed, lease_window_sync,
           lease_window_delayed_batched, lease_window_sync_batched)


def launched_plans() -> set:
    """Every distinct plan the kernel entries launched in this process."""
    return set().union(*(fn.plans for fn in ENTRIES))


def reset_launches() -> None:
    """Zero the launch counts of every kernel entry and plain version (the
    entries' ``plans`` stay)."""
    for fn in (lease_window_delayed, lease_window_sync,
               lease_window_delayed_torch, lease_window_sync_torch,
               lease_window_delayed_batched, lease_window_sync_batched,
               lease_window_delayed_batched_torch,
               lease_window_sync_batched_torch):
        fn.launches = 0
