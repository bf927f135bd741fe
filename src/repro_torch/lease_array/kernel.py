"""Time-resident window kernels of the lease plane: a whole ``[T, ...]``
scenario in ONE launch, and their plain PyTorch versions.

Two pairs of functions, one pair per kernel:

  ``lease_window_delayed`` / ``lease_window_delayed_torch`` — T ticks of the
      delayed in-flight model (``netplane.delayed_tick_math``);
  ``lease_window_sync`` / ``lease_window_sync_torch`` — T ticks of the
      zero-delay model (``ref.sync_tick_math``).

The first of each pair takes CUDA tensors only and launches the hand-written
kernel of ``csrc/lease_window.cu`` (one thread per cell, the cell's state in
registers for all T ticks; see the note at the top of that file) or raises.
The ``_torch`` plain version is a Python loop over ticks of the same tick
math, on any device — the CPU path and the yardstick the kernel is held
bit-exact against. It runs every tick: the kernel's window staging and
quiescence skip (``window``, ``skip_stable``) must not change a result, so
the plain version has neither, as ``repro``'s jnp path has neither. Each of
the four functions counts its calls in its ``launches`` attribute.

Each kernel also has a batched entry, the counterpart of the Pallas kernels
under ``jax.vmap`` in the reference's sweep: ``lease_window_delayed_batched``
/ ``lease_window_sync_batched`` replay B scenarios ([B, T, ...] planes) from
one shared start state in ONE launch (one grid row per scenario), write no
final state, and either return the [B, T, N] owner/count rows
(``collect="owners"``) or reduce them inside the kernel to three [B, N]
planes (``collect="summary"``: max owner count, owned ticks, final owner;
see :func:`window_summary`). Their plain versions (``*_batched_torch``) run
the plain window loop scenario by scenario and reduce in torch.
"""
from __future__ import annotations

import ctypes

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
#: the batched sync kernel's warps a block and ticks a warp stages at once
#: (csrc/lease_window.cu kBatchWarps, kSub)
SYNC_BATCH_WARPS, SYNC_BATCH_SUB = 4, 16


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


def _batch_outputs(B: int, T: int, N: int, collect: str, dev):
    """The batched kernels' outputs and their pointers: (owners, counts)
    [B, T, N] rows, or the three [B, N] summary planes."""
    if collect == "owners":
        out = tuple(torch.empty((B, T, N), dtype=I32, device=dev)
                    for _ in range(2))
        return out, [*map(_ptr, out), 0, 0, 0]
    out = tuple(torch.empty((B, N), dtype=I32, device=dev) for _ in range(3))
    return out, [0, 0, *map(_ptr, out)]


def _check_geometry(A: int, P: int, tw: int, per_tick: int) -> None:
    if not 1 <= A <= MAX_ACCEPTORS:
        raise ValueError(
            f"the lease kernels take 1..{MAX_ACCEPTORS} acceptors; got {A}"
        )
    if P < 1:
        raise ValueError(f"need at least one proposer; got {P}")
    smem = per_tick * tw * 4
    if smem > MAX_SMEM:
        raise ValueError(
            f"a {tw}-tick window stages {smem} bytes of shared memory "
            f"(max {MAX_SMEM}); use a smaller window"
        )


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _launch(name: str, ptrs: list, ints: list, device) -> None:
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


def _check_sync_inputs(packed, cols, lead: tuple, P: int, window: int):
    """Checks a sync launch's state and [*lead, T, ...] planes (cols:
    attempts, releases, acc_up, pclk, aclk). Returns (device, A, N, T, tw)."""
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    T = cols[0].shape[len(lead)]
    tw = max(1, min(int(window), T))
    _check_geometry(A, P, tw, 2 * A + P)
    for name, x, shape in zip(
        PackedLeaseState._fields, packed, ((A, N), (A, N), (1, N), (1, N))
    ):
        _check(x, name, shape, dev)
    for name, x, rows in zip(("attempts", "releases", "acc_up", "pclk", "aclk"),
                             cols, (N, N, A, P, A)):
        _check(x, name, (*lead, T, rows), dev)
    return dev, A, N, T, tw


def _check_delayed_inputs(packed, net, cols, link, opt: dict, lead: tuple,
                          P: int, window: int, ticked):
    """Checks a delayed launch's state, net and [*lead, T, ...] planes
    (cols as for sync, then the link plane and the ``DELAYED_OPTIONAL``
    planes in ``opt``), and fills the absent columns of a present group
    (corruption, restart) with zeros, in place in ``opt``. Returns
    (device, A, N, T, tw)."""
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    T = cols[0].shape[len(lead)]
    tw = max(1, min(int(window), T)) if T else 1
    corrupt = opt["stale"] is not None or opt["equiv"] is not None
    restart = any(opt[k] is not None
                  for k in ("acc_restart", "acc_deaf", "prop_restart", "prop_rc"))
    _check_geometry(
        A, P, tw,
        2 * A + P + P * A + (2 * A if corrupt else 0)
        + (2 * A + 2 * P if restart else 0),
    )
    for name, x, shape in zip(
        PackedLeaseState._fields, packed, ((A, N), (A, N), (1, N), (1, N))
    ):
        _check(x, name, shape, dev)
    for name, x in zip(NetPlaneState._fields, net):
        _check(x, name, (A, N) if name in NetPlaneState._fields[:6] else (1, N),
               dev)
    for name, x, rows in zip(("attempts", "releases", "acc_up", "pclk", "aclk"),
                             cols, (N, N, A, P, A)):
        _check(x, name, (*lead, T, rows), dev)
    if opt["extends"] is not None:
        _check(opt["extends"], "extends", (*lead, T, N), dev)
    _check(link, "link", (*lead, T, P, A), dev)
    groups = ((corrupt, (("stale", A), ("equiv", A))),
              (restart, (("acc_restart", A), ("acc_deaf", A),
                         ("prop_restart", P), ("prop_rc", P))))
    for present, names in groups:
        if present:  # the absent columns of a present group are 0
            for name, rows in names:
                opt[name] = (
                    torch.zeros((*lead, T, rows), dtype=I32, device=dev)
                    if opt[name] is None
                    else _check(opt[name], name, (*lead, T, rows), dev))
    if ticked is not None and (
        ticked.dtype != torch.int64 or ticked.device != dev
        or ticked.numel() != 1
    ):
        raise ValueError("ticked must be a one-element int64 tensor on the "
                         "state's device")
    return dev, A, N, T, tw


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
    dev, A, N, T, tw = _check_sync_inputs(packed, cols, (), n_proposers, window)
    out = PackedLeaseState(*(torch.empty_like(x) for x in packed))
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    if N == 0 or T == 0:
        return PackedLeaseState(*(x.clone() for x in packed)), owners, counts
    ptrs = [*map(_ptr, packed), *map(_ptr, out), *map(_ptr, cols),
            _ptr(owners), _ptr(counts)]
    ints = [N, T, A, n_proposers, int(t0), tw, majority, lease_q4, 0,
            lease_q4 if guard_q4 is None else guard_q4, 0]
    with torch.cuda.device(dev):
        _launch("lease_window_sync", ptrs, ints, dev)
    lease_window_sync.launches += 1
    return out, owners, counts


lease_window_sync.launches = 0


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
    dev, A, N, T, tw = _check_delayed_inputs(packed, net, cols, link, opt, (),
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
    ints = [N, T, A, n_proposers, int(t0), tw, majority, lease_q4, round_q4,
            lease_q4 if guard_q4 is None else guard_q4, int(bool(skip_stable))]
    with torch.cuda.device(dev):
        _launch("lease_window_delayed", ptrs, ints, dev)
    lease_window_delayed.launches += 1
    return out_lease, out_net, owners, counts


lease_window_delayed.launches = 0


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
    SYNC_BATCH_SUB ticks at a time, so ``window`` changes no result and no
    launch). Returns (owners, counts) [B, T, N] with ``collect="owners"``,
    else the :func:`window_summary` planes [B, N]."""
    B = attempts.shape[0]
    _check_batch(B, collect)
    cols = (attempts, releases, acc_up, pclk, aclk)
    dev, A, N, T, tw = _check_sync_inputs(packed, cols, (B,), n_proposers,
                                          window)
    # the batched kernel stages SYNC_BATCH_SUB ticks a warp, whatever the window
    _check_geometry(A, n_proposers, SYNC_BATCH_SUB,
                    SYNC_BATCH_WARPS * (2 * A + n_proposers))
    out, out_ptrs = _batch_outputs(B, T, N, collect, dev)
    if N == 0 or T == 0:
        return out
    ptrs = [*map(_ptr, packed), 0, 0, 0, 0, *map(_ptr, cols), *out_ptrs]
    ints = [N, T, A, n_proposers, int(t0), tw, majority, lease_q4, 0,
            lease_q4 if guard_q4 is None else guard_q4, 0, B,
            int(collect == "summary")]
    with torch.cuda.device(dev):
        _launch("lease_window_sync_batched", ptrs, ints, dev)
    lease_window_sync_batched.launches += 1
    return out


lease_window_sync_batched.launches = 0


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
):
    """Replay B scenarios of T delayed-model ticks from one start state
    ``(packed, net)`` in ONE launch of the CUDA delayed window kernel (no
    final state). Optional planes are [B, T, ...] or None, as in
    :func:`lease_window_delayed`. Returns (owners, counts) [B, T, N] with
    ``collect="owners"``, else the :func:`window_summary` planes [B, N]."""
    B = attempts.shape[0]
    _check_batch(B, collect)
    cols = (attempts, releases, acc_up, pclk, aclk)
    opt = dict(extends=extends, stale=stale, equiv=equiv,
               acc_restart=acc_restart, acc_deaf=acc_deaf,
               prop_restart=prop_restart, prop_rc=prop_rc)
    dev, A, N, T, tw = _check_delayed_inputs(packed, net, cols, link, opt,
                                             (B,), n_proposers, window, ticked)
    out, out_ptrs = _batch_outputs(B, T, N, collect, dev)
    if N == 0 or T == 0:
        return out
    ptrs = [
        *map(_ptr, packed), *map(_ptr, net), *([0] * 16),
        _ptr(attempts), _ptr(releases), _ptr(extends),
        _ptr(acc_up), _ptr(pclk), _ptr(aclk), _ptr(link),
        *(_ptr(opt[k]) for k in DELAYED_OPTIONAL[1:]),
        *out_ptrs[:2], _ptr(ticked), *out_ptrs[2:],
    ]
    ints = [N, T, A, n_proposers, int(t0), tw, majority, lease_q4, round_q4,
            lease_q4 if guard_q4 is None else guard_q4, int(bool(skip_stable)),
            B, int(collect == "summary")]
    with torch.cuda.device(dev):
        _launch("lease_window_delayed_batched", ptrs, ints, dev)
    lease_window_delayed_batched.launches += 1
    return out


lease_window_delayed_batched.launches = 0


def reset_launches() -> None:
    """Zero the launch counts of every kernel entry and plain version."""
    for fn in (lease_window_delayed, lease_window_sync,
               lease_window_delayed_torch, lease_window_sync_torch,
               lease_window_delayed_batched, lease_window_sync_batched,
               lease_window_delayed_batched_torch,
               lease_window_sync_batched_torch):
        fn.launches = 0
