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
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    P = n_proposers
    T = attempts.shape[0]
    tw = max(1, min(int(window), T))
    _check_geometry(A, P, tw, 2 * A + P)
    for name, x, shape in zip(
        PackedLeaseState._fields, packed, ((A, N), (A, N), (1, N), (1, N))
    ):
        _check(x, name, shape, dev)
    _check(attempts, "attempts", (T, N), dev)
    _check(releases, "releases", (T, N), dev)
    _check(acc_up, "acc_up", (T, A), dev)
    _check(pclk, "pclk", (T, P), dev)
    _check(aclk, "aclk", (T, A), dev)
    out = PackedLeaseState(*(torch.empty_like(x) for x in packed))
    owners = torch.empty((T, N), dtype=I32, device=dev)
    counts = torch.empty((T, N), dtype=I32, device=dev)
    if N == 0 or T == 0:
        return PackedLeaseState(*(x.clone() for x in packed)), owners, counts
    ptrs = [*map(_ptr, packed), *map(_ptr, out), _ptr(attempts),
            _ptr(releases), _ptr(acc_up), _ptr(pclk), _ptr(aclk),
            _ptr(owners), _ptr(counts)]
    ints = [N, T, A, P, int(t0), tw, majority, lease_q4, 0,
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
    dev = _cuda_device(packed.promised)
    A, N = packed.promised.shape
    P = n_proposers
    T = attempts.shape[0]
    tw = max(1, min(int(window), T)) if T else 1
    corrupt = stale is not None or equiv is not None
    restart = any(
        x is not None for x in (acc_restart, acc_deaf, prop_restart, prop_rc)
    )
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
    _check(attempts, "attempts", (T, N), dev)
    _check(releases, "releases", (T, N), dev)
    if extends is not None:
        _check(extends, "extends", (T, N), dev)
    _check(acc_up, "acc_up", (T, A), dev)
    _check(pclk, "pclk", (T, P), dev)
    _check(aclk, "aclk", (T, A), dev)
    _check(link, "link", (T, P, A), dev)
    if corrupt or restart:  # the absent columns of a present group are 0
        za = torch.zeros((T, A), dtype=I32, device=dev)
        zp = torch.zeros((T, P), dtype=I32, device=dev)
    if corrupt:
        stale = za if stale is None else _check(stale, "stale", (T, A), dev)
        equiv = za if equiv is None else _check(equiv, "equiv", (T, A), dev)
    if restart:
        acc_restart = za if acc_restart is None else _check(
            acc_restart, "acc_restart", (T, A), dev)
        acc_deaf = za if acc_deaf is None else _check(
            acc_deaf, "acc_deaf", (T, A), dev)
        prop_restart = zp if prop_restart is None else _check(
            prop_restart, "prop_restart", (T, P), dev)
        prop_rc = zp if prop_rc is None else _check(
            prop_rc, "prop_rc", (T, P), dev)
    if ticked is not None and (
        ticked.dtype != torch.int64 or ticked.device != dev
        or ticked.numel() != 1
    ):
        raise ValueError("ticked must be a one-element int64 tensor on the "
                         "state's device")
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
        _ptr(stale), _ptr(equiv),
        _ptr(acc_restart), _ptr(acc_deaf), _ptr(prop_restart), _ptr(prop_rc),
        _ptr(owners), _ptr(counts), _ptr(ticked),
    ]
    ints = [N, T, A, P, int(t0), tw, majority, lease_q4, round_q4,
            lease_q4 if guard_q4 is None else guard_q4, int(bool(skip_stable))]
    with torch.cuda.device(dev):
        _launch("lease_window_delayed", ptrs, ints, dev)
    lease_window_delayed.launches += 1
    return out_lease, out_net, owners, counts


lease_window_delayed.launches = 0


def reset_launches() -> None:
    """Zero the launch counts of both kernels and both plain versions."""
    for fn in (lease_window_delayed, lease_window_sync,
               lease_window_delayed_torch, lease_window_sync_torch):
        fn.launches = 0
