"""Public entry points of the lease plane: backend dispatch between the
plain PyTorch window loops and the CUDA window kernels.

The bulk path is :func:`lease_window_scan`: a whole ``[T, …]`` scenario in
ONE dispatch. Both backends run the same packed tick math
(``ref.sync_tick_math`` / ``netplane.delayed_tick_math``) and agree
bit-for-bit:

  - ``"torch"`` — the plain version (``kernel.lease_window_*_torch``): a
                  Python loop over ticks of tensor ops, on any device; the
                  CPU path and the yardstick the kernels are held against;
  - ``"cuda"``  — the hand-written window kernels (``kernel.lease_window_*``,
                  ``csrc/lease_window.cu``); CUDA tensors only.

With ``backend=None`` the state's device decides: ``"cuda"`` on a CUDA
device, ``"torch"`` on the CPU.

One step: :func:`lease_plane_tick` advances every cell one tick of either
network model through the same dispatch. Its per-tick inputs are a
:class:`~repro_torch.lease_array.scenario.TickInputs` bundle. The
pre-Scenario one-argument-per-plane forms, :func:`lease_plane_step` (sync)
and :func:`lease_plane_step_delayed`, remain as deprecated shims: each
warns, builds the ``TickInputs`` and calls :func:`lease_plane_tick`, so on
the card they run the same window kernels.

The falsifier's margins sweep has no kernel (nor has the reference's):
:func:`_margin_scan_impl` replays a batch of scenarios as ONE plain delayed
tick loop on the state's device, the batch folded into the cell axis, and
reduces the §4 boundary-proximity margins per scenario.

Absent means honest: an optional plane (corruption, restart, extends) that
sits entirely at its default is stripped before dispatch, and a stripped
plane adds no work to either backend. A restart history (``rst0``) keeps
restart mode on even when a dispatch's restart planes are quiet, so the
ballot encoding never switches mid-trace.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .kernel import (
    DELAYED_OPTIONAL,
    lease_window_delayed,
    lease_window_delayed_batched,
    lease_window_delayed_batched_torch,
    lease_window_delayed_torch,
    lease_window_sync,
    lease_window_sync_batched,
    lease_window_sync_batched_torch,
    lease_window_sync_torch,
)
from .netplane import (
    R_PROPOSING,
    NetPlaneState,
    _votes,
    delayed_tick_math,
    legs_columns,
    pack_link,
)
from .scenario import (
    CORRUPTION_PLANES,
    EXTEND_PLANES,
    PLANES,
    RESTART_PLANES,
    TickInputs,
    make_tick,
)
from .state import (
    I32,
    PACK_MASK,
    PACK_SHIFT,
    QUARTERS,
    LeaseArrayState,
    PackedLeaseState,
    ballot_proposer,
    check_pack_budget,
    clock_select,
    pack_state,
    packed_q4,
    rate1_clock,
    unpack_state,
)

BACKENDS = ("torch", "cuda")


def default_backend(device) -> str:
    """The kernels on a CUDA device, the plain version elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _legacy_plane(x):
    """A plane argument of a deprecated spelling as a host array (None, the
    plane's default, stays None)."""
    return None if x is None else _host(x)


def _as_i32(x, device) -> torch.Tensor:
    """A plane (numpy array, tensor or scalar list) as a contiguous int32
    tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=I32).contiguous()
    a = np.asarray(x)
    if a.dtype != np.int32 or not a.flags.c_contiguous or not a.flags.writeable:
        a = np.array(a, dtype=np.int32, order="C")
    return torch.from_numpy(a).to(device)


def _all_equal(v, value: int) -> bool:
    if isinstance(v, torch.Tensor):
        return bool((v == value).all())
    return bool((np.asarray(v) == value).all())


def _local_clock_planes(t0: int, T: int, clk0, planes: dict, n_proposers: int,
                        n_acceptors: int, device, lead: tuple = ()):
    """Absolute per-tick local-clock planes ``(pclk [T, P], aclk [T, A])``:
    ``clk0`` (each node's accumulated local quarter-ticks at ``t0``) plus
    the exclusive prefix sum of the scenario's rate planes. ``clk0=None``
    is the rate-1 reading ``4·t0`` on every node; a rate plane missing from
    the dict means the drift-free DEFAULT_RATE step. With a ``lead`` batch
    shape (a sweep's ``(B,)``) the rate planes are ``lead + [T, ...]`` and
    so are the clock planes, each scenario's from the same ``clk0``."""

    def one(rate, rows: int, c0):
        c0 = (rate1_clock(t0, rows, device=device) if c0 is None
              else _as_i32(c0, device))
        if rate is None:
            steps = QUARTERS * torch.arange(T, dtype=I32, device=device)
            clk = c0[None, :] + steps[:, None]
            return clk.expand(*lead, T, rows).contiguous() if lead else clk
        rate = _as_i32(rate, device)
        return c0[None, :] + torch.cumsum(rate, dim=-2, dtype=I32) - rate

    pc0, ac0 = (None, None) if clk0 is None else clk0
    return (
        one(planes.get("prop_rate"), n_proposers, pc0),
        one(planes.get("acc_rate"), n_acceptors, ac0),
    )


def _restart_planes(rst0, arst, prst, aclk, lease_q4: int, guard: bool):
    """Absolute per-tick crash/restart planes, precomputed like the clock
    planes so restart state needs no carry through the tick loop:

      ``rc [T, P]``        INCLUSIVE running per-proposer restart count;
      ``deaf [T, A]``      1 while the acceptor's local clock has not yet
                           advanced a maximal lease span (``lease_q4``) past
                           its latest restart (a running cummax of
                           restart-minted horizons vs ``aclk``);
      ``deaf_rem [T, A]``  local quarter-ticks of deaf window remaining.

    ``rst0`` is the (rc0 [P], deaf_until0 [A]) restart history at t0
    (None = fresh). ``guard=False`` (the §4 negative control) zeroes the
    deaf window. The planes may carry a leading batch axis (a sweep's)."""
    device = aclk.device
    rc0, du0 = (None, None) if rst0 is None else rst0
    rc = torch.cumsum(prst, dim=-2, dtype=I32)
    if rc0 is not None:
        rc = rc + _as_i32(rc0, device)[None, :]
    minted = torch.where(arst > 0, aclk + lease_q4, 0)
    du = torch.cummax(minted, dim=-2).values
    if du0 is not None:
        du = torch.maximum(du, _as_i32(du0, device)[None, :])
    deaf_rem = (du - aclk).clamp(min=0)
    if not guard:
        deaf_rem = torch.zeros_like(deaf_rem)
    return rc, (deaf_rem > 0).to(I32), deaf_rem


def _device_planes(planes: dict, dev, clk0, rst0, t0: int, *, n_proposers: int,
                   n_acceptors: int, lease_q4: int, restart_guard: bool,
                   sync: bool) -> dict:
    """The scenario planes of one dispatch as int32 tensors on ``dev``, in
    the window kernels' argument form: attempts, releases, acc_up, the
    local-clock planes pclk/aclk, the fused link plane (delayed model
    only), and the optional ``extends``/``stale``/``equiv``/restart columns
    (None when absent: absent means honest; restart mode adds ``deaf_rem``,
    which only the margin scan reads). ``planes`` are [T, ...], or
    [B, T, ...] for a sweep (every plane batched alike)."""
    P, A = n_proposers, n_acceptors
    attempts = _as_i32(planes["attempts"], dev)
    *lead, T, _ = attempts.shape
    lead = tuple(lead)
    pclk, aclk = _local_clock_planes(t0, T, clk0, planes, P, A, dev, lead)
    out = dict(attempts=attempts, releases=_as_i32(planes["releases"], dev),
               acc_up=_as_i32(planes["acc_up"], dev), pclk=pclk, aclk=aclk)
    # the adversarial corruption planes: absent means honest
    stale = planes.get("acc_stale")
    equiv = planes.get("acc_equiv")
    if stale is not None or equiv is not None:
        if sync:
            raise ValueError(
                "corruption planes (acc_stale/acc_equiv) need the delayed "
                "model; the synchronous tick cannot honor them"
            )
        za = torch.zeros((*lead, T, A), dtype=I32, device=dev)
        out["stale"] = za if stale is None else _as_i32(stale, dev)
        out["equiv"] = za if equiv is None else _as_i32(equiv, dev)
    # the §6 extends plane: same omit-means-honest contract
    ext = planes.get("extends")
    if ext is not None:
        if sync:
            raise ValueError(
                "the extends plane (§6 owner extension) needs the delayed "
                "model; the synchronous tick cannot honor it"
            )
        out["extends"] = _as_i32(ext, dev)
    # the crash/restart planes: a restart history (rst0) keeps restart mode
    # on across dispatches even when these planes are quiet
    arst = planes.get("acc_restart")
    prst = planes.get("prop_restart")
    if arst is not None or prst is not None or rst0 is not None:
        if sync:
            raise ValueError(
                "restart planes (acc_restart/prop_restart) need the "
                "delayed model; the synchronous tick cannot honor them"
            )
        arst = (torch.zeros((*lead, T, A), dtype=I32, device=dev)
                if arst is None else _as_i32(arst, dev))
        prst = (torch.zeros((*lead, T, P), dtype=I32, device=dev)
                if prst is None else _as_i32(prst, dev))
        rc, deaf, deaf_rem = _restart_planes(
            rst0, arst, prst, aclk, lease_q4, restart_guard
        )
        out.update(acc_restart=arst, acc_deaf=deaf, prop_restart=prst,
                   prop_rc=rc, deaf_rem=deaf_rem)
    if not sync:
        out["link"] = pack_link(_as_i32(planes["delay"], dev),
                                _as_i32(planes["drop"], dev))  # [.., T, P, A]
    return out


def _check_backend(backend: str, dev) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown lease-plane backend {backend!r}")
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(
            f"backend 'cuda' runs the CUDA kernels and needs CUDA tensors; "
            f"the state is on {dev} (use backend 'torch' there)"
        )


def _window_scan_impl(
    state: LeaseArrayState,
    net,
    t0: int,
    clk0,
    rst0,
    planes: dict,
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int,
    backend: str,
    sync: bool,
    window: int,
    restart_guard: bool = True,
    skip_stable: bool = True,
):
    """Shared body of the fused scan. ``planes`` is the Scenario plane dict
    ([T, ...] arrays or tensors); ``clk0`` the (prop [P], acc [A])
    local-clock offsets at ``t0`` (None = ``4·t0``); ``rst0`` the
    (restart-counter [P], deaf-until [A]) restart history at ``t0`` (None =
    fresh). Returns (state', net', owners [T, N], counts [T, N])."""
    dev = state.highest_promised.device
    _check_backend(backend, dev)
    P = state.n_proposers
    A = state.highest_promised.shape[0]
    t0 = int(t0)
    d = _device_planes(planes, dev, clk0, rst0, t0, n_proposers=P,
                       n_acceptors=A, lease_q4=lease_q4,
                       restart_guard=restart_guard, sync=sync)
    packed = pack_state(state)
    if backend == "cuda":
        packed = PackedLeaseState(*(x.contiguous() for x in packed))
    cols = (d["attempts"], d["releases"], d["acc_up"], d["pclk"], d["aclk"])

    if sync:
        kw = dict(majority=majority, lease_q4=lease_q4, n_proposers=P,
                  guard_q4=guard_q4)
        if backend == "cuda":
            packed, owners, counts = lease_window_sync(
                packed, t0, *cols, window=window, **kw,
            )
        else:
            packed, owners, counts = lease_window_sync_torch(
                packed, t0, *cols, **kw,
            )
        new_net = net
    else:
        net = NetPlaneState(*(x.contiguous() for x in net))
        kw = dict(majority=majority, lease_q4=lease_q4, round_q4=round_q4,
                  n_proposers=P, guard_q4=guard_q4,
                  **{k: d.get(k) for k in DELAYED_OPTIONAL})
        args = (packed, net, t0, *cols, d["link"])
        if backend == "cuda":
            packed, new_net, owners, counts = lease_window_delayed(
                *args, window=window, skip_stable=skip_stable, **kw)
        else:
            packed, new_net, owners, counts = lease_window_delayed_torch(
                *args, **kw)
    return unpack_state(packed, P), new_net, owners, counts


def _sweep_scan_impl(
    state: LeaseArrayState,
    net,
    t0: int,
    clk0,
    rst0,
    planes: dict,
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int,
    backend: str,
    sync: bool,
    window: int,
    collect: str,
    restart_guard: bool = True,
    skip_stable: bool = True,
):
    """The batched body of ``LeaseArrayEngine.sweep``: B stacked scenarios
    (``planes`` [B, T, ...]) each replayed from the same start (state, net,
    t0, clk0, rst0) in ONE dispatch, the state left as it is. Returns
    (owners, counts) [B, T, N] with ``collect="owners"``, else the
    per-cell summary planes (max owner count, owned ticks, final owner)
    [B, N] (``kernel.window_summary``)."""
    dev = state.highest_promised.device
    _check_backend(backend, dev)
    P = state.n_proposers
    A = state.highest_promised.shape[0]
    t0 = int(t0)
    d = _device_planes(planes, dev, clk0, rst0, t0, n_proposers=P,
                       n_acceptors=A, lease_q4=lease_q4,
                       restart_guard=restart_guard, sync=sync)
    packed = PackedLeaseState(*(x.contiguous() for x in pack_state(state)))
    cols = (d["attempts"], d["releases"], d["acc_up"], d["pclk"], d["aclk"])
    cuda = backend == "cuda"
    if sync:
        kw = dict(majority=majority, lease_q4=lease_q4, n_proposers=P,
                  guard_q4=guard_q4, collect=collect)
        if cuda:
            return lease_window_sync_batched(packed, t0, *cols, window=window,
                                             **kw)
        return lease_window_sync_batched_torch(packed, t0, *cols, **kw)
    net = NetPlaneState(*(x.contiguous() for x in net))
    kw = dict(majority=majority, lease_q4=lease_q4, round_q4=round_q4,
              n_proposers=P, guard_q4=guard_q4, collect=collect,
              **{k: d.get(k) for k in DELAYED_OPTIONAL})
    args = (packed, net, t0, *cols, d["link"])
    if cuda:
        return lease_window_delayed_batched(*args, window=window,
                                            skip_stable=skip_stable, **kw)
    return lease_window_delayed_batched_torch(*args, **kw)


#: "never got close" sentinel for the min-tracked margin components
MARGIN_BIG = 1 << 28

#: the margin components, in the order the scan carries them
MARGIN_NAMES = ("votes_gap", "tie_q4", "ghost_q4", "deaf_q4", "open_rounds")


def _scenario_columns(x: torch.Tensor, n_cells: int) -> torch.Tensor:
    """[B, T, ...] per-scenario rows -> [T, ..., B·N]: each scenario's rows
    repeated over its N cells (column b·N + n)."""
    B, T, *rows = x.shape
    y = x.movedim(0, -1).unsqueeze(-1)  # [T, ..., B, 1]
    return y.expand(T, *rows, B, n_cells).reshape(T, *rows, B * n_cells)


def _margin_scan_impl(
    state: LeaseArrayState,
    net,
    t0: int,
    clk0,
    rst0,
    planes: dict,
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int,
    restart_guard: bool = True,
):
    """The body of ``engine.sweep(collect="margins")``: B stacked scenarios
    (``planes`` [B, T, ...]) replayed from one start (state, net, t0, clk0,
    rst0) by the plain delayed tick with §4 boundary-proximity margins
    reduced per scenario, as int32 [B] tensors, never [B, T, N]:

      ``votes_gap``   min votes still missing for a *foreign* round to
                      reach a majority while another proposer's belief is
                      live (0: the violating vote is already in flight);
      ``tie_q4``      min |owner expiry − owner local clock| in quarter-
                      ticks over ticks whose release (or, in extend mode,
                      extend) names the live owner: the guarded-expiry tie;
      ``ghost_q4``    min local quarter-ticks by which a majority-accepted
                      claim missed its own guarded timer (§3 step 5);
      ``deaf_q4``     min local quarter-ticks of deaf window left when a
                      post-restart deaf acceptor refused a due request of
                      the open round while it was one vote short of a
                      foreign quorum (in extend mode also the owner's own
                      extend round);
      ``open_rounds`` max cells of the scenario with a round open at once.

    Min components start at ``MARGIN_BIG`` ("never got close"). Always the
    delayed model (zero-delay planes are the sync model's special case bit
    for bit), and always plain torch ops on the state's device: the kernels
    have no margins mode. The batch is ONE tick loop: it folds into the
    cell axis (B·N columns), each scenario's per-node rows and [P, A] link
    repeated over its cells (``legs_columns``). Returns (owners [B, T, N],
    counts [B, T, N], margins dict of [B] tensors), the counterpart of the
    reference's ``ops._margin_scan_impl`` under ``vmap``.
    """
    dev = state.highest_promised.device
    P = state.n_proposers
    A, N = state.highest_promised.shape
    t0 = int(t0)
    d = _device_planes(planes, dev, clk0, rst0, t0, n_proposers=P,
                       n_acceptors=A, lease_q4=lease_q4,
                       restart_guard=restart_guard, sync=False)
    B, T = d["attempts"].shape[:2]

    def cells(x):  # [B, T, N] -> [T, 1, B·N]
        return x.transpose(0, 1).reshape(T, 1, B * N)

    att, rel = cells(d["attempts"]), cells(d["releases"])
    up, pclk, aclk, link = (_scenario_columns(d[k], N)
                            for k in ("acc_up", "pclk", "aclk", "link"))
    extend = d.get("extends") is not None
    ext = cells(d["extends"]) if extend else None
    corrupt = d.get("stale") is not None
    if corrupt:
        stale, equiv = (_scenario_columns(d[k], N) for k in ("stale", "equiv"))
    restart = d.get("acc_restart") is not None
    if restart:
        arst, deaf, prst, rc, deaf_rem = (
            _scenario_columns(d[k], N) for k in
            ("acc_restart", "acc_deaf", "prop_restart", "prop_rc", "deaf_rem"))
    lease = tuple(x.repeat(1, B) for x in pack_state(state))
    netc = tuple(x.repeat(1, B) for x in net)
    big = MARGIN_BIG

    def per_scenario_min(x, mask):  # [rows, B·N] -> [B]
        return torch.where(mask, x, big).view(-1, B, N).amin(dim=(0, 2))

    m = [torch.full((B,), big, dtype=I32, device=dev) for _ in range(4)]
    m.append(torch.zeros(B, dtype=I32, device=dev))
    owners = torch.empty((B, T, N), dtype=I32, device=dev)
    counts = torch.empty((B, T, N), dtype=I32, device=dev)
    for tau in range(T):
        t = t0 + tau
        adv = {}
        if extend:
            adv["extend"] = ext[tau]
        if corrupt:
            adv.update(stale=stale[tau], equiv=equiv[tau])
        if restart:
            adv.update(acc_restart=arst[tau], acc_deaf=deaf[tau],
                       prop_restart=prst[tau], prop_rc=rc[tau])
        pc = pclk[tau]
        # pre-tick: the guarded-expiry tie at releases (and extends) that
        # name the live owner, its packed expiry against its clock now
        own_id, ownp = lease[2], lease[3]
        names_owner = (rel[tau] >= 0) & (own_id == rel[tau])
        if extend:
            names_owner = names_owner | ((ext[tau] >= 0) & (own_id == ext[tau]))
        tie = per_scenario_min(
            (packed_q4(ownp) - clock_select(pc, own_id)).abs(),
            names_owner & (ownp > 0))
        # pre-tick: the deaf-window boundary, a due request of the open
        # round at a deaf acceptor while that round is one vote short of a
        # quorum against a live belief: the refusal the M-wait exists for
        if restart:
            live_min = (QUARTERS * t + 1) << PACK_SHIFT
            rnd_b = netc[6]
            round_req = torch.zeros_like(netc[0], dtype=torch.bool)
            for slot in (netc[0], netc[3]):  # prepare, propose requests
                round_req = round_req | ((slot > 0) & (slot < live_min)
                                         & ((slot & PACK_MASK) == rnd_b))
            against = (rnd_b > 0) & (ownp > 0)
            if not extend:  # extend mode counts the owner's own round too
                against = against & (own_id != ballot_proposer(rnd_b, P))
            one_short = torch.maximum(
                _votes(netc[10], A), _votes(netc[11], A)) == majority - 1
            deaf_m = per_scenario_min(
                deaf_rem[tau],
                (deaf_rem[tau] > 0) & round_req & against & one_short)
        lease, netc, count = delayed_tick_math(
            lease, netc, t, att[tau], rel[tau], up[tau], pc, aclk[tau],
            link[tau], majority=majority, lease_q4=lease_q4,
            round_q4=round_q4, n_proposers=P, guard_q4=guard_q4,
            legs=legs_columns, **adv,
        )
        # post-tick: the contention gap, and ghost-guard refusals still in
        # the round rows (a refused claim leaves its round R_PROPOSING with
        # a majority of accept bits)
        own_id, ownp = lease[2], lease[3]
        rnd_b, rnd_phase, rnd_expiry = netc[6], netc[7], netc[8]
        rnd_prop = ballot_proposer(rnd_b, P)
        accs = _votes(netc[11], A)
        nvotes = torch.maximum(_votes(netc[10], A), accs)
        contested = (rnd_b > 0) & (ownp > 0) & (own_id != rnd_prop)
        refused = (rnd_b > 0) & (rnd_phase == R_PROPOSING) & (accs >= majority)
        step = [
            per_scenario_min((majority - nvotes).clamp(min=0), contested),
            tie,
            per_scenario_min(
                clock_select(pc, rnd_prop) - rnd_expiry + 1, refused),
        ]
        for i, v in enumerate(step + ([deaf_m] if restart else [])):
            m[i] = torch.minimum(m[i], v)
        m[4] = torch.maximum(
            m[4], (rnd_b > 0).view(B, N).sum(dim=1, dtype=I32))
        owners[:, tau] = own_id.view(B, N)
        counts[:, tau] = count.view(B, N)
    return owners, counts, dict(zip(MARGIN_NAMES, m))


def _guard_pack_budget(
    t0, n_ticks, planes, *, n_proposers, lease_q4, sync, clk0=None,
    rst0=None,
):
    """Host-side overflow guard for the public entry points: a tick past
    ``state.max_pack_tick`` would silently corrupt the packed (deadline,
    ballot) fields, so refuse it here. Fast clocks shrink the budget (the
    rate planes' maximum step and any clock offsets already ahead of the
    rate-1 reading are charged), and restart mode charges the ballot carve
    plus the highest per-proposer restart count."""
    delay = None if sync else planes.get("delay")
    t0 = int(t0)
    max_delay = 0 if delay is None else int(_host(delay).max(initial=0))
    max_rate = max(
        (
            int(_host(planes[k]).max(initial=0))
            for k in ("prop_rate", "acc_rate") if planes.get(k) is not None
        ),
        default=QUARTERS,
    )
    max_rate = max(max_rate, QUARTERS)
    clk_slack = 0
    if clk0 is not None:
        clk_max = max(int(_host(c).max(initial=0)) for c in clk0)
        clk_slack = max(0, clk_max - max_rate * t0)
    arst = planes.get("acc_restart")
    prst = planes.get("prop_restart")
    max_restarts = 0
    if arst is not None or prst is not None or rst0 is not None:
        rc_end = np.zeros(n_proposers, np.int64)
        if prst is not None:
            rc_end += _host(prst).astype(np.int64).reshape(
                -1, n_proposers).sum(axis=0)
        if rst0 is not None:
            rc_end += _host(rst0[0]).astype(np.int64)
        # acc-only restart schedules still switch the ballot encoding, so
        # charge at least one carve slot
        max_restarts = max(1, int(rc_end.max(initial=0)))
    check_pack_budget(
        t0 + n_ticks, n_proposers, lease_q4, max_delay,
        max_rate=max_rate, clk_slack=clk_slack, max_restarts=max_restarts,
    )


def strip_default_planes(planes: dict) -> dict:
    """Drop optional fault planes sitting entirely at their registered
    default: all-default corruption/restart/extends planes ARE the honest
    engine, and a stripped plane adds no work to the dispatch."""
    return {
        k: v for k, v in planes.items()
        if not (
            k in CORRUPTION_PLANES + RESTART_PLANES + EXTEND_PLANES
            and _all_equal(v, PLANES[k].default)
        )
    }


def lease_window_scan(
    state: LeaseArrayState,
    net,
    t0: int,
    planes: dict,
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int = None,
    clk0=None,
    rst0=None,
    restart_guard: bool = True,
    backend: str = None,
    sync: bool = False,
    window: int = 16,
    skip_stable: bool = True,
) -> tuple[LeaseArrayState, NetPlaneState, torch.Tensor, torch.Tensor]:
    """Replay a whole [T]-tick scenario-plane dict in ONE dispatch.

    ``sync=True`` runs the zero-delay synchronous model (``net`` passes
    through untouched; the planes' delay/drop entries are ignored);
    ``sync=False`` runs the delayed in-flight model. ``window`` is the
    number of ticks the kernels stage per shared-memory window (and the
    quiescence vote's span). ``guard_q4`` is the proposer's drift-guarded
    own timespan (default: ``lease_q4``, the ε=0 case) and ``clk0`` the
    (prop [P], acc [A]) local-clock offsets at ``t0`` (default: ``4·t0``).
    ``rst0`` is the (restart-counter [P], deaf-until [A]) restart history
    at ``t0`` (None = fresh; its presence keeps restart mode on);
    ``restart_guard=False`` disables the post-restart deaf window — the §4
    negative control. ``skip_stable=False`` disables the delayed kernel's
    quiescence skip (results are bit-identical either way); ``window`` and
    ``skip_stable`` shape only the CUDA kernels' work, so the plain
    ``"torch"`` backend ignores both. ``backend=None`` picks by the
    state's device. Returns (new_state, new_net, owners [T, N],
    owner_counts [T, N]) on the state's device.
    """
    if guard_q4 is None:
        guard_q4 = lease_q4
    if backend is None:
        backend = default_backend(state.highest_promised.device)
    planes = strip_default_planes(planes)
    _guard_pack_budget(
        t0, int(planes["attempts"].shape[0]), planes,
        n_proposers=state.n_proposers, lease_q4=lease_q4, sync=sync,
        clk0=clk0, rst0=rst0,
    )
    return _window_scan_impl(
        state, net, t0, clk0, rst0, planes,
        majority=majority, lease_q4=lease_q4, round_q4=round_q4,
        guard_q4=guard_q4, backend=backend, sync=sync, window=window,
        restart_guard=restart_guard, skip_stable=skip_stable,
    )


def lease_plane_tick(
    state: LeaseArrayState,
    net: NetPlaneState,
    t: int,
    tick: TickInputs,
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int = None,
    clk0=None,
    rst0=None,
    restart_guard: bool = True,
    backend: str = None,
    sync: bool = False,
    window: int = 16,
    skip_stable: bool = True,
) -> tuple[LeaseArrayState, NetPlaneState, torch.Tensor]:
    """Advance all cells one tick.

    ``sync=True`` runs the zero-delay synchronous model (``net`` passes
    through untouched); ``sync=False`` runs the delayed in-flight model
    with the tick's ``[P, A]`` link matrices. ``guard_q4``/``clk0`` are the
    drift parameters (see :func:`lease_window_scan`); the tick's rate
    planes advance the clocks *after* this tick's deadlines are evaluated,
    so a stateful caller carries ``clk0 + rate`` into the next tick
    (``engine.step`` does). Returns (new_state, new_net, owner_count[N]).
    """
    if guard_q4 is None:
        guard_q4 = lease_q4
    if backend is None:
        backend = default_backend(state.highest_promised.device)

    def _default_plane(k, v):
        # an all-DEFAULT_RATE rate plane is the default clock, and an
        # all-default corruption/restart/extends plane is the honest
        # engine: omit either from the dispatch. A restart history (rst0)
        # pins the restart planes in, so ballot encoding never switches.
        if k in ("prop_rate", "acc_rate"):
            return _all_equal(v, QUARTERS)
        if k in CORRUPTION_PLANES or (k in RESTART_PLANES and rst0 is None):
            return _all_equal(v, 0)
        if k in EXTEND_PLANES:
            return _all_equal(v, PLANES[k].default)
        return False

    planes = {
        k: v[None, ...] for k, v in tick.planes.items()
        if not _default_plane(k, v)
    }
    _guard_pack_budget(
        t, 1, tick.planes,
        n_proposers=state.n_proposers, lease_q4=lease_q4, sync=sync,
        clk0=clk0, rst0=rst0,
    )
    new_state, new_net, _, counts = _window_scan_impl(
        state, net, t, clk0, rst0, planes,
        majority=majority, lease_q4=lease_q4, round_q4=round_q4,
        guard_q4=guard_q4, backend=backend, sync=sync, window=window,
        restart_guard=restart_guard, skip_stable=skip_stable,
    )
    return new_state, new_net, counts[0]


# --------------------------------------------------------------------------
# deprecation shims: the pre-Scenario one-argument-per-fault-dimension API
# --------------------------------------------------------------------------
def _shim_tick(state: LeaseArrayState, attempt, release, acc_up, delay, drop):
    """The ``TickInputs`` of a shim call, built and validated by
    ``make_tick`` (None = the plane's default; ``delay``/``drop`` ``[A]`` or
    ``[P, A]``). The reference also lets a traced call skip the host-side
    validation; the port traces nothing, so every call is validated."""
    A, N = state.highest_promised.shape
    return make_tick(
        n_cells=N, n_acceptors=A, n_proposers=state.n_proposers,
        attempts=_legacy_plane(attempt), releases=_legacy_plane(release),
        acc_up=_legacy_plane(acc_up), delay=_legacy_plane(delay),
        drop=_legacy_plane(drop),
    )


def lease_plane_step(
    state: LeaseArrayState,
    t,
    attempt,
    release,
    acc_up,
    *,
    majority: int,
    lease_q4: int,
    backend: str = None,
    window: int = 16,
) -> tuple[LeaseArrayState, torch.Tensor]:
    """Deprecated: build a :class:`TickInputs` and call
    :func:`lease_plane_tick` with ``sync=True`` instead. Returns
    (new_state, owner_count [N])."""
    warnings.warn(
        "lease_plane_step is deprecated; use lease_plane_tick(state, net, "
        "t, tick, ..., sync=True) with a scenario.TickInputs",
        DeprecationWarning, stacklevel=2,
    )
    tick = _shim_tick(state, attempt, release, acc_up, None, None)
    new_state, _, count = lease_plane_tick(
        state, None, t, tick,
        majority=majority, lease_q4=lease_q4, round_q4=0,
        backend=backend, window=window, sync=True,
    )
    return new_state, count


def lease_plane_step_delayed(
    state: LeaseArrayState,
    net: NetPlaneState,
    t,
    attempt,
    release,
    acc_up,
    delay,     # [A] or [P, A] int32 delays (ticks) for legs sent this tick
    drop,      # [A] or [P, A] bool/int32 drop masks for legs sent this tick
    *,
    majority: int,
    lease_q4: int,
    round_q4: int,
    backend: str = None,
    window: int = 16,
) -> tuple[LeaseArrayState, NetPlaneState, torch.Tensor]:
    """Deprecated: build a :class:`TickInputs` and call
    :func:`lease_plane_tick` instead. Returns (new_state, new_net,
    owner_count [N])."""
    warnings.warn(
        "lease_plane_step_delayed is deprecated; use lease_plane_tick with "
        "a scenario.TickInputs",
        DeprecationWarning, stacklevel=2,
    )
    tick = _shim_tick(state, attempt, release, acc_up, delay, drop)
    return lease_plane_tick(
        state, net, t, tick,
        majority=majority, lease_q4=lease_q4, round_q4=round_q4,
        backend=backend, window=window, sync=False,
    )
