"""LeaseArrayEngine: a stateful driver over the vectorized lease plane.

Three modes:
  - ``step(tick)``          — advance one tick (a ``TickInputs``);
  - ``run_trace(scenario)`` — a whole [T]-tick ``Scenario`` in ONE dispatch:
                              one launch of the CUDA window kernel on the
                              card (``backend="cuda"``), or the plain
                              PyTorch tick loop (``backend="torch"``);
  - ``sweep(scenarios)``    — a BATCH of scenarios in ONE dispatch (one
                              launch of a batched window kernel, one grid
                              row per scenario; the falsifier's margins
                              mode one plain tick loop over the batch),
                              each replayed from the engine's current
                              state, which it leaves as it is;
                              per-scenario §4 verification built in.

The engine lives on one device, CUDA unless the caller passes
``device="cpu"``; without a CUDA device the default raises. The backend
follows the device unless given: the kernels on the card, the plain version
on the CPU. State, owners and counts stay tensors on that device.

Clock drift (§4): the engine carries each node's accumulated local clock
(``prop_clk``/``acc_clk``, local quarter-ticks) across dispatches, so a
drifted trace split over many ``run_trace``/``step`` calls replays
bit-identically to one call. ``drift_eps`` is the ε the proposers' guard
discount assumes (``guard_q4 = ⌊lease_q4·(1-ε)/(1+ε)⌋``).

Two network models share the machinery: the synchronous zero-delay tick
and the delayed in-flight message plane (``netplane.py``). A scenario (or
tick) carrying nonzero delay/drop, corruption, restart or extends planes
switches the engine onto the delayed model for good (messages may be in
flight).

The packed int32 layout bounds the clock: ``run_trace``/``step`` raise
once a trace would cross ``state.max_pack_tick`` (≈ 4k ticks at P = 8).
Before a bulk dispatch (``run_trace``, ``sweep``) the interval analysis of
the traced tick core (``analysis.staticcheck.intervals``) also proves that
no int32 intermediate can leave int32 — round horizons and clock sums the
hand bound does not look at — and refuses the replay otherwise.
"""
from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from .kernel import COLLECT, window_summary
from .netplane import NetPlaneState, init_netplane
from .ops import (
    BACKENDS,
    _as_i32,
    _host,
    _margin_scan_impl,
    _sweep_scan_impl,
    _window_scan_impl,
    default_backend,
    lease_plane_tick,
    strip_default_planes,
)
from .ref import owner_row
from .scenario import (
    CORRUPTION_PLANES,
    EXTEND_PLANES,
    PLANES,
    RESTART_PLANES,
    Scenario,
    TickInputs,
    plane_digest,
)
from .state import (
    DEFAULT_RATE,
    I32,
    NO_PROPOSER,
    QUARTERS,
    check_pack_budget,
    guarded_lease_q4,
    init_state,
    lease_quarters,
    rate1_clock,
    resolve_device,
)


@functools.lru_cache(maxsize=512)
def _static_pack_findings(
    t_end: int, n_proposers: int, n_acceptors: int, lease_q4: int,
    round_q4: int, guard_q4: Optional[int], max_delay: int, max_rate: int,
    clk_slack: int, max_restarts: int = 0,
) -> tuple[str, ...]:
    """Interval-analysis twin of ``state.check_pack_budget``: walk the
    traced delayed tick core (the conservative superset of the sync one)
    and bound EVERY int32 intermediate for replays up to ``t_end``. The
    hand check budgets only ballots and lease deadlines — this one also
    sees round horizons, clock sums and any future field the core grows.
    Cached because the same protocol config is re-proved per dispatch."""
    from ..analysis.staticcheck.intervals import (
        TickConfig,
        analyze_tick_config,
    )

    cfg = TickConfig(
        t_end=t_end, n_proposers=n_proposers, n_acceptors=n_acceptors,
        lease_q4=lease_q4, round_q4=round_q4, guard_q4=guard_q4,
        max_delay=max_delay, max_rate=max_rate, clk_slack=clk_slack,
        max_restarts=max_restarts,
    )
    return tuple(str(f) for f in analyze_tick_config(cfg))


#: set once the analyzer itself failed (the gate then warned, once)
_STATIC_CHECK_FAILED = False


def _scenario_scanner(
    majority: int, lease_q4: int, round_q4: int, backend: str, sync: bool,
    guard_q4: int = None,
):
    """(state, net, t0, clk0, planes) -> (state, net, owners, counts).

    The per-tick scanner: a loop whose body is ONE ``lease_plane_tick``, so
    every plane crosses a dispatch every tick. Kept as the dispatch-overhead
    baseline and the cross-check that the fused window scan (what
    ``run_trace`` uses) changes nothing but speed; both run the same packed
    tick math, so they agree bit-for-bit. The local-clock columns
    ``clk0 = (prop [P], acc [A])`` ride the loop here (the fused path
    precomputes them as prefix-sum planes instead). It carries no restart
    history from tick to tick, so it refuses restart scenarios.
    """
    if guard_q4 is None:
        guard_q4 = lease_q4

    def scan(state, net, t0, clk0, planes):
        for k in RESTART_PLANES:
            v = planes.get(k)
            if v is not None and _host(v).any():
                raise ValueError(
                    "the per-tick scanner cannot accumulate restart "
                    "history across ticks; replay restart scenarios "
                    "through run_trace/lease_window_scan instead"
                )
        # all-default corruption/restart/extends planes are the honest
        # path: dropped here (same contract as ops.lease_window_scan)
        planes = strip_default_planes(planes)
        dev = state.highest_promised.device
        t0 = int(t0)
        if clk0 is None:  # the rate-1 reading at t0, like ops' default
            pc = rate1_clock(t0, state.n_proposers, device=dev)
            ac = rate1_clock(t0, state.highest_promised.shape[0], device=dev)
        else:
            pc, ac = (_as_i32(c, dev) for c in clk0)
        rows, counts = [], []
        for tau in range(int(planes["attempts"].shape[0])):
            xs = {k: v[tau] for k, v in planes.items()}
            state, net, count = lease_plane_tick(
                state, net, t0 + tau, TickInputs(xs),
                majority=majority, lease_q4=lease_q4, round_q4=round_q4,
                guard_q4=guard_q4, clk0=(pc, ac), backend=backend, sync=sync,
            )
            # a rate plane missing from a hand-rolled dict means the
            # drift-free step, like ops._local_clock_planes' contract
            pc = pc + (_as_i32(xs["prop_rate"], dev) if "prop_rate" in xs
                       else DEFAULT_RATE)
            ac = ac + (_as_i32(xs["acc_rate"], dev) if "acc_rate" in xs
                       else DEFAULT_RATE)
            rows.append(owner_row(state))
            counts.append(count)
        return state, net, torch.stack(rows), torch.stack(counts)

    return scan


class SweepResult(NamedTuple):
    """Per-scenario results of one :meth:`LeaseArrayEngine.sweep` dispatch,
    as tensors on the engine's device.

    ``max_owner_count`` is the §4 verdict: >1 anywhere means some tick of
    that scenario would have produced a second simultaneous believer.
    """

    max_owner_count: torch.Tensor  # [B] int32 max owner count over T x N
    owned_frac: torch.Tensor       # [B] float32 fraction of (tick, cell) slots owned
    final_owners: torch.Tensor     # [B, N] owner row after the last tick
    owners: Optional[torch.Tensor] = None  # [B, T, N] iff collect="owners"
    counts: Optional[torch.Tensor] = None  # [B, T, N] iff collect="owners"
    #: [B] int32 per margin component iff collect="margins" (see
    #: ops._margin_scan_impl; MARGIN_BIG = never close)
    margins: Optional[dict] = None


class LeaseArrayEngine:
    def __init__(
        self,
        n_cells: int,
        *,
        n_acceptors: int = 5,
        n_proposers: int = 8,
        lease_ticks: int = 3,
        round_ticks: int = 1,
        drift_eps: float = 0.0,
        backend: str = None,
        window: int = 16,
        restart_guard: bool = True,
        skip_stable: bool = True,
        device="cuda",
    ) -> None:
        if n_acceptors < 1 or n_proposers < 1:
            raise ValueError("need at least one acceptor and one proposer")
        self.device = resolve_device(device)
        if backend is None:
            backend = default_backend(self.device)
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown lease-plane backend {backend!r}; one of {BACKENDS}"
            )
        if backend == "cuda" and self.device.type != "cuda":
            raise ValueError("backend 'cuda' needs a CUDA device")
        self.n_cells = n_cells
        self.n_acceptors = n_acceptors
        self.n_proposers = n_proposers
        self.majority = n_acceptors // 2 + 1
        self.lease_ticks = lease_ticks
        self.lease_q4 = lease_quarters(lease_ticks)
        self.round_ticks = round_ticks
        self.round_q4 = QUARTERS * int(round_ticks)
        #: ε, the assumed clock-drift bound (§4): proposers discount their
        #: own lease timer to T·(1-ε)/(1+ε)
        self.drift_eps = float(drift_eps)
        self.guard_q4 = guarded_lease_q4(self.lease_q4, self.drift_eps)
        self.backend = backend
        self.window = int(window)
        self.state = init_state(
            n_cells, n_acceptors, n_proposers, device=self.device
        )
        self.net: NetPlaneState = init_netplane(
            n_cells, n_acceptors, device=self.device
        )
        self.t = 0
        # accumulated local clocks (local quarter-ticks at global tick t);
        # advanced by the scenario's prop_rate/acc_rate planes each tick
        self.prop_clk = np.zeros(n_proposers, np.int32)
        self.acc_clk = np.zeros(n_acceptors, np.int32)
        self.last_owner_count = torch.zeros(n_cells, dtype=I32,
                                            device=self.device)
        # flips True on the first delayed step; once messages may be in
        # flight, every later tick must run the delayed model too
        self._netplane_active = False
        #: §2 diskless deaf window honored? False is the negative control:
        #: restarted acceptors answer immediately with blank state
        self.restart_guard = bool(restart_guard)
        #: quiescence skip in the delayed kernel (bit-identical either way)
        self.skip_stable = bool(skip_stable)
        # restart history carried across dispatches: per-proposer restart
        # counters and each acceptor's deaf-until reading on ITS local
        # clock; _restart_active pins the restart-mode ballot encoding once
        # any restart plane fired
        self._rc = np.zeros(n_proposers, np.int32)
        self._deaf_until = np.zeros(n_acceptors, np.int32)
        self._restart_active = False

    # -------------------------------------------------------- packing budget
    def _max_restarts(self, prop_restart=None) -> int:
        """The pack-budget ``max_restarts`` charge for a dispatch that may
        add ``prop_restart`` ([T, P], a sweep's [B, T, P] or a single [P]
        row) to the carried counters — 0 while the engine has never seen a
        restart, else at least 1 so the RESTART_SHIFT carve is charged once
        restart mode is on."""
        rc_end = self._rc.astype(np.int64)
        seen = self._restart_active
        if prop_restart is not None:
            prst = np.asarray(prop_restart, np.int64)
            if prst.size:
                if prst.ndim >= 3:
                    # [B, T, P] stack: each scenario replays independently,
                    # so charge the worst per-scenario total, not the sum
                    add = (prst.reshape(prst.shape[0], -1, self.n_proposers)
                           .sum(axis=1).max(axis=0))
                else:
                    add = prst.reshape(-1, self.n_proposers).sum(axis=0)
                rc_end = rc_end + add
                seen = seen or bool(prst.any())
        if not seen:
            return 0
        return max(1, int(rc_end.max(initial=0)))

    def _clk_slack(self, max_rate: int) -> int:
        """How far ahead of ``max_rate * t`` the engine's clocks run (the
        pack budgets' ``clk_slack``), from one read of the clock maximum."""
        clk_max = int(max(self.prop_clk.max(), self.acc_clk.max(), 0))
        return max(0, clk_max - max(int(max_rate), QUARTERS) * self.t)

    def _check_pack_budget(
        self, t_end: int, max_delay: int = 0, max_rate: int = QUARTERS,
        max_restarts: int = 0, clk_slack: Optional[int] = None,
    ) -> None:
        max_rate = max(int(max_rate), QUARTERS)
        check_pack_budget(
            t_end, self.n_proposers, self.lease_q4, max_delay,
            max_rate=max_rate,
            clk_slack=(self._clk_slack(max_rate) if clk_slack is None
                       else clk_slack),
            max_restarts=max_restarts,
        )

    def _static_bound_check(
        self, t_end: int, max_delay: int, max_rate: int, max_restarts: int,
        clk_slack: int,
    ) -> None:
        """Run the leaselint interval analysis host-side before a bulk
        dispatch. Complements ``_check_pack_budget``: the hand bound is
        blind to everything but ballots and lease deadlines, while this
        proves every traced-core intermediate stays in int32. Best-effort
        by design — an analyzer failure warns once and never blocks a
        dispatch; a *finding* (an actual overflow proof) raises."""
        global _STATIC_CHECK_FAILED
        try:
            findings = _static_pack_findings(
                int(t_end), self.n_proposers, self.n_acceptors,
                self.lease_q4, self.round_q4, self.guard_q4,
                int(max_delay), max(int(max_rate), QUARTERS), int(clk_slack),
                int(max_restarts),
            )
        except Exception as e:
            if not _STATIC_CHECK_FAILED:
                _STATIC_CHECK_FAILED = True
                warnings.warn(
                    f"static pack-budget analysis unavailable "
                    f"(falling back to the hand check only): {e!r}",
                    RuntimeWarning, stacklevel=3,
                )
            return
        if findings:
            raise ValueError(
                f"static analysis refused a {t_end}-tick replay — the "
                f"traced tick core can overflow where the runtime check "
                f"does not look:\n  " + "\n  ".join(findings)
            )

    def _clk0(self):
        """The engine's local-clock offsets for a dispatch — or None while
        every clock still equals the rate-1 reading ``4t``."""
        t4 = QUARTERS * self.t
        if (self.prop_clk == t4).all() and (self.acc_clk == t4).all():
            return None
        return self.prop_clk, self.acc_clk

    def _rst0(self):
        """The engine's restart history for a dispatch — or None while no
        restart plane has ever fired (honest replays run the restart-free
        tick and the honest ballot encoding). Once active, always a
        (rc [P], deaf_until [A]) pair, so the mode stays pinned."""
        if not self._restart_active:
            return None
        return self._rc, self._deaf_until

    def _advance_restarts(self, acc_restart, prop_restart, acc_rate) -> None:
        """Fold a dispatched schedule's restart planes into the carried
        history. MUST run before ``_advance_clocks``: deaf-until deadlines
        are minted against each acceptor's local clock AT the restart tick
        (``self.acc_clk`` + the exclusive rate prefix)."""
        prst = np.asarray(prop_restart, np.int64).reshape(
            -1, self.n_proposers
        )
        self._rc = (self._rc + prst.sum(axis=0)).astype(np.int32)
        arst = np.asarray(acc_restart, np.int64).reshape(
            -1, self.n_acceptors
        )
        rate = np.asarray(acc_rate, np.int64).reshape(-1, self.n_acceptors)
        aclk = self.acc_clk.astype(np.int64) + np.concatenate(
            [np.zeros((1, self.n_acceptors), np.int64),
             np.cumsum(rate, axis=0)[:-1]]
        )
        minted = np.where(arst > 0, aclk + self.lease_q4, 0)
        self._deaf_until = np.maximum(
            self._deaf_until, minted.max(axis=0, initial=0)
        ).astype(np.int32)

    def _advance_clocks(self, prop_rate, acc_rate) -> None:
        """Accumulate the scenario's rate planes ([T, P]/[T, A] or one
        tick's [P]/[A] rows) into the engine's local clocks."""
        self.prop_clk = (
            self.prop_clk
            + np.asarray(prop_rate, np.int64).reshape(-1, self.n_proposers)
            .sum(axis=0)
        ).astype(np.int32)
        self.acc_clk = (
            self.acc_clk
            + np.asarray(acc_rate, np.int64).reshape(-1, self.n_acceptors)
            .sum(axis=0)
        ).astype(np.int32)

    # ------------------------------------------------------------ one tick
    def step(self, tick: TickInputs) -> torch.Tensor:
        """Advance one tick; returns the per-cell owner row (id or -1).

        ``tick`` is a :class:`TickInputs` (``make_tick(...)``). A tick whose
        delay/drop, corruption, restart or extends planes are nonzero
        switches the engine onto the delayed model permanently.

        Slot-isolation precondition (netplane.py): a new attempt on a cell
        overwrites that cell's in-flight request slots, so attempts on the
        SAME cell must be spaced more than ``4 * max_delay`` ticks apart
        while older messages may be in flight; releases ``max_delay``
        (``random_trace`` enforces both).
        """
        if not isinstance(tick, TickInputs):
            raise TypeError(
                "step takes a TickInputs (build one with make_tick(...)); "
                f"got {type(tick).__name__}"
            )
        tick.validate_for(
            n_cells=self.n_cells, n_acceptors=self.n_acceptors,
            n_proposers=self.n_proposers,
        )
        if (
            np.asarray(tick.delay).any()
            or np.asarray(tick.drop).any()
            or tick.corrupted
            or tick.restarted
            or tick.extended
        ):
            self._netplane_active = True
        self._check_pack_budget(
            self.t + 1,
            int(np.asarray(tick.delay).max(initial=0)),
            max(
                int(np.asarray(tick.prop_rate).max(initial=0)),
                int(np.asarray(tick.acc_rate).max(initial=0)),
            ),
            self._max_restarts(tick.prop_restart),
        )
        if tick.restarted:
            # restarts pin the restart-mode ballot encoding from here on
            self._restart_active = True
        self.state, self.net, self.last_owner_count = lease_plane_tick(
            self.state, self.net, self.t, tick,
            majority=self.majority, lease_q4=self.lease_q4,
            round_q4=self.round_q4, guard_q4=self.guard_q4,
            clk0=self._clk0(), rst0=self._rst0(),
            restart_guard=self.restart_guard, backend=self.backend,
            sync=not self._netplane_active, window=self.window,
            skip_stable=self.skip_stable,
        )
        self.t += 1
        if self._restart_active:
            self._advance_restarts(
                tick.acc_restart, tick.prop_restart, tick.acc_rate
            )
        self._advance_clocks(tick.prop_rate, tick.acc_rate)
        return owner_row(self.state)

    # ---------------------------------------------------------- validation
    def _coerce_scenario(self, scenario) -> Scenario:
        if not isinstance(scenario, Scenario):
            raise TypeError(
                "run_trace takes a Scenario (Scenario.build(...) or "
                f"Trace.scenario()); got {type(scenario).__name__}"
            )
        scenario.validate_for(
            n_cells=self.n_cells, n_acceptors=self.n_acceptors,
            n_proposers=self.n_proposers,
        )
        return scenario

    def _pick_model(self, netplane, delayed: bool, *, mutate: bool = True) -> bool:
        """Returns sync=True/False. With ``mutate`` the engine flips onto
        the netplane permanently when the delayed model is picked
        (run_trace); a read-only caller (sweep) passes ``mutate=False``."""
        if netplane is False and (delayed or self._netplane_active):
            raise ValueError(
                "netplane=False but the scenario carries nonzero delay/drop, "
                "corruption or restart planes (or messages are already in "
                "flight); the synchronous model cannot honor them"
            )
        wants_net = bool(netplane) or (netplane is None and delayed)
        if mutate and wants_net:
            self._netplane_active = True
        return not (wants_net or self._netplane_active)

    # ------------------------------------------------------------ bulk path
    def run_trace(self, scenario: Scenario, *, netplane=None):
        """Replay a [T]-tick :class:`Scenario` in one fused dispatch.

        ``netplane`` picks the network model: None (default) takes the
        delayed in-flight model iff the scenario carries nonzero
        delay/drop, corruption, restart or extends planes (or the engine is
        already on it); True forces it (zero-delay scenarios are
        bit-identical either way); False forces the synchronous step and
        raises where that cannot honor the scenario.
        Returns (owners [T, N], owner_counts [T, N]) as int32 tensors on
        the engine's device; the engine's state/tick advance past the
        trace.
        """
        scenario = self._coerce_scenario(scenario)
        T = scenario.n_ticks
        restarted = scenario.restarted
        sync = self._pick_model(
            netplane,
            scenario.delayed or scenario.corrupted or restarted
            or scenario.extended,
        )
        if T == 0:
            empty = torch.zeros((0, self.n_cells), dtype=I32,
                                device=self.device)
            return empty, empty.clone()
        dmax = int(np.asarray(scenario.delay).max(initial=0))
        rmax = max(
            int(np.asarray(scenario.prop_rate).max(initial=0)),
            int(np.asarray(scenario.acc_rate).max(initial=0)),
        )
        mr = self._max_restarts(scenario.prop_restart)
        slack = self._clk_slack(rmax)
        self._check_pack_budget(self.t + T, dmax, rmax, mr, slack)
        self._static_bound_check(self.t + T, dmax, rmax, mr, slack)
        if restarted:
            self._restart_active = True  # pins the restart ballot encoding
        # all-default corruption/restart/extends planes stay host-side: the
        # honest replay does no fault work; once restart mode is pinned,
        # rst0 (not the planes) keeps it on across quiet dispatches
        planes = strip_default_planes(scenario.planes)
        self.state, self.net, owners, counts = _window_scan_impl(
            self.state, self.net, self.t, self._clk0(), self._rst0(), planes,
            majority=self.majority, lease_q4=self.lease_q4,
            round_q4=self.round_q4, guard_q4=self.guard_q4,
            backend=self.backend, sync=sync, window=self.window,
            restart_guard=self.restart_guard, skip_stable=self.skip_stable,
        )
        self.t += int(T)
        if self._restart_active:
            self._advance_restarts(
                scenario.acc_restart, scenario.prop_restart,
                scenario.acc_rate,
            )
        self._advance_clocks(scenario.prop_rate, scenario.acc_rate)
        self.last_owner_count = counts[-1]
        return owners, counts

    # ----------------------------------------------------------- the sweep
    def sweep(
        self, scenarios, *, netplane=None, collect: str = "summary",
        verify: bool = True, backend: Optional[str] = None, tags=None,
    ) -> SweepResult:
        """Replay a BATCH of scenarios in ONE dispatch — "replay 10k fault
        scenarios" as a single call.

        ``scenarios`` is a list of same-geometry same-length
        :class:`Scenario`\\ s (each checked with ``validate_for``, then
        stacked) or an already-stacked ``Scenario.stack`` bundle ([B, T, ...]
        planes). Every scenario starts from THIS engine's current state,
        tick, clocks and restart history; the engine itself is NOT advanced
        (a sweep is a fan-out query, not a state transition). On
        ``backend="cuda"`` the batch is one launch of a batched window
        kernel (``kernel.lease_window_*_batched``); ``"torch"`` runs the
        plain window loop scenario by scenario. ``backend=None`` is the
        engine's.

        ``collect="summary"`` (default) reduces inside the kernel — only
        [B]-shaped verdicts and the [B, N] final owner rows come back, and no
        [B, T, N] tensor is made on the device; ``collect="owners"`` also
        returns the full owners/counts cubes. ``collect="margins"`` also
        returns the §4 boundary-proximity margins (``SweepResult.margins``,
        [B] int32 per component of ``ops.MARGIN_NAMES``, the falsifier's
        fitness): the batch replayed as ONE plain delayed tick loop on the
        engine's device (``ops._margin_scan_impl``; the kernels have no
        margins mode, so ``backend`` is not read), still never a
        [B, T, N] result on the host. With ``verify=True`` a per-scenario §4
        violation (max owner count > 1) raises AssertionError naming each
        offender's ``plane_digest`` (and its ``tags[i]`` when the caller
        passes per-scenario ``tags``), so a violation reproduces standalone.
        """
        if collect not in COLLECT + ("margins",):
            raise ValueError(f"unknown collect mode {collect!r}")
        if isinstance(scenarios, (list, tuple)):
            if not scenarios:
                raise ValueError("sweep needs at least one scenario")
            for sc in scenarios:
                sc.validate_for(
                    n_cells=self.n_cells, n_acceptors=self.n_acceptors,
                    n_proposers=self.n_proposers,
                )
            stacked = Scenario.stack(scenarios)
        else:
            stacked = scenarios
        planes = stacked.planes
        # one host read per fault plane (the delay plane feeds both the
        # model choice and the pack-budget check)
        dmax = int(_host(planes["delay"]).max(initial=0))
        delayed = dmax > 0 or bool(_host(planes["drop"]).any())
        rmax = max([QUARTERS] + [
            int(_host(planes[k]).max(initial=0))
            for k in ("prop_rate", "acc_rate")
        ])
        corrupt = any(_host(planes[k]).any()
                      for k in CORRUPTION_PLANES if k in planes)
        # the engine's restart history keeps restart mode on regardless
        restarted = self._restart_active or any(
            _host(planes[k]).any() for k in RESTART_PLANES if k in planes)
        extended = any((_host(planes[k]) != PLANES[k].default).any()
                       for k in EXTEND_PLANES if k in planes)
        T = int(planes["attempts"].shape[1])
        if T == 0:
            raise ValueError("sweep scenarios must have at least one tick")
        # a sweep is read-only: pick the model without flipping the engine
        # (corruption, restart and extends planes only exist in the
        # delayed tick)
        sync = self._pick_model(
            netplane, delayed or corrupt or restarted or extended,
            mutate=False,
        )
        mr = self._max_restarts(planes.get("prop_restart"))
        slack = self._clk_slack(rmax)
        self._check_pack_budget(self.t + T, dmax, rmax, mr, slack)
        self._static_bound_check(self.t + T, dmax, rmax, mr, slack)
        backend = backend or self.backend
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown lease-plane backend {backend!r}; one of {BACKENDS}"
            )
        owners = counts = margins = None
        if collect == "margins":
            out = _margin_scan_impl(
                self.state, self.net, self.t, self._clk0(), self._rst0(),
                strip_default_planes(planes),
                majority=self.majority, lease_q4=self.lease_q4,
                round_q4=self.round_q4, guard_q4=self.guard_q4,
                restart_guard=self.restart_guard,
            )
            margins = out[2]
            out = window_summary(*out[:2])
        else:
            out = _sweep_scan_impl(
                self.state, self.net, self.t, self._clk0(), self._rst0(),
                strip_default_planes(planes),
                majority=self.majority, lease_q4=self.lease_q4,
                round_q4=self.round_q4, guard_q4=self.guard_q4,
                backend=backend, sync=sync, window=self.window,
                collect=collect, restart_guard=self.restart_guard,
                skip_stable=self.skip_stable,
            )
        if collect == "owners":
            owners, counts = out
            out = window_summary(owners, counts)
        max_count, owned, final = out
        # float32 owned slots times the float32 reciprocal of T·N: what
        # the reference's jnp mean compiles to (XLA turns the division by a
        # constant into that product), bit for bit
        inv_slots = torch.tensor(np.float32(1) / np.float32(T * self.n_cells),
                                 device=owned.device)
        result = SweepResult(
            max_owner_count=max_count.amax(dim=-1),
            owned_frac=owned.sum(dim=-1).to(torch.float32) * inv_slots,
            final_owners=final, owners=owners, counts=counts,
            margins=margins,
        )
        if verify:
            bad = torch.nonzero(result.max_owner_count > 1).flatten().tolist()
            if bad:
                # name each offender by its content digest (+ the caller's
                # lineage tag): batch indices alone don't reproduce
                # standalone
                ids = []
                for i in bad[:8]:
                    label = (f"#{i} digest="
                             f"{plane_digest({k: _host(v)[i] for k, v in planes.items()})}")
                    if tags is not None and i < len(tags):
                        label += f" tag={tags[i]}"
                    ids.append(label)
                raise AssertionError(
                    f"§4 at-most-one-owner violated in {len(bad)} "
                    f"scenario(s) of the sweep: " + "; ".join(ids)
                )
        return result

    # ------------------------------------------------------------- queries
    def owners(self) -> torch.Tensor:
        return owner_row(self.state)

    def ticks_left(self) -> torch.Tensor:
        """Per cell: whole LOCAL ticks of ownership remaining as the owner
        sees it (0 if unowned), measured against the owning proposer's
        accumulated clock (= ``4t`` when nothing drifts)."""
        st = self.state
        expiry = torch.where(st.owner_mask > 0, st.owner_expiry, 0).amax(dim=0)
        owners = owner_row(st)
        prop_clk = torch.as_tensor(self.prop_clk, device=self.device)
        clk = torch.where(
            owners == NO_PROPOSER, 0,
            prop_clk[owners.clamp(0, self.n_proposers - 1).long()],
        )
        return (expiry - clk).clamp(min=0) // QUARTERS
