"""Interval abstract interpretation over the port's traced tick cores (the
counterpart of ``repro.analysis.staticcheck.intervals``).

The packed int32 layout (``q4 << PACK_SHIFT | ballot``, ``state.py``) is a
bit budget: ballots must fit in PACK_SHIFT bits, deadlines in the rest,
and every intermediate of the tick math must stay inside int32. The hand
check (``state.check_pack_budget``) budgets only ballots and lease
deadlines; this module bounds every intermediate.

How: trace ``ref.sync_tick_math`` / ``netplane.delayed_tick_math`` once
per protocol config with ``make_fx`` (tiny CPU int32 blocks, the tick
number ``t`` a 0-d tensor so it stays a graph input; the cores are
branch-free int32 math, so the aten graph IS the semantics the CUDA window
kernels are held bit-exact against), then walk ``graph.nodes`` with an
interval domain:

  - every input gets an interval from the scenario config: ``t`` in
    ``[0, t_end]``, local clocks in ``[0, max_rate*t_end + clk_slack]``,
    link words in ``[0, 2*max_delay + 1]``, attempt/release ids in
    ``[-1, P-1]``;
  - state planes (promised ballots, packed leases, in-flight slots, round
    rows) start at their init values and iterate to a fixpoint: the tick
    is re-interpreted with last round's output intervals joined in until
    nothing widens — the loop invariant of the tick loop, derived not
    assumed;
  - arithmetic is exact on unbounded Python ints, so ``add``/``mul``/
    left-shift results falling outside int32 are flagged
    (``int32-overflow``) — the check the int32 tensors can't do;
  - ``bitwise_or`` carries *pack provenance*: a left shift by a constant k
    tags its result, and ``(x << k) | low`` demands ``low`` fit in k bits
    — the ``pack-budget`` rule, which is exactly "ballot <= PACK_MASK" at
    every ``pack_pair``/``pack_slot`` site.

An aten op with no rule here is an ``unknown-primitive`` finding (its
result widened to full int32), never a silent default.

``derived_max_pack_tick`` inverts the checker: binary-search the largest
``t_end`` with no findings. For delay-free configs it reproduces
``state.max_pack_tick`` exactly; with link delays the hand formula
double-charges the clock budget and the derived bound is ≥ — the hand
check stays safe, just conservative.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from ...lease_array.state import (
    I32,
    MAX_PACK_Q4,
    PACK_SHIFT,
    QUARTERS,
    lease_quarters,
)
from .findings import Finding

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1

#: fixpoint passes before giving up and widening to full int32
_MAX_FIXPOINT_ITERS = 64


class IV(NamedTuple):
    """A closed integer interval [lo, hi] on unbounded Python ints."""

    lo: int
    hi: int

    def join(self, other: "IV") -> "IV":
        return IV(min(self.lo, other.lo), max(self.hi, other.hi))

    def __contains__(self, v: int) -> bool:
        return self.lo <= v <= self.hi


INT32 = IV(INT32_MIN, INT32_MAX)
BOOL = IV(0, 1)


class AbsVal(NamedTuple):
    """Interval + pack provenance: ``shift=k`` means the value is exactly
    some nonnegative field shifted left by the constant k (low k bits
    zero), so an ``or`` against it is field packing, not bit soup."""

    iv: IV
    shift: Optional[int] = None


def _clamp_i32(iv: IV) -> IV:
    return IV(max(iv.lo, INT32_MIN), min(iv.hi, INT32_MAX))


def _bitlen_cap(hi: int) -> int:
    """Smallest 2^m - 1 >= hi (hi >= 0): the or-result ceiling."""
    return (1 << int(hi).bit_length()) - 1


# ---------------------------------------------------------------------------
# the scenario config under analysis
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TickConfig:
    """Everything the interval analysis needs to bound a replay: the
    protocol constants baked into the traced core plus the scenario-wide
    extremes of the inputs (mirroring ``state.max_pack_tick``'s
    parameters, with ``clk_slack`` = how far ahead of ``max_rate * t`` the
    engine's accumulated clocks already run)."""

    t_end: int
    n_proposers: int = 8
    n_acceptors: int = 5
    lease_ticks: int = 3
    round_q4: int = QUARTERS
    guard_q4: Optional[int] = None  # None = lease_q4 (the eps=0 case)
    max_delay: int = 0
    max_rate: int = QUARTERS
    clk_slack: int = 0
    sync: bool = False
    lease_q4: Optional[int] = None  # overrides lease_ticks when given
    corrupt: bool = False  # thread the stale/equiv planes
    #: > 0 threads the crash/restart planes AND switches ballots onto the
    #: restart-carve encoding (state.RESTART_SHIFT): the highest per-
    #: proposer restart counter any tick can carry
    max_restarts: int = 0
    extend: bool = False  # thread the §6 extends plane

    @property
    def majority(self) -> int:
        return self.n_acceptors // 2 + 1

    @property
    def restart(self) -> bool:
        return self.max_restarts > 0

    @property
    def eff_lease_q4(self) -> int:
        if self.lease_q4 is not None:
            return int(self.lease_q4)
        return lease_quarters(self.lease_ticks)

    @property
    def eff_guard_q4(self) -> int:
        return self.eff_lease_q4 if self.guard_q4 is None else int(self.guard_q4)

    @property
    def eff_rate(self) -> int:
        return max(int(self.max_rate), QUARTERS)


# ---------------------------------------------------------------------------
# tracing the tick cores (once per protocol config; intervals re-run free)
# ---------------------------------------------------------------------------
#: placeholder layout of each traced core: (name, kind) per flat argument.
#: kind "state" participates in the fixpoint; the rest are config inputs.
_SYNC_ARGS = (
    ("promised", "state"), ("acc_lease", "state"),
    ("own_id", "state_id"), ("ownp", "state"),
    ("t", "t"), ("attempt", "pid"), ("release", "pid"),
    ("up", "bool"), ("pclk", "clk"), ("aclk", "clk"),
)
_NET_STATE = (
    ("preq", "state"), ("presp", "state"), ("presp_pay", "state_id"),
    ("poreq", "state"), ("poresp", "state"), ("rel_s", "state"),
    ("rnd_ballot", "state"), ("rnd_phase", "state"),
    ("rnd_expiry", "state"), ("rnd_deadline", "state"),
    ("rnd_open_bits", "state"), ("rnd_acc_bits", "state"),
)
_DELAYED_ARGS = _SYNC_ARGS[:4] + _NET_STATE + _SYNC_ARGS[4:] + (
    ("link", "link"),
)
#: the corruption-plane variant: two extra [A, 1] 0/1 planes (the
#: falsifier's negative controls, stale / equiv)
_CORRUPT_ARGS = _DELAYED_ARGS + (("stale", "bool"), ("equiv", "bool"))
#: the crash/restart variant: the per-tick restart/deaf indicator planes
#: plus the running restart-counter plane ([0, max_restarts], the "rc"
#: kind) that the restart-mode ballot mint ORs under RESTART_SHIFT
_RESTART_TAIL = (
    ("acc_restart", "bool"), ("acc_deaf", "bool"),
    ("prop_restart", "rc"), ("prop_rc", "rc"),
)
#: the §6 extend variant: one extra [1, bn] proposer-id plane (the owner
#: extending its own live lease) merged into the attempt stream
_EXTEND_TAIL = (("extend", "pid"),)


@functools.lru_cache(maxsize=None)
def trace_tick_core(
    n_proposers: int,
    n_acceptors: int,
    lease_q4: int,
    round_q4: int,
    guard_q4: int,
    majority: int,
    *,
    sync: bool = False,
    legs: str = "gather",
    block_n: int = 8,
    corrupt: bool = False,
    restart: bool = False,
    extend: bool = False,
) -> torch.fx.GraphModule:
    """``make_fx`` of one tick core with the protocol constants closed
    over, on tiny CPU blocks (intervals are shape-oblivious except for
    ``arange``/``sum`` extents, which use the real A/P). Returns the aten
    ``GraphModule``; cached — the expensive trace happens once per config,
    every ``t_end`` probe of the binary search re-walks it for free."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from ...lease_array import netplane as _netplane
    from ...lease_array.ref import sync_tick_math

    A, P, bn = n_acceptors, n_proposers, block_n

    def z(*shape):
        return torch.zeros(shape, dtype=I32)

    lease_shapes = [z(A, bn), z(A, bn), z(1, bn), z(1, bn)]
    common = [z(), z(1, bn), z(1, bn), z(A, 1), z(P, 1), z(A, 1)]

    if sync:
        def fn(pr, al, oi, op, t, att, rel, up, pclk, aclk):
            lease, count = sync_tick_math(
                (pr, al, oi, op), t, att, rel, up, pclk, aclk,
                majority=majority, lease_q4=lease_q4,
                n_proposers=P, guard_q4=guard_q4,
            )
            return (*lease, count)

        return make_fx(fn, tracing_mode="real")(*lease_shapes, *common)

    net_shapes = [z(A, bn) for _ in range(6)] + [z(1, bn) for _ in range(6)]
    legs_fn = _netplane.legs_select if legs == "select" else _netplane.legs_gather

    def fn(*args):
        lease, net = args[:4], args[4:16]
        rest = list(args[16:])
        adv = {}
        if extend:
            adv["extend"] = rest.pop()
        if restart:
            arst, deaf, prst, prc = rest[-4:]
            rest = rest[:-4]
            adv.update(
                acc_restart=arst, acc_deaf=deaf,
                prop_restart=prst, prop_rc=prc,
            )
        if corrupt:
            stale, equiv = rest[-2:]
            rest = rest[:-2]
            adv.update(stale=stale, equiv=equiv)
        t, att, rel, up, pclk, aclk, link = rest
        lease, net, count = _netplane.delayed_tick_math(
            lease, net, t, att, rel, up, pclk, aclk, link,
            majority=majority, lease_q4=lease_q4, round_q4=round_q4,
            n_proposers=P, guard_q4=guard_q4, legs=legs_fn, **adv,
        )
        return (*lease, *net, count)

    extra = [z(A, 1), z(A, 1)] if corrupt else []
    if restart:
        extra += [z(A, 1), z(A, 1), z(P, 1), z(P, 1)]
    if extend:
        extra += [z(1, bn)]
    return make_fx(fn, tracing_mode="real")(
        *lease_shapes, *net_shapes, *common, z(P, A), *extra
    )


def _input_intervals(cfg: TickConfig) -> dict[str, AbsVal]:
    """Config inputs → intervals. Clocks are accumulated local quarter-
    ticks: at most ``max_rate`` per tick plus any pre-existing slack."""
    clk_hi = cfg.eff_rate * cfg.t_end + cfg.clk_slack
    return {
        "t": AbsVal(IV(0, cfg.t_end)),
        "pid": AbsVal(IV(-1, cfg.n_proposers - 1)),
        "bool": AbsVal(BOOL),
        "clk": AbsVal(IV(0, clk_hi)),
        "link": AbsVal(IV(0, 2 * cfg.max_delay + 1)),
        "rc": AbsVal(IV(0, cfg.max_restarts)),
    }


def _init_state(kind: str) -> AbsVal:
    # fresh engines: every packed plane is 0, id planes are NO_PROPOSER
    return AbsVal(IV(-1, -1)) if kind == "state_id" else AbsVal(IV(0, 0))


# ---------------------------------------------------------------------------
# the abstract interpreter
# ---------------------------------------------------------------------------
def _shift_amount(v: AbsVal) -> Optional[int]:
    """The shift count iff statically a single value."""
    return v.iv.lo if v.iv.lo == v.iv.hi else None


def _tensor_meta(node):
    """(dtype, shape) of a traced node's value, or None for a non-tensor."""
    val = node.meta.get("val")
    if isinstance(val, torch.Tensor):
        return val.dtype, tuple(val.shape)
    return None


def _const(value) -> AbsVal:
    if isinstance(value, torch.Tensor):
        return AbsVal(IV(int(value.min()), int(value.max())))
    return AbsVal(IV(int(value), int(value)))


def _op_name(target) -> tuple[str, str]:
    """(base name, overload) of an aten op: ``aten.where.self`` ->
    ("where", "self")."""
    parts = str(target).split(".")
    if len(parts) == 3 and parts[0] == "aten":
        return parts[1], parts[2]
    return str(target), ""


#: value-preserving view ops (value set and provenance unchanged)
_SHAPE_ONLY = frozenset({
    "select", "slice", "expand", "permute", "unsqueeze", "squeeze", "view",
    "reshape", "transpose", "t", "clone", "alias", "detach",
})
_COMPARE = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})
_LSHIFT = frozenset({"__lshift__", "bitwise_left_shift"})
_RSHIFT = frozenset({"__rshift__", "bitwise_right_shift"})
#: rules that read two integer operands (a float operand has no rule)
_BINARY = _LSHIFT | _RSHIFT | frozenset({
    "add", "sub", "mul", "bitwise_or", "bitwise_and", "bitwise_xor",
    "maximum", "minimum", "remainder", "floor_divide", "div"})


class _Interp:
    """One abstract walk of a traced graph. Collects findings only when
    ``report`` is set — fixpoint warm-up passes stay silent so a single
    violation isn't reported once per iteration. ``env`` keeps each node's
    value of the last walk (the soundness tests read it)."""

    def __init__(self, report: Optional[list[Finding]] = None) -> None:
        self.report = report
        self._seen_unknown: set[str] = set()
        self.env: dict = {}

    # -- findings ----------------------------------------------------------
    def _finding(self, rule: str, where: str, detail: str) -> None:
        if self.report is not None:
            self.report.append(Finding("intervals", rule, where, detail))

    def _check_i32(self, iv: IV, prim: str, where: str) -> IV:
        if iv.lo < INT32_MIN or iv.hi > INT32_MAX:
            self._finding(
                "int32-overflow", where,
                f"`{prim}` result can reach [{iv.lo}, {iv.hi}], outside "
                f"int32 [{INT32_MIN}, {INT32_MAX}] — the packed tick math "
                f"would silently wrap",
            )
            iv = _clamp_i32(iv)
        return iv

    # -- the walk ----------------------------------------------------------
    def eval_graph(self, gm: torch.fx.GraphModule,
                   args: list[AbsVal]) -> list[AbsVal]:
        env = self.env = {}
        inputs = iter(args)

        def read(a) -> Optional[AbsVal]:
            if isinstance(a, torch.fx.Node):
                return env[a]
            if isinstance(a, (bool, int)):
                return AbsVal(IV(int(a), int(a)))
            return None  # dtypes, devices, shapes, None

        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env[node] = next(inputs)
            elif node.op == "get_attr":
                obj = gm
                for part in node.target.split("."):
                    obj = getattr(obj, part)
                env[node] = _const(obj)
            elif node.op == "call_function":
                env[node] = self._eval_node(node, [read(a) for a in node.args])
            elif node.op == "output":
                outs = node.args[0]
                outs = outs if isinstance(outs, (list, tuple)) else (outs,)
                return [read(o) for o in outs]
            else:
                env[node] = self._unknown(node.op, f"node `{node.name}`",
                                          node)
        raise ValueError("traced graph has no output node")

    def _unknown(self, prim: str, where: str, node) -> AbsVal:
        # no rule: stay sound (full int32 / bool) and say so once
        if prim not in self._seen_unknown:
            self._seen_unknown.add(prim)
            self._finding(
                "unknown-primitive", where,
                f"no interval rule for `{prim}`; result widened to full "
                f"int32 — add a rule to staticcheck/intervals.py",
            )
        meta = _tensor_meta(node)
        return AbsVal(BOOL if meta and meta[0] == torch.bool else INT32)

    # -- op rules (the jaxpr primitives' counterparts) ---------------------
    def _eval_node(self, node, ins: list) -> AbsVal:
        prim, overload = _op_name(node.target)
        where = f"node `{node.name}` `{prim}.{overload}`"
        meta = _tensor_meta(node)
        is_bool = meta is not None and meta[0] == torch.bool

        if prim in _SHAPE_ONLY:
            return ins[0]
        if prim == "gather":
            return AbsVal(ins[0].iv)
        if prim == "_to_copy":
            iv = ins[0].iv
            if is_bool:
                iv = IV(max(0, min(iv.lo, 1)), max(0, min(iv.hi, 1)))
            return AbsVal(iv)
        if prim == "arange":
            # the traced extent: n elements from start by step
            n = meta[1][0] if meta else 0
            start = ins[0].iv.lo if overload.startswith("start") else 0
            step = ins[2].iv.lo if overload == "start_step" else 1
            ends = (start, start + step * max(0, n - 1))
            return AbsVal(IV(min(ends), max(ends)))
        if prim == "scalar_tensor":
            return AbsVal(ins[0].iv)
        if prim == "zeros":
            return AbsVal(IV(0, 0))

        a = ins[0].iv if ins and ins[0] is not None else None
        b = ins[1].iv if len(ins) > 1 and ins[1] is not None else None
        if a is None or (prim in _BINARY and b is None):
            return self._unknown(f"{prim}.{overload}", where, node)

        if prim in ("add", "sub") and node.kwargs.get("alpha", 1) == 1:
            iv = IV(a.lo + b.lo, a.hi + b.hi) if prim == "add" else IV(
                a.lo - b.hi, a.hi - b.lo)
            return AbsVal(self._check_i32(iv, prim, where))
        if prim == "mul":
            prods = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
            iv = self._check_i32(IV(min(prods), max(prods)), prim, where)
            return AbsVal(iv)
        if prim in _LSHIFT:
            s_lo = max(0, b.lo)
            s_hi = max(0, b.hi)
            cand = [a.lo << s_lo, a.lo << s_hi, a.hi << s_lo, a.hi << s_hi]
            raw = IV(min(cand), max(cand))
            if raw.hi > INT32_MAX and a.lo >= 0:
                # name the budget in pack terms when the shift is a pack
                k = _shift_amount(ins[1])
                if k == PACK_SHIFT:
                    self._finding(
                        "pack-budget", where,
                        f"packed deadline field can reach {a.hi} quarter-"
                        f"ticks but only [0, {MAX_PACK_Q4}] fits above "
                        f"PACK_SHIFT={PACK_SHIFT} in int32",
                    )
                    raw = _clamp_i32(raw)
                else:
                    raw = self._check_i32(raw, prim, where)
            else:
                raw = self._check_i32(raw, prim, where)
            shift = _shift_amount(ins[1]) if a.lo >= 0 else None
            return AbsVal(raw, shift=shift)
        if prim in _RSHIFT:  # arithmetic on signed ints
            s_lo, s_hi = max(0, b.lo), max(0, b.hi)
            cand = [a.lo >> s_lo, a.lo >> s_hi, a.hi >> s_lo, a.hi >> s_hi]
            return AbsVal(IV(min(cand), max(cand)))
        if prim == "bitwise_or":
            return self._eval_or(ins[0], ins[1], is_bool, where)
        if prim == "bitwise_and":
            if is_bool:
                return AbsVal(IV(min(a.lo, b.lo), min(a.hi, b.hi)))
            if a.lo >= 0 or b.lo >= 0:
                hi = min(a.hi, b.hi) if (a.lo >= 0 and b.lo >= 0) else (
                    a.hi if a.lo >= 0 else b.hi
                )
                return AbsVal(IV(0, max(0, hi)))
            return AbsVal(INT32)
        if prim == "bitwise_xor":
            if is_bool:
                return AbsVal(BOOL)
            if a.lo >= 0 and b.lo >= 0:
                return AbsVal(IV(0, max(_bitlen_cap(a.hi), _bitlen_cap(b.hi))))
            return AbsVal(INT32)
        if prim == "bitwise_not":
            if is_bool:
                return AbsVal(IV(1 - a.hi, 1 - a.lo))
            return AbsVal(IV(-a.hi - 1, -a.lo - 1))
        if prim in _COMPARE:
            return AbsVal(BOOL)
        if prim == "maximum":
            return AbsVal(IV(max(a.lo, b.lo), max(a.hi, b.hi)))
        if prim == "minimum":
            return AbsVal(IV(min(a.lo, b.lo), min(a.hi, b.hi)))
        if prim == "clamp":
            lo_v, hi_v = ins[1], ins[2] if len(ins) > 2 else None
            lo, hi = a.lo, a.hi
            if lo_v is not None:
                lo, hi = max(lo, lo_v.iv.lo), max(hi, lo_v.iv.lo)
            if hi_v is not None:
                lo, hi = min(lo, hi_v.iv.hi), min(hi, hi_v.iv.hi)
            return AbsVal(IV(lo, hi))
        if prim == "remainder":
            if b.lo > 0:  # torch: the sign of the divisor
                hi = b.hi - 1
                return AbsVal(IV(0, min(a.hi, hi) if a.lo >= 0 else hi))
            return AbsVal(INT32)
        if prim in ("floor_divide", "div"):
            mode = "floor" if prim == "floor_divide" else node.kwargs.get(
                "rounding_mode")
            if mode in ("floor", "trunc") and (b.lo > 0 or b.hi < 0):
                # monotone in each operand while the divisor keeps its sign
                if mode == "floor":
                    cand = [p // q for p in (a.lo, a.hi) for q in (b.lo, b.hi)]
                else:  # toward zero
                    cand = [abs(p) // abs(q) * (1 if (p >= 0) == (q > 0) else -1)
                            for p in (a.lo, a.hi) for q in (b.lo, b.hi)]
                return AbsVal(IV(min(cand), max(cand)))
            return self._unknown(f"{prim}.{overload}", where, node)
        if prim == "where":
            return AbsVal(ins[1].iv.join(ins[2].iv))
        if prim == "sum":
            src = _tensor_meta(node.args[0])
            if src is None:
                return self._unknown(f"{prim}.{overload}", where, node)
            shape = src[1]
            dims = node.args[1] if len(node.args) > 1 else None
            if overload == "default" or not dims:
                dims = range(len(shape))
            n = 1
            for d in dims:
                n *= shape[d]
            return AbsVal(self._check_i32(IV(n * a.lo, n * a.hi), prim, where))
        if prim in ("amax", "amin"):
            return AbsVal(a)
        return self._unknown(f"{prim}.{overload}", where, node)

    def _eval_or(self, x: AbsVal, y: AbsVal, is_bool: bool, where: str) -> AbsVal:
        if is_bool:
            return AbsVal(IV(max(x.iv.lo, y.iv.lo), max(x.iv.hi, y.iv.hi)))
        # pack rule: (field << k) | low is exact addition iff low fits in k
        # bits; a low side that can't fit is a pack-budget violation (it
        # would bleed into the deadline field)
        for hi_side, lo_side in ((x, y), (y, x)):
            if hi_side.shift is None:
                continue
            k = hi_side.shift
            budget = (1 << k) - 1
            if 0 <= lo_side.iv.lo and lo_side.iv.hi <= budget:
                return AbsVal(IV(
                    hi_side.iv.lo + lo_side.iv.lo,
                    hi_side.iv.hi + lo_side.iv.hi,
                ))
            self._finding(
                "pack-budget", where,
                f"low field of a `<< {k} | ...` pack can reach "
                f"[{lo_side.iv.lo}, {lo_side.iv.hi}] but the packed layout "
                f"budgets [0, {budget}]"
                + (" (= PACK_MASK: a ballot past the 15-bit budget)"
                   if k == PACK_SHIFT else ""),
            )
            return AbsVal(_clamp_i32(IV(
                min(hi_side.iv.lo, lo_side.iv.lo),
                hi_side.iv.hi + max(0, lo_side.iv.hi),
            )))
        if x.iv.lo >= 0 and y.iv.lo >= 0:
            return AbsVal(IV(
                max(x.iv.lo, y.iv.lo),
                max(_bitlen_cap(x.iv.hi), _bitlen_cap(y.iv.hi)),
            ))
        return AbsVal(INT32)  # bitwise: can't leave int32


# ---------------------------------------------------------------------------
# the public checker
# ---------------------------------------------------------------------------
def core_layout(cfg: TickConfig) -> tuple:
    """The placeholder layout of the core ``cfg`` selects."""
    if cfg.sync:
        return _SYNC_ARGS
    layout = _CORRUPT_ARGS if cfg.corrupt else _DELAYED_ARGS
    if cfg.restart:
        layout = layout + _RESTART_TAIL
    if cfg.extend:
        layout = layout + _EXTEND_TAIL
    return layout


def _core_and_layout(cfg: TickConfig, legs: str):
    core = trace_tick_core(
        cfg.n_proposers, cfg.n_acceptors, cfg.eff_lease_q4, cfg.round_q4,
        cfg.eff_guard_q4, cfg.majority, sync=cfg.sync, legs=legs,
        corrupt=cfg.corrupt, restart=cfg.restart, extend=cfg.extend,
    )
    return core, core_layout(cfg)


def _analyze(cfg: TickConfig, legs: str, core, layout):
    """The fixpoint and the reporting walk: (findings, {node: AbsVal})."""
    if core is None:
        core, layout = _core_and_layout(cfg, legs)
    cfg_ivs = _input_intervals(cfg)
    n_state = sum(1 for _, kind in layout if kind.startswith("state"))
    state = [
        _init_state(kind) for _, kind in layout if kind.startswith("state")
    ]

    def args_for(state_vals):
        vals, si = [], 0
        for _, kind in layout:
            if kind.startswith("state"):
                vals.append(state_vals[si])
                si += 1
            else:
                vals.append(cfg_ivs[kind])
        return vals

    # fixpoint: join each pass's state outputs back into the state inputs
    silent = _Interp(report=None)
    for _ in range(_MAX_FIXPOINT_ITERS):
        outs = silent.eval_graph(core, args_for(state))
        new = [
            AbsVal(s.iv.join(o.iv))
            for s, o in zip(state, outs[:n_state])
        ]
        if all(n.iv == s.iv for n, s in zip(new, state)):
            break
        state = new
    else:  # pragma: no cover - the cores converge in a handful of passes
        state = [AbsVal(INT32)] * n_state

    # the reporting pass, on the converged invariant
    findings: list[Finding] = []
    interp = _Interp(report=findings)
    interp.eval_graph(core, args_for(state))
    return findings, interp.env


def analyze_tick_config(
    cfg: TickConfig, *, legs: str = "gather", core=None, layout=None,
) -> list[Finding]:
    """Prove (or refute) that replaying ticks ``[0, cfg.t_end]`` keeps
    every tick-core intermediate inside int32 and every pack inside its
    field budget. Returns the violations (empty = proven safe).

    ``core``/``layout`` override the traced core — the mutation fixtures
    use this to feed a seeded-bad variant through the same checker.
    """
    return _analyze(cfg, legs, core, layout)[0]


def node_intervals(
    cfg: TickConfig, *, legs: str = "gather", core=None, layout=None,
) -> dict[str, IV]:
    """Each traced node's interval on the converged invariant, by node
    name: what a concrete run of the core must stay inside (the soundness
    tests hold ``torch.fx.Interpreter`` runs to it)."""
    return {n.name: v.iv for n, v in _analyze(cfg, legs, core, layout)[1].items()
            if v is not None}


def derived_max_pack_tick(
    n_proposers: int,
    lease_q4: int,
    max_delay_ticks: int = 0,
    max_rate: int = QUARTERS,
    clk_slack: int = 0,
    *,
    n_acceptors: int = 5,
    round_q4: int = QUARTERS,
    guard_q4: Optional[int] = None,
    sync: bool = False,
    max_restarts: int = 0,
) -> int:
    """``state.max_pack_tick`` as a *derived* result: the largest ``t_end``
    the interval analysis proves safe, by monotone binary search (larger
    horizons only widen intervals, so safety is downward-closed).

    Signature mirrors the hand formula so tests can diff them on a grid.
    """
    base = TickConfig(
        t_end=0, n_proposers=n_proposers, n_acceptors=n_acceptors,
        lease_q4=lease_q4, round_q4=round_q4, guard_q4=guard_q4,
        max_delay=max_delay_ticks, max_rate=max_rate, clk_slack=clk_slack,
        sync=sync, max_restarts=max_restarts,
    )
    core, layout = _core_and_layout(base, "gather")

    def safe(t_end: int) -> bool:
        return not analyze_tick_config(
            replace(base, t_end=t_end), core=core, layout=layout
        )

    if not safe(0):
        return -1  # the config can't even start (e.g. clk_slack too hot)
    lo, hi = 0, 1
    while safe(hi):
        lo, hi = hi, hi * 2
        if hi > INT32_MAX:
            return INT32_MAX  # pragma: no cover - ballots overflow far sooner
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if safe(mid) else (lo, mid)
    return lo
