"""One tick of the PyTorch lease plane against the JAX reference, bit-exact.

The same inputs, drawn with numpy from a seed, go through
``repro.lease_array`` (jnp) and ``repro_torch.lease_array`` (torch on the
CPU): ``delayed_tick_math`` in every variant (honest, §6 extend, stale/equiv
corruption, crash/restart, all at once), ``sync_tick_math``, the per-leg
link strategies, the public one-tick wrappers, the pack/unpack layout and
the pack budget. All state is int32, so the tolerance is zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lease_array import netplane as jnet
from repro.lease_array import ref as jref
from repro.lease_array import state as jstate
from repro_torch.lease_array import netplane as tnet
from repro_torch.lease_array import ref as tref
from repro_torch.lease_array import state as tstate

A, N, T_NOW = 5, 64, 40


def _pack(q4, b):
    return (np.asarray(q4, np.int64) << 15 | np.asarray(b, np.int64)).astype(np.int32)


def _random_tick(seed: int, P: int):
    """A plausible packed state and one tick's inputs around tick T_NOW:
    live and expired leases, due and future in-flight slots, open rounds in
    both phases, out-of-range ids where the protocol allows them."""
    rng = np.random.default_rng(seed)
    t4 = 4 * T_NOW
    top = (T_NOW + 1) * P

    def maybe(p, shape, value):
        return np.where(rng.random(shape) < p, value, 0).astype(np.int32)

    def q4(shape, lo, hi):
        return rng.integers(t4 + lo, t4 + hi, shape)

    def ballots(shape):
        return rng.integers(1, top, shape)

    sa, sr = (A, N), (1, N)
    own_id = rng.integers(-1, P, sr).astype(np.int32)
    lease = (
        rng.integers(0, top + P, sa).astype(np.int32),
        maybe(0.6, sa, _pack(q4(sa, -20, 60), ballots(sa))),
        own_id,
        np.where(own_id >= 0, maybe(0.8, sr, _pack(q4(sr, -8, 40), ballots(sr))), 0)
        .astype(np.int32),
    )
    slot = lambda: maybe(0.4, sa, _pack(q4(sa, -8, 20), ballots(sa)))  # noqa: E731
    rnd_ballot = maybe(0.5, sr, ballots(sr))
    rnd_phase = np.where(rnd_ballot > 0, rng.integers(1, 3, sr), 0).astype(np.int32)
    net = (
        slot(), slot(), rng.integers(-1, P, sa).astype(np.int32), slot(), slot(),
        slot(), rnd_ballot, rnd_phase,
        np.where(rnd_phase == 2, q4(sr, -4, 40), 0).astype(np.int32),
        np.where(rnd_ballot > 0, q4(sr, -6, 12), 0).astype(np.int32),
        rng.integers(0, 1 << A, sr).astype(np.int32),
        rng.integers(0, 1 << A, sr).astype(np.int32),
    )
    ids = lambda p: np.where(rng.random(sr) < p, rng.integers(0, P, sr), -1).astype(np.int32)  # noqa: E731
    inputs = dict(
        attempt=ids(0.3), release=ids(0.2),
        up=(rng.random((A, 1)) < 0.85).astype(np.int32),
        pclk=rng.integers(t4 - 6, t4 + 6, (P, 1)).astype(np.int32),
        aclk=rng.integers(t4 - 6, t4 + 6, (A, 1)).astype(np.int32),
        link=((rng.integers(0, 4, (P, A)) << 1) | (rng.random((P, A)) < 0.2)).astype(np.int32),
    )
    variants = dict(
        extend=ids(0.5),
        stale=(rng.random((A, 1)) < 0.4).astype(np.int32),
        equiv=(rng.random((A, 1)) < 0.4).astype(np.int32),
        acc_restart=(rng.random((A, 1)) < 0.3).astype(np.int32),
        acc_deaf=(rng.random((A, 1)) < 0.3).astype(np.int32),
        prop_restart=(rng.random((P, 1)) < 0.3).astype(np.int32),
        prop_rc=rng.integers(0, 4, (P, 1)).astype(np.int32),
    )
    return lease, net, inputs, variants


def _assert_same(ref_out, port_out):
    for r, p in zip(ref_out, port_out):
        assert p.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(r), p.numpy())


VARIANTS = {
    "honest": (),
    "extend": ("extend",),
    "corrupt": ("stale", "equiv"),
    "restart": ("acc_restart", "acc_deaf", "prop_restart", "prop_rc"),
    "all": ("extend", "stale", "equiv", "acc_restart", "acc_deaf",
            "prop_restart", "prop_rc"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed,P", [(0, 4), (1, 6), (2, 8), (3, 3)])
def test_delayed_tick_math_bit_exact(variant, seed, P):
    lease, net, inputs, variants = _random_tick(seed, P)
    adv = {k: variants[k] for k in VARIANTS[variant]}
    kw = dict(majority=A // 2 + 1, lease_q4=4 * 5 + 1, round_q4=12,
              n_proposers=P, guard_q4=17)
    order = ("attempt", "release", "up", "pclk", "aclk", "link")
    j = jnet.delayed_tick_math(
        tuple(map(jnp.asarray, lease)), tuple(map(jnp.asarray, net)), T_NOW,
        *(jnp.asarray(inputs[k]) for k in order),
        **{k: jnp.asarray(v) for k, v in adv.items()}, **kw,
    )
    t = tnet.delayed_tick_math(
        tuple(map(torch.from_numpy, lease)), tuple(map(torch.from_numpy, net)),
        T_NOW, *(torch.from_numpy(inputs[k]) for k in order),
        **{k: torch.from_numpy(v) for k, v in adv.items()}, **kw,
    )
    _assert_same(j[0], t[0])
    _assert_same(j[1], t[1])
    _assert_same([j[2]], [t[2]])


@pytest.mark.parametrize("seed,P", [(4, 4), (5, 6), (6, 8)])
def test_delayed_tick_math_select_legs_equal_gather_legs(seed, P):
    """The kernel's zero-row leg strategy and the reference's clipped gather
    give the same tick: every out-of-range leg is gated off."""
    lease, net, inputs, variants = _random_tick(seed, P)
    kw = dict(majority=3, lease_q4=21, round_q4=12, n_proposers=P, **{
        k: torch.from_numpy(v) for k, v in variants.items()})
    order = ("attempt", "release", "up", "pclk", "aclk", "link")
    args = (tuple(map(torch.from_numpy, lease)), tuple(map(torch.from_numpy, net)),
            T_NOW, *(torch.from_numpy(inputs[k]) for k in order))
    a = tnet.delayed_tick_math(*args, legs=tnet.legs_select, **kw)
    b = tnet.delayed_tick_math(*args, legs=tnet.legs_gather, **kw)
    for x, y in zip((*a[0], *a[1], a[2]), (*b[0], *b[1], b[2])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed,P", [(0, 4), (1, 6), (2, 8)])
def test_sync_tick_math_bit_exact(seed, P):
    lease, _, inputs, _ = _random_tick(seed, P)
    kw = dict(majority=3, lease_q4=21, n_proposers=P, guard_q4=15)
    order = ("attempt", "release", "up", "pclk", "aclk")
    j = jref.sync_tick_math(tuple(map(jnp.asarray, lease)), T_NOW,
                            *(jnp.asarray(inputs[k]) for k in order), **kw)
    t = tref.sync_tick_math(tuple(map(torch.from_numpy, lease)), T_NOW,
                            *(torch.from_numpy(inputs[k]) for k in order), **kw)
    _assert_same(j[0], t[0])
    _assert_same([j[1]], [t[1]])


@pytest.mark.parametrize("rows", [1, A])
def test_legs_select_and_gather_match_reference(rows):
    """Both leg strategies match the reference's, out-of-range ids included
    (select reads a zero row, gather clips), and agree on in-range ids."""
    P = 6
    rng = np.random.default_rng(7)
    link = ((rng.integers(0, 5, (P, A)) << 1) | rng.integers(0, 2, (P, A))).astype(np.int32)
    prop = rng.integers(-2, P + 2, (rows, 40)).astype(np.int32)
    for jf, tf in ((jnet.legs_select, tnet.legs_select),
                   (jnet.legs_gather, tnet.legs_gather)):
        jd, jl = jf(jnp.asarray(link), jnp.asarray(prop))
        td, tl = tf(torch.from_numpy(link), torch.from_numpy(prop))
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    inside = torch.from_numpy(np.clip(prop, 0, P - 1))
    sd, sl = tnet.legs_select(torch.from_numpy(link), inside)
    gd, gl = tnet.legs_gather(torch.from_numpy(link), inside)
    assert torch.equal(sd, gd) and torch.equal(sl, gl)


def _public(seed: int, P: int):
    """A public-format state (unpacked from a random packed one) in both
    packages' types."""
    lease, net, _, _ = _random_tick(seed, P)
    st = jstate.unpack_state(jstate.PackedLeaseState(*map(jnp.asarray, lease)), P)
    return st, tstate.LeaseArrayState(*(torch.from_numpy(np.array(x)) for x in st)), net


@pytest.mark.parametrize("seed,P", [(8, 4), (9, 6)])
def test_lease_step_ref_bit_exact(seed, P):
    jst, tst, _ = _public(seed, P)
    rng = np.random.default_rng(seed)
    att = np.where(rng.random(N) < 0.4, rng.integers(0, P, N), -1).astype(np.int32)
    rel = np.where(rng.random(N) < 0.2, rng.integers(0, P, N), -1).astype(np.int32)
    up = rng.random(A) < 0.8
    pclk = rng.integers(150, 170, P).astype(np.int32)
    for kw in ({}, dict(pclk=pclk, aclk=pclk[:1].repeat(A), guard_q4=15)):
        j = jref.lease_step_ref(jst, T_NOW, att, rel, up, majority=3, lease_q4=21, **kw)
        t = tref.lease_step_ref(tst, T_NOW, att, rel, up, majority=3, lease_q4=21, **kw)
        _assert_same(j[0], t[0])
        _assert_same([j[1]], [t[1]])


@pytest.mark.parametrize("case", ["plain", "extend", "restart", "asym-drift"])
def test_lease_step_delayed_ref_bit_exact(case):
    P = 4
    jst, tst, net = _public(10, P)
    rng = np.random.default_rng(11)
    att = np.where(rng.random(N) < 0.4, rng.integers(0, P, N), -1).astype(np.int32)
    rel = np.where(rng.random(N) < 0.2, rng.integers(0, P, N), -1).astype(np.int32)
    up = rng.random(A) < 0.8
    delay = rng.integers(0, 3, A).astype(np.int32)
    drop = rng.random(A) < 0.2
    kw = dict(majority=3, lease_q4=21, round_q4=12)
    if case == "extend":
        kw["extend"] = rng.integers(-1, P, N).astype(np.int32)
    if case == "restart":
        kw.update(acc_restart=np.eye(A, dtype=np.int32)[1],
                  prop_restart=np.eye(P, dtype=np.int32)[2],
                  prop_rc=np.array([0, 1, 2, 1], np.int32))
    if case == "asym-drift":
        delay = rng.integers(0, 3, (P, A)).astype(np.int32)
        drop = rng.random((P, A)) < 0.2
        kw.update(pclk=rng.integers(150, 170, P), aclk=rng.integers(150, 170, A),
                  guard_q4=15)
    j = jref.lease_step_delayed_ref(
        jst, jnet.NetPlaneState(*map(jnp.asarray, net)), T_NOW, att, rel, up,
        delay, drop, **kw)
    t = tref.lease_step_delayed_ref(
        tst, tnet.NetPlaneState(*map(torch.from_numpy, net)), T_NOW, att, rel,
        up, delay, drop, **kw)
    _assert_same(j[0], t[0])
    _assert_same(j[1], t[1])
    _assert_same([j[2]], [t[2]])


def test_lease_step_delayed_ref_keeps_extend_with_restarts():
    """The port threads an extend row given together with restart columns
    (the reference's wrapper drops it, ref.py:258): the result equals the
    tick math called with both."""
    P = 4
    _, tst, net = _public(12, P)
    ext = np.full(N, 1, np.int32)
    rst = dict(acc_restart=np.zeros(A, np.int32), prop_restart=np.zeros(P, np.int32))
    tnet_state = tnet.NetPlaneState(*map(torch.from_numpy, net))
    none = np.full(N, -1, np.int32)
    st, nt, cnt = tref.lease_step_delayed_ref(
        tst, tnet_state, T_NOW, none, none, np.ones(A, bool), np.zeros(A, np.int32),
        np.zeros(A, np.int32), majority=3, lease_q4=21, round_q4=12, extend=ext, **rst)
    col = lambda rows: torch.zeros((rows, 1), dtype=torch.int32)  # noqa: E731
    lease, netc, cnt2 = tnet.delayed_tick_math(
        tuple(tstate.pack_state(tst)), tuple(tnet_state), T_NOW,
        torch.from_numpy(none)[None], torch.from_numpy(none)[None],
        torch.ones((A, 1), dtype=torch.int32),
        torch.full((P, 1), 4 * T_NOW, dtype=torch.int32),
        torch.full((A, 1), 4 * T_NOW, dtype=torch.int32),
        torch.zeros((P, A), dtype=torch.int32),
        majority=3, lease_q4=21, round_q4=12, n_proposers=P,
        extend=torch.from_numpy(ext)[None], acc_restart=col(A), acc_deaf=col(A),
        prop_restart=col(P), prop_rc=col(P),
    )
    assert torch.equal(cnt, cnt2.reshape(N))
    for x, y in zip(nt, netc):
        assert torch.equal(x, y)


@pytest.mark.parametrize("seed,P", [(13, 4), (14, 6), (15, 8)])
def test_pack_unpack_round_trip_matches_reference(seed, P):
    jst, tst, _ = _public(seed, P)
    # an illegal double belief: the highest proposer id wins in both
    mask = np.asarray(jst.owner_mask).copy()
    mask[:, :4] = 1
    jst = jst._replace(owner_mask=jnp.asarray(mask))
    tst = tst._replace(owner_mask=torch.from_numpy(mask))
    jp, tp = jstate.pack_state(jst), tstate.pack_state(tst)
    _assert_same(jp, tp)
    _assert_same(jstate.unpack_state(jp, P), tstate.unpack_state(tp, P))
    back = tstate.unpack_state(tstate.pack_state(tstate.unpack_state(tp, P)), P)
    for x, y in zip(back, tstate.unpack_state(tp, P)):
        assert torch.equal(x, y)


def test_constants_match_reference():
    for name in ("NO_PROPOSER", "QUARTERS", "DEFAULT_RATE", "PACK_SHIFT",
                 "PACK_MASK", "MAX_PACK_Q4", "RESTART_SHIFT", "MAX_RESTARTS"):
        assert getattr(tstate, name) == getattr(jstate, name), name
    assert tnet.MAX_VOTE_ACCEPTORS == jnet.MAX_VOTE_ACCEPTORS
    for eps in (0.0, 0.1, 0.25, 0.5):
        for lq in (5, 13, 97, 385):
            assert tstate.guarded_lease_q4(lq, eps) == jstate.guarded_lease_q4(lq, eps)
    assert tstate.ballot_of(7, 3, 8) == jstate.ballot_of(7, 3, 8)
    assert tstate.ballot_of(7, 3, 8, 2) == jstate.ballot_of(7, 3, 8, 2)


def test_pack_budget_edges():
    """The reference's edges (tests/test_pack_budget.py): 4094 ticks at P=8
    honest, 1022 with the restart carve; the limit passes, limit+1 raises."""
    assert tstate.max_pack_tick(8, 13) == 4094
    assert tstate.max_pack_tick(8, 13, max_restarts=1) == 1022
    for kw in ({}, dict(max_restarts=1), dict(max_restarts=3)):
        limit = tstate.max_pack_tick(8, 13, **kw)
        tstate.check_pack_budget(limit, 8, 13, **kw)
        with pytest.raises(ValueError, match="exceeds the packed int32"):
            tstate.check_pack_budget(limit + 1, 8, 13, **kw)
    with pytest.raises(ValueError, match="restart-counter carve"):
        tstate.check_pack_budget(10, 8, 13, max_restarts=tstate.MAX_RESTARTS + 1)


@pytest.mark.parametrize("n_proposers", [2, 3, 8, 16])
@pytest.mark.parametrize("max_rate", [4, 9])
@pytest.mark.parametrize("max_restarts", [0, 1, 3])
def test_pack_budget_grid_matches_reference(n_proposers, max_rate, max_restarts):
    for delay in (0, 1, 3):
        for slack in (0, 37):
            args = (n_proposers, 13, delay, max_rate, slack, max_restarts)
            limit = jstate.max_pack_tick(*args)
            assert tstate.max_pack_tick(*args) == limit
            for t_end in (limit, limit + 1):
                outcome = []
                for mod in (jstate, tstate):
                    try:
                        mod.check_pack_budget(t_end, *args)
                        outcome.append(None)
                    except ValueError as e:
                        outcome.append(str(e))
                assert outcome[0] == outcome[1]
