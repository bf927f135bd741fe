"""The port's deprecation surface against the reference's
(``tests/test_deprecations.py``), on the CPU.

Every legacy spelling (``LeaseArrayEngine.step`` per-plane keywords, the
bare positional attempt row and the full positional signature;
``run_trace`` with raw plane arrays; the ``ops.lease_plane_step`` and
``lease_plane_step_delayed`` shims) warns with the reference's words and
is bit-equal both to the reference's same legacy call and to the port's
current form; the current forms stay silent under ``pytest.ini``'s
``error::DeprecationWarning``. The reference's legacy calls run inside
``pytest.warns`` too.

Both packages' ``deprecated-shim`` lint rules read identifiers. The
reference's scans every file under ``tests/`` and lets only
``tests/test_deprecations.py`` name the shims, and the reference stays as
it is, so this file reaches the four shim functions through ``getattr`` of
their names (``SHIMS``) and names none of them.
"""
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.lease_array import LeaseArrayEngine as RefEngine  # noqa: E402
from repro.lease_array import Scenario as RefScenario  # noqa: E402
from repro.lease_array import random_trace as ref_random_trace  # noqa: E402
from repro.lease_array import ops as ref_ops  # noqa: E402
from repro.lease_array.netplane import init_netplane as ref_init_netplane  # noqa: E402
from repro.lease_array.state import init_state as ref_init_state  # noqa: E402
from repro_torch.lease_array import (  # noqa: E402
    LeaseArrayEngine,
    Scenario,
    lease_quarters,
    make_tick,
)
from repro_torch.lease_array import ops  # noqa: E402
from repro_torch.lease_array.netplane import init_netplane  # noqa: E402
from repro_torch.lease_array.ops import lease_plane_tick  # noqa: E402
from repro_torch.lease_array.state import NO_PROPOSER, init_state  # noqa: E402

#: the ops shims' names (the sync one, the delayed one)
SHIMS = ("lease_plane_step", "lease_plane_step_delayed")
port_step, port_step_delayed = (getattr(ops, name) for name in SHIMS)
ref_step, ref_step_delayed = (getattr(ref_ops, name) for name in SHIMS)

N, A, P = 8, 3, 2
NA = NO_PROPOSER
STEP_WARNS = "per-plane .*step"
TRACE_WARNS = "raw plane arrays"


def _engine(n_cells=N, **kw):
    return LeaseArrayEngine(n_cells, n_acceptors=A, n_proposers=P, device="cpu", **kw)


def _ref_engine(n_cells=N, **kw):
    return RefEngine(n_cells, n_acceptors=A, n_proposers=P, **kw)


def _planes(T):
    attempts = np.full((T, N), NO_PROPOSER, np.int32)
    attempts[0] = 0
    return attempts


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b) -> bool:
    return np.array_equal(_np(a), _np(b))


# ------------------------------------------- shim 1: engine.step per-plane
@pytest.mark.parametrize("spelling", ["kwargs", "bare", "keyword-planes"])
def test_step_legacy_spelling_warns_and_matches_reference_and_tickinputs(spelling):
    """Each pre-Scenario step spelling warns, and its owner row equals the
    reference's same legacy call and the port's TickInputs form."""
    a = np.zeros(N, np.int32)
    up = np.ones(A, np.int32)
    calls = {
        "kwargs": (lambda e: e.step(attempt=a)),
        "bare": (lambda e: e.step(a)),
        "keyword-planes": (lambda e: e.step(attempt=a, acc_up=up,
                                            release=np.full(N, NA, np.int32))),
    }
    match = "make_tick" if spelling == "bare" else STEP_WARNS
    with pytest.warns(DeprecationWarning, match=match):
        old = calls[spelling](_engine())
    with pytest.warns(DeprecationWarning, match=match):
        ref = calls[spelling](_ref_engine())
    tick = make_tick(n_cells=N, n_acceptors=A, n_proposers=P, attempts=a)
    new = _engine().step(tick)
    assert _same(old, new) and _same(old, ref)


def test_step_full_positional_signature_and_misuse():
    """step(attempt, release, acc_up, ...) positionally over two ticks, as
    the reference; planes both positionally and by keyword, or beside a
    TickInputs, raise; a step's first argument that is no plane raises."""
    e, r = _engine(2), _ref_engine(2)
    with pytest.warns(DeprecationWarning, match="make_tick"):
        e.step(np.array([0, 1], np.int32))
    with pytest.warns(DeprecationWarning, match=STEP_WARNS):
        own = e.step(None, np.array([0, NA], np.int32), np.ones(A, np.int32))
    with pytest.warns(DeprecationWarning, match="make_tick"):
        r.step(np.array([0, 1], np.int32))
    with pytest.warns(DeprecationWarning, match=STEP_WARNS):
        ref_own = r.step(None, np.array([0, NA], np.int32), np.ones(A, np.int32))
    assert own.tolist() == [NA, 1] == ref_own.tolist()
    with pytest.raises(TypeError, match="not both"):
        e.step(np.array([0, NA], np.int32), attempt=np.array([0, NA], np.int32))
    with pytest.raises(TypeError, match="inside the TickInputs"):
        e.step(make_tick(n_cells=2, n_acceptors=A, n_proposers=P),
               release=np.array([0, NA], np.int32))
    with pytest.raises(TypeError, match="TickInputs"):
        e.step({"attempts": np.array([0, NA], np.int32)})


def test_step_legacy_delay_switches_to_the_delayed_model():
    """The legacy delay=/drop= keywords put the engine on the in-flight
    model, as the reference's, and replay bit-equal over several ticks."""
    e, r = _engine(), _ref_engine()
    ticks = [dict(attempt=_planes(1)[0], delay=np.ones(A, np.int32)),
             dict(drop=np.zeros((P, A), np.int32))] + [{}] * 4
    for kw in ticks:
        if kw:
            with pytest.warns(DeprecationWarning, match=STEP_WARNS):
                got = e.step(**kw)
            with pytest.warns(DeprecationWarning, match=STEP_WARNS):
                want = r.step(**kw)
        else:
            got, want = e.step(), r.step()
        assert _same(got, want)
    assert e._netplane_active and r._netplane_active


def test_step_tickinputs_form_is_silent():
    eng = _engine()
    tick = make_tick(n_cells=N, n_acceptors=A, n_proposers=P,
                     attempts=np.zeros(N, np.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        owners = eng.step(tick)
    assert (owners == 0).all()


def test_bare_step_is_silent():
    eng = _engine()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        owners = eng.step()
    assert owners.tolist() == [NA] * N


# --------------------------------------- shim 2: engine.run_trace raw planes
def test_run_trace_legacy_planes_warn_and_match_scenario():
    """Raw plane arrays (positional or attempts=) warn and replay
    bit-identically to the Scenario form and to the reference's legacy
    call."""
    T = 6
    with pytest.warns(DeprecationWarning, match=TRACE_WARNS):
        old, old_c = _engine().run_trace(_planes(T))
    with pytest.warns(DeprecationWarning, match=TRACE_WARNS):
        ref, ref_c = _ref_engine().run_trace(_planes(T))
    sc = Scenario.build(T, n_cells=N, n_acceptors=A, n_proposers=P,
                        attempts=_planes(T))
    new, new_c = _engine().run_trace(sc)
    assert _same(old, new) and _same(old_c, new_c)
    assert _same(old, ref) and _same(old_c, ref_c)

    with pytest.warns(DeprecationWarning, match=TRACE_WARNS):
        kw, _ = _engine().run_trace(attempts=_planes(T))
    assert _same(kw, new)
    with pytest.raises(TypeError, match="not both"):
        _engine().run_trace(_planes(T), attempts=_planes(T))
    with pytest.raises(TypeError, match="Scenario"):
        _engine().run_trace("attempts")


def test_run_trace_legacy_delay_drop_match_the_reference():
    """The delayed model driven through the legacy delay/drop keywords:
    the port's legacy call, its Scenario form and the reference's legacy
    call agree bit for bit."""
    tr = ref_random_trace(3, n_ticks=40, n_cells=6, n_acceptors=3,
                          n_proposers=3, lease_ticks=2, p_release=0.1,
                          max_delay_ticks=1, p_drop=0.1)
    kw = dict(n_acceptors=3, n_proposers=3, lease_ticks=2,
              round_ticks=tr.round_ticks)
    e1 = LeaseArrayEngine(6, device="cpu", **kw)
    o1, c1 = e1.run_trace(Scenario.build(
        n_cells=6, n_acceptors=3, n_proposers=3, attempts=tr.attempts,
        releases=tr.releases, acc_up=tr.acc_up, delay=tr.delay, drop=tr.drop))
    e2 = LeaseArrayEngine(6, device="cpu", **kw)
    with pytest.warns(DeprecationWarning, match=TRACE_WARNS):
        o2, c2 = e2.run_trace(tr.attempts, tr.releases, tr.acc_up,
                              delay=tr.delay, drop=tr.drop)
    r = RefEngine(6, **kw)
    with pytest.warns(DeprecationWarning, match=TRACE_WARNS):
        o3, c3 = r.run_trace(tr.attempts, tr.releases, tr.acc_up,
                             delay=tr.delay, drop=tr.drop)
    assert _same(o1, o2) and _same(c1, c2)
    assert _same(o2, o3) and _same(c2, c3)
    assert e2._netplane_active and e2.t == r.t == 40


def test_run_trace_scenario_form_is_silent():
    T = 6
    sc = Scenario.build(T, n_cells=N, n_acceptors=A, n_proposers=P,
                        attempts=_planes(T))
    ref_sc = RefScenario.build(T, n_cells=N, n_acceptors=A, n_proposers=P,
                               attempts=_planes(T))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        owners, _ = _engine().run_trace(sc)
        ref_owners, _ = _ref_engine().run_trace(ref_sc)
    assert (owners[0] == 0).all() and _same(owners, ref_owners)


# ---------------------------------------------- shim 3: ops.lease_plane_step
def _states_equal(port_state, ref_state) -> bool:
    return all(_same(a, b) for a, b in zip(port_state, ref_state))


def test_lease_plane_step_shim_warns_and_matches_tick_and_reference():
    att = np.array([0, 1, NA, NA], np.int32)
    rel = np.full(4, NA, np.int32)
    up = np.ones(3, np.int32)
    state = init_state(4, 3, 2, device="cpu")
    with pytest.warns(DeprecationWarning, match="lease_plane_step is deprecated"):
        old_state, old_count = port_step(
            state, 0, att, rel, up, majority=2, lease_q4=lease_quarters(2))
    with pytest.warns(DeprecationWarning, match="lease_plane_step is deprecated"):
        ref_state, ref_count = ref_step(
            ref_init_state(4, 3, 2), 0, att, rel, up,
            majority=2, lease_q4=lease_quarters(2))
    tick = make_tick(n_cells=4, n_acceptors=3, n_proposers=2,
                     attempts=att, releases=rel, acc_up=up)
    new_state, _, new_count = lease_plane_tick(
        state, None, 0, tick,
        majority=2, lease_q4=lease_quarters(2), round_q4=0, sync=True)
    assert _states_equal(old_state, new_state) and _same(old_count, new_count)
    assert _states_equal(old_state, ref_state) and _same(old_count, ref_count)
    assert old_count.tolist() == [1, 1, 0, 0]


# -------------------------------------- shim 4: ops.lease_plane_step_delayed
@pytest.mark.parametrize("links", ["per-acceptor", "per-link"])
def test_lease_plane_step_delayed_shim_warns_and_matches_tick_and_reference(links):
    """The [A] delay/drop form is the P-broadcast of the [P, A] matrix; both
    forms match the TickInputs call and the reference's shim, over two
    ticks (the request still in flight after the first)."""
    att = np.array([0, NA, NA, NA], np.int32)
    none = np.full(4, NA, np.int32)
    up = np.ones(3, np.int32)
    delay = np.array([1, 1, 1]) if links == "per-acceptor" else np.ones((2, 3), np.int64)
    drop = np.zeros(3, np.int32) if links == "per-acceptor" else np.zeros((2, 3), bool)
    kw = dict(majority=2, lease_q4=lease_quarters(2), round_q4=8)
    st, net = init_state(4, 3, 2, device="cpu"), init_netplane(4, 3, device="cpu")
    rst, rnet = ref_init_state(4, 3, 2), ref_init_netplane(4, 3)
    tst, tnet = st, net
    for t in range(2):
        a = att if t == 0 else none
        with pytest.warns(DeprecationWarning, match="lease_plane_step_delayed is deprecated"):
            st, net, c1 = port_step_delayed(st, net, t, a, none, up, delay, drop, **kw)
        with pytest.warns(DeprecationWarning, match="lease_plane_step_delayed is deprecated"):
            rst, rnet, c3 = ref_step_delayed(rst, rnet, t, a, none, up,
                                                         delay, drop, **kw)
        tick = make_tick(n_cells=4, n_acceptors=3, n_proposers=2, attempts=a,
                         acc_up=up, delay=np.ones((2, 3), np.int32))
        tst, tnet, c2 = lease_plane_tick(tst, tnet, t, tick, **kw)
        assert _states_equal(st, tst) and _states_equal(net, tnet) and _same(c1, c2)
        assert _states_equal(st, rst) and _states_equal(net, rnet) and _same(c1, c3)
        if t == 0:  # the request is still in flight
            assert c1.tolist() == [0, 0, 0, 0] and (net.preq_b > 0).any()


# ------------------------------------------------------- modern forms: silent
def test_lease_plane_tick_is_silent():
    state, net = init_state(N, A, P, device="cpu"), init_netplane(N, A, device="cpu")
    tick = make_tick(n_cells=N, n_acceptors=A, n_proposers=P,
                     attempts=np.zeros(N, np.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        lease_plane_tick(state, net, 0, tick, majority=2, lease_q4=13, round_q4=8)
