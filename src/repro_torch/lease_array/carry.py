"""Carry an engine's state across: numpy arrays in, a running engine out.

An engine's carried state is everything a replay reads to continue: the
public lease planes (`state.LeaseArrayState`), the in-flight message plane
(`netplane.NetPlaneState`), the tick, the accumulated local clocks and the
restart history. As numpy arrays under their field names it moves between
this package and the reference package (whose engine keeps the same fields
as JAX arrays), so a trace started on one can continue on the other and
give the same owners, counts and final state as one uninterrupted run.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import LeaseArrayEngine
from .netplane import NetPlaneState
from .state import LeaseArrayState

#: host-side engine arrays carried besides the state and net planes (the
#: tick and the two mode flags travel as 0-d arrays)
HOST_ARRAYS = ("prop_clk", "acc_clk", "_rc", "_deaf_until")


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def engine_to_arrays(engine) -> dict[str, np.ndarray]:
    """The carried state of an engine — this package's or the reference's —
    as a dict of numpy arrays (one per state/net field, clock and restart
    counter; the tick and mode flags as 0-d arrays)."""
    out = {f: _numpy(getattr(engine.state, f)).astype(np.int32)
           for f in LeaseArrayState._fields}
    out.update({f: _numpy(getattr(engine.net, f)).astype(np.int32)
                for f in NetPlaneState._fields})
    out.update({k: _numpy(getattr(engine, k)).astype(np.int32)
                for k in HOST_ARRAYS})
    out["t"] = np.asarray(int(engine.t))
    out["_netplane_active"] = np.asarray(bool(engine._netplane_active))
    out["_restart_active"] = np.asarray(bool(engine._restart_active))
    return out


def engine_from_reference(arrays: dict, **cfg) -> LeaseArrayEngine:
    """A :class:`LeaseArrayEngine` holding the carried state in ``arrays``
    (as :func:`engine_to_arrays` gives it). ``cfg`` takes the engine's
    keyword arguments (``lease_ticks``, ``round_ticks``, ``drift_eps``,
    ``device``, …); the geometry comes from the arrays."""
    promised = np.asarray(arrays["highest_promised"])
    A, N = promised.shape
    P = np.asarray(arrays["owner_mask"]).shape[0]
    eng = LeaseArrayEngine(N, n_acceptors=A, n_proposers=P, **cfg)

    def tensor(name):
        a = np.array(arrays[name], dtype=np.int32, order="C")
        return torch.from_numpy(a).to(eng.device)

    eng.state = LeaseArrayState(*map(tensor, LeaseArrayState._fields))
    eng.net = NetPlaneState(*map(tensor, NetPlaneState._fields))
    for k in HOST_ARRAYS:
        setattr(eng, k, np.array(arrays[k], dtype=np.int32))
    eng.t = int(arrays["t"])
    eng._netplane_active = bool(arrays["_netplane_active"])
    eng._restart_active = bool(arrays["_restart_active"])
    return eng
