"""The WKV6 gradient on the CPU: the port's plain backward ``wkv6_bwd_ref``
against ``jax.vjp`` of ``repro.models.rwkv6.wkv_chunked`` and against torch
autograd of ``wkv_chunked_bhsn``, and ``passes_model``, the backward
kernel's split into passes in plain torch, against ``wkv6_bwd_ref``.

Inputs come from numpy with a seed: ``tests/test_kernels_rwkv6.py``'s five
cases (the bf16 one with its r, k, v rounded to bf16 and then held in
fp32), ragged lengths, a nonzero initial state, a final-state gradient
given and not, rwkv6's decay_base spread and decays down to -33 a token.
The reference runs in fp32 at chunk 32 on the (B, S, H, N) layout, folded
by ``ref.fold_heads``; its ``u`` gradient is the batch's sum of the port's
per-row one. Limit: ‖Δ‖₂/‖g‖₂ < 1e-4 per gradient (fp32 sums in another
order over a few hundred tokens read ~1e-6).

``passes_model`` repeats the kernel's arithmetic in plain torch, pass by
pass and column tile by column tile (``csrc/wkv6_bwd.cu``): its limit
against ``wkv6_bwd_ref`` is 1e-5, and copies of it with a fault planted
(the reverse sum a token off, another tile's h partial, the sum started
without rowsum(S_T * dS_T), dv read after G's step) miss 1e-4, so the
limit can fail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv_chunked as ref_wkv_chunked
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import (
    fold_heads,
    unfold_heads,
    wkv6_bwd_ref,
    wkv_chunked_bhsn,
)

GRAD_TOL = 1e-4
MODEL_TOL = 1e-5
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")

# (b, s, h, n, decay, bf16-rounded r/k/v, initial state, final-state
# gradient); decay is omega_hi of a uniform [-6, omega_hi] draw, "spread"
# (decay_base) or "extreme" (omega up to 3.5: logw down to -33)
CASES = [
    (2, 64, 4, 64, 0.5, False, False, False),
    (1, 128, 2, 64, 1.0, False, False, False),
    (1, 96, 2, 64, 0.5, False, False, False),
    (2, 96, 3, 32, 0.5, True, False, False),
    (1, 64, 1, 128, 0.0, False, False, False),
    (1, 77, 2, 64, 0.5, False, True, True),
    (2, 45, 3, 16, 1.0, False, True, False),
    (1, 33, 2, 32, "spread", False, True, True),
    (1, 100, 2, 64, "spread", False, False, True),
    (2, 50, 1, 64, "extreme", True, True, True),
    (1, 1, 2, 16, 0.5, False, True, True),
]


def case_id(c):
    b, s, h, n, decay, rounded, st, ds = c
    return (f"b{b}s{s}h{h}n{n}-{decay}{'-bf16' if rounded else ''}{'-state' if st else ''}"
            f"{'-dstate' if ds else ''}")


def inputs(b, s, h, n, decay, rounded, with_state, with_dstate, seed=0):
    """numpy (B, S, H, N) r, k, v, logw, do; u (H, N); state and dstate
    (B, H, N, N) or None; all fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((b, s, h, n), np.float32) for _ in range(4))
    if rounded:
        r, k, v = (torch.from_numpy(a).bfloat16().float().numpy() for a in (r, k, v))
    if decay == "spread":
        omega = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5 + 0.1 * rng.standard_normal(
            (b, s, h, n))
    else:
        omega = rng.uniform(-6.0, 3.5 if decay == "extreme" else decay, (b, s, h, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32) if with_state else None
    ds = rng.standard_normal((b, h, n, n)).astype(np.float32) if with_dstate else None
    return r, k, v, logw, u, st, do, ds


def bhsn(arrays):
    """The port's (B·H, S, N) torch inputs of ``inputs``' arrays."""
    r, k, v, logw, u, st, do, ds = arrays
    b, _, h, n = r.shape
    t = torch.from_numpy
    ue = t(np.broadcast_to(u, (b, h, n)).reshape(b * h, n).copy())
    return (*(fold_heads(t(a)).contiguous() for a in (r, k, v, logw)), ue,
            None if st is None else t(st).reshape(b * h, n, n),
            fold_heads(t(do)).contiguous(), None if ds is None else t(ds).reshape(b * h, n, n))


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def jax_grads(arrays):
    """jax.vjp of the reference's chunked form (chunk 32, fp32): the
    gradients of r, k, v, logw, u (H, N) and the initial state."""
    r, k, v, logw, u, st, do, ds = arrays
    b, _, h, n = r.shape
    st0 = np.zeros((b, h, n, n), np.float32) if st is None else st
    out, vjp = jax.vjp(lambda *a: ref_wkv_chunked(*a, chunk=32),
                       *(jnp.asarray(a) for a in (r, k, v, logw, u, st0)))
    cot = (jnp.asarray(do), jnp.zeros_like(out[1]) if ds is None else jnp.asarray(ds))
    return [np.asarray(g) for g in vjp(cot)]


def port_in_model_layout(got, b):
    """``wkv6_bwd_ref``'s (B·H, ...) gradients in the reference's layout: the
    first four (B, S, H, N), du summed over the batch (H, N), the state
    gradient (B, H, N, N)."""
    dr, dk, dv, dlogw, du, ds0 = got
    bh, n = du.shape
    return ([unfold_heads(x, b).numpy() for x in (dr, dk, dv, dlogw)]
            + [du.reshape(b, bh // b, n).sum(0).numpy(), ds0.reshape(b, bh // b, n, n).numpy()])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_backward_matches_the_jax_reference(case):
    arrays = inputs(*case, seed=1)
    got = port_in_model_layout(wkv6_bwd_ref(*bhsn(arrays)), case[0])
    want = jax_grads(arrays)
    with_state = case[6]
    for name, g, w in zip(NAMES, got, want):
        if name == "dstate0" and not with_state:
            continue  # the reference takes zeros; the port's None has no gradient to give
        assert g.shape == w.shape, name
        assert rel(g, w) < GRAD_TOL, (name, rel(g, w))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_backward_matches_autograd_of_the_chunked_form(case):
    r, k, v, logw, u, st, do, ds = bhsn(inputs(*case, seed=2))
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u)]
    st_leaf = None if st is None else st.clone().requires_grad_(True)
    out, st_out = wkv_chunked_bhsn(*leaves, st_leaf)
    loss = (out * do).sum() + (0 if ds is None else (st_out * ds).sum())
    want = torch.autograd.grad(loss, leaves + ([] if st_leaf is None else [st_leaf]))
    got = wkv6_bwd_ref(r, k, v, logw, u, st, do, ds)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert rel(g, w) < GRAD_TOL, (name, rel(g, w))


#: the kernel's column tile (MT) by head size (csrc/wkv6_bwd.cu, Tile<N>),
#: and the tokens between restarts of its dlogw sum (KD)
KERNEL_MT = {16: 16, 32: 32, 64: 32, 128: 32}
KERNEL_KD = 64
FAULTS = ("shifted_sum", "other_tiles_h", "no_final_state_term", "stale_g")


def passes_model(r, k, v, logw, u, state, dout, dstate, fault=None):
    """The backward kernel's arithmetic in plain torch, its passes in turn
    over the column tiles of ``KERNEL_MT``: A recomputes each tile's
    columns of S forward in time and keeps the tile's partial h, its
    columns of S every ``KERNEL_KD`` tokens and its part of D_T =
    rowsum(S_T * dS_T); B carries each tile's columns of G back, giving dv
    (whole over the keys), the tile's partial f and its share of dlogw
    from a running D that starts at the tile's part of D_T (and restarts
    from rowsum(S_t * G_t) where S_t was kept), takes k * f's partial and
    adds r * h's partial (pass A's, same tile); C adds the tiles' partials
    and the bonus terms. ``fault`` plants one of ``FAULTS``."""
    bh, s, n = r.shape
    rf, kf, vf, wf, uf, do = (x.float() for x in (r, k, v, logw, u, dout))
    w = torch.exp(wf)
    mt = KERNEL_MT[n]
    s0 = torch.zeros(bh, n, n) if state is None else state.float()
    gt = torch.zeros(bh, n, n) if dstate is None else dstate.float()
    tiles = [slice(c, c + mt) for c in range(0, n, mt)]
    hpart, dpart, kept = [], [], []
    for cols in tiles:  # pass A
        st, hs, kept_c = s0[:, :, cols].clone(), [], {}
        for t in range(s):
            hs.append(torch.einsum("bjm,bm->bj", st, do[:, t, cols]))
            st = w[:, t, :, None] * st + kf[:, t, :, None] * vf[:, t, None, cols]
            if (t + 1) % KERNEL_KD == 0 and t + 1 < s:
                kept_c[t] = st
        hpart.append(torch.stack(hs, 1))
        kept.append(kept_c)
        dpart.append((st * gt[:, :, cols]).sum(-1))
    e = (do * vf).sum(-1)
    b = (rf * uf[:, None, :] * kf).sum(-1)
    dv, ds0 = torch.zeros(bh, s, n), torch.zeros(bh, n, n)
    fpart, dlpart = [], []
    for c, cols in enumerate(tiles):  # pass B
        g = gt[:, :, cols].clone()
        dsum = torch.zeros(bh, n) if fault == "no_final_state_term" else dpart[c]
        h_c = hpart[0] if fault == "other_tiles_h" else hpart[c]
        fs, dls = [None] * s, [None] * s
        for t in reversed(range(s)):
            if t in kept[c]:
                dsum = (kept[c][t] * g).sum(-1)
            g_next = w[:, t, :, None] * g + rf[:, t, :, None] * do[:, t, None, cols]
            g_read = g_next if fault == "stale_g" else g
            dv[:, t, cols] = (torch.einsum("bj,bjm->bm", kf[:, t], g_read)
                              + b[:, t, None] * do[:, t, cols])
            fs[t] = torch.einsum("bjm,bm->bj", g, vf[:, t, cols])
            y = kf[:, t] * fs[t]
            if fault == "shifted_sum":
                dsum = dsum + rf[:, t] * h_c[:, t]
            dls[t] = dsum - y
            dsum = dsum - y + (0 if fault == "shifted_sum" else rf[:, t] * h_c[:, t])
            g = g_next
        ds0[:, :, cols] = g
        fpart.append(torch.stack(fs, 1))
        dlpart.append(torch.stack(dls, 1))
    dr = sum(hpart) + uf[:, None, :] * kf * e[..., None]  # pass C
    dk = sum(fpart) + uf[:, None, :] * rf * e[..., None]
    return dr, dk, dv, sum(dlpart), (rf * kf * e[..., None]).sum(1), ds0


#: the model's cases: every head size (one to four column tiles), ragged
#: lengths, both states, the decay_base spread and the extreme decay
MODEL_CASES = [c for c in CASES if c[2] * c[0] * c[1] <= 400]


@pytest.mark.parametrize("case", MODEL_CASES, ids=case_id)
def test_passes_model_matches_the_plain_backward(case):
    x = bhsn(inputs(*case, seed=3))
    got, want = passes_model(*x), wkv6_bwd_ref(*x)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g, w) < MODEL_TOL, (name, rel(g, w))


@pytest.mark.parametrize("fault", FAULTS)
def test_passes_model_with_a_planted_fault_misses_the_limit(fault):
    """At 128 keys (four column tiles), from a state, with dS_T given: each
    fault puts some gradient far past the kernel's limit."""
    x = bhsn(inputs(1, 40, 2, 128, 0.5, False, True, True, seed=4))
    got, want = passes_model(*x, fault=fault), wkv6_bwd_ref(*x)
    assert max(rel(g, w) for g, w in zip(got, want)) > 100 * GRAD_TOL, fault


def test_cpu_backward_runs_the_plain_version_and_counts_no_launch():
    x = bhsn(inputs(*CASES[5], seed=5))
    K.reset_launches()
    got = K.wkv6_bwd(*x)
    want = wkv6_bwd_ref(*x)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert K.wkv6_bhsn.launches == 0
    with pytest.raises(ValueError, match="dout must be"):
        K.wkv6_bwd(*x[:6], x[6][:, :3], x[7])
    with pytest.raises(ValueError, match="dstate must be"):
        K.wkv6_bwd(*x[:7], x[7][:, :4])


def test_gradient_through_the_entry_point_on_the_cpu():
    """``ops.wkv6`` under autograd on CPU tensors (the plain chunked form):
    every input's gradient, ``u``'s summed over the batch, against
    ``wkv6_bwd_ref``."""
    r, k, v, logw, u, st, do, ds = (None if a is None else torch.from_numpy(a)
                                    for a in inputs(*CASES[7], seed=6))
    b, _, h, n = r.shape
    leaves = [x.clone().requires_grad_(True) for x in (r, k, v, logw, u, st)]
    out, st_out = ops.wkv6(*leaves)
    ((out * do).sum() + (st_out * ds).sum()).backward()
    want = port_in_model_layout(wkv6_bwd_ref(*bhsn(inputs(*CASES[7], seed=6))), b)
    for name, leaf, w in zip(NAMES, leaves, want):
        assert rel(leaf.grad.numpy(), w) < GRAD_TOL, name
