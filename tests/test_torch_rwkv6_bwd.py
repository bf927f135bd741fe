"""The WKV6 gradient on the CPU: the port's plain backward ``wkv6_bwd_ref``
against ``jax.vjp`` of ``repro.models.rwkv6.wkv_chunked`` and against torch
autograd of ``wkv_chunked_bhsn``, and ``chunks_model``, the backward
kernel's arithmetic in plain torch, against ``wkv6_bwd_ref``.

Inputs come from numpy with a seed: ``tests/test_kernels_rwkv6.py``'s five
cases (the bf16 one with its r, k, v rounded to bf16 and then held in
fp32), ragged lengths (63, 65 and 129 about the kernel's 64-token chunk),
a nonzero initial state, a final-state gradient given and not, rwkv6's
decay_base spread and decays down to -33 a token. The reference runs in
fp32 at chunk 32 on the (B, S, H, N) layout, folded by ``ref.fold_heads``;
its ``u`` gradient is the batch's sum of the port's per-row one. Limit:
‖Δ‖₂/‖g‖₂ < 1e-4 per gradient (fp32 sums in another order over a few
hundred tokens read ~1e-6).

``chunks_model`` repeats the kernel's arithmetic (``csrc/wkv6_bwd.cu``)
pass by pass and chunk by chunk, every product's operands split into TF32
hi and lo as the kernel's three ``mma.sync`` products take them: its limit
against ``wkv6_bwd_ref`` is 1e-5. Copies of it with a fault planted
(dlogw's sum a token off, the restart from the chunk's start state, the
diagonal blocks' pairs taking s <= t, the inter terms from the previous
chunk's state, G's inter decay a token off) miss 1e-4 a hundredfold, and
the model with one TF32 product (lo terms dropped) misses 1e-4, so the
limits can fail and three products are needed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
    (1, 63, 2, 64, 0.5, False, True, True),
    (1, 65, 2, 128, "spread", True, True, False),
    (1, 129, 2, 32, "extreme", False, False, True),
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


#: tokens a chunk of the kernel by head size (csrc/wkv6_bwd.cu, Chunk<N>),
#: cut into blocks of KERNEL_BLOCK tokens
KERNEL_C = {16: 64, 32: 64, 64: 64, 128: 32}
KERNEL_BLOCK = 16
LOG2E = 1.4426950408889634
FAULTS = ("shifted_sum", "restart_from_start_state", "diagonal_mask_le",
          "previous_chunk_state", "shifted_inter_decay")


def tf32(x):
    """fp32 -> tf32 as the kernel's ``split`` rounds: to nearest, ties away
    from zero, the 13 low bits cleared (int32 bit operations)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x = hi + lo, hi = tf32(x), lo = x - hi (exact); the tensor core reads
    lo with its 13 low bits cleared."""
    hi = tf32(x)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, products=3):
    """a @ b from TF32 operands in fp32: a_lo b_hi + a_hi b_lo, then + a_hi
    b_hi; ``products=1`` keeps a_hi b_hi alone."""
    ah, al = tf32_split(a.contiguous())
    bh, bl = tf32_split(b.contiguous())
    if products == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def chunks_model(r, k, v, logw, u, state, dout, dstate, fault=None, products=3):
    """The backward kernel's arithmetic in plain torch (``csrc/wkv6_bwd.cu``),
    pass by pass and chunk by chunk, every product's operands rounded to
    TF32 hi/lo (``tf32_product``). Chunks of ``KERNEL_C`` tokens (zero-padded
    at the end, logw 0 there), cum in base 2. Pass state: the S chain
    forward (S_in of every chunk, and S_T), the G chain backward (G_end of
    every chunk, and dS_0). Pass chunk, for each chunk from its tiles and
    those states: dA = dO V^T; A off the 16-token diagonal blocks
    factorised at the earlier block's last token, inside them pairwise in
    fp32 within each 8-token half and the second half against the first
    factorised at the first's last token; dv = (k 2^{cum_end - cum}) G_end +
    A^T dO + b dO; h = 2^{cum_ex} (dO S_in^T) + the earlier blocks
    factorised at the token before the block + the diagonal block (split in
    halves as A's); f likewise from V G_end^T and the later blocks; dlogw
    = D_end - k f + sum_{s > t} (r h - k f) with D_end = rowsum(S_end
    G_end); dr, dk with their bonus terms. Pass sum: du over the chunks.
    ``fault`` plants one of ``FAULTS``; ``products=1`` keeps a_hi b_hi
    alone."""
    bh, s, n = r.shape
    C, blk = KERNEL_C[n], KERNEL_BLOCK
    nc = -(-s // C)
    pad = nc * C - s
    rf, kf, vf, do, wf = (F.pad(x.float(), (0, 0, 0, pad)).view(bh, nc, C, n)
                          for x in (r, k, v, dout, logw))
    uf = u.float()
    cum = (wf * torch.tensor(LOG2E, dtype=torch.float32)).cumsum(2)
    cum_ex = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], 2)
    cum_end = cum[:, :, -1]  # (bh, nc, n)
    ex2 = torch.exp2

    def prod(a, b):
        return tf32_product(a, b, products)

    # pass state: the S chain forward, the G chain backward
    st = torch.zeros(bh, n, n) if state is None else state.float().clone()
    s_in = [st]
    for c in range(nc):
        kd = kf[:, c] * ex2(cum_end[:, c, None] - cum[:, c])
        st = ex2(cum_end[:, c])[:, :, None] * st + prod(kd.transpose(1, 2), vf[:, c])
        s_in.append(st)
    g = torch.zeros(bh, n, n) if dstate is None else dstate.float().clone()
    g_end = [None] * nc
    for c in reversed(range(nc)):
        g_end[c] = g
        rd = rf[:, c] * ex2(cum_ex[:, c])
        g = ex2(cum_end[:, c])[:, :, None] * g + prod(rd.transpose(1, 2), do[:, c])

    # pass chunk
    nb = C // blk
    blocks = [slice(blk * i, blk * (i + 1)) for i in range(nb)]
    pairs = torch.ones(blk, blk).tril(0 if fault == "diagonal_mask_le" else -1).bool()
    outs = torch.zeros(4, bh, nc, C, n)  # dr, dk, dv, dlogw
    du = torch.zeros(bh, n)
    for c in range(nc):
        rc, kc, vc, dc, cu, ce, cend = (x[:, c] for x in (rf, kf, vf, do, cum, cum_ex, cum_end))
        sa = s_in[c - 1 if fault == "previous_chunk_state" and c > 0 else c]
        ge = g_end[c]
        e = (dc * vc).sum(-1)  # (bh, C)
        b = (rc * uf[:, None] * kc).sum(-1)
        dA = prod(dc, vc.transpose(1, 2))
        A = torch.zeros(bh, C, C)
        hd, fd = torch.zeros(bh, C, n), torch.zeros(bh, C, n)
        half = blk // 2
        for i in range(nb):
            ti = blocks[i]
            fac = ex2(torch.where(pairs[None, :, :, None], ce[:, ti, None, :] - cu[:, None, ti, :],
                                  -torch.inf))  # the diagonal block's pairs s < t
            # A, h and f: pairwise inside each 8-token half, the second half
            # against the first factorised at the first half's last token
            for hb in range(2):
                th, hh = slice(blk * i + half * hb, blk * i + half * (hb + 1)), slice(
                    half * hb, half * (hb + 1))
                fh = fac[:, hh, hh]
                A[:, th, th] = (rc[:, th, None, :] * kc[:, None, th, :] * fh).sum(-1)
                dAh = dA[:, th, th] * pairs[:half, :half]
                hd[:, th] = (dAh[..., None] * kc[:, None, th, :] * fh).sum(2)
                fd[:, th] = (dAh[..., None] * rc[:, th, None, :] * fh).sum(1)
            lo, hi = slice(blk * i, blk * i + half), slice(blk * i + half, blk * (i + 1))
            ref = cu[:, blk * i + half - 1, None, :]
            r_hi, k_lo = rc[:, hi] * ex2(ce[:, hi] - ref), kc[:, lo] * ex2(ref - cu[:, lo])
            A[:, hi, lo] = prod(r_hi, k_lo.transpose(1, 2))
            hd[:, hi] += prod(dA[:, hi, lo], k_lo) * ex2(ce[:, hi] - ref)
            fd[:, lo] += prod(dA[:, hi, lo].transpose(1, 2), r_hi) * ex2(ref - cu[:, lo])
            for j in range(i):  # factorised at block j's last token
                ref = cu[:, blk * j + blk - 1, None, :]
                A[:, ti, blocks[j]] = prod(
                    rc[:, ti] * ex2(ce[:, ti] - ref),
                    (kc[:, blocks[j]] * ex2(ref - cu[:, blocks[j]])).transpose(1, 2))
        decay_to_end = ex2(cend[:, None] - (ce if fault == "shifted_inter_decay" else cu))
        dv = (prod(kc * decay_to_end, ge) + prod(A.transpose(1, 2), dc)) + b[..., None] * dc
        h = prod(dc, sa.transpose(1, 2)) * ex2(ce)
        f = prod(vc, ge.transpose(1, 2)) * decay_to_end
        for i in range(1, nb):  # factorised at the token before block i
            ti, before = blocks[i], slice(0, blk * i)
            ref = cu[:, blk * i - 1, None, :]
            q = kc[:, before] * ex2(ref - cu[:, before])
            h[:, ti] = h[:, ti] + prod(dA[:, ti, before], q) * ex2(ce[:, ti] - ref)
        for i in range(nb - 1):  # factorised at block i's last token
            ti, after = blocks[i], slice(blk * (i + 1), C)
            ref = cu[:, blk * i + blk - 1, None, :]
            p = rc[:, after] * ex2(ce[:, after] - ref)
            f[:, ti] = f[:, ti] + prod(dA[:, after, ti].transpose(1, 2), p) * ex2(ref - cu[:, ti])
        h, f = h + hd, f + fd
        d_end = ((sa if fault == "restart_from_start_state" else s_in[c + 1]) * ge).sum(-1)
        y = -kc * f
        x = y + rc * h
        later = torch.cat([x.flip(1).cumsum(1).flip(1)[:, 1:], torch.zeros_like(x[:, :1])], 1)
        if fault == "shifted_sum":
            later = later + x
        ue = uf[:, None] * e[..., None]
        outs[:, :, c] = torch.stack([h + ue * kc, f + ue * rc, dv, d_end[:, None] + y + later])
        du = du + (rc * kc * e[..., None]).sum(1)
    dr, dk, dv, dlogw = outs.reshape(4, bh, nc * C, n)[:, :, :s]
    return dr, dk, dv, dlogw, du, g


#: the model's cases: every head size, lengths ragged about the 64-token
#: chunk (and N 128's 32), both states, the decay_base spread and the
#: extreme decay
MODEL_CASES = [c for c in CASES if c[2] * c[0] * c[1] <= 400]


@pytest.mark.parametrize("case", MODEL_CASES, ids=case_id)
def test_chunks_model_matches_the_plain_backward(case):
    x = bhsn(inputs(*case, seed=3))
    got, want = chunks_model(*x), wkv6_bwd_ref(*x)
    for name, g, w in zip(NAMES, got, want):
        assert rel(g, w) < MODEL_TOL, (name, rel(g, w))


@pytest.mark.parametrize("fault", FAULTS)
def test_chunks_model_with_a_planted_fault_misses_the_limit(fault):
    """At 128 keys over 200 tokens (seven 32-token chunks, the last ragged),
    from a state, with dS_T given: each fault puts some gradient far past
    the kernel's limit."""
    x = bhsn(inputs(1, 200, 1, 128, 0.5, False, True, True, seed=4))
    got, want = chunks_model(*x, fault=fault), wkv6_bwd_ref(*x)
    assert max(rel(g, w) for g, w in zip(got, want)) > 100 * GRAD_TOL, fault


def test_one_tf32_product_misses_the_limit():
    """The same arithmetic with each product's lo terms dropped (one TF32
    product, a_hi b_hi) puts some gradient past the 1e-4 limit: the three
    products are what fp32 accuracy needs."""
    x = bhsn(inputs(1, 130, 2, 64, 0.5, False, True, True, seed=5))
    want = wkv6_bwd_ref(*x)
    assert max(rel(g, w) for g, w in zip(chunks_model(*x), want)) < MODEL_TOL
    assert max(rel(g, w) for g, w in zip(chunks_model(*x, products=1), want)) > GRAD_TOL


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
