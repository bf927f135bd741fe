"""The flash-attention backward's plain version and dispatch, on the CPU.

``attention_bwd_ref`` (the backward kernel's function from its explicit
formulas) is held against ``torch.autograd`` of ``attention_ref`` and
against ``jax.grad`` of the reference's ``attention_chunked`` (what the
reference's ``loss_fn`` differentiates) and ``attention_full``; the row
log-sum-exp ``attention_lse_ref`` against a float64 numpy one. Cases cover
causal, windowed and non-causal attention, Sq ≠ Sk, GQA groups 1, 2, 5 and
6, and a ragged length. Inputs come from numpy. Limit: ‖Δ‖₂/‖g‖₂ < 1e-5
per gradient (fp32 sums in another order read ~1e-7).

The kernel itself runs on the card only
(``tests/test_torch_flash_bwd_cuda.py``, ``chip_smoke.py`` phase 42); here
the wrappers take their plain versions for CPU tensors, and the predicate
that sends a CUDA call through ``FlashAttention`` (or, for WKV6, makes it
raise) is pinned. ``wgmma_bwd_model`` is the bf16 kernel's arithmetic
(``csrc/flash_attention_bwd_wgmma.cu``) in plain torch: bf16 inputs, fp32
products summed 16 deep in the kernel's order, P^T and dS^T rounded to
bf16 before dV and dK, dS before dQ. It is held, under the bf16 rule of
phase 42 (per gradient at most twice the bf16 plain run's error plus
1e-3), against ``attention_bwd_ref`` on the upcast inputs and against
``jax.grad`` of the reference's ``attention_full``. ``tf32x3_bwd_model``
(``tests/test_torch_flash_kernel.py``) is the fp32 kernel's arithmetic
(``csrc/flash_attention_bwd_tf32.cu``): every product as three TF32
products, its tiles in their order, the group's heads in order, P in base
2. It is held at ``CASES`` to phase 42's fp32 limit, 1e-4 per gradient in
‖Δ‖₂/‖g‖₂, against ``attention_bwd_ref`` and ``jax.vjp`` of the
reference's ``attention_full``; with one TF32 product, or a mask one key
off, it misses that limit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention_chunked as ref_chunked
from repro.models.attention import attention_full as ref_full
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
    live_mask,
)
from repro_torch.kernels.rwkv6 import kernel as WK
from test_torch_flash_kernel import tf32x3_bwd_model

TOL = 1e-5
#: (b, sq, sk, hq, hkv, dh, causal, window)
CASES = [
    (1, 40, 40, 2, 2, 16, True, None),     # group 1
    (2, 37, 37, 4, 2, 32, True, 9),        # group 2, window, ragged
    (1, 33, 33, 5, 1, 16, True, None),     # group 5
    (1, 50, 50, 6, 1, 16, True, 12),       # group 6, window
    (2, 20, 45, 4, 2, 16, False, None),    # non-causal, Sq < Sk
    (1, 75, 75, 2, 1, 48, True, None),     # a ragged length
    (1, 30, 50, 2, 2, 16, False, 10),      # non-causal with a window
    (1, 45, 20, 4, 4, 16, False, None),    # non-causal, Sq > Sk
]


def case_id(c):
    b, sq, sk, hq, hkv, dh, causal, window = c
    return f"b{b}-q{sq}-k{sk}-h{hq}/{hkv}-d{dh}-{'causal' if causal else 'full'}-w{window}"


def inputs(case, seed=0):
    """q (B, Sq, Hq, Dh), k, v (B, Sk, Hkv, Dh), do like q, from numpy."""
    b, sq, sk, hq, hkv, dh, *_ = case
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, sq, hq, dh), f(b, sk, hkv, dh), f(b, sk, hkv, dh), f(b, sq, hq, dh)


def fold(a):
    """(B, S, H, Dh) -> (B·H, S, Dh), as ``ops.flash_attention`` folds."""
    b, s, h, d = a.shape
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, s, d)))


def unfold(t, b):
    bh, s, d = t.shape
    return t.reshape(b, bh // b, s, d).permute(0, 2, 1, 3).numpy()


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def plain_bwd(case, arrays):
    """attention_bwd_ref's (dq, dk, dv) in the (B, S, H, Dh) layout."""
    *_, causal, window = case
    q, k, v, do = (fold(a) for a in arrays)
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    grads = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    return [unfold(g, case[0]) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_backward_matches_autograd(case):
    *_, causal, window = case
    arrays = inputs(case)
    q, k, v = (fold(a).requires_grad_(True) for a in arrays[:3])
    o = attention_ref(q, k, v, causal=causal, window=window)
    o.backward(fold(arrays[3]))
    want = [unfold(t.grad, case[0]) for t in (q, k, v)]
    for got, w in zip(plain_bwd(case, arrays), want):
        assert rel(got, w) < TOL


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_backward_matches_jax_grad_of_the_reference(case):
    """Both of the reference's attention functions, ``attention_chunked`` in
    chunks of 16 (the ragged last one masked) and ``attention_full``."""
    *_, causal, window = case
    arrays = inputs(case, seed=1)

    def grads(q, k, v, do):
        out = []
        for attend in (lambda q, k, v: ref_chunked(q, k, v, causal=causal, window=window,
                                                     chunk=16),
                       lambda q, k, v: ref_full(q, k, v, causal=causal, window=window)):
            out.append(jax.vjp(attend, q, k, v)[1](do))
        return out

    plain = plain_bwd(case, arrays)
    for want in jax.jit(grads)(*(jnp.asarray(a) for a in arrays)):
        for got, w in zip(plain, want):
            assert rel(got, np.asarray(w)) < TOL


#: the bf16 kernel's model: groups 1, 2 and 5, Dh 48, 64 and 128, a window,
#: Sq < Sk causal and not (b, sq, sk, hq, hkv, dh, causal, window)
BF16_CASES = [
    (1, 70, 70, 2, 2, 64, True, None),     # group 1, Dh 64
    (2, 45, 45, 4, 2, 128, True, 20),      # group 2, Dh 128, a window, ragged
    (1, 50, 50, 5, 1, 48, True, None),     # group 5, Dh 48
    (1, 30, 80, 4, 2, 48, True, None),     # causal Sq < Sk: keys past every row
    (2, 20, 45, 4, 2, 64, False, None),    # non-causal, Sq < Sk
    (1, 60, 60, 5, 1, 128, False, 25),     # group 5, non-causal with a window
]
BF16_SLACK = 1e-3
LOG2E = 1.4426950408889634


def bf16(x):
    """fp32 values rounded to bf16 (nearest even) and back."""
    return x.bfloat16().float()


def k16_sum(a, b, eq: str, axis_a: int, axis_b: int):
    """einsum(eq, a, b) in fp32, the contracted axis taken 16 at a time and
    the slices' products added in ascending order, as a wgmma k-loop adds
    them to its accumulator."""
    n = a.shape[axis_a]
    out = None
    for s in range(0, n, 16):
        part = torch.einsum(eq, a.narrow(axis_a, s, min(16, n - s)),
                            b.narrow(axis_b, s, min(16, n - s)))
        out = part if out is None else out + part
    return out


def wgmma_bwd_model(q, k, v, o, do, lse, *, causal=True, window=None, live=None):
    """(dq, dk, dv) in bf16 by the bf16 wgmma backward's arithmetic: q, k, v,
    o, do bf16, lse fp32. S = Q K^T and dP = dO V^T exact products summed 16
    head dims at a time; P = 2^(S scale log2 e - lse log2 e) on live pairs;
    dS = P (dP - D), D = rowsum(do o) in fp32; dV = sum over the group's
    heads, then over rows 16 at a time, of bf16(P)^T dO; dK the same of
    bf16(dS)^T Q, times the scale; dQ over keys 16 at a time of bf16(dS) K,
    times the scale. ``live`` (Sq, Sk) replaces the mask of ``causal`` and
    ``window``."""
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    g = bhq // bhkv
    scale = 1.0 / np.sqrt(dh)
    if live is None:
        live = live_mask(sq, sk, causal=causal, window=window)
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    kg, vg = kf.repeat_interleave(g, 0), vf.repeat_interleave(g, 0)
    s = k16_sum(qf, kg, "hqd,hkd->hqk", 2, 2)
    dp = k16_sum(dof, vg, "hqd,hkd->hqk", 2, 2)
    sl2 = np.float32(scale * LOG2E)
    p = torch.exp2(s * sl2 - lse.float()[..., None] * np.float32(LOG2E))
    p = torch.where(live[None], p, torch.zeros(()))
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - d)
    pb, dsb = bf16(p), bf16(ds)
    dq = k16_sum(dsb, kg, "hqk,hkd->hqd", 2, 1) * np.float32(scale)
    # dK/dV: the group's heads in turn, each head's rows 16 at a time
    dk = torch.zeros(bhkv, sk, dh)
    dv = torch.zeros(bhkv, sk, dh)
    for h in range(g):
        heads = slice(h, bhq, g)
        dv = dv + k16_sum(pb[heads], dof[heads], "hqk,hqd->hkd", 1, 1)
        dk = dk + k16_sum(dsb[heads], qf[heads], "hqk,hqd->hkd", 1, 1)
    return dq.bfloat16(), (dk * np.float32(scale)).bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("case", BF16_CASES, ids=case_id)
def test_wgmma_model_holds_the_bf16_rule(case):
    """The bf16 kernel's model against ``attention_bwd_ref`` in fp32 on the
    upcast inputs, and against ``jax.vjp`` of the reference's
    ``attention_full`` at those inputs, each per gradient within twice the
    bf16 plain run's error plus 1e-3 (phase 42's rule)."""
    *_, causal, window = case
    arrays = inputs(case, seed=6)
    q, k, v, do = (fold(a).bfloat16() for a in arrays)
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    got = wgmma_bwd_model(q, k, v, o, do, lse, causal=causal, window=window)
    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    up = [x.float() for x in (q, k, v, o, do)]
    want = attention_bwd_ref(*up, lse, causal=causal, window=window)

    def attend(qa, ka, va):
        return ref_full(qa, ka, va, causal=causal, window=window)

    b = case[0]
    grads = jax.vjp(attend, *(jnp.asarray(unfold(x, b)) for x in up[:3]))[1](
        jnp.asarray(unfold(up[4], b)))
    for name, gm, pl, w, jg in zip(("dq", "dk", "dv"), got, plain, want, grads):
        assert gm.dtype == torch.bfloat16
        gm, pl, w = (unfold(x.float(), b) for x in (gm, pl, w))
        jg = np.asarray(jg)
        assert rel(gm, w) < 2 * rel(pl, w) + BF16_SLACK, (name, rel(gm, w), rel(pl, w))
        assert rel(gm, jg) < 2 * rel(pl, jg) + BF16_SLACK, (name, rel(gm, jg), rel(pl, jg))


def test_wgmma_model_catches_a_leaked_mask():
    """A model that lets the first masked key of each row through (a tile
    mask one off) misses the bf16 rule: the rule can fail."""
    case = BF16_CASES[0]
    *_, causal, window = case
    q, k, v, do = (fold(a).bfloat16() for a in inputs(case, seed=6))
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    want = attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)), lse, causal=causal,
                             window=window)
    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    one_off = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril(1)  # key q + 1 leaks
    bad = wgmma_bwd_model(q, k, v, o, do, lse, live=one_off)
    worst = max(rel(b.float().numpy(), w.float().numpy()) / (2 * rel(p.float().numpy(),
                                                              w.float().numpy()) + BF16_SLACK)
                for b, p, w in zip(bad, plain, want))
    assert worst > 1


#: the fp32 kernel against the plain backward and the reference's gradient
#: (phase 42's fp32 limit); its model reads ~3e-7, one TF32 product ~5e-4
FP32_LIMIT = 1e-4


def fp32_model_errors(case, seed=6, **model):
    """tf32x3_bwd_model's (dq, dk, dv) at ``case``, each as ‖Δ‖₂/‖g‖₂
    against ``attention_bwd_ref`` and against ``jax.vjp`` of the reference's
    ``attention_full``, in the (B, S, H, Dh) layout."""
    *_, causal, window = case
    arrays = inputs(case, seed=seed)
    q, k, v, do = (fold(a) for a in arrays)
    o = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    model.setdefault("causal", causal)
    model.setdefault("window", window)
    got = [unfold(g, case[0]) for g in tf32x3_bwd_model(q, k, v, o, do, lse, **model)]
    plain = [unfold(g, case[0]) for g in attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                                            window=window)]
    grads = jax.vjp(lambda qa, ka, va: ref_full(qa, ka, va, causal=causal, window=window),
                    *(jnp.asarray(a) for a in arrays[:3]))[1](jnp.asarray(arrays[3]))
    return ([rel(a, b) for a, b in zip(got, plain)],
            [rel(a, np.asarray(b)) for a, b in zip(got, grads)])


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_tf32x3_bwd_model_holds_the_fp32_limit(case):
    """The fp32 kernel's arithmetic at groups 1, 2, 5 and 6, windows, ragged
    lengths, Sq < Sk and Sq > Sk, Dh 16/32/48: within 1e-4 of the plain
    backward and of the reference's gradient, per gradient."""
    plain, ref = fp32_model_errors(case)
    assert max(plain) < FP32_LIMIT, plain
    assert max(ref) < FP32_LIMIT, ref


def test_one_tf32_product_misses_the_fp32_limit():
    """Why every product of the fp32 backward is three TF32 products: one
    keeps 11 bits and lands several times outside 1e-4."""
    plain, ref = fp32_model_errors(CASES[5], products=1)
    assert min(plain) > 3 * FP32_LIMIT and min(ref) > 3 * FP32_LIMIT, (plain, ref)


def test_tf32x3_bwd_model_catches_a_leaked_mask():
    """The model with the first masked key of each row let through (a mask
    one off, over every tile) misses the fp32 limit by orders of magnitude:
    the limit can fail."""
    case = CASES[0]
    live = torch.ones(case[1], case[2], dtype=torch.bool).tril(1)  # key q + 1 leaks
    plain, ref = fp32_model_errors(case, causal=False, live=live)
    assert min(plain) > 1e3 * FP32_LIMIT and min(ref) > 1e3 * FP32_LIMIT, (plain, ref)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_lse_matches_float64(case):
    b, sq, sk, hq, hkv, dh, causal, window = case
    q, k, _, _ = inputs(case, seed=2)
    qf, kf = fold(q).double().numpy(), fold(k).double().numpy()
    kf = np.repeat(kf, hq // hkv, axis=0)
    s = np.einsum("hqd,hkd->hqk", qf, kf) / np.sqrt(dh)
    qp, kp = np.arange(sq)[:, None], np.arange(sk)[None, :]
    live = np.ones((sq, sk), bool)
    if causal:
        live &= kp <= qp
    if window is not None:
        live &= kp > qp - window
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    got = attention_lse_ref(fold(q), fold(k), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (b * hq, sq)
    assert np.abs(got.numpy() - want).max() < 1e-5


def test_gradient_through_the_models_entry_point_on_the_cpu():
    """``ops.flash_attention`` on CPU tensors: autograd of the plain version,
    equal to the backward's formulas."""
    case = CASES[1]
    *_, causal, window = case
    arrays = inputs(case, seed=3)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrays[:3])
    flash_attention(q, k, v, causal=causal, window=window).backward(torch.from_numpy(arrays[3]))
    for got, want in zip((q.grad, k.grad, v.grad), plain_bwd(case, arrays)):
        assert rel(got.numpy(), want) < TOL


def test_launchers_take_the_plain_versions_on_the_cpu():
    case = CASES[3]
    *_, causal, window = case
    q, k, v, do = (fold(a) for a in inputs(case, seed=4))
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
    assert torch.equal(o, attention_ref(q, k, v, causal=causal, window=window))
    assert torch.equal(lse, attention_lse_ref(q, k, causal=causal, window=window))
    got = K.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.flash_attention_bhsd.launches == 0
    with pytest.raises(ValueError, match="do not fit"):
        K.flash_attention_bwd(q, k, v, o, do[:, :-1], lse, causal=causal, window=window)


@pytest.mark.parametrize("module", [K, WK], ids=["flash", "wkv6"])
def test_the_gradient_predicate(module):
    """A CUDA call goes through ``FlashAttention`` (flash) or raises (WKV6)
    exactly when grad mode is on and an input requires grad."""
    x, w = torch.zeros(2), torch.zeros(2, requires_grad=True)
    assert not module.needs_grad(x, x)
    assert module.needs_grad(x, w)
    with torch.no_grad():
        assert not module.needs_grad(x, w)
    with torch.inference_mode():
        assert not module.needs_grad(x, x)
    if module is WK:
        assert not module.needs_grad(x, None) and module.needs_grad(None, w)


def test_counts_name_every_entry():
    K.reset_launches()
    assert set(K.flash_attention_bhsd.launches_by_kernel) == {
        *K.KERNELS.values(), *K.BWD_KERNELS[torch.float32], *K.BWD_KERNELS[torch.bfloat16]}
    assert K.BWD_KERNELS[torch.bfloat16] == ("flash_bwd_pre_bf16", "flash_bwd_dkdv_bf16",
                                             "flash_bwd_dq_bf16")
    from repro_torch.kernels.flash_attention import _build

    # D in flash_attention_bwd.cu, the fp32 passes (3xTF32 on mma.sync,
    # through sm80_tf32.cuh) in flash_attention_bwd_tf32.cu, the bf16 passes
    # (on wgmma, no mma.sync) in flash_attention_bwd_wgmma.cu; each entry once
    srcs = {p: p.read_text() for p in (_build.BWD_SOURCE, _build.BWD_TF32_SOURCE,
                                        _build.BWD_WGMMA_SOURCE)}
    homes = {"flash_bwd_dkdv_bf16": _build.BWD_WGMMA_SOURCE,
             "flash_bwd_dq_bf16": _build.BWD_WGMMA_SOURCE,
             "flash_bwd_dkdv_f32": _build.BWD_TF32_SOURCE,
             "flash_bwd_dq_f32": _build.BWD_TF32_SOURCE}
    for entry in _build.BWD_ENTRY_POINTS:
        home = homes.get(entry, _build.BWD_SOURCE)
        assert f'extern "C" int {entry}(' in srcs[home]
        assert sum(f'extern "C" int {entry}(' in s for s in srcs.values()) == 1
    assert all("mma.sync" not in srcs[p] for p in (_build.BWD_SOURCE, _build.BWD_WGMMA_SOURCE))
    for src in srcs.values():
        assert "atomicAdd" not in src  # deterministic: no block adds into another's output


@pytest.mark.parametrize("policy", ["nothing", "full", "dots"])
def test_function_wiring_under_each_remat_policy(policy, monkeypatch):
    """``FlashAttention`` (its plain internals on CPU tensors) as the
    model's attention, under each remat policy: the loss's gradients equal
    those of autograd through ``attention_ref``."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch import steps
    from repro_torch.models import init_model
    from repro_torch.models.schema import leaf_paths

    cfg = dataclasses.replace(configs.reduced(configs.get_config("internlm2-1.8b"),
                                              dtype="float32"), remat_policy=policy)
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)}
    want, want_loss, _ = steps.accumulate_grads(cfg, params, batch)
    want = {k: g.clone() for k, g in leaf_paths(want)}
    monkeypatch.setattr(ops, "flash_attention_bhsd", lambda q, k, v, *, causal, window:
                        K.FlashAttention.apply(q, k, v, causal, window))
    got, loss, _ = steps.accumulate_grads(cfg, params, batch)
    assert torch.equal(loss, want_loss)
    for key, g in leaf_paths(got):
        assert rel(g.numpy(), want[key].numpy()) < TOL, key
