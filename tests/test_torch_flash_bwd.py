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
raise) is pinned.
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
)
from repro_torch.kernels.rwkv6 import kernel as WK

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

    src = _build.BWD_SOURCE.read_text()
    for entry in _build.BWD_ENTRY_POINTS:
        assert f'extern "C" int {entry}(' in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
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
