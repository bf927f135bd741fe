"""The flash-attention backward kernel (``csrc/flash_attention_bwd.cu``) and
the forward kernels' row log-sum-exp against their plain versions, on the
card. Every test here is marked ``cuda`` and skips without a CUDA device;
the file imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py

Shapes: internlm2-1.8b's train microbatch (2 × 4096, 16/8 heads of 128,
causal), mixtral's 1 × 8192 (group 6, window 4096), hymba's Dh 64 (group
5, window 1024), whisper's non-causal 1500² and 448 × 1500, and small
ragged cases. Limits, per gradient, in ‖Δ‖₂/‖g‖₂: fp32 below 1e-4; bf16 by
FlashAttention's own rule, the kernel's error against the fp32 plain run
on the same (upcast) inputs at most twice the bf16 plain run's plus 1e-3.
The LSE within 1e-4 (fp32) and 5e-4 (bf16) of ``attention_lse_ref``: a row's
log-sum-exp is ~10 and both kernels sum fp32 weights of exact or 3xTF32
scores. Two runs of the kernel give the same bits.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import (
    attention_bwd_ref,
    attention_lse_ref,
)
from repro_torch.kernels.rwkv6 import kernel as WK
from repro_torch.launch import steps
from repro_torch.models import init_model

FP32_TOL = 1e-4
BF16_SLACK = 1e-3
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-4}
#: (name, bhq, bhkv, sq, sk, dh, causal, window)
SHAPES = [
    ("internlm2-train", 32, 16, 4096, 4096, 128, True, None),
    ("mixtral", 48, 8, 8192, 8192, 128, True, 4096),
    ("hymba", 100, 20, 2048, 2048, 64, True, 1024),
    ("whisper-encoder", 160, 160, 1500, 1500, 64, False, None),
    ("whisper-cross", 160, 160, 448, 1500, 64, False, None),
    ("ragged-causal", 6, 2, 1500, 1500, 128, True, None),
    ("ragged-window", 5, 1, 333, 333, 48, True, 100),
    ("ragged-cross", 4, 4, 77, 200, 16, False, None),
    ("ragged-group8", 8, 1, 129, 129, 112, True, None),
    ("ragged-sq-lt-sk", 4, 2, 65, 300, 80, True, None),
]
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    return torch.device("cuda")


def rel(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def make_inputs(shape, dtype, dev, seed=0):
    _, bhq, bhkv, sq, sk, dh, *_ = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g, device=dev).to(dtype)
    return f(bhq, sq, dh), f(bhkv, sk, dh), f(bhkv, sk, dh), f(bhq, sq, dh)


def bwd_errors(shape, dtype, dev):
    """(the kernel's relative error per gradient, the limit per gradient,
    the LSE's max |err|, whether two runs are bit-identical)."""
    *_, causal, window = shape
    q, k, v, do = make_inputs(shape, dtype, dev)
    with torch.no_grad():
        o, lse = K.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
        lse_err = float((lse - attention_lse_ref(q, k, causal=causal, window=window))
                        .abs().max())
        got = K.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        again = K.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        up = [x.float() for x in (q, k, v, o, do)]
        want = attention_bwd_ref(*up, lse, causal=causal, window=window)
        errs = [rel(a, b) for a, b in zip(got, want)]
        if dtype == torch.float32:
            limits = [FP32_TOL] * 3
        else:
            plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
            limits = [2 * rel(a, b) + BF16_SLACK for a, b in zip(plain, want)]
    return errs, limits, lse_err, same


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_backward_kernel_matches_plain(cuda_device, shape, dt):
    dtype = DTYPES[dt]
    errs, limits, lse_err, same = bwd_errors(shape, dtype, cuda_device)
    for name, e, lim in zip(("dq", "dk", "dv"), errs, limits):
        assert e < lim, (name, e, lim)
    assert lse_err < LSE_TOL[dtype]
    assert same, "two runs of the backward kernel differ"


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_lse_leaves_the_forward_output_as_it_was(cuda_device, dt):
    shape = SHAPES[5]
    *_, causal, window = shape
    q, k, v, _ = make_inputs(shape, DTYPES[dt], cuda_device, seed=1)
    plain_o = K.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    o, lse = K.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
    assert torch.equal(o, plain_o)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    assert K.flash_attention_fwd(q, k, v, causal=causal, window=window)[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES)
def test_autograd_goes_through_the_kernels(cuda_device, dt):
    """``flash_attention_bhsd`` with inputs that require grad: one forward
    launch with the LSE, the three backward entries once each, and the
    gradients of the launchers called by hand."""
    dtype = DTYPES[dt]
    shape = SHAPES[6]
    *_, causal, window = shape
    q, k, v, do = make_inputs(shape, dtype, cuda_device, seed=2)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    K.reset_launches()
    o = K.flash_attention_bhsd(*leaves, causal=causal, window=window)
    o.backward(do)
    counts = K.flash_attention_bhsd.launches_by_kernel
    assert counts[K.KERNELS[dtype]] == 1
    assert all(counts[e] == 1 for e in K.BWD_KERNELS[dtype])
    assert K.flash_attention_bhsd.launches == 4
    with torch.no_grad():
        o2, lse = K.flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
        want = K.flash_attention_bwd(q, k, v, o2, do, lse, causal=causal, window=window)
    assert torch.equal(o.detach(), o2)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
def test_no_gradient_is_dropped_silently(cuda_device):
    """Outside ``FlashAttention`` the launchers refuse a call that wants a
    gradient; so does WKV6, which has no backward; the Function refuses
    rows with no key in reach; rwkv6 refuses to train on the card."""
    q = torch.randn(2, 64, 64, device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        K.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="no key in reach"):
        K.flash_attention_bhsd(q, q[:, :32], q[:, :32], causal=True)
    r = torch.randn(2, 32, 64, device=cuda_device, requires_grad=True)
    logw = -torch.rand(2, 32, 64, device=cuda_device)
    u = torch.zeros(2, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        WK.wkv6_bhsn(r, r, r, logw, u)
    with torch.no_grad():
        WK.wkv6_bhsn(r, r, r, logw, u)  # inference still runs
    cfg = reduced(get_config("rwkv6-3b"), dtype="float32")
    params = init_model(cfg, 0, device=cuda_device)
    batch = {"tokens": torch.zeros(1, 8, dtype=torch.int32, device=cuda_device),
             "labels": torch.zeros(1, 8, dtype=torch.int32, device=cuda_device)}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        steps.accumulate_grads(cfg, params, batch)


@pytest.mark.cuda
def test_reduced_model_gradients_on_the_card_match_the_cpu(cuda_device):
    """The reduced internlm2 (head_dim 16) in fp32: every gradient leaf of
    ``loss_fn`` through the kernels against the plain path on the CPU."""
    cfg = reduced(get_config("internlm2-1.8b"), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 300)).astype(np.int32)}
    want, want_loss, _ = steps.accumulate_grads(cfg, params, batch)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}

    card = to_card(params)
    K.reset_launches()
    got, loss, _ = steps.accumulate_grads(cfg, card, batch)
    assert K.flash_attention_bhsd.launches_by_kernel["flash_bwd_dq_f32"] == cfg.n_layers
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))

    def leaves(tree, pre=()):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from leaves(tree[key], pre + (key,))
            else:
                yield pre + (key,), tree[key]

    want_leaves = dict(leaves(want))
    for path, g in leaves(got):
        assert rel(g.cpu(), want_leaves[path]) < FP32_TOL, path


def test_shapes_name_the_slices_attention():
    """The listed shapes are the model paths' own: internlm2's train
    microbatch, and the causal/windowed ones have Sq <= Sk (a key in reach
    for every row)."""
    cfg = get_config("internlm2-1.8b")
    name, bhq, bhkv, sq, sk, dh, causal, window = SHAPES[0]
    assert (bhq, bhkv, dh) == (2 * cfg.n_heads, 2 * cfg.n_kv_heads, cfg.head_dim)
    assert all(s[3] <= s[4] for s in SHAPES if s[6] or s[7] is not None)
    assert math.prod(SHAPES[1][3:5]) == 8192 ** 2
