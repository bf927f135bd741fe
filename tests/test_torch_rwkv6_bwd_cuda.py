"""The WKV6 backward kernel (``csrc/wkv6_bwd.cu``: passes state, chunk and
sum) against its plain version ``ref.wkv6_bwd_ref``, on the card. Tests marked
``cuda`` skip without a CUDA device; the file imports no JAX, so it runs on
a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_bwd_cuda.py

Cases: ``tests/test_kernels_rwkv6.py``'s five, lengths ragged about the
kernel's chunks (64 tokens, 32 at N 128: 1 to 129, and 2049), every head
size, a
nonzero initial state, a final-state gradient given and not, rwkv6's
decay_base spread and decays down to -33 a token, in fp32 and bf16 r/k/v.
Limits, per gradient, in ‖Δ‖₂/‖g‖₂: below 1e-4 (every sum is fp32 in both
dtypes); bf16's dr, dk, dv are rounded to bf16 at the end, and their limit
is twice that rounding's relative 2-norm, measured on the plain gradient.
Two runs give the same bits. The reduced rwkv6-3b's gradient leaves on the
card against the CPU's (plain chunked form under autograd) below 1e-4 in
fp32.

The tests without the mark run anywhere: the source defines each entry
point, takes no atomics and its products from the tf32 ``mma.sync`` of the
header it includes, each dtype names its three passes, and the launch
counts have a key for each.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.rwkv6 import _build
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref
from repro_torch.launch import steps
from repro_torch.models import init_model, schema

GRAD_TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dlogw", "du", "dstate0")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (bh, s, n, decay, initial state, final-state gradient): the reference's
# five cases (as B·H rows), then ragged lengths about the chunks at every
# head size, the decay_base spread and decays down to -33
CASES = [
    (8, 64, 64, 0.5, False, False),
    (2, 128, 64, 1.0, False, False),
    (2, 96, 64, 0.5, False, False),
    (6, 96, 32, 0.5, False, False),
    (1, 64, 128, 0.0, False, False),
    (3, 1, 16, 0.5, True, True),
    (3, 31, 32, 0.5, True, False),
    (3, 33, 64, "extreme", True, True),
    (3, 95, 128, 0.5, False, True),
    (2, 2049, 64, "spread", True, True),
    (4, 77, 64, "spread", False, False),
    (2, 300, 128, "extreme", True, True),
    (3, 63, 32, "extreme", False, True),
    (2, 65, 64, "spread", True, True),
    (2, 129, 128, 0.5, True, False),
]


def case_id(c):
    bh, s, n, decay, st, ds = c
    return f"bh{bh}s{s}n{n}-{decay}{'-state' if st else ''}{'-dstate' if ds else ''}"


def inputs(bh, s, n, decay, with_state, with_dstate, dtype, seed=0, device="cpu"):
    """(r, k, v, logw, u, state, dout, dstate) on the kernel's (B·H, S, N)
    layout from numpy: r, k, v in ``dtype``, the rest fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((bh, s, n), np.float32) for _ in range(4))
    if decay == "spread":
        omega = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5 + 0.1 * rng.standard_normal(
            (bh, s, n))
    else:
        omega = rng.uniform(-6.0, 3.5 if decay == "extreme" else decay, (bh, s, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = (rng.standard_normal((bh, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((bh, n, n)) * 0.1).astype(np.float32) if with_state else None
    ds = rng.standard_normal((bh, n, n)).astype(np.float32) if with_dstate else None

    def t(a, d=torch.float32):
        return None if a is None else torch.from_numpy(a).to(device, d)

    return (*(t(a, TORCH_DT[dtype]) for a in (r, k, v)), t(logw), t(u), t(st), t(do), t(ds))


def rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm().clamp_min(1e-30))


def limits(want, dtype):
    """Per gradient: 1e-4; bf16's dr, dk, dv twice their bf16 rounding."""
    out = [GRAD_TOL] * 6
    if dtype == "bfloat16":
        out[:3] = [2 * rel(w.bfloat16(), w) for w in want[:3]]
    return out


# ------------------------------------------------------------------ CPU
def test_each_dtype_names_its_three_passes():
    assert _build.BWD_SOURCE in _build.sources()
    assert _build.BWD_STAGES == ("wkv6_bwd_state", "wkv6_bwd_chunk", "wkv6_bwd_sum")
    src = _build.BWD_SOURCE.read_text()
    header = _build.TF32_HEADER.read_text()  # its PTX helpers
    for dt, entries in K.BWD_KERNELS.items():
        assert len(entries) == 3 and all(e in _build.BWD_ENTRY_POINTS for e in entries)
        suffix = "f32" if dt == torch.float32 else "bf16"
        assert entries == tuple(f"{s}_{suffix}" for s in _build.BWD_STAGES)
        for e in entries:
            assert f"WKV6_BWD_ENTRY({e}," in src
    for op in ("atomicAdd(", "atom.", "red.global.add"):  # every sum in a fixed order
        assert op not in src and op not in header
    assert f'#include "../../flash_attention/csrc/{_build.TF32_HEADER.name}"' in src
    for call in ("mma_tf32(", "split(", "cp_async16(", "cp_async_wait_all("):
        assert call in src
    for op in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert op in header
    K.reset_launches()
    assert set(K.wkv6_bhsn.launches_by_kernel) == {*K.KERNELS.values(),
                                                    *_build.BWD_ENTRY_POINTS}


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV6 backward kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TORCH_DT))
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_backward_kernel_matches_plain(cuda_device, case, dtype):
    x = inputs(*case, dtype, seed=1, device=cuda_device)
    with torch.no_grad():
        got = K.wkv6_bwd(*x)
        again = K.wkv6_bwd(*x)
        want = wkv6_bwd_ref(*x)
    torch.cuda.synchronize()
    assert [g.dtype for g in got[:3]] == [TORCH_DT[dtype]] * 3
    assert all(g.dtype == torch.float32 for g in got[3:])
    for name, g, w, lim in zip(NAMES, got, want, limits(want, dtype)):
        assert g.shape == w.shape, name
        assert rel(g, w) < lim, (name, rel(g, w), lim)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # bit-identical


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(TORCH_DT))
def test_gradient_through_the_entry_point_and_its_launches(cuda_device, dtype):
    """``ops.wkv6`` under autograd: one forward launch, one of each backward
    pass, and every input's gradient (u's summed over the batch) against
    the CPU's plain chunked form under autograd, below 1e-4; in bf16, dr, dk
    and dv are bf16 on both sides and their roundings of the two fp32 sums
    differ, so 1e-2 for those three (a bf16 rounding is 3.9e-3)."""
    b, s, h, n = 2, 100, 3, 64
    rng = np.random.default_rng(2)
    arrays = [rng.standard_normal((b, s, h, n), np.float32) for _ in range(4)]
    logw = (-np.exp(rng.uniform(-6, 1.5, (b, s, h, n)))).astype(np.float32)
    u = (rng.standard_normal((h, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((b, h, n, n)) * 0.1).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda_device):
        r, k, v = (torch.from_numpy(a).to(TORCH_DT[dtype]).to(dev) for a in arrays[:3])
        leaves = [x.requires_grad_(True) for x in
                  (r, k, v, *(torch.from_numpy(a).to(dev) for a in (logw, u, st)))]
        do = torch.from_numpy(arrays[3]).to(dev)
        K.reset_launches()
        out, _ = ops.wkv6(*leaves)
        (out * do).sum().backward()
        grads[str(dev)] = [x.grad.float().cpu() for x in leaves]
        if dev != "cpu":
            counts = K.wkv6_bhsn.launches_by_kernel
            assert counts[K.KERNELS[TORCH_DT[dtype]]] == 1
            assert all(counts[e] == 1 for e in K.BWD_KERNELS[TORCH_DT[dtype]])
            assert K.wkv6_bhsn.launches == 4
    want = grads["cpu"]
    for name, g, w in zip(NAMES, grads[str(cuda_device)], want):
        lim = GRAD_TOL if dtype == "float32" or name not in ("dr", "dk", "dv") else 1e-2
        assert rel(g, w) < lim, (name, rel(g, w))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="head size"):
        K.wkv6_bwd(*inputs(2, 20, 48, 0.5, True, True, "float32", device=cuda_device))
    x = inputs(2, 20, 64, 0.5, True, True, "float32", device=cuda_device)
    with pytest.raises(ValueError, match="takes r, k, v"):
        K.wkv6_bwd(*(a.double() for a in x[:3]), *x[3:])
    with pytest.raises(ValueError, match="dout must be"):
        K.wkv6_bwd(*x[:6], x[6][:, :5], x[7])
    leaf = x[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="drop the gradient"):
        K.wkv6_bwd(leaf, *x[1:])
    with pytest.raises(RuntimeError, match="drop the gradient"):
        K.wkv6_fwd(leaf, *x[1:6])


@pytest.mark.cuda
def test_block_fits_the_cards_shared_memory(cuda_device):
    lib = _build.load()
    for n in K.HEAD_SIZES:
        for code in (0, 1):
            for p in (0, 1):
                assert 0 < lib.wkv6_bwd_smem_bytes(n, code, p) <= 232448
        assert lib.wkv6_bwd_scratch_bytes(80, 4096, n) > 0
    assert lib.wkv6_bwd_smem_bytes(48, 0, 0) == 0
    assert lib.wkv6_bwd_scratch_bytes(2, 8, 48) == -1


@pytest.mark.cuda
def test_reduced_model_gradients_on_the_card_match_the_cpu(cuda_device):
    """The reduced rwkv6-3b (head size 16) in fp32: every gradient leaf of
    ``loss_fn`` through the kernels against the plain chunked form on the
    CPU, below 1e-4; the forward kernel twice a layer (remat "dots"
    recomputes it), each backward pass once."""
    cfg = reduced(get_config("rwkv6-3b"), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 150)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 150)).astype(np.int32)}
    want, want_loss, _ = steps.accumulate_grads(cfg, params, batch)
    card = schema.map_tree(params, lambda t: t.to(cuda_device))
    K.reset_launches()
    got, loss, _ = steps.accumulate_grads(cfg, card, batch)
    counts = dict(K.wkv6_bhsn.launches_by_kernel)
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = dict(schema.leaf_paths(want))
    for path, g in schema.leaf_paths(got):
        assert rel(g.cpu(), want[path]) < GRAD_TOL, ("/".join(path), rel(g.cpu(), want[path]))
    fwd = K.KERNELS[torch.float32]
    assert counts[fwd] == (2 if cfg.remat_policy == "dots" else 1) * cfg.n_layers
    assert all(counts[e] == cfg.n_layers for e in K.BWD_KERNELS[torch.float32])
