"""The WKV6 CUDA kernel against its plain PyTorch version.

Tests marked ``cuda`` build ``csrc/wkv6.cu`` and hold the kernel against the
plain chunked form ``ref.wkv_chunked_bhsn`` on the card, outputs and final
state, to the reference's tolerances (5e-4 relative for fp32 inputs, 3e-2
for bf16; ``tests/test_kernels_rwkv6.py``); without a CUDA device they skip.
This file imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_kernel.py

The rest run anywhere: CPU tensors take the plain version and count no
launch, the plain forms agree with each other, and the wrapper refuses
inputs that do not fit together.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.rwkv6 import _build
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6 import ops
from repro_torch.kernels.rwkv6.ref import fold_heads, wkv6_ref, wkv_chunked_bhsn
from repro_torch.models import forward, init_model

# (b, s, h, n, omega_hi, dtype, initial state): tests/test_kernels_rwkv6.py's
# five cases, then ragged lengths, a nonzero state and the reduced head size
CASES = [
    (2, 64, 4, 64, 0.5, "float32", False),
    (1, 128, 2, 64, 1.0, "float32", False),
    (1, 96, 2, 64, 0.5, "float32", False),
    (2, 96, 3, 32, 0.5, "bfloat16", False),
    (1, 64, 1, 128, 0.0, "float32", False),
    (1, 77, 4, 64, 0.5, "float32", True),
    (2, 1000, 2, 64, 0.5, "bfloat16", True),
    (1, 200, 2, 128, 1.0, "float32", True),
    (3, 45, 4, 16, 0.5, "float32", True),
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def case_id(c):
    return f"b{c[0]}s{c[1]}h{c[2]}n{c[3]}w{c[4]}{c[5]}{'-state' if c[6] else ''}"


def tol(dt):
    return 3e-2 if dt == "bfloat16" else 5e-4


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-9))


def inputs(b, s, h, n, omega_hi, dt, with_state, seed=0, device="cpu", omega=None):
    """(r, k, v, logw, u, state) on the kernel's (B·H, S, N) layout; r, k, v
    in ``dt``, the rest fp32; ``omega`` replaces the uniform decay draw."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n), np.float32) for _ in range(3))
    if omega is None:
        omega = rng.uniform(-6.0, omega_hi, (b, s, h, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = np.broadcast_to(rng.standard_normal((h, n)) * 0.3, (b, h, n)).reshape(b * h, n)
    st = (rng.standard_normal((b * h, n, n)) * 0.1).astype(np.float32) if with_state else None
    t = lambda a, d=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(device, d)  # noqa: E731
    return (*(fold_heads(t(a, TORCH_DT[dt])) for a in (r, k, v)), fold_heads(t(logw)),
            t(u.astype(np.float32)), None if st is None else t(st))


def decay_base_omega(b, s, h, n, seed):
    """rwkv6's decay_base spread over a head's channels, plus 0.1 noise."""
    base = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5
    return base + 0.1 * np.random.default_rng(seed).standard_normal((b, s, h, n))


# ------------------------------------------------------------------ CPU
def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    K.reset_launches()
    args = inputs(*CASES[5], seed=1)
    out, st = K.wkv6_bhsn(*args)
    want, want_st = wkv_chunked_bhsn(*args)
    assert torch.equal(out, want) and torch.equal(st, want_st)
    assert K.wkv6_bhsn.launches == 0


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_forms_agree(case):
    """The chunked form (the kernel's yardstick) against the sequential
    scan, outputs and final state, from the case's state."""
    args = inputs(*case, seed=2)
    out, st = wkv_chunked_bhsn(*args)
    want, want_st = wkv6_ref(*args)
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert rel_err(out, want) < 5e-4 and rel_err(st, want_st) < 5e-4


def test_plain_form_is_exact_at_the_decay_base_spread():
    b, s, h, n = 1, 64, 2, 64
    args = inputs(b, s, h, n, None, "float32", True, seed=3,
                  omega=decay_base_omega(b, s, h, n, 4))
    out, st = wkv_chunked_bhsn(*args)
    want, want_st = wkv6_ref(*args)
    assert rel_err(out, want) < 5e-4 and rel_err(st, want_st) < 5e-4


def test_caller_state_is_not_modified():
    args = inputs(1, 33, 2, 16, 0.5, "float32", True, seed=6)
    before = args[-1].clone()
    out, _ = K.wkv6_bhsn(*args)
    assert torch.equal(args[-1], before) and out.shape == (2, 33, 16)


def test_wrapper_refuses_what_does_not_fit():
    r = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="shape"):
        K.wkv6_bhsn(r, r, r[:, :4], r, torch.zeros(2, 16))
    with pytest.raises(ValueError, match="u must be"):
        K.wkv6_bhsn(r, r, r, r, torch.zeros(2, 8))
    with pytest.raises(ValueError, match="state must be"):
        K.wkv6_bhsn(r, r, r, r, torch.zeros(2, 16), torch.zeros(2, 16, 8))
    with pytest.raises(ValueError, match="dtypes differ"):
        K.wkv6_bhsn(r, r.double(), r, r, torch.zeros(2, 16))


def test_entry_point_folds_heads_and_carries_the_state():
    rng = np.random.default_rng(7)
    b, s, h, n = 2, 20, 3, 16
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, n), np.float32)) for _ in range(3))
    logw = -torch.exp(torch.from_numpy(rng.uniform(-6, 0.5, (b, s, h, n)).astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((h, n), np.float32))
    out, st = ops.wkv6(r, k, v, logw, u)
    assert out.shape == (b, s, h, n) and st.shape == (b, h, n, n)
    ue = u[None].expand(b, h, n).reshape(b * h, n)
    want, want_st = wkv6_ref(*map(fold_heads, (r, k, v, logw)), ue)
    assert rel_err(fold_heads(out), want) < 5e-4
    assert rel_err(st.reshape(b * h, n, n), want_st) < 5e-4


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libwkv6_")
    src = tmp_path / "wkv6.cu"
    src.write_text(_build.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "SOURCE", src)
    assert _build.library_path() != first


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV6 kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_plain(cuda_device, case):
    args = inputs(*case, seed=8, device=cuda_device)
    before = K.wkv6_bhsn.launches
    out, st = K.wkv6_bhsn(*args)
    torch.cuda.synchronize()
    assert K.wkv6_bhsn.launches == before + 1
    want, want_st = wkv_chunked_bhsn(*args)
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert rel_err(out, want) < tol(case[5])
    assert rel_err(st, want_st) < tol(case[5])


@pytest.mark.cuda
def test_kernel_carries_the_state_across_calls(cuda_device):
    r, k, v, logw, u, _ = inputs(1, 128, 2, 64, 0.5, "float32", False, seed=9,
                                 device=cuda_device)
    full, full_st = K.wkv6_bhsn(r, k, v, logw, u)
    o1, st = K.wkv6_bhsn(r[:, :64], k[:, :64], v[:, :64], logw[:, :64], u)
    o2, st = K.wkv6_bhsn(r[:, 64:], k[:, 64:], v[:, 64:], logw[:, 64:], u, st)
    assert rel_err(torch.cat([o1, o2], 1), full) < 5e-4
    assert rel_err(st, full_st) < 5e-4


@pytest.mark.cuda
def test_kernel_is_exact_at_the_decay_base_spread(cuda_device):
    b, s, h, n = 2, 256, 4, 64
    args = inputs(b, s, h, n, None, "float32", True, seed=10, device=cuda_device,
                  omega=decay_base_omega(b, s, h, n, 11))
    out, st = K.wkv6_bhsn(*args)
    want, want_st = wkv6_ref(*args)
    assert rel_err(out, want) < 5e-4 and rel_err(st, want_st) < 5e-4


@pytest.mark.cuda
def test_kernel_refuses_what_it_lacks(cuda_device):
    x = torch.zeros(2, 8, 48, device=cuda_device)
    with pytest.raises(ValueError, match="head size"):
        K.wkv6_bhsn(x, x, x, x, torch.zeros(2, 48, device=cuda_device))
    y = torch.zeros(2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        K.wkv6_bhsn(y, y, y, y.float(), torch.zeros(2, 64, device=cuda_device))
    z = torch.zeros(2 * 8 * 64 + 1, device=cuda_device)[1:].view(2, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        K.wkv6_bhsn(z, z, z, z, torch.zeros(2, 64, device=cuda_device))


@pytest.mark.cuda
def test_model_forward_on_the_card_matches_the_cpu(cuda_device):
    """The reduced rwkv6-3b (head size 16) through the kernel, against the
    plain path on the CPU, fp32: logits and the emitted wkv state to a
    relative error below 2e-4, one launch per layer."""
    cfg = reduced(get_config("rwkv6-3b"), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    want, want_cache = forward(cfg, params, {"tokens": toks}, emit_cache=True)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}

    before = K.wkv6_bhsn.launches
    got, cache = forward(cfg, to_card(params), {"tokens": toks.to(cuda_device)},
                         emit_cache=True)
    assert K.wkv6_bhsn.launches == before + cfg.n_layers
    assert rel_err(got.cpu(), want) < 2e-4
    assert rel_err(cache["wkv"].cpu(), want_cache["wkv"]) < 2e-4
