"""The WKV6 CUDA kernels against their plain PyTorch version.

Tests marked ``cuda`` build ``csrc/`` (``wkv6.cu``, fp32 on the CUDA cores;
``wkv6_mma.cu``, bf16 on the tensor cores) and hold each kernel against the
plain chunked form ``ref.wkv_chunked_bhsn`` on the card, outputs and final
state, to the reference's tolerances (5e-4 relative for fp32 inputs, 3e-2
for bf16; ``tests/test_kernels_rwkv6.py``), and the bf16 kernel also against
``mma_model``, the model of its arithmetic below, to 2^-9; without a CUDA
device they skip.
This file imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_rwkv6_kernel.py

The rest run anywhere: CPU tensors take the plain version and count no
launch, the plain forms agree with each other, a model of the tensor-core
kernel's arithmetic (``mma_model``) holds the reference's bf16 tolerance,
each dtype names its kernel, and the wrapper refuses inputs that do not fit
together.
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

LOG2E = 1.4426950408889634

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


def extreme_omega(b, s, h, n, seed):
    """Decay draws up to omega 3.5 (logw down to -33 a token): a factoring
    of the decay about any point inside a 16-token block overflows."""
    return np.random.default_rng(seed).uniform(-6.0, 3.5, (b, s, h, n))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def mma_model(r, k, v, logw, u, state=None, chunk=64):
    """The arithmetic of ``csrc/wkv6_mma.cu`` in plain torch on (BH, S, N):
    chunks of ``chunk`` tokens in 16-token sub-blocks; the decay in base 2
    (cum = running sum of logw·log2 e per channel, cum_ex its exclusive
    form); off-diagonal scores of sub-blocks i > j about the reference point
    cum[e_j] (e_j the last token of block j), from bf16 Q~ and K~; diagonal
    blocks pairwise in fp32 by the running product k·w[s+1]···w[t-1], with
    the bonus r·u·k on the diagonal; the scores, the decayed r and k and the
    copy of the state that the products read rounded to bf16; the state
    itself in fp32. -> (out (BH, S, N), state (BH, N, N)), fp32."""
    bh, s, n = r.shape
    pad = (-s) % chunk
    padded = [torch.nn.functional.pad(x.float(), (0, 0, 0, pad)) for x in (r, k, v, logw)]
    rf, kf, vf, lw = padded
    st = (torch.zeros(bh, n, n) if state is None else state.float()).clone()
    uf = u.float()
    nb = chunk // 16
    outs = []
    for c0 in range(0, s + pad, chunk):
        rc, kc, vc = (x[:, c0:c0 + chunk] for x in (rf, kf, vf))
        lw2 = lw[:, c0:c0 + chunk] * LOG2E
        cum = lw2.cumsum(1)
        cum_ex = torch.cat([torch.zeros_like(cum[:, :1]), cum[:, :-1]], 1)
        ends = cum[:, 15::16]  # (BH, nb, N): cum at each block's last token
        ref_pt = ends.repeat_interleave(16, 1)  # cum[e_j(s)] per token s
        kt = bf16(kc * torch.exp2(ref_pt - cum))
        a = torch.zeros(bh, chunk, chunk)
        for i in range(nb):
            ti = slice(16 * i, 16 * i + 16)
            for j in range(i):
                qt = bf16(rc[:, ti] * torch.exp2(cum_ex[:, ti] - ends[:, j:j + 1]))
                a[:, ti, 16 * j:16 * j + 16] = qt @ kt[:, 16 * j:16 * j + 16].transpose(1, 2)
            # the diagonal block, pairwise: g_s = k[s] w[s+1] ... w[t-1]
            g = kc[:, ti].clone()
            w = torch.exp2(lw2[:, ti])
            sidx = torch.arange(16)
            for t in range(16):
                live = (sidx < t)[None, :, None]
                a[:, 16 * i + t, ti] = torch.where(
                    sidx[None] < t, torch.einsum("bn,bsn->bs", rc[:, 16 * i + t], g), 0.0)
                g = torch.where(live, g * w[:, t:t + 1], g)
            a[:, ti, ti] += torch.diag_embed((rc[:, ti] * uf[:, None] * kc[:, ti]).sum(-1))
        o = bf16(a) @ vc + bf16(rc * torch.exp2(cum_ex)) @ bf16(st)
        last = cum[:, -1:]
        kh = bf16(kc * torch.exp2(last - cum))
        st = torch.exp2(last).transpose(1, 2) * st + kh.transpose(1, 2) @ vc
        outs.append(o)
    return torch.cat(outs, 1)[:, :s], st


# ------------------------------------------------------------------ CPU
def test_cpu_tensors_run_the_plain_version_and_count_no_launch(monkeypatch):
    """The wrapper hands CPU tensors to the plain chunked form and returns
    its result as it is. (Two runs of the plain form on the CPU do not
    always agree to the bit, in about one process of seven, so the result
    of the one call is what is compared.)"""
    calls = []

    def plain(*a):
        calls.append((a, wkv_chunked_bhsn(*a)))
        return calls[-1][1]

    monkeypatch.setattr(K, "wkv_chunked_bhsn", plain)
    K.reset_launches()
    args = inputs(*CASES[5], seed=1)
    out, st = K.wkv6_bhsn(*args)
    assert len(calls) == 1 and all(x is y for x, y in zip(calls[0][0], args))
    assert out is calls[0][1][0] and st is calls[0][1][1]
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


@pytest.mark.parametrize("attr", ["SOURCE", "MMA_SOURCE", "BWD_SOURCE"])
def test_library_name_follows_the_source(tmp_path, monkeypatch, attr):
    """The library's name hashes every source: an edit of any renames it."""
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libwkv6_")
    src = tmp_path / getattr(_build, attr).name
    src.write_text(getattr(_build, attr).read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, attr, src)
    assert _build.library_path() != first


def test_each_dtype_names_its_kernel():
    """bf16 launches the tensor-core kernel, fp32 the CUDA-core one: each
    entry point is defined in its own source, and only the bf16 source
    issues mma.sync, ldmatrix and 16-byte cp.async (the fp32 one copies its
    stages in bulk). The library also holds the backward's source, and the
    launch counts have a key for each of its entry points."""
    assert set(K.KERNELS) == {torch.float32, torch.bfloat16}
    assert sorted(K.KERNELS.values()) == sorted(_build.ENTRY_POINTS)
    cores, tensor_cores = _build.SOURCE.read_text(), _build.MMA_SOURCE.read_text()
    assert f'extern "C" int {K.KERNELS[torch.float32]}(' in cores
    assert f'extern "C" int {K.KERNELS[torch.bfloat16]}(' in tensor_cores
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", "ldmatrix.sync",
               "cp.async.cg.shared.global", "cp.async.wait_group"):
        assert op in tensor_cores and op not in cores
    assert _build.sources() == [_build.SOURCE, _build.MMA_SOURCE, _build.BWD_SOURCE]
    K.reset_launches()
    assert K.wkv6_bhsn.launches == 0
    assert K.wkv6_bhsn.launches_by_kernel == dict.fromkeys(
        [*K.KERNELS.values(), *_build.BWD_ENTRY_POINTS], 0)


# (b, s, h, n, decay, initial state, chunk) for the model of the tensor-core
# kernel: the decay_base spread, a uniform draw, the extreme decay, ragged
# lengths about its 16-token blocks and 64-token chunks, and the head sizes
# whose chunk differs (N 128 runs 32-token chunks)
MODEL_CASES = (
    [(1, 256, 2, 64, "spread", True, 64), (2, 200, 2, 64, "uniform", False, 64),
     (1, 200, 2, 64, "extreme", True, 64), (1, 130, 2, 128, "spread", True, 32),
     (2, 90, 3, 16, "uniform", True, 64)]
    + [(1, s, 2, 32, "uniform", st, 64) for s in (1, 15, 17, 65) for st in (False, True)]
)
OMEGA = {"spread": decay_base_omega, "extreme": extreme_omega, "uniform": None}


def model_case_id(c):
    return f"b{c[0]}s{c[1]}h{c[2]}n{c[3]}-{c[4]}{'-state' if c[5] else ''}-c{c[6]}"


def bf16_inputs(b, s, h, n, decay, with_state, seed, device="cpu"):
    omega = OMEGA[decay] and OMEGA[decay](b, s, h, n, seed + 1)
    return inputs(b, s, h, n, 0.5, "bfloat16", with_state, seed=seed, device=device,
                  omega=omega)


@pytest.mark.parametrize("case", MODEL_CASES, ids=model_case_id)
def test_mma_model_holds_the_bf16_tolerance(case):
    """The tensor-core kernel's arithmetic, bf16 roundings and all, against
    the exact scan within the bf16 tolerance, outputs and final state."""
    *shape, decay, with_state, chunk = case
    args = bf16_inputs(*shape, decay, with_state, seed=20)
    out, st = mma_model(*args, chunk=chunk)
    want, want_st = wkv6_ref(*args)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert rel_err(out, want) < 3e-2 and rel_err(st, want_st) < 3e-2


# the ragged lengths the fp32 kernel's stages (16 or 32 tokens) must handle:
# one token, a stage less one, one stage, a stage and one, three and a bit,
# and 2049 at a small BH
RING_LENGTHS = (1, 31, 32, 33, 95, 2049)
OMEGA_F32 = {"uniform": lambda *a: None, "extreme": extreme_omega}


def jax_wkv6(r, k, v, logw, u):
    """The JAX reference's sequential scan (``repro.kernels.rwkv6.ref.wkv6_ref``,
    from a zero state) on the same inputs, handed over as numpy. JAX is
    imported here, not with the module, so that the file runs where only
    the card's packages are."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref

    out = jax_ref(*(jnp.asarray(x.contiguous().numpy()) for x in (r, k, v, logw, u)))
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("decay", sorted(OMEGA_F32))
@pytest.mark.parametrize("s", RING_LENGTHS)
def test_plain_fp32_form_matches_the_jax_reference(s, decay):
    """The port's plain fp32 WKV6 (the kernel's yardstick) against the JAX
    reference's sequential scan, at the ring's ragged lengths, for a uniform
    decay draw and decays down to -33 a token."""
    b, h, n = (1, 1, 64) if s > 1000 else (1, 2, 64)
    args = inputs(b, s, h, n, 0.5, "float32", False, seed=30 + s,
                  omega=OMEGA_F32[decay](b, s, h, n, 31))
    out, _ = wkv_chunked_bhsn(*args)
    assert rel_err(out, jax_wkv6(*args[:5])) < 5e-4


@pytest.mark.parametrize("split", [(1, 94), (31, 33), (32, 63), (95, 1954)])
def test_plain_fp32_form_carries_the_state_as_the_jax_reference(split):
    """One sequence in two calls of the port's plain fp32 form, the state
    carried between them, against one call of the JAX reference."""
    s1, s2 = split
    r, k, v, logw, u, _ = inputs(1, s1 + s2, 2, 32, 0.5, "float32", False, seed=40 + s1)
    o1, st = wkv_chunked_bhsn(r[:, :s1], k[:, :s1], v[:, :s1], logw[:, :s1], u)
    o2, _ = wkv_chunked_bhsn(r[:, s1:], k[:, s1:], v[:, s1:], logw[:, s1:], u, st)
    assert rel_err(torch.cat([o1, o2], 1), jax_wkv6(r, k, v, logw, u)) < 5e-4


def test_fp32_source_copies_asynchronously():
    """The fp32 kernel fetches its stages by bulk copies on mbarriers: the
    source issues the copy, and initialises, arms and waits on the
    barriers."""
    src = _build.SOURCE.read_text()
    for op in ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes",
               "mbarrier.init.shared::cta.b64", "mbarrier.arrive.expect_tx.shared::cta.b64",
               "mbarrier.try_wait.parity.shared::cta.b64"):
        assert op in src, op


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
@pytest.mark.parametrize("n", K.HEAD_SIZES)
@pytest.mark.parametrize("s", RING_LENGTHS)
def test_fp32_kernel_ring_lengths_carry_the_state(cuda_device, s, n):
    """The fp32 kernel against plain at the ring's ragged lengths, from a
    nonzero state, in one call and in two with the state carried between
    them (the second holds no token where s is 1)."""
    h = 1 if s > 1000 else 3
    r, k, v, logw, u, st0 = inputs(1, s, h, n, 0.5, "float32", True, seed=50 + s,
                                   device=cuda_device)
    want, want_st = wkv_chunked_bhsn(r, k, v, logw, u, st0)
    out, st = K.wkv6_bhsn(r, k, v, logw, u, st0)
    s1 = (s + 1) // 2
    o1, mid = K.wkv6_bhsn(r[:, :s1], k[:, :s1], v[:, :s1], logw[:, :s1], u, st0)
    o2, st2 = K.wkv6_bhsn(r[:, s1:], k[:, s1:], v[:, s1:], logw[:, s1:], u, mid)
    torch.cuda.synchronize()
    for got, got_st in ((out, st), (torch.cat([o1, o2], 1), st2)):
        assert rel_err(got, want) < 5e-4 and rel_err(got_st, want_st) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("s", RING_LENGTHS)
def test_fp32_kernel_holds_decays_down_to_minus_33(cuda_device, s):
    b, h, n = 1, 2, 64
    args = inputs(b, s, h, n, None, "float32", True, seed=60 + s, device=cuda_device,
                  omega=extreme_omega(b, s, h, n, 61))
    out, st = K.wkv6_bhsn(*args)
    want, want_st = wkv_chunked_bhsn(*args)
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert rel_err(out, want) < 5e-4 and rel_err(st, want_st) < 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", K.HEAD_SIZES)
def test_fp32_kernel_at_a_tile_count_off_the_sm_count(cuda_device, n):
    """37 heads: 37 to 296 blocks (74 at N 64, two 32-column tiles a head),
    no multiple of the card's 132 SMs, so the last wave is partial."""
    args = inputs(1, 300, 37, n, 0.5, "float32", True, seed=70, device=cuda_device)
    out, st = K.wkv6_bhsn(*args)
    want, want_st = wkv_chunked_bhsn(*args)
    assert rel_err(out, want) < 5e-4 and rel_err(st, want_st) < 5e-4


@pytest.mark.cuda
def test_fp32_block_fits_the_cards_shared_memory(cuda_device):
    """The shared memory the library launches an fp32 block with fits the
    card's opt-in limit at every head size (227 KB a block on Hopper), and
    other head sizes get 0."""
    lib = _build.load()
    for n in K.HEAD_SIZES:
        assert 0 < lib.wkv6_fwd_f32_smem_bytes(n) <= 232448
    assert lib.wkv6_fwd_f32_smem_bytes(48) == 0


# bf16 through the tensor-core kernel: every head size; ragged lengths about
# its 16-token blocks and 64-token chunks, with and without a state; the
# decay_base spread and the extreme decay (b, s, h, n, decay, initial state)
BF16 = (
    [(1, 200, 4, n, "uniform", True) for n in K.HEAD_SIZES]
    + [(1, s, 2, 64, "uniform", st) for s in (1, 15, 16, 17, 63, 65, 1000)
       for st in (False, True)]
    + [(2, 512, 4, 64, "spread", True), (1, 300, 2, 128, "spread", False),
       (1, 333, 3, 16, "spread", True)]
    + [(2, 256, 4, 64, "extreme", True), (1, 100, 2, 32, "extreme", False),
       (1, 150, 2, 128, "extreme", True)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16, ids=lambda c: model_case_id((*c, 64)))
def test_bf16_kernel_matches_plain(cuda_device, case):
    args = bf16_inputs(*case, seed=21, device=cuda_device)
    before = dict(K.wkv6_bhsn.launches_by_kernel)
    out, st = K.wkv6_bhsn(*args)
    torch.cuda.synchronize()
    assert K.wkv6_bhsn.launches_by_kernel["wkv6_fwd_bf16"] == before["wkv6_fwd_bf16"] + 1
    assert K.wkv6_bhsn.launches_by_kernel["wkv6_fwd_f32"] == before["wkv6_fwd_f32"]
    want, want_st = wkv_chunked_bhsn(*args)
    assert out.dtype == torch.float32 and out.shape == args[0].shape
    assert torch.isfinite(out).all() and torch.isfinite(st).all()
    assert rel_err(out, want) < 3e-2 and rel_err(st, want_st) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16, ids=lambda c: model_case_id((*c, 64)))
def test_bf16_kernel_matches_its_model(cuda_device, case):
    """The tensor-core kernel against ``mma_model`` on the same bf16 inputs.
    Both round the same terms to bf16; they differ by the order of the fp32
    sums and ``ex2.approx``, and by the bf16 roundings that those move across
    a rounding boundary (up to 2^-8 of a term). The limit is 2^-9 of the
    largest value: at the extreme decay, where a few terms carry each output,
    one such flip reads about 1e-3."""
    args = bf16_inputs(*case, seed=21, device=cuda_device)
    out, st = K.wkv6_bhsn(*args)
    n = case[3]
    want, want_st = mma_model(*(None if x is None else x.cpu() for x in args),
                              chunk=32 if n == 128 else 64)
    assert rel_err(out.cpu(), want) < 2.0 ** -9 and rel_err(st.cpu(), want_st) < 2.0 ** -9


@pytest.mark.cuda
def test_bf16_kernel_carries_the_state_across_calls(cuda_device):
    r, k, v, logw, u, st0 = bf16_inputs(1, 300, 2, 64, "spread", True, seed=22,
                                        device=cuda_device)
    full, full_st = K.wkv6_bhsn(r, k, v, logw, u, st0)
    o1, st = K.wkv6_bhsn(r[:, :100], k[:, :100], v[:, :100], logw[:, :100], u, st0)
    o2, st = K.wkv6_bhsn(r[:, 100:], k[:, 100:], v[:, 100:], logw[:, 100:], u, st)
    want, want_st = wkv_chunked_bhsn(r, k, v, logw, u, st0)
    assert rel_err(torch.cat([o1, o2], 1), want) < 3e-2 and rel_err(st, want_st) < 3e-2
    assert rel_err(torch.cat([o1, o2], 1), full) < 3e-2 and rel_err(st, full_st) < 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, name, other", [
    (torch.bfloat16, "wkv6_mma_kernel", "wkv6_kernel"),
    (torch.float32, "wkv6_kernel", "wkv6_mma_kernel"),
])
def test_dtype_launches_its_kernel(cuda_device, dtype, name, other):
    """The device kernels a call runs, as the profiler names them. Now and
    then a profiling session records no device activity at all; such a
    session is run again, three times at most."""
    from torch.profiler import ProfilerActivity, profile

    args = inputs(1, 128, 2, 64, 0.5, "float32", True, seed=23, device=cuda_device)
    args = (*(x.to(dtype) for x in args[:3]), *args[3:])
    K.wkv6_bhsn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            K.wkv6_bhsn(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert any(name in n for n in names), names
    assert not any(other in n for n in names), names


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
