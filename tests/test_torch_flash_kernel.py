"""The flash-attention CUDA kernels against their plain PyTorch version.

Tests marked ``cuda`` build ``csrc/`` (both kernels on the tensor cores:
fp32 as three TF32 products, bf16 on wgmma) and hold each against
``attention_ref`` on the card, with the reference's tolerances (5e-5 fp32,
2.5e-2 bf16 max |err|; bf16 also within ``BF16_REL_TOL`` of the relative
2-norm), and the fp32 kernel against ``tf32x3_model``, the model of its
arithmetic below; without a CUDA device they skip. This file imports
no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_kernel.py

The rest run anywhere: CPU tensors take the plain version and count no
launch, the wrapper refuses inputs that do not fit together, each dtype
names its kernel, the library's name hashes every source,
``tf32x3_model`` holds the fp32 tolerance where one TF32 product does not,
and ``BF16_REL_TOL`` passes ``bf16_model`` and fails a planted tail leak at
whisper's non-causal shapes.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels.flash_attention import _build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import forward, init_model

# (b, sq, sk, hq, hkv, dh, causal, window, dtype): tests/test_kernels_flash.py
CASES = [
    (2, 256, 256, 4, 2, 64, True, None, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, "float32"),
    (1, 128, 128, 8, 8, 128, True, None, "bfloat16"),
    (2, 256, 256, 4, 1, 64, True, 96, "float32"),  # SWA + MQA
    (1, 128, 256, 2, 2, 64, False, None, "float32"),  # cross-attention
    (1, 64, 64, 6, 3, 112, True, None, "float32"),  # kimi head_dim
    (1, 256, 256, 2, 2, 64, True, 32, "bfloat16"),  # tight window, bf16
]
# lengths that are no multiple of the kernel's 64-row tiles
RAGGED = [
    (1, 300, 300, 4, 2, 128, True, None, "float32"),
    (1, 1000, 1000, 4, 2, 128, True, None, "bfloat16"),
    (2, 300, 300, 4, 2, 64, True, 100, "float32"),
    (1, 77, 200, 4, 4, 16, False, None, "float32"),  # cross-attention, ragged k
    (1, 150, 130, 2, 1, 48, True, 40, "float32"),  # Sq > Sk, window
]
# bf16 through the tensor-core kernel: every head width it takes; the
# reference's windowed, MQA, GQA and cross-attention shapes; ragged lengths
# about its 128-row tiles, alone and with Sq > Sk or Sk > Sq; windows whose
# first live tile is fully masked for the block's last rows; and one head
# group at internlm2's prefill widths
BF16 = (
    [(1, 200, 200, 4, 2, dh, True, None, "bfloat16") for dh in K.HEAD_DIMS]
    + [
        (2, 256, 256, 4, 1, 64, True, 96, "bfloat16"),  # SWA + MQA (group 4)
        (2, 256, 256, 4, 2, 128, True, None, "bfloat16"),  # GQA, group 2
        (1, 256, 256, 8, 1, 128, True, None, "bfloat16"),  # GQA, group 8
        (1, 128, 256, 2, 2, 64, False, None, "bfloat16"),  # cross-attention
        (1, 64, 64, 6, 3, 112, True, None, "bfloat16"),  # kimi head_dim
    ]
    + [(1, n, n, 2, 1, 128, True, None, "bfloat16") for n in (1, 63, 65, 127, 129, 300)]
    + [
        (1, 300, 127, 2, 1, 64, True, None, "bfloat16"),  # Sq > Sk
        (1, 150, 130, 2, 1, 48, True, 40, "bfloat16"),  # Sq > Sk, window
        (1, 65, 1000, 2, 2, 112, False, None, "bfloat16"),  # Sk > Sq
        (1, 129, 300, 4, 2, 80, True, None, "bfloat16"),  # Sk > Sq, causal
        (1, 512, 512, 2, 1, 128, True, 100, "bfloat16"),  # first live tile fully masked
        (1, 512, 512, 2, 1, 64, True, 100, "bfloat16"),  # ... for some rows
        (1, 2048, 2048, 16, 8, 128, True, None, "bfloat16"),  # prefill widths
    ]
)
# the MoE and hybrid slice's heads at lengths past their windows: hymba
# (GQA group 5, Dh 64, window 1024) and mixtral (group 6, Dh 128, window
# 4096), one kv head each, in both dtypes
GQA_WINDOW = [
    (1, 1100, 1100, 5, 1, 64, True, 1024, dt) for dt in ("float32", "bfloat16")
] + [
    (1, 4200, 4200, 6, 1, 128, True, 4096, dt) for dt in ("float32", "bfloat16")
] + [(2, 1300, 1300, 10, 2, 64, True, 1024, "bfloat16")]
# whisper-large-v3's heads (20/20 of 64): the encoder's non-causal
# self-attention over 1500 frames (1500 = 11 x 128 + 92: a ragged last key
# tile in every row), the decoder's cross-attention from 448 tokens to
# them, and the decoder's own causal attention, in both dtypes
WHISPER = [
    (1, sq, sk, 20, 20, 64, causal, None, dt)
    for sq, sk, causal in ((1500, 1500, False), (448, 1500, False), (448, 448, True))
    for dt in ("float32", "bfloat16")
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def case_id(c):
    return f"b{c[0]}q{c[1]}k{c[2]}h{c[3]}kv{c[4]}d{c[5]}c{int(c[6])}w{c[7]}{c[8]}"


def inputs(case, seed=0):
    """q (B, Sq, Hq, Dh), k and v (B, Sk, Hkv, Dh), fp32 numpy."""
    b, sq, sk, hq, hkv, dh, *_ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, dh), np.float32),
            rng.standard_normal((b, sk, hkv, dh), np.float32),
            rng.standard_normal((b, sk, hkv, dh), np.float32))


def tol(dt):
    return 2.5e-2 if dt == "bfloat16" else 5e-5


#: bf16 outputs are also held to ||got - want||_2 / ||want||_2 below this.
#: Over 1500 keys an output is a mean of ~0.04, and a fault that scales
#: every row by 1.4 % moves it by ~0.004, far inside 2.5e-2 max |err|;
#: rounding to bf16 costs ~2e-3 of each value wherever it lies
#: (``test_bf16_relative_limit_sits_between_sound_and_leaking``)
BF16_REL_TOL = 5e-3


def rel_norm(got, want):
    """||got - want||_2 / ||want||_2, in fp32."""
    d = got.float() - want.float()
    return (d.norm() / want.float().norm()).item()


def fold(a):
    """(B, S, H, Dh) -> (B·H, S, Dh)."""
    b, s, h, d = a.shape
    return a.transpose(0, 2, 1, 3).reshape(b * h, s, d)


LOG2E = 1.4426950408889634
MASKED = -1e30


def tf32(x):
    """fp32 -> tf32 as ``cvt.rna.tf32.f32`` rounds: to nearest, ties away
    from zero, the 13 low bits cleared (int32 bit operations)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x):
    """x = hi + lo, hi = tf32(x), lo = x - hi (exact); the tensor core reads
    lo's top 11 bits (its 13 low bits cleared)."""
    hi = tf32(x)
    return hi, ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, products=3):
    """a @ b from TF32 operands in fp32: a_lo b_hi + a_hi b_lo (the small
    products), then + a_hi b_hi; ``products=1`` keeps a_hi b_hi alone."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if products == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


#: the fp32 kernel's query rows a block and keys a tile (BQ, BK)
BQ, BK = 128, 64


def tf32x3_model(q, k, v, *, causal=True, window=None, products=3):
    """The arithmetic of ``csrc/flash_attention.cu`` in plain torch on
    (B·H, S, Dh), fp32: blocks of ``BQ`` query rows walk the live tiles of
    ``BK`` keys (none entirely in the block's future or behind its window);
    S = Q K^T and P V as three TF32 products (``tf32_product``); scores in
    base 2 (scale·log2 e in one fp32 multiply), the finite mask value -1e30,
    -inf past Sk (K/V zero-filled there); the online softmax per tile,
    o = acc / max(l, 1e-30)."""
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    pad = (0, 0, 0, (-sk) % BK)
    kf, vf = (torch.nn.functional.pad(x.float(), pad).repeat_interleave(bhq // bhkv, 0)
              for x in (k, v))
    sl2 = (torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
           * torch.tensor(LOG2E, dtype=torch.float32))
    out = torch.empty(bhq, sq, dh)
    for q0 in range(0, sq, BQ):
        q1 = min(q0 + BQ, sq)
        rows = torch.arange(q0, q1)[:, None]
        t_begin, t_end = 0, -(-sk // BK)
        if causal:
            t_end = min(t_end, (q1 - 1) // BK + 1)
        if window is not None and q0 - window + 1 > 0:
            t_begin = (q0 - window + 1) // BK
        m = torch.full((bhq, q1 - q0), MASKED)
        l = torch.zeros(bhq, q1 - q0)
        acc = torch.zeros(bhq, q1 - q0, dh)
        for t in range(t_begin, t_end):
            k0 = t * BK
            cols = torch.arange(k0, k0 + BK)[None, :]
            s = tf32_product(q[:, q0:q1].float(), kf[:, k0:k0 + BK].transpose(1, 2),
                             products) * sl2
            dead = torch.zeros(q1 - q0, BK, dtype=torch.bool)
            if causal:
                dead |= cols > rows
            if window is not None:
                dead |= cols <= rows - window
            s = torch.where(cols >= sk, -math.inf, torch.where(dead, MASKED, s))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + tf32_product(p, vf[:, k0:k0 + BK], products)
            m = m_new
        out[:, q0:q1] = acc / l.clamp_min(1e-30)[..., None]
    return out


#: the bf16 kernel's key tile: K and V are zero-filled past Sk up to it
BF16_BK = 128


def bf16_model(q, k, v, *, causal=True, window=None):
    """The arithmetic of ``csrc/flash_attention_wgmma.cu`` on bf16
    (B·H, S, Dh), without its tiling: fp32 scores and softmax, the row sum l
    from fp32 P, P rounded to bf16 for P V in fp32, o = (P V) / l rounded
    to bf16. (The online softmax's rescaling adds fp32 roundings only.)"""
    bhq, sq, dh = q.shape
    g = bhq // k.shape[0]
    kf, vf = (x.float().repeat_interleave(g, 0) for x in (k, v))
    s = torch.einsum("hqd,hkd->hqk", q.float(), kf) / math.sqrt(dh)
    rows, cols = torch.arange(sq)[:, None], torch.arange(k.shape[1])[None, :]
    live = torch.ones(sq, k.shape[1], dtype=torch.bool)
    if causal:
        live &= cols <= rows
    if window is not None:
        live &= cols > rows - window
    s = torch.where(live, s, MASKED)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("hqk,hkd->hqd", p.bfloat16().float(), vf) / p.sum(-1, keepdim=True)
    return o.to(q.dtype)


def tail_leak(q, k, v):
    """A planted fault of a non-causal kernel: the zero-filled keys of the
    last ``BF16_BK``-key tile counted in every row's softmax (score 0,
    value 0), so each output shrinks by their share of the row sum."""
    pad = (0, 0, 0, (-k.shape[1]) % BF16_BK)
    return attention_ref(q, torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
                         causal=False)


FP32 = [c for c in CASES + RAGGED if c[-1] == "float32"]
#: the fp32 kernel against its model on the card: both take the same
#: operand bits and differ only in how their fp32 sums round (the tensor
#: core's inner sums of eight products truncate, Fasi et al. 2021; torch's
#: round to nearest in another order) and in ex2.approx (2 ulp): a few
#: ulps of |o| <= ~4, ~1e-6; 1e-5 leaves that several times over and sits
#: 100x below what losing the small products costs (~1e-3)
MODEL_TOL = 1e-5


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    K.reset_launches()
    q, k, v = (torch.from_numpy(fold(a)) for a in inputs(CASES[0]))
    out = K.flash_attention_bhsd(q, k, v, causal=True)
    assert torch.equal(out, attention_ref(q, k, v, causal=True))
    assert K.flash_attention_bhsd.launches == 0


def test_wrapper_refuses_what_does_not_fit():
    q = torch.zeros(6, 8, 16)
    k = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        K.flash_attention_bhsd(q, k, k)
    with pytest.raises(ValueError, match="do not fit"):
        K.flash_attention_bhsd(q, torch.zeros(3, 8, 32), torch.zeros(3, 8, 32))
    with pytest.raises(ValueError, match="dtypes differ"):
        K.flash_attention_bhsd(q, k[:3].double(), k[:3])
    with pytest.raises(ValueError, match="window"):
        K.flash_attention_bhsd(q, k[:3], k[:3], window=0)


def test_each_dtype_names_its_kernel():
    """bf16 launches the wgmma kernel, fp32 the mma.sync one (three TF32
    products): each entry point is defined in its own source, and only the
    bf16 source issues wgmma and TMA loads into an mbarrier ring."""
    assert set(K.KERNELS) == {torch.float32, torch.bfloat16}
    assert sorted(K.KERNELS.values()) == sorted(_build.ENTRY_POINTS)
    cores, tensor_cores = _build.SOURCE.read_text(), _build.WGMMA_SOURCE.read_text()
    assert f'extern "C" int {K.KERNELS[torch.float32]}(' in cores
    assert f'extern "C" int {K.KERNELS[torch.bfloat16]}(' in tensor_cores
    for op in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait", "setmaxnreg"):
        assert op in tensor_cores and op not in cores
    assert _build.sources() == [_build.SOURCE, _build.WGMMA_SOURCE, _build.BWD_SOURCE]


def test_fp32_source_takes_three_tf32_products_on_the_tensor_cores():
    """The fp32 kernel issues tf32 mma.sync, takes its fragments by
    ldmatrix, brings its tiles in by cp.async and reports its shared memory
    to the host."""
    cores = _build.SOURCE.read_text()
    for op in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "cp.async.cg.shared.global", "ldmatrix.sync.aligned",
               'extern "C" int flash_fwd_f32_smem_bytes('):
        assert op in cores, op


def test_tf32_rounds_to_nearest_ties_away_and_splits_exactly():
    """``tf32`` is cvt.rna's rounding, and hi + lo holds x to 2^-22."""
    one = 1.0 + 2.0 ** -11  # halfway between two tf32 neighbours of 1
    x = torch.tensor([one, -one, 1.0 + 2.0 ** -12, 3.0, -0.0, 1.0 + 3 * 2.0 ** -11])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, -0.0,
                         1.0 + 2.0 ** -9])
    assert torch.equal(tf32(x), want)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = tf32_split(y)
    assert torch.equal(hi.view(torch.int32) & 0x1FFF, torch.zeros(4096, dtype=torch.int32))
    assert ((y - hi).abs() <= y.abs() * 2.0 ** -11).all()
    assert ((hi + lo - y).abs() <= y.abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("case", FP32, ids=case_id)
def test_tf32x3_model_holds_the_fp32_tolerance(case):
    *_, causal, window, _ = case
    q, k, v = (torch.from_numpy(fold(a)) for a in inputs(case, seed=2))
    got = tf32x3_model(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert (got - want).abs().max().item() < tol("float32")


def test_one_tf32_product_misses_the_fp32_tolerance():
    """Why the kernel takes three products: one keeps 11 bits and lands
    ~20x outside 5e-5."""
    case = (1, 128, 128, 8, 8, 128, True, None, "float32")
    q, k, v = (torch.from_numpy(fold(a)) for a in inputs(case, seed=2))
    want = attention_ref(q, k, v, causal=True)
    one = (tf32x3_model(q, k, v, products=1) - want).abs().max().item()
    three = (tf32x3_model(q, k, v) - want).abs().max().item()
    assert one > 10 * tol("float32") and three < tol("float32") / 10


@pytest.mark.parametrize("case", [c for c in WHISPER if not c[6] and c[-1] == "bfloat16"],
                         ids=case_id)
def test_bf16_relative_limit_sits_between_sound_and_leaking(case):
    """At whisper's non-causal shapes (1500 keys: 36 zero-filled in the last
    tile) the kernel's bf16 arithmetic reads below ``BF16_REL_TOL`` and a
    tail leak at least twice above it, though the leak's max |err| (~4e-3)
    lies far inside 2.5e-2. Four of the 20 heads: the readings are per row."""
    case = (case[0], case[1], case[2], 4, 4, *case[5:])
    q, k, v = (torch.from_numpy(fold(a)).bfloat16() for a in inputs(case, seed=2))
    want = attention_ref(q, k, v, causal=False)
    bad = tail_leak(q, k, v)
    assert rel_norm(bf16_model(q, k, v, causal=False), want) < BF16_REL_TOL
    assert rel_norm(bad, want) > 2 * BF16_REL_TOL
    assert (bad.float() - want.float()).abs().max().item() < tol("bfloat16")


@pytest.mark.parametrize("case", [c for c in BF16 if c[1] * c[2] * c[3] <= 2 ** 20],
                         ids=case_id)
def test_bf16_model_holds_the_relative_limit(case):
    """The kernel's bf16 arithmetic within ``BF16_REL_TOL`` where the mask
    is causal, windowed or grouped too (the smaller bf16 cases)."""
    *_, causal, window, _ = case
    q, k, v = (torch.from_numpy(fold(a)).bfloat16() for a in inputs(case, seed=2))
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert rel_norm(bf16_model(q, k, v, causal=causal, window=window), want) < BF16_REL_TOL


@pytest.mark.parametrize("attr", ["SOURCE", "WGMMA_SOURCE", "BWD_SOURCE"])
def test_library_name_hashes_every_source(tmp_path, monkeypatch, attr):
    first = _build.library_path()
    src = tmp_path / getattr(_build, attr).name
    src.write_text(getattr(_build, attr).read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, attr, src)
    assert _build.library_path() != first


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libflash_attention_")
    src = tmp_path / "flash_attention.cu"
    src.write_text(_build.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "SOURCE", src)
    assert _build.library_path() != first


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the flash-attention kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full fp32
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + RAGGED + BF16 + GQA_WINDOW + WHISPER, ids=case_id)
def test_kernel_matches_plain(cuda_device, case):
    *_, causal, window, dt = case
    q, k, v = (torch.from_numpy(fold(a)).to(cuda_device, TORCH_DT[dt])
               for a in inputs(case, seed=2))
    before = K.flash_attention_bhsd.launches
    got = K.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.flash_attention_bhsd.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() < tol(dt)
    if dt == "bfloat16":
        assert rel_norm(got, want) < BF16_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", FP32, ids=case_id)
def test_fp32_kernel_matches_its_model(cuda_device, case):
    *_, causal, window, _ = case
    q, k, v = (torch.from_numpy(fold(a)) for a in inputs(case, seed=2))
    got = K.flash_attention_bhsd(q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
                                 causal=causal, window=window)
    want = tf32x3_model(q, k, v, causal=causal, window=window)
    assert (got.cpu() - want).abs().max().item() < MODEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, name, other", [
    (torch.bfloat16, "flash_wgmma_kernel", "flash_fwd_kernel"),
    (torch.float32, "flash_fwd_kernel", "flash_wgmma_kernel"),
])
def test_dtype_launches_its_kernel(cuda_device, dtype, name, other):
    """The device kernels a call runs, as the profiler names them."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(2, 256, 128, device=cuda_device).to(dtype)
    K.flash_attention_bhsd(x, x, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        K.flash_attention_bhsd(x, x, x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any(name in n for n in names), names
    assert not any(other in n for n in names), names


@pytest.mark.cuda
def test_kernel_refuses_what_it_lacks(cuda_device):
    x = torch.zeros(2, 8, 40, device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        K.flash_attention_bhsd(x, x, x)
    y = torch.zeros(2, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="takes"):
        K.flash_attention_bhsd(y, y, y)


@pytest.mark.cuda
def test_model_forward_on_the_card_matches_the_cpu(cuda_device):
    """The reduced internlm2 (head_dim 16) through the kernel, against the
    plain path on the CPU, fp32, relative error below 2e-4."""
    cfg = reduced(get_config("internlm2-1.8b"), dtype="float32")
    params = init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32))
    want, _ = forward(cfg, params, {"tokens": toks})

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}

    before = K.flash_attention_bhsd.launches
    got, _ = forward(cfg, to_card(params), {"tokens": toks.to(cuda_device)})
    assert K.flash_attention_bhsd.launches == before + cfg.n_layers
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err.item() < 2e-4


@pytest.mark.cuda
def test_whisper_forward_on_the_card_matches_the_cpu(cuda_device):
    """The reduced whisper (head_dim 16) through the kernel: the encoder,
    the decoder's own attention and its cross-attention, a launch each a
    layer, against the plain path on the CPU, fp32, relative error below
    2e-4; the emitted cross K/V alike."""
    cfg = reduced(get_config("whisper-large-v3"), dtype="float32", encoder_seq=300)
    params = init_model(cfg, 0, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 130))
                                        .astype(np.int32)),
             "frames": torch.from_numpy(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model))
                                        .astype(np.float32))}
    want, want_cache = forward(cfg, params, batch, emit_cache=True)

    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda_device)
                for k, v in tree.items()}

    before = K.flash_attention_bhsd.launches
    got, cache = forward(cfg, to_card(params), to_card(batch), emit_cache=True)
    assert K.flash_attention_bhsd.launches == before + cfg.n_encoder_layers + 2 * cfg.n_layers
    err = (got.cpu() - want).abs().max() / want.abs().max()
    assert err.item() < 2e-4
    for name in ("k", "v", "ck", "cv"):
        err = (cache[name].cpu() - want_cache[name]).abs().max() / want_cache[name].abs().max()
        assert err.item() < 2e-4, name
