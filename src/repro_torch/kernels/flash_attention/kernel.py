"""Flash attention on the (B·H, S, Dh) layout: the CUDA kernels' wrappers.

``flash_attention_bhsd`` launches, for CUDA tensors, one of two forward
kernels, and the dtype alone decides which (``KERNELS``):

* bf16 goes to ``csrc/flash_attention_wgmma.cu``, on the tensor cores
  (``wgmma``, K/V by TMA into an mbarrier ring). It rounds the softmax
  weights to bf16 before the product with V, as tensor-core flash kernels
  do; the result stays within the reference's bf16 tolerance.
* fp32 goes to ``csrc/flash_attention.cu``, also on the tensor cores
  (``mma.sync``, K/V by ``cp.async`` into two stages), to fp32 accuracy:
  one TF32 product keeps 11 bits and misses the reference's fp32 tolerance
  (5e-5), so each product is taken as three (a_lo·b_hi + a_hi·b_lo +
  a_hi·b_hi, with x = hi + lo split in registers), which holds it.

When a gradient is wanted (grad mode on and an input that requires grad),
the call goes through ``FlashAttention``, a ``torch.autograd.Function``:
its forward asks the kernel for the rows' log-sum-exp as well, and its
backward launches three entries (``BWD_KERNELS``), again by dtype:
D = rowsum(do ∘ o) from ``csrc/flash_attention_bwd.cu``, then the dK/dV
and dQ passes. bf16 passes are ``csrc/flash_attention_bwd_wgmma.cu``'s,
built as the bf16 forward is (``wgmma``, Q/dO or K/V tiles by TMA into an
mbarrier ring, a producer warpgroup and two consumer warpgroups; P and dS
rounded to bf16 as the A operands of their products); fp32 passes are
``csrc/flash_attention_bwd_tf32.cu``'s, built as the fp32 forward is
(every product as three TF32 ``mma.sync`` products, Q/dO or K/V tiles by
``cp.async`` into two stages). Both are two deterministic passes without
atomics. The launchers themselves
(``flash_attention_fwd``, ``flash_attention_bwd``) record no autograd
graph, so they refuse a call that wants one rather than drop its gradient.

This is a rule, not a fallback: nothing is chosen at run time, and on what
its kernel does not take the wrapper raises. For CPU tensors it runs the
plain versions of ``ref`` (``attention_ref``, which autograd
differentiates). ``flash_attention_bhsd.launches`` counts kernel launches
only, and ``.launches_by_kernel`` splits that count by entry point;
``reset_launches()`` zeros both.
"""
from __future__ import annotations

import math

import torch

from ...device import footprint, plain_path
from . import _build
from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

#: the forward's C entry point (``_build.ENTRY_POINTS``) that each dtype launches
KERNELS = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
#: the backward's entry points each dtype launches, in order: D, dK/dV, dQ
BWD_KERNELS = {dt: tuple(f"{stage}_{'f32' if dt == torch.float32 else 'bf16'}"
                         for stage in _build.BWD_STAGES) for dt in KERNELS}
#: head widths every kernel takes
HEAD_DIMS = tuple(range(16, 129, 16))
MAX_GRID_Y = 65535


def _check(q, k, v, window) -> None:
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.ndim != 3:
            raise ValueError(f"{name} must be a 3-d tensor (B·H, S, Dh)")
    if k.shape != v.shape or q.shape[2] != k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit together")
    if k.shape[0] == 0 or q.shape[0] % k.shape[0]:
        raise ValueError(f"query heads ({q.shape[0]}) must be a multiple of "
                         f"kv heads ({k.shape[0]})")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")


def _check_kernel(q, k) -> None:
    """What every kernel takes, for CUDA tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA (kernel) or CPU "
                         f"(plain) tensors, not {q.device}")
    if q.dtype not in KERNELS:
        raise ValueError(f"the kernel takes {list(KERNELS)}, not {q.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {q.shape[2]}")
    if q.shape[0] > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} query heads per call, got {q.shape[0]}")


def needs_grad(*tensors) -> bool:
    """Whether a call on ``tensors`` must record an autograd graph: grad mode
    is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _refuse_grad(*tensors) -> None:
    if needs_grad(*tensors) and tensors[0].device.type == "cuda":
        raise RuntimeError(
            "the flash kernels' launchers record no autograd graph, so this "
            "call would drop the gradient of its inputs; call "
            "flash_attention_bhsd (it differentiates through FlashAttention) "
            "or run under torch.no_grad()")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads and TMA."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _count(entry: str) -> None:
    _COUNTS.launches += 1
    _COUNTS.launches_by_kernel[entry] += 1


def _raise_on(err: int, entry: str) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None, with_lse: bool = False):
    """The forward kernel alone: (o, lse or None), o (BHq, Sq, Dh) in q's
    dtype and, with ``with_lse``, each row's log-sum-exp of its scaled,
    masked scores, (BHq, Sq) fp32. Records no autograd graph: raises for
    CUDA inputs that want a gradient. CPU tensors run the plain versions."""
    _check(q, k, v, window)
    if plain_path(q):
        lse = attention_lse_ref(q, k, causal=causal, window=window) if with_lse else None
        return attention_ref(q, k, v, causal=causal, window=window), lse
    if footprint(q):  # what the kernel returns, not computed
        lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
               if with_lse else None)
        return torch.empty_like(q), lse
    _check_kernel(q, k)
    _refuse_grad(q, k, v)
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((bhq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    if sq == 0:
        return o, lse
    entry = KERNELS[q.dtype]
    with torch.cuda.device(q.device):
        err = getattr(_build.load(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(),
            bhq, bhkv, sq, sk, dh, int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, entry)
    _count(entry)
    return o, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True, window=None):
    """The backward kernels: (dq, dk, dv) of the attention at output
    gradient ``do``, from the forward's output ``o`` and row log-sum-exp
    ``lse`` (``flash_attention_fwd(..., with_lse=True)``), in the inputs'
    dtypes. Three launches: D = rowsum(do ∘ o), then dK/dV (a block a key
    tile, over the group's query heads), then dQ (a block a query tile);
    no atomics, so equal inputs give equal bits. CPU tensors run
    ``attention_bwd_ref``."""
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(f"o {tuple(o.shape)}, do {tuple(do.shape)} and lse "
                         f"{tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    if plain_path(q):
        return attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    _check_kernel(q, k)
    if o.dtype != q.dtype or do.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"o and do must be {q.dtype} and lse float32, not "
                         f"{o.dtype}, {do.dtype}, {lse.dtype}")
    _refuse_grad(q, k, v, o, do, lse)
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    q, k, v, o, do, lse = (_aligned(x) for x in (q, k, v, o, do, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((bhq, sq), dtype=torch.float32, device=q.device)
    lib = _build.load()
    pre, dkdv, dqe = BWD_KERNELS[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (bhq, bhkv, sq, sk, dh, int(bool(causal)), 0 if window is None else int(window),
            1.0 / math.sqrt(dh), stream)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    with torch.cuda.device(q.device):
        for entry, args in ((pre, (o.data_ptr(), do.data_ptr(), delta.data_ptr(), bhq * sq, dh,
                                   stream)),
                            (dkdv, (*ins, dk.data_ptr(), dv.data_ptr(), *tail)),
                            (dqe, (*ins, dq.data_ptr(), None, *tail))):
            _raise_on(getattr(lib, entry)(*args), entry)
            _count(entry)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention through the kernels with its gradient: the forward kernel
    (emitting the rows' log-sum-exp), saved q, k, v, o and the LSE, and the
    backward kernels. Rows with no key in reach lie outside the kernels'
    contract, so ``flash_attention_bhsd`` refuses a causal or windowed
    call with Sq > Sk that wants a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window=None) -> torch.Tensor:
    """q: (BHq, Sq, Dh); k, v: (BHkv, Sk, Dh) -> (BHq, Sq, Dh) in q's dtype.
    Query head h reads kv head h // (BHq // BHkv); ``window`` keeps keys
    with k_pos > q_pos - window (None: all). Differentiable: on the CPU (and
    ``meta``) through ``attention_ref``, on CUDA through ``FlashAttention``."""
    _check(q, k, v, window)
    if plain_path(q):
        return attention_ref(q, k, v, causal=causal, window=window)
    if not needs_grad(q, k, v):
        return flash_attention_fwd(q, k, v, causal=causal, window=window)[0]
    if footprint(q):
        return FlashAttention.apply(q, k, v, causal, window)
    _check_kernel(q, k)
    if (causal or window is not None) and q.shape[1] > k.shape[1]:
        raise ValueError(
            f"a causal or windowed call with Sq {q.shape[1]} > Sk {k.shape[1]} has rows "
            f"with no key in reach, outside the kernels' contract; its gradient is refused")
    return FlashAttention.apply(q, k, v, causal, window)


#: the object that holds the counts (the function itself, whatever later
#: rebinds the module's name)
_COUNTS = flash_attention_bhsd


def reset_launches() -> None:
    _COUNTS.launches = 0
    _COUNTS.launches_by_kernel = dict.fromkeys(
        [*KERNELS.values(), *(e for entries in BWD_KERNELS.values() for e in entries)], 0)


reset_launches()
