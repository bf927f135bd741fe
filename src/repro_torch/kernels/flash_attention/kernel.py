"""Flash attention on the (B·H, S, Dh) layout: the CUDA kernels' wrapper.

``flash_attention_bhsd`` launches, for CUDA tensors, one of two kernels, and
the dtype alone decides which (``KERNELS``):

* bf16 goes to ``csrc/flash_attention_wgmma.cu``, on the tensor cores
  (``wgmma``, K/V by TMA into an mbarrier ring). It rounds the softmax
  weights to bf16 before the product with V, as tensor-core flash kernels
  do; the result stays within the reference's bf16 tolerance.
* fp32 goes to ``csrc/flash_attention.cu``, also on the tensor cores
  (``mma.sync``, K/V by ``cp.async`` into two stages), to fp32 accuracy:
  one TF32 product keeps 11 bits and misses the reference's fp32 tolerance
  (5e-5), so each product is taken as three (a_lo·b_hi + a_hi·b_lo +
  a_hi·b_hi, with x = hi + lo split in registers), which holds it.

This is a rule, not a fallback: nothing is chosen at run time, and on what
its kernel does not take the wrapper raises. For CPU tensors it runs the
plain version, ``ref.attention_ref``. ``flash_attention_bhsd.launches``
counts kernel launches only, and ``.launches_by_kernel`` splits that count
by entry point; ``reset_launches()`` zeros both.
"""
from __future__ import annotations

import math

import torch

from . import _build
from .ref import attention_ref

#: the C entry point (``_build.ENTRY_POINTS``) that each dtype launches
KERNELS = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_bf16"}
#: head widths both kernels take
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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, and 16-byte aligned for the kernels' vector loads and TMA."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window=None) -> torch.Tensor:
    """q: (BHq, Sq, Dh); k, v: (BHkv, Sk, Dh) -> (BHq, Sq, Dh) in q's dtype.
    Query head h reads kv head h // (BHq // BHkv); ``window`` keeps keys
    with k_pos > q_pos - window (None: all)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on CUDA (kernel) or CPU "
                         f"(plain) tensors, not {q.device}")
    bhq, sq, dh = q.shape
    bhkv, sk, _ = k.shape
    if q.dtype not in KERNELS:
        raise ValueError(f"the kernel takes {list(KERNELS)}, not {q.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim in {HEAD_DIMS}, not {dh}")
    if bhq > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} query heads per call, got {bhq}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    if sq == 0:
        return o
    entry = KERNELS[q.dtype]
    with torch.cuda.device(q.device):
        err = getattr(_build.load(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            bhq, bhkv, sq, sk, dh, int(bool(causal)),
            0 if window is None else int(window), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.launches_by_kernel[entry] += 1
    return o


def reset_launches() -> None:
    flash_attention_bhsd.launches = 0
    flash_attention_bhsd.launches_by_kernel = dict.fromkeys(KERNELS.values(), 0)


reset_launches()
