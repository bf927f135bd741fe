"""WKV6 on the (B·H, S, N) layout: the CUDA kernels' wrapper.

``wkv6_bhsn`` launches, for CUDA tensors, one of two kernels, and the dtype
of r, k, v alone decides which (``KERNELS``):

* bf16 goes to ``csrc/wkv6_mma.cu``, the chunked matrix form on the tensor
  cores (``mma.sync``, the next chunk's loads by ``cp.async`` beside this
  chunk's work). It rounds the decayed r and k, the scores and a copy of the
  state to bf16 for the products, and stays within the reference's bf16
  tolerance (3e-2).
* fp32 goes to ``csrc/wkv6.cu``, the recurrence token by token on the CUDA
  cores: bf16 operands cannot hold the fp32 tolerance (5e-4). Its stages
  come by bulk copies (``cp.async.bulk``) on mbarriers; a block owns 32
  value columns of a head at N 64, 16 at the other head sizes.

This is a rule, not a fallback: nothing is chosen at run time, and on what
its kernel does not take the wrapper raises. For CPU tensors it runs the
plain chunked form, ``ref.wkv_chunked_bhsn``. ``wkv6_bhsn.launches`` counts
kernel launches only, and ``.launches_by_kernel`` splits that count by
entry point; ``reset_launches()`` zeros both.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import wkv_chunked_bhsn

#: the C entry point (``_build.ENTRY_POINTS``) that each dtype of r, k, v launches
KERNELS = {torch.float32: "wkv6_fwd_f32", torch.bfloat16: "wkv6_fwd_bf16"}
#: the dtype code both entry points take (each refuses the other's)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes both kernels are instantiated for
HEAD_SIZES = (16, 32, 64, 128)
MAX_GRID_Y = 65535


def _check(r, k, v, logw, u, state) -> None:
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if not isinstance(x, torch.Tensor) or x.ndim != 3 or x.shape != r.shape:
            raise ValueError(f"{name} must be a (B·H, S, N) tensor of r's shape "
                             f"{tuple(r.shape)}")
    bh, _, n = r.shape
    if tuple(u.shape) != (bh, n):
        raise ValueError(f"u must be (B·H, N) = {(bh, n)}, not {tuple(u.shape)}")
    if state is not None and tuple(state.shape) != (bh, n, n):
        raise ValueError(f"state must be (B·H, N, N) = {(bh, n, n)}, not "
                         f"{tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"r, k, v dtypes differ: {r.dtype}, {k.dtype}, {v.dtype}")
    devices = {x.device for x in (r, k, v, logw, u) + ((state,) if state is not None else ())}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def _kernel_operand(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """Contiguous (in ``dtype`` if given); raises unless 16-byte aligned,
    as the kernels' vector loads and ``cp.async`` copies need."""
    x = x.contiguous() if dtype is None else x.to(dtype).contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the WKV6 kernel needs 16-byte aligned tensors")
    return x


def wkv6_bhsn(r, k, v, logw, u, state=None):
    """r, k, v: (BH, S, N) fp32 or bf16; logw: (BH, S, N), <= 0; u: (BH, N);
    state: (BH, N, N) or None (zeros). -> (out (BH, S, N) fp32, final state
    (BH, N, N) fp32). The caller's state is not modified."""
    _check(r, k, v, logw, u, state)
    if r.device.type == "cpu":
        return wkv_chunked_bhsn(r, k, v, logw, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"WKV6 runs on CUDA (kernel) or CPU (plain) tensors, "
                         f"not {r.device}")
    bh, s, n = r.shape
    if r.dtype not in KERNELS:
        raise ValueError(f"WKV6 takes r, k, v in {list(KERNELS)}, not {r.dtype}")
    if n not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head size N in {HEAD_SIZES}, not {n}")
    if bh > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} heads per call, got {bh}")
    r, k, v = (_kernel_operand(x) for x in (r, k, v))
    logw, u = _kernel_operand(logw, torch.float32), _kernel_operand(u, torch.float32)
    st = (torch.zeros((bh, n, n), dtype=torch.float32, device=r.device) if state is None
          else _kernel_operand(state, torch.float32).clone())  # overwritten in place
    out = torch.empty((bh, s, n), dtype=torch.float32, device=r.device)
    entry = KERNELS[r.dtype]
    with torch.cuda.device(r.device):
        err = getattr(_build.load(), entry)(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            out.data_ptr(), st.data_ptr(), bh, s, n, DTYPE_CODES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    wkv6_bhsn.launches += 1
    wkv6_bhsn.launches_by_kernel[entry] += 1
    return out, st


def reset_launches() -> None:
    wkv6_bhsn.launches = 0
    wkv6_bhsn.launches_by_kernel = dict.fromkeys(KERNELS.values(), 0)


reset_launches()
