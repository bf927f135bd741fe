"""WKV6 on the (B·H, S, N) layout: the CUDA kernel's wrapper.

``wkv6_bhsn`` launches ``csrc/wkv6.cu`` for CUDA tensors (see the note at
the top of that file) and raises on what the kernel does not take; it never
falls back. For CPU tensors it runs the plain chunked form,
``ref.wkv_chunked_bhsn``. ``wkv6_bhsn.launches`` counts kernel launches
only; ``reset_launches()`` zeros it.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import wkv_chunked_bhsn

#: element types of r, k, v (C enum of ``wkv6_fwd``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is instantiated for
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
    as the kernel's vector loads need."""
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
    if r.dtype not in DTYPES:
        raise ValueError(f"the kernel takes r, k, v in {list(DTYPES)}, not {r.dtype}")
    if n not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head size N in {HEAD_SIZES}, not {n}")
    if bh > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} heads per call, got {bh}")
    r, k, v = (_kernel_operand(x) for x in (r, k, v))
    logw, u = _kernel_operand(logw, torch.float32), _kernel_operand(u, torch.float32)
    st = (torch.zeros((bh, n, n), dtype=torch.float32, device=r.device) if state is None
          else _kernel_operand(state, torch.float32).clone())  # overwritten in place
    out = torch.empty((bh, s, n), dtype=torch.float32, device=r.device)
    lib = _build.load()
    with torch.cuda.device(r.device):
        err = lib.wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            out.data_ptr(), st.data_ptr(), bh, s, n, DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"wkv6_fwd launch failed: cudaError {err}")
    wkv6_bhsn.launches += 1
    return out, st


wkv6_bhsn.launches = 0


def reset_launches() -> None:
    wkv6_bhsn.launches = 0
