"""WKV6 on the (B·H, S, N) layout: the CUDA kernels' wrappers.

``wkv6_bhsn`` launches, for CUDA tensors, one of two forward kernels, and
the dtype of r, k, v alone decides which (``KERNELS``):

* bf16 goes to ``csrc/wkv6_mma.cu``, the chunked matrix form on the tensor
  cores (``mma.sync``, the next chunk's loads by ``cp.async`` beside this
  chunk's work). It rounds the decayed r and k, the scores and a copy of the
  state to bf16 for the products, and stays within the reference's bf16
  tolerance (3e-2).
* fp32 goes to ``csrc/wkv6.cu``, the recurrence token by token on the CUDA
  cores: bf16 operands cannot hold the fp32 tolerance (5e-4). Its stages
  come by bulk copies (``cp.async.bulk``) on mbarriers; a block owns 32
  value columns of a head at N 64, 16 at the other head sizes.

When a gradient is wanted (grad mode on and an input that requires grad),
the call goes through ``WKV6``, a ``torch.autograd.Function``: its forward
is the forward kernel, and its backward launches the three passes of
``csrc/wkv6_bwd.cu`` (``BWD_KERNELS``, by dtype; every product as three
TF32 ``mma.sync`` products, every other sum in fp32, dr, dk, dv rounded to
r's dtype at the end): state carries S forward and its gradient G back
over the 64-token chunks (32 at N 128) and keeps each chunk's boundary
states, chunk computes every chunk's gradients in parallel from its tiles
and those states, sum adds the chunks' shares of du. No atomics, so equal
inputs give equal bits. The launchers
themselves (``wkv6_fwd``, ``wkv6_bwd``) record no autograd graph, so they
refuse a call that wants one rather than drop its gradient.

This is a rule, not a fallback: nothing is chosen at run time, and on what
its kernel does not take the wrapper raises. For CPU tensors it runs the
plain versions (``ref.wkv_chunked_bhsn``, which autograd differentiates;
``ref.wkv6_bwd_ref`` for ``wkv6_bwd``). ``wkv6_bhsn.launches`` counts
kernel launches only, and ``.launches_by_kernel`` splits that count by
entry point, forward and backward; ``reset_launches()`` zeros both.
"""
from __future__ import annotations

import torch

from ...device import footprint, plain_path
from . import _build
from .ref import wkv6_bwd_ref, wkv_chunked_bhsn

#: the C entry point (``_build.ENTRY_POINTS``) that each dtype of r, k, v launches
KERNELS = {torch.float32: "wkv6_fwd_f32", torch.bfloat16: "wkv6_fwd_bf16"}
#: the backward's entry points each dtype launches, in order: state, chunk, sum
BWD_KERNELS = {dt: tuple(f"{stage}_{'f32' if dt == torch.float32 else 'bf16'}"
                         for stage in _build.BWD_STAGES) for dt in KERNELS}
#: the dtype code both forward entry points take (each refuses the other's)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes every kernel is instantiated for
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


def needs_grad(*tensors) -> bool:
    """Whether a call on ``tensors`` (None skipped) must record an autograd
    graph: grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in tensors)


def _check_kernel(r) -> None:
    """What every kernel takes, for CUDA tensors."""
    if r.device.type != "cuda":
        raise ValueError(f"WKV6 runs on CUDA (kernel) or CPU (plain) tensors, "
                         f"not {r.device}")
    bh, _, n = r.shape
    if r.dtype not in KERNELS:
        raise ValueError(f"WKV6 takes r, k, v in {list(KERNELS)}, not {r.dtype}")
    if n not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head size N in {HEAD_SIZES}, not {n}")
    if bh > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} heads per call, got {bh}")


def _refuse_grad(*tensors) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(
            "the WKV6 kernels' launchers record no autograd graph, so this call "
            "would drop the gradient of its inputs; call wkv6_bhsn (it "
            "differentiates through WKV6) or run under torch.no_grad()")


def _count(entry: str) -> None:
    _COUNTS.launches += 1
    _COUNTS.launches_by_kernel[entry] += 1


def wkv6_fwd(r, k, v, logw, u, state=None):
    """The forward kernel alone: (out (BH, S, N) fp32, final state (BH, N, N)
    fp32). Records no autograd graph: raises for CUDA inputs that want a
    gradient. CPU tensors run the plain chunked form."""
    _check(r, k, v, logw, u, state)
    if plain_path(r):
        return wkv_chunked_bhsn(r, k, v, logw, u, state)
    if footprint(r):  # what the kernel returns, not computed
        bh, s, n = r.shape
        return (torch.empty((bh, s, n), dtype=torch.float32, device=r.device),
                torch.empty((bh, n, n), dtype=torch.float32, device=r.device))
    _check_kernel(r)
    _refuse_grad(r, k, v, logw, u, state)
    bh, s, n = r.shape
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
    _count(entry)
    return out, st


def wkv6_bwd(r, k, v, logw, u, state, dout, dstate=None):
    """The backward kernels: (dr, dk, dv, dlogw, du, dstate0) of WKV6 at
    output gradient ``dout`` (BH, S, N) and final-state gradient ``dstate``
    (BH, N, N; None: zero), from the forward's inputs; dr, dk, dv in r's
    dtype, the rest fp32. Three launches (state, chunk, sum), no atomics, so
    equal inputs give equal bits. CPU tensors run ``ref.wkv6_bwd_ref``."""
    _check(r, k, v, logw, u, state)
    bh, s, n = r.shape
    if tuple(dout.shape) != (bh, s, n):
        raise ValueError(f"dout must be {(bh, s, n)}, not {tuple(dout.shape)}")
    if dstate is not None and tuple(dstate.shape) != (bh, n, n):
        raise ValueError(f"dstate must be {(bh, n, n)}, not {tuple(dstate.shape)}")
    if plain_path(r):
        return wkv6_bwd_ref(r, k, v, logw, u, state, dout, dstate)
    _check_kernel(r)
    _refuse_grad(r, k, v, logw, u, state, dout, dstate)
    r, k, v = (_kernel_operand(x) for x in (r, k, v))
    logw, u, dout = (_kernel_operand(x, torch.float32) for x in (logw, u, dout))
    state, dstate = (None if x is None else _kernel_operand(x, torch.float32)
                     for x in (state, dstate))
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlogw = torch.empty((bh, s, n), dtype=torch.float32, device=r.device)
    du = torch.empty((bh, n), dtype=torch.float32, device=r.device)
    dstate0 = torch.empty((bh, n, n), dtype=torch.float32, device=r.device)
    lib = _build.load()
    scratch = torch.empty(lib.wkv6_bwd_scratch_bytes(bh, s, n) // 4, dtype=torch.float32,
                          device=r.device)
    ptrs = [None if x is None else x.data_ptr()
            for x in (r, k, v, logw, u, state, dout, dstate, dr, dk, dv, dlogw, du, dstate0,
                      scratch)]
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        for entry in BWD_KERNELS[r.dtype]:
            err = getattr(lib, entry)(*ptrs, bh, s, n, stream)
            if err != 0:
                raise RuntimeError(f"{entry} launch failed: cudaError {err}")
            _count(entry)
    return dr, dk, dv, dlogw, du, dstate0


class WKV6(torch.autograd.Function):
    """WKV6 through the kernels with its gradient: the forward kernel, the
    saved inputs (the backward's pass state recomputes the chunks' states
    from them, so no state a token is kept), and the backward kernels. A
    final state that no loss reads gets no gradient (``dstate`` None, zero
    to the kernel)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, state)
        return wkv6_fwd(r, k, v, logw, u, state)

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, logw, u, state = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dr, dk, dv, dlogw, du, dstate0 = wkv6_bwd(r, k, v, logw, u, state, dout, dstate)
        return (dr, dk, dv, dlogw.to(logw.dtype), du.to(u.dtype),
                None if state is None else dstate0.to(state.dtype))


def wkv6_bhsn(r, k, v, logw, u, state=None):
    """r, k, v: (BH, S, N) fp32 or bf16; logw: (BH, S, N), <= 0; u: (BH, N);
    state: (BH, N, N) or None (zeros). -> (out (BH, S, N) fp32, final state
    (BH, N, N) fp32). The caller's state is not modified. Differentiable: on
    the CPU through the plain chunked form, on CUDA through ``WKV6``."""
    _check(r, k, v, logw, u, state)
    if plain_path(r):
        return wkv_chunked_bhsn(r, k, v, logw, u, state)
    if not needs_grad(r, k, v, logw, u, state):
        return wkv6_fwd(r, k, v, logw, u, state)
    return WKV6.apply(r, k, v, logw, u, state)


#: the object that holds the counts (the function itself, whatever later
#: rebinds the module's name)
_COUNTS = wkv6_bhsn


def reset_launches() -> None:
    _COUNTS.launches = 0
    _COUNTS.launches_by_kernel = dict.fromkeys(
        [*KERNELS.values(), *(e for entries in BWD_KERNELS.values() for e in entries)], 0)


reset_launches()
