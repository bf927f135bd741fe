"""WKV6 (RWKV6 "Finch"): the CUDA kernels of ``csrc/`` for the H100 (the
forward in ``wkv6.cu`` and ``wkv6_mma.cu``, the gradient in
``wkv6_bwd.cu``), their wrappers (``kernel.wkv6_bhsn``, differentiable
through ``kernel.WKV6``; ``wkv6_fwd`` and ``wkv6_bwd``, the launchers), the
(B, S, H, N) entry point (``ops.wkv6``) and the plain versions
(``ref.wkv6_ref``, the sequential scan; ``ref.wkv_chunked``, the chunked
form; ``ref.wkv6_bwd_ref``, the gradient)."""
from .kernel import WKV6, reset_launches, wkv6_bhsn, wkv6_bwd, wkv6_fwd
from .ops import wkv6
from .ref import wkv6_bwd_ref, wkv6_ref, wkv_chunked, wkv_chunked_bhsn

__all__ = ["WKV6", "reset_launches", "wkv6", "wkv6_bhsn", "wkv6_bwd", "wkv6_bwd_ref",
           "wkv6_fwd", "wkv6_ref", "wkv_chunked", "wkv_chunked_bhsn"]
