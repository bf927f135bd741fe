"""WKV6 (RWKV6 "Finch"): ``csrc/wkv6.cu`` for the H100, its wrapper
(``kernel.wkv6_bhsn``), the (B, S, H, N) entry point (``ops.wkv6``) and the
plain versions (``ref.wkv6_ref``, the sequential scan, and
``ref.wkv_chunked``, the chunked form)."""
from .kernel import reset_launches, wkv6_bhsn
from .ops import wkv6
from .ref import wkv6_ref, wkv_chunked, wkv_chunked_bhsn

__all__ = ["reset_launches", "wkv6", "wkv6_bhsn", "wkv6_ref", "wkv_chunked",
           "wkv_chunked_bhsn"]
