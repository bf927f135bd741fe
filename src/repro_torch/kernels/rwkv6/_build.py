"""Build and load the WKV6 CUDA kernel (``csrc/wkv6.cu``).

One library holds every instantiation (fp32 and bf16 r/k/v, head sizes 16,
32, 64 and 128), named by a hash of the source and flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from ..._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

SOURCE = Path(__file__).with_name("csrc") / "wkv6.cu"


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwkv6_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless the hashed library exists (the
    ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(), [SOURCE], list(NVCC_FLAGS))


@functools.cache
def load() -> ctypes.CDLL:
    """The library with ``wkv6_fwd``'s signature declared (built if needed,
    loaded once per process)."""
    lib = ctypes.CDLL(str(build()))
    fn = lib.wkv6_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
