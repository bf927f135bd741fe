"""Build and load the WKV6 CUDA kernels (``csrc/``).

One library holds both kernels: ``wkv6.cu`` (fp32 r/k/v, CUDA cores) and
``wkv6_mma.cu`` (bf16 r/k/v, tensor cores: ``mma.sync`` and ``cp.async``),
each for head sizes 16, 32, 64 and 128. It is named by a hash of every
source and the flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from ..._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

CSRC = Path(__file__).with_name("csrc")
#: the fp32 kernel on the CUDA cores
SOURCE = CSRC / "wkv6.cu"
#: the bf16 kernel on the tensor cores
MMA_SOURCE = CSRC / "wkv6_mma.cu"
#: the C entry point of each kernel, both with one signature
ENTRY_POINTS = ("wkv6_fwd_f32", "wkv6_fwd_bf16")


def sources() -> list:
    return [SOURCE, MMA_SOURCE]


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwkv6_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists (the
    ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(), sources(), list(NVCC_FLAGS))


@functools.cache
def load() -> ctypes.CDLL:
    """The library with both entry points' signatures declared (built if
    needed, loaded once per process): r, k, v, logw, u, out, state, bh,
    seq, n, dtype, stream."""
    lib = ctypes.CDLL(str(build()))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
