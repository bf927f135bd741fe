"""Build and load the flash-attention CUDA kernels (``csrc/``).

One library holds both kernels: ``flash_attention.cu`` (fp32 as three TF32
products on the tensor cores: mma.sync, cp.async; head widths 16..128 in
steps of 16) and ``flash_attention_wgmma.cu`` (bf16, tensor cores: wgmma,
TMA, mbarriers; widths padded to 64 and 128). It is
named by a hash of every source and the flags. The wgmma source reaches the
driver's ``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``, so
the library links no ``-lcuda`` and the flags are those of every library of
the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from ..._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

CSRC = Path(__file__).with_name("csrc")
#: the fp32 kernel (3xTF32 on mma.sync)
SOURCE = CSRC / "flash_attention.cu"
#: the bf16 kernel on the tensor cores
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
#: the C entry point of each kernel, both with one signature
ENTRY_POINTS = ("flash_fwd_f32", "flash_fwd_bf16")


def sources() -> list:
    return [SOURCE, WGMMA_SOURCE]


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflash_attention_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists (the
    ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(), sources(), list(NVCC_FLAGS))


@functools.cache
def load() -> ctypes.CDLL:
    """The library with both entry points' signatures declared (built if
    needed, loaded once per process): q, k, v, o, bhq, bhkv, sq, sk, dh,
    causal, window, scale, stream; and ``flash_fwd_f32_smem_bytes(dh)``, the
    fp32 kernel's dynamic shared memory a block."""
    lib = ctypes.CDLL(str(build()))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_fwd_f32_smem_bytes.argtypes = [ctypes.c_int]
    lib.flash_fwd_f32_smem_bytes.restype = ctypes.c_int
    return lib
