"""Build and load the flash-attention CUDA kernels (``csrc/``).

One library holds the five sources: ``flash_attention.cu`` (the fp32
forward as three TF32 products on the tensor cores: mma.sync, cp.async;
head widths 16..128 in steps of 16), ``flash_attention_wgmma.cu`` (the bf16
forward, tensor cores: wgmma, TMA, mbarriers; widths padded to 64 and 128),
``flash_attention_bwd.cu`` (the backward's D = rowsum(do * o), both
dtypes), ``flash_attention_bwd_tf32.cu`` (the fp32 backward's dK/dV and dQ
passes, built as the fp32 forward is) and ``flash_attention_bwd_wgmma.cu``
(the bf16 backward's passes, built as the bf16 forward is). The two fp32
tensor-core sources include ``sm80_tf32.cuh`` (cp.async, ldmatrix, the
tf32 mma.sync, the 3xTF32 split), the two wgmma sources ``sm90.cuh``
(their PTX helpers and tensor maps). The library is named by a hash of
every source, both headers and the flags; the sources compile side by
side, one nvcc each. The wgmma sources reach the driver's
``cuTensorMapEncodeTiled`` through ``cudaGetDriverEntryPoint``, so the
library links no ``-lcuda`` and the flags are those of every library of
the port.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from ..._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

CSRC = Path(__file__).with_name("csrc")
#: the fp32 forward (3xTF32 on mma.sync)
SOURCE = CSRC / "flash_attention.cu"
#: the bf16 forward on the tensor cores
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
#: the backward's D = rowsum(do * o), both dtypes
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
#: the backward's fp32 passes (3xTF32 on mma.sync)
BWD_TF32_SOURCE = CSRC / "flash_attention_bwd_tf32.cu"
#: the backward's bf16 passes on the tensor cores
BWD_WGMMA_SOURCE = CSRC / "flash_attention_bwd_wgmma.cu"
#: the PTX helpers and tensor maps the two wgmma sources include
SM90_HEADER = CSRC / "sm90.cuh"
#: the PTX helpers the two fp32 tensor-core sources include
TF32_HEADER = CSRC / "sm80_tf32.cuh"
#: the C entry point of each forward kernel, both with one signature
ENTRY_POINTS = ("flash_fwd_f32", "flash_fwd_bf16")
#: the backward's entry points by dtype suffix: D = rowsum(do * o), then
#: dK/dV, then dQ
BWD_STAGES = ("flash_bwd_pre", "flash_bwd_dkdv", "flash_bwd_dq")
BWD_ENTRY_POINTS = tuple(f"{stage}_{dt}" for dt in ("f32", "bf16") for stage in BWD_STAGES)


def sources() -> list:
    return [SOURCE, WGMMA_SOURCE, BWD_SOURCE, BWD_TF32_SOURCE, BWD_WGMMA_SOURCE]


def library_path() -> Path:
    """The library's path, named by a hash of the sources, the headers they
    include and the flags: an edit to any of them rebuilds."""
    h = hashlib.sha256()
    for src in [*sources(), SM90_HEADER, TF32_HEADER]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libflash_attention_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists (the
    ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(), sources(), list(NVCC_FLAGS))


@functools.cache
def load() -> ctypes.CDLL:
    """The library with every entry point's signature declared (built if
    needed, loaded once per process). Forward: q, k, v, o, lse (null, or
    the rows' log-sum-exp), bhq, bhkv, sq, sk, dh, causal, window, scale,
    stream. Backward: ``flash_bwd_pre_*`` o, do, delta, rows, dh, stream;
    ``flash_bwd_dkdv_*`` and ``flash_bwd_dq_*`` q, k, v, do, lse, delta,
    out0, out1, bhq, bhkv, sq, sk, dh, causal, window, scale, stream.
    And ``flash_fwd_f32_smem_bytes(dh)`` and ``flash_bwd_f32_smem_bytes(dh,
    dq)``, the fp32 forward's and backward passes' (the dQ pass's if ``dq``)
    dynamic shared memory a block."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {name: [ptr] * 5 + [i32] * 7 + [ctypes.c_float, ptr] for name in ENTRY_POINTS}
    for name in BWD_ENTRY_POINTS:
        signatures[name] = ([ptr] * 3 + [i32] * 2 + [ptr] if name.startswith("flash_bwd_pre")
                            else [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ptr])
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.flash_fwd_f32_smem_bytes.argtypes = [i32]
    lib.flash_fwd_f32_smem_bytes.restype = i32
    lib.flash_bwd_f32_smem_bytes.argtypes = [i32, i32]
    lib.flash_bwd_f32_smem_bytes.restype = i32
    return lib
