"""Build and load the flash-attention CUDA kernels (``csrc/``).

One library holds the three sources: ``flash_attention.cu`` (the fp32
forward as three TF32 products on the tensor cores: mma.sync, cp.async;
head widths 16..128 in steps of 16), ``flash_attention_wgmma.cu`` (the bf16
forward, tensor cores: wgmma, TMA, mbarriers; widths padded to 64 and 128)
and ``flash_attention_bwd.cu`` (the backward of both: bf16 on mma.sync,
fp32 on the CUDA cores). It is named by a hash of every source and the
flags; the sources compile side by side, one nvcc each. The wgmma source
reaches the driver's ``cuTensorMapEncodeTiled`` through
``cudaGetDriverEntryPoint``, so the library links no ``-lcuda`` and the
flags are those of every library of the port.
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
#: the backward, both dtypes
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
#: the C entry point of each forward kernel, both with one signature
ENTRY_POINTS = ("flash_fwd_f32", "flash_fwd_bf16")
#: the backward's entry points by dtype suffix: D = rowsum(do * o), then
#: dK/dV, then dQ
BWD_STAGES = ("flash_bwd_pre", "flash_bwd_dkdv", "flash_bwd_dq")
BWD_ENTRY_POINTS = tuple(f"{stage}_{dt}" for dt in ("f32", "bf16") for stage in BWD_STAGES)


def sources() -> list:
    return [SOURCE, WGMMA_SOURCE, BWD_SOURCE]


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
    """The library with every entry point's signature declared (built if
    needed, loaded once per process). Forward: q, k, v, o, lse (null, or
    the rows' log-sum-exp), bhq, bhkv, sq, sk, dh, causal, window, scale,
    stream. Backward: ``flash_bwd_pre_*`` o, do, delta, rows, dh, stream;
    ``flash_bwd_dkdv_*`` and ``flash_bwd_dq_*`` q, k, v, do, lse, delta,
    out0, out1, bhq, bhkv, sq, sk, dh, causal, window, scale, stream.
    And ``flash_fwd_f32_smem_bytes(dh)``, the fp32 forward's dynamic shared
    memory a block."""
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
    return lib
