"""Build and load the WKV6 CUDA kernels (``csrc/``).

One library holds the three sources: ``wkv6.cu`` (the forward for fp32
r/k/v, CUDA cores), ``wkv6_mma.cu`` (the forward for bf16 r/k/v, tensor
cores: ``mma.sync`` and ``cp.async``) and ``wkv6_bwd.cu`` (the gradient,
both dtypes, in three passes, its products as three TF32 ``mma.sync``
products through the fp32 flash kernels' ``sm80_tf32.cuh``), each for head
sizes 16, 32, 64 and 128. It is named by a hash of every source, that
header and the flags; the sources compile side by side, one nvcc each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from ..._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library
from ..flash_attention._build import TF32_HEADER

CSRC = Path(__file__).with_name("csrc")
#: the fp32 kernel on the CUDA cores
SOURCE = CSRC / "wkv6.cu"
#: the bf16 kernel on the tensor cores
MMA_SOURCE = CSRC / "wkv6_mma.cu"
#: the gradient, both dtypes
BWD_SOURCE = CSRC / "wkv6_bwd.cu"
#: the C entry point of each forward kernel, both with one signature
ENTRY_POINTS = ("wkv6_fwd_f32", "wkv6_fwd_bf16")
#: the backward's passes, launched in this order: state (the chunks' boundary
#: states, S forward and G backward in time), chunk (every chunk in parallel),
#: sum (du over the chunks)
BWD_STAGES = ("wkv6_bwd_state", "wkv6_bwd_chunk", "wkv6_bwd_sum")
BWD_ENTRY_POINTS = tuple(f"{stage}_{dt}" for dt in ("f32", "bf16") for stage in BWD_STAGES)


def sources() -> list:
    return [SOURCE, MMA_SOURCE, BWD_SOURCE]


def library_path() -> Path:
    h = hashlib.sha256()
    for src in [*sources(), TF32_HEADER]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libwkv6_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists (the
    ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(), sources(), list(NVCC_FLAGS))


@functools.cache
def load() -> ctypes.CDLL:
    """The library with every entry point's signature declared (built if
    needed, loaded once per process). Forward: r, k, v, logw, u, out,
    state, bh, seq, n, dtype, stream. Backward passes: r, k, v, logw, u,
    state0, dout, dstate, dr, dk, dv, dlogw, du, dstate0, scratch, bh, seq,
    n, dtype, stream. And ``wkv6_bwd_scratch_bytes(bh, seq, n)``,
    ``wkv6_bwd_smem_bytes(n, dtype, pass)`` and each forward's
    ``*_smem_bytes(n)``."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    signatures = {name: [ptr] * 7 + [i32] * 4 + [ptr] for name in ENTRY_POINTS}
    signatures.update({name: [ptr] * 15 + [i32] * 3 + [ptr] for name in BWD_ENTRY_POINTS})
    signatures.update({f"{name}_smem_bytes": [i32] for name in ENTRY_POINTS})
    signatures["wkv6_bwd_smem_bytes"] = [i32] * 3
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i32
    lib.wkv6_bwd_scratch_bytes.argtypes = [i32] * 3
    lib.wkv6_bwd_scratch_bytes.restype = ctypes.c_longlong
    return lib
