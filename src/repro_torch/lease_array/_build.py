"""Build and load the lease-plane CUDA kernels (``csrc/*.cu``).

``_nvcc.compile_library`` compiles the sources for Hopper (``sm_90a``) into a
shared library with a plain C interface, bound with ``ctypes``. The acceptor
count A is a compile-time constant of the kernels, so there is one library
per A, named by A and a hash of the sources and flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
from pathlib import Path

from .._nvcc import BUILD_DIR, NVCC_FLAGS, compile_library

CSRC = Path(__file__).with_name("csrc")
#: C entry points and their ctypes signatures: (host pointer array, host
#: int array, cudaStream_t) -> cudaError_t
ENTRY_POINTS = ("lease_window_delayed", "lease_window_sync",
                "lease_window_delayed_batched", "lease_window_sync_batched")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(n_acceptors: int) -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"liblease_window_a{n_acceptors}_{h.hexdigest()[:16]}.so"


def build(n_acceptors: int) -> Path:
    """Compile the sources for ``n_acceptors`` unless the hashed library
    already exists (the ``-Xptxas -v`` report sits beside it as ``.log``)."""
    return compile_library(library_path(n_acceptors), sources(),
                           [*NVCC_FLAGS, f"-DLEASE_ACCEPTORS={n_acceptors}"])


@functools.cache
def load(n_acceptors: int) -> ctypes.CDLL:
    """The library for ``n_acceptors`` with its entry points' signatures
    declared (built if needed, loaded once per process)."""
    lib = ctypes.CDLL(str(build(n_acceptors)))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
