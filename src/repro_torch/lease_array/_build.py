"""Build and load the lease-plane CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, bound with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes. The acceptor count A is a
compile-time constant of the kernels, so there is one library per A. It
goes to ``build/repro_torch/`` at the repository root, named by A and a hash
of the sources and flags, so an edited source rebuilds and an unchanged one
is reused. A build happens at first use, never at import: machines without
``nvcc`` import this package and run the plain versions on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: C entry points and their ctypes signatures: (host pointer array, host
#: int array, cudaStream_t) -> cudaError_t
ENTRY_POINTS = ("lease_window_delayed", "lease_window_sync")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the lease-plane CUDA "
        "kernels are built from csrc/ at first use on a machine with the "
        "CUDA toolkit"
    )


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
    already exists; the compiler's report (registers, spills, shared memory
    per kernel) is kept beside it as ``.log``. Raises RuntimeError with the
    compiler output on failure."""
    lib = library_path(n_acceptors)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-DLEASE_ACCEPTORS={n_acceptors}",
               "-o", tmp, *map(str, sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


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
