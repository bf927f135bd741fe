"""Build a CUDA source set into a shared library with ``nvcc``.

Shared by every kernel library of the port (``lease_array/_build.py``,
``kernels/flash_attention/_build.py``). Each builds for Hopper (``sm_90a``)
a library with a plain C interface, bound with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries go to ``build/repro_torch/`` at
the repository root under a name that hashes the sources and flags, so an
edited source rebuilds and an unchanged one is reused. Builds happen at
first use, never at import: machines without ``nvcc`` import the package
and run the plain versions on the CPU.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from their csrc/ at first use on a machine with "
        "the CUDA toolkit"
    )


def compile_library(lib: Path, sources: list, flags: list) -> Path:
    """Compile ``sources`` with ``flags`` into ``lib`` unless it exists; the
    compiler's report (registers, spills, shared memory per kernel) is kept
    beside it as ``.log``. Raises RuntimeError with the compiler output on
    failure."""
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *flags, "-o", tmp, *map(str, sources)]
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
