#!/usr/bin/env python3
"""Where the tensor-core WKV6 kernel's time goes, on the card.

Builds ``csrc/wkv6_mma.cu`` as it is and a copy with a ``clock64()`` mark
just before each barrier (``__syncthreads();`` or ``__syncwarp();`` on a
line of its own) of the kernel's chunk loop, summed per warp into a
``__device__`` array and read back with ``cudaMemcpyFromSymbol`` (there is
no ``ncu`` on the machine with the card). Both run at the phase-17 shapes of
``chip_smoke.py`` (bf16, BH 160, S 2048, N 64, rwkv6's decay_base spread)
and are held against the plain chunked form. It prints the cycles a chunk
each warp takes from its arrival at one barrier to its arrival at the next
(so a stretch holds the wait at the barrier it starts from: a clock read
placed just after a barrier is scheduled ahead of it), and the two builds'
CUDA-event times in turns, which give the marks' cost. The first stretch
runs from the chunk before's last barrier through the loop's head and the
``cp.async`` wait.

    python3 tools/wkv6_sections.py
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src/repro_torch/kernels/rwkv6/csrc/wkv6_mma.cu"
OUT = ROOT / "build" / "wkv6_sections"
LOOP = "for (int c = 0; c < chunks; ++c) {"
BARRIER = re.compile(r"^([ \t]*)(__syncthreads|__syncwarp)\(\);[ \t]*(?://[ \t]*(.*))?$", re.M)
MAX_WARPS = 32


def instrument(src: str) -> tuple[str, list]:
    """-> (the source with the marks, a label for each barrier: its line in
    the source, its kind and its comment)."""
    head, loop = src.split(LOOP)  # the kernel has one chunk loop
    depth = 1
    for end, ch in enumerate(loop):  # the brace that closes the loop
        depth += (ch == "{") - (ch == "}")
        if depth == 0:
            break
    labels = []
    first_line = head.count("\n") + 1

    def mark(m):
        line = first_line + loop[:m.start()].count("\n")
        labels.append(f"line {line} {m[2]}" + (f" ({m[3]})" if m[3] else ""))
        return f"{m[1]}MARK({len(labels) - 1});\n{m[0]}"

    body = BARRIER.sub(mark, loop[:end])
    if not labels:
        raise SystemExit(f"no barrier in the chunk loop of {SOURCE}")
    nm = len(labels)
    decl = (f"unsigned prof[{nm}] = {{0}};\n  long long t_last = clock64();\n"
            "#define MARK(i) { const long long now = clock64(); "
            "prof[i] += (unsigned)(now - t_last); t_last = now; }\n  ")
    flush = ("\n  if ((threadIdx.x & 31) == 0) {\n"
             f"    for (int i = 0; i < {nm}; ++i)\n"
             "      atomicAdd(&g_prof[threadIdx.x >> 5][i], (unsigned long long)prof[i]);\n"
             f"    atomicAdd(&g_prof[threadIdx.x >> 5][{nm}], (unsigned long long)chunks);\n  }}")
    src = head + decl + LOOP + body + "}" + flush + loop[end + 1:]
    last_include = list(re.finditer(r"^#include .*$", src, re.M))[-1].end()
    src = (src[:last_include]
           + f"\n__device__ unsigned long long g_prof[{MAX_WARPS}][{nm + 1}];"
           + src[last_include:])
    return src + (
        '\nextern "C" int read_prof(void* h) { return cudaMemcpyFromSymbol(h, g_prof, '
        'sizeof(g_prof)); }\n'), labels


def build(src: str, name: str) -> ctypes.CDLL:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}.so"
    lib.unlink(missing_ok=True)
    compile_library(lib, [cu], list(NVCC_FLAGS))
    dll = ctypes.CDLL(str(lib))
    dll.wkv6_fwd_bf16.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return dll


def main() -> int:
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda")
    args = CS.wkv_inputs(dev, 4, 2048, 40, 64, None, "bfloat16", False, seed=17,
                         omega=CS.decay_base_omega(4, 2048, 40, 64, 18))
    r, k, v, logw, u, _ = args
    bh, s, n = r.shape
    want, want_st = wkv_chunked_bhsn(*args)

    def call(lib):
        o = torch.empty(bh, s, n, device=dev)
        st = torch.zeros(bh, n, n, device=dev)
        err = lib.wkv6_fwd_bf16(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                                u.data_ptr(), o.data_ptr(), st.data_ptr(), bh, s, n, 1,
                                torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o, st

    src = SOURCE.read_text()
    marked_src, labels = instrument(src)
    libs = {"as is": build(src, "plain"), "marked": build(marked_src, "marked")}
    ok = True
    for name, lib in libs.items():
        o, st = call(lib)
        torch.cuda.synchronize()
        e_o, e_st = CS.rel_err(o, want), CS.rel_err(st, want_st)
        ok &= max(e_o, e_st) < CS.WKV_TOL["bfloat16"]
        print(f"{name}: rel err vs plain {e_o:.3e}, state {e_st:.3e}")
    nm = len(labels)
    buf = (ctypes.c_ulonglong * (MAX_WARPS * (nm + 1)))()
    assert libs["marked"].read_prof(buf) == 0
    prof = np.array(buf[:], dtype=np.float64).reshape(MAX_WARPS, nm + 1)
    prof = prof[prof[:, nm] > 0]
    cyc = prof[:, :nm] / prof[:, nm:]  # per warp, a chunk
    print(f"cycles a chunk, warps {'/'.join(map(str, range(len(cyc))))}, at the "
          "phase-17 shapes, from the arrival at the barrier before:")
    for i, label in enumerate(labels):
        print(f"  up to {label}: " + "/".join(f"{c:.0f}" for c in cyc[:, i]))
    print("  total: " + "/".join(f"{c:.0f}" for c in cyc.sum(1)))
    order = ["as is", "marked", "marked", "as is"]
    print("CUDA-event ms in turns: " + ", ".join(
        f"{name} {CS.time_ms(lambda: call(libs[name]), 10):.4f}" for name in order))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
