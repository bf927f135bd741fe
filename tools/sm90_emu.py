#!/usr/bin/env python3
"""The flash kernels (forward and backward), the WKV6 backward and the
batched delayed lease kernel on host threads, without a card.

    python3 tools/sm90_emu.py [--csrc DIR] [--fp32 | --wkv6 | --lease] [CASE ...]

Builds ``csrc/flash_attention_wgmma.cu`` and ``csrc/flash_attention_bwd_wgmma.cu``
with g++ into ``build/sm90_emu/libemu.so``: ``sm90.cuh``'s block between its
``PTX helpers`` and ``end PTX helpers`` marks is swapped for the host versions
in ``tools/sm90_emu/emu_ptx.h``, and the CUDA surface they stand on (bf16, the
runtime and driver types, ``__syncthreads``, shuffles, ``<<<...>>>`` launches)
for ``tools/sm90_emu/emu_cuda.h``. A block runs its threads as
``std::thread``s, blocks one after another; an mbarrier is a phase, a count
of pending arrivals and a transaction count under a mutex (a wait that lasts
20 s aborts, naming the barrier: a deadlock); a TMA load copies its box at
once, zeros out of bounds, in the 128-byte swizzle, and completes its bytes;
a wgmma reads its operands through their descriptors (K-major rows, or
MN-major with the panel stride as leading byte offset) and the A fragments
of its warpgroup's 128 threads, and adds into each thread's accumulator
fragment. The swizzle, descriptors and fragment layouts are this emulator's
reading of them, which the forward kernel's results on the card confirm
for the forms it shares with the backward; the forward runs here too, as
the emulator's own check.

Then each case (all, or the given indices of ``CASES``) runs the forward
(its output and LSE against ``attention_ref`` and ``attention_lse_ref``)
and the backward's two passes (D from plain torch) against
``attention_bwd_ref`` under phase 42's bf16 rule, on CPU tensors. It
catches logic faults (masks, tile ranges, ring phases, the order of
arrivals) before a chip call; a case takes a few seconds. ``--csrc`` builds
another copy of the sources (a variant, or a copy with a planted fault).

``--fp32`` builds the fp32 kernels instead, ``csrc/flash_attention.cu``
(the forward) and ``csrc/flash_attention_bwd_tf32.cu`` (the backward's
passes), into ``build/sm90_emu/libemu_fp32.so``: ``sm80_tf32.cuh``'s PTX
block is swapped for ``tools/sm90_emu/emu_tf32.h`` (cp.async as copies
made at the thread's wait, ldmatrix and the tf32 mma.sync as exchanges
among a warp's lanes, operands read with their 13 low bits cleared). Each
case then holds the forward to ``tf32x3_model`` (1e-5 max |err|, the
card's limit: the forward is proven on the card, so this checks the
emulator) and ``attention_ref``, and the backward's passes (D from plain
torch) to ``tf32x3_bwd_model`` and, per gradient, to ``attention_bwd_ref``
within 1e-4 in ||err||_2 / ||g||_2 (phase 42's fp32 limit); both models
are ``tests/test_torch_flash_kernel.py``'s.

``--wkv6`` builds ``kernels/rwkv6/csrc/wkv6_bwd.cu`` (or the one in
``--csrc``) into ``build/sm90_emu/libemu_wkv6_bwd.so``, the
``sm80_tf32.cuh`` it includes with its ``PTX helpers`` block swapped for
``emu_tf32.h`` (as ``--fp32`` builds it), and runs its three passes
(state, chunk, sum) at each of ``WKV6_CASES`` (every head size, lengths
ragged about its 64-token chunks (32 at N 128), both dtypes, the states
given or not, the decay_base spread and decays down to -33) against
``ref.wkv6_bwd_ref``: below 1e-4 per gradient, bf16's dr, dk, dv within
twice their bf16 rounding (phase 46's limits).

``--lease`` builds ``lease_array/csrc/lease_window.cu`` (or the one in
``--csrc``) with g++ for A 3 and 5 (``-DLEASE_ACCEPTORS``; a library per A,
named by a hash of the source, under ``build/sm90_emu/``) and runs the
port's own wrapper ``lease_window_delayed_batched`` on CPU tensors with
the host library in place of ``_build.load`` (the wrapper's device check
and stream lookups stubbed). Each case of ``chip_smoke.LANE_CASES`` (a
batch of small scenarios with every optional plane group; cell counts
ragged about the tiles, 4, 32 and 300) runs every plane-group variant at
every lane count of the case's A, owners and summary, windows 1 and 16,
the quiescence skip on and off, against ``lease_window_delayed_batched_
torch``, bit-exact; ``ticked`` must count every cell-tick with the skip
off, and a quiet case must skip some.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import math
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tools" / "sm90_emu"
OUT = ROOT / "build" / "sm90_emu"
#: (bhq, bhkv, sq, sk, dh, causal, window)
CASES = [
    (2, 1, 130, 130, 64, True, None),
    (2, 2, 200, 200, 128, True, None),
    (5, 1, 333, 333, 48, True, 100),
    (4, 4, 77, 200, 16, False, None),
    (8, 1, 129, 129, 112, True, None),
    (4, 2, 65, 300, 80, True, None),
    (2, 2, 150, 150, 32, False, 40),
    (6, 2, 256, 256, 128, True, None),
    (3, 3, 300, 190, 64, False, None),
]


def build(csrc: Path) -> Path:
    """The host build of the two wgmma sources in ``csrc``."""
    OUT.mkdir(parents=True, exist_ok=True)
    hdr = (csrc / "sm90.cuh").read_text()
    hdr = re.sub(r"#include <cuda\.h>.*?#include <stdint\.h>\n", '#include "emu_cuda.h"\n', hdr,
                 flags=re.S)
    hdr = re.sub(r"// -+ PTX helpers\n.*?// -+ end PTX helpers\n", '#include "emu_ptx.h"\n', hdr,
                 flags=re.S)
    (OUT / "sm90_emu.h").write_text(hdr)
    objs = []
    for name in ("flash_attention_wgmma.cu", "flash_attention_bwd_wgmma.cu"):
        t = (csrc / name).read_text()
        t = t.replace('#include "sm90.cuh"', '#include "sm90_emu.h"')
        t = re.sub(r"#include <cuda(_bf16|_runtime)?\.h>.*\n", "", t)
        t = t.replace("#include <math.h>", '#include "emu_cuda.h"\n#include <math.h>')
        t = t.replace("extern __shared__ uint8_t smem_raw[];", "uint8_t* smem_raw = emu_smem();")
        t = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", t, flags=re.S)
        # the forward's own fence and setmaxnreg statements
        t = re.sub(r'asm volatile\("(fence\.mbarrier_init|setmaxnreg)[^\n]*\n', ";\n", t)
        src = OUT / (name[:-3] + "_emu.cpp")
        src.write_text(t)
        objs.append(str(src))
    lib = OUT / "libemu.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-I", str(EMU),
                    "-I", str(OUT), "-o", str(lib), *objs], check=True)
    return lib


def build_fp32(csrc: Path) -> Path:
    """The host build of the two fp32 tensor-core sources in ``csrc``."""
    OUT.mkdir(parents=True, exist_ok=True)
    hdr = (csrc / "sm80_tf32.cuh").read_text()
    hdr = hdr.replace("#include <cuda_runtime.h>\n#include <stdint.h>\n",
                      '#include "emu_cuda.h"\n')
    hdr = re.sub(r"// -+ PTX helpers\n.*?// -+ end PTX helpers\n", '#include "emu_tf32.h"\n',
                 hdr, flags=re.S)
    (OUT / "sm80_tf32_emu.h").write_text(hdr)
    objs = []
    for name in ("flash_attention.cu", "flash_attention_bwd_tf32.cu"):
        t = (csrc / name).read_text()
        t = t.replace('#include "sm80_tf32.cuh"', '#include "sm80_tf32_emu.h"')
        t = t.replace("#include <cuda_runtime.h>\n", "")
        t = t.replace("#include <math.h>", '#include "emu_cuda.h"\n#include <math.h>')
        t = t.replace("extern __shared__ float4 smem4[];", "float4* smem4 = (float4*)emu_smem();")
        t = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", t, flags=re.S)
        src = OUT / (name[:-3] + "_emu.cpp")
        src.write_text(t)
        objs.append(str(src))
    lib = OUT / "libemu_fp32.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-I", str(EMU),
                    "-I", str(OUT), "-o", str(lib), *objs], check=True)
    return lib


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def run_case(lib, bhq, bhkv, sq, sk, dh, causal, window, seed=0) -> bool:
    import torch

    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref,
        attention_lse_ref,
        attention_ref,
    )

    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(h, s, dh, generator=g).bfloat16()
                   for h, s in ((bhq, sq), (bhkv, sk), (bhkv, sk), (bhq, sq)))
    o, lse = torch.empty_like(q), torch.empty(bhq, sq)
    tail = (bhq, bhkv, sq, sk, dh, int(causal), 0 if window is None else window,
            1 / math.sqrt(dh), None)
    assert lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              lse.data_ptr(), *tail) == 0
    fwd = rel(o, attention_ref(q, k, v, causal=causal, window=window))
    lse_err = float((lse - attention_lse_ref(q, k, causal=causal, window=window)).abs().max())
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    assert lib.flash_bwd_dkdv_bf16(*ins, dk.data_ptr(), dv.data_ptr(), *tail) == 0
    assert lib.flash_bwd_dq_bf16(*ins, dq.data_ptr(), None, *tail) == 0
    want = attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)), lse, causal=causal,
                             window=window)
    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    errs = [rel(a, b) for a, b in zip((dq, dk, dv), want)]
    limits = [2 * rel(a, b) + 1e-3 for a, b in zip(plain, want)]
    ok = all(e < x for e, x in zip(errs, limits)) and fwd < 5e-3 and lse_err < 5e-4
    print(f"{'ok ' if ok else 'BAD'} BHq {bhq} BHkv {bhkv} Sq {sq} Sk {sk} Dh {dh} "
          f"{'causal' if causal else 'non-causal'} window {window}: forward rel {fwd:.2e}, LSE "
          f"{lse_err:.1e}; dq/dk/dv " + "/".join(f"{e:.2e}" for e in errs) + " (limits "
          + "/".join(f"{x:.2e}" for x in limits) + ")", flush=True)
    return ok


#: (bhq, bhkv, sq, sk, dh, causal, window): every head width the fp32
#: kernels take, GQA groups 1, 2, 5 and 6, windows, Sq < Sk and Sq > Sk,
#: lengths ragged about the steps (32 or 64 rows) and blocks (64 keys, 128
#: rows)
FP32_CASES = [
    (2, 2, 40, 40, 16, True, None),
    (4, 2, 37, 37, 32, True, 9),
    (5, 1, 150, 150, 48, True, 40),
    (6, 1, 50, 50, 64, True, 12),
    (4, 2, 20, 45, 80, False, None),
    (2, 1, 130, 130, 96, True, None),
    (2, 2, 30, 50, 112, False, 10),
    (4, 4, 45, 20, 128, False, None),
    (2, 1, 140, 300, 128, True, None),
]
#: the fp32 backward against its model: the two differ in the order and
#: rounding of fp32 sums only
BWD_MODEL_TOL = 1e-5


def run_case_fp32(lib, bhq, bhkv, sq, sk, dh, causal, window, seed=0) -> bool:
    import torch

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_flash_kernel import MODEL_TOL, tf32x3_bwd_model, tf32x3_model

    from repro_torch.kernels.flash_attention.ref import (
        attention_bwd_ref,
        attention_lse_ref,
        attention_ref,
    )

    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(h, s, dh, generator=g)
                   for h, s in ((bhq, sq), (bhkv, sk), (bhkv, sk), (bhq, sq)))
    o, lse = torch.empty_like(q), torch.empty(bhq, sq)
    tail = (bhq, bhkv, sq, sk, dh, int(causal), 0 if window is None else window,
            1 / math.sqrt(dh), None)
    assert lib.flash_fwd_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             lse.data_ptr(), *tail) == 0
    fwd_model = float((o - tf32x3_model(q, k, v, causal=causal, window=window)).abs().max())
    fwd = float((o - attention_ref(q, k, v, causal=causal, window=window)).abs().max())
    lse_err = float((lse - attention_lse_ref(q, k, causal=causal, window=window)).abs().max())
    delta = (do * o).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr())
    assert lib.flash_bwd_dkdv_f32(*ins, dk.data_ptr(), dv.data_ptr(), *tail) == 0
    assert lib.flash_bwd_dq_f32(*ins, dq.data_ptr(), None, *tail) == 0
    got = (dq, dk, dv)
    model = tf32x3_bwd_model(q, k, v, o, do, lse, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=window)
    errs = [rel(a, b) for a, b in zip(got, want)]
    model_errs = [rel(a, b) for a, b in zip(got, model)]
    ok = (all(e < 1e-4 for e in errs) and all(e < BWD_MODEL_TOL for e in model_errs)
          and fwd_model < MODEL_TOL and fwd < 5e-5 and lse_err < 1e-4)
    print(f"{'ok ' if ok else 'BAD'} BHq {bhq} BHkv {bhkv} Sq {sq} Sk {sk} Dh {dh} "
          f"{'causal' if causal else 'non-causal'} window {window}: forward max |err| "
          f"{fwd:.2e} (model {fwd_model:.2e}), LSE {lse_err:.1e}; dq/dk/dv "
          + "/".join(f"{e:.2e}" for e in errs) + " (limit 1e-4), against the model "
          + "/".join(f"{e:.2e}" for e in model_errs) + f" (limit {BWD_MODEL_TOL:g})",
          flush=True)
    return ok


def build_wkv6(csrc: Path) -> Path:
    """The host build of the WKV6 backward (``kernels/rwkv6/csrc/wkv6_bwd.cu``
    in ``csrc``): the fp32 flash kernels' ``sm80_tf32.cuh``, which it
    includes, with its PTX block swapped for ``emu_tf32.h`` (cp.async as
    copies made at the thread's wait, ldmatrix and the tf32 mma.sync as
    exchanges among a warp's lanes)."""
    from repro_torch.kernels.flash_attention import _build as flash_build

    OUT.mkdir(parents=True, exist_ok=True)
    hdr = flash_build.TF32_HEADER.read_text()
    hdr = hdr.replace("#include <cuda_runtime.h>\n#include <stdint.h>\n",
                      '#include "emu_cuda.h"\n')
    hdr = re.sub(r"// -+ PTX helpers\n.*?// -+ end PTX helpers\n", '#include "emu_tf32.h"\n',
                 hdr, flags=re.S)
    (OUT / "sm80_tf32_emu.h").write_text(hdr)
    t = (csrc / "wkv6_bwd.cu").read_text()
    t = re.sub(r'#include "[./]*flash_attention/csrc/sm80_tf32\.cuh"',
               '#include "sm80_tf32_emu.h"', t)
    t = re.sub(r"#include <cuda(_bf16|_runtime)\.h>\n", "", t)
    t = t.replace("#include <math.h>", '#include "emu_cuda.h"\n#include <math.h>')
    t = t.replace("extern __shared__ float4 smem4[];", "float4* smem4 = (float4*)emu_smem();")
    t = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", t, flags=re.S)
    src = OUT / "wkv6_bwd_emu.cpp"
    src.write_text(t)
    lib = OUT / "libemu_wkv6_bwd.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-I", str(EMU),
                    "-I", str(OUT), "-o", str(lib), str(src)], check=True)
    return lib


#: (bh, s, n, dtype, initial state, final-state gradient, decay): every head
#: size, lengths ragged about the chunks (64 tokens, 32 at N 128) and their
#: 16-token blocks, both dtypes, with and without the states, the
#: decay_base spread and decays down to -33
WKV6_CASES = [
    (2, 37, 64, "float32", True, True, "spread"),
    (3, 8, 64, "float32", False, False, "uniform"),
    (2, 1, 64, "bfloat16", True, True, "uniform"),
    (2, 95, 16, "float32", True, True, "uniform"),
    (1, 33, 32, "bfloat16", False, True, "spread"),
    (2, 50, 128, "float32", True, False, "extreme"),
    (1, 130, 64, "bfloat16", True, True, "extreme"),
    (3, 17, 32, "float32", True, True, "uniform"),
    (2, 40, 16, "bfloat16", True, False, "spread"),
    (2, 63, 64, "float32", False, True, "extreme"),
    (1, 129, 128, "bfloat16", True, True, "spread"),
    (2, 65, 32, "float32", True, False, "uniform"),
]


def wkv6_bwd_inputs(bh, s, n, dtype, with_state, with_dstate, decay, seed=0):
    """CPU inputs of the WKV6 backward from numpy: r, k, v in ``dtype``, the
    rest fp32; the decay drawn uniformly (omega in [-6, 1.5]), from rwkv6's
    decay_base spread, or down to -33 a token (omega up to 3.5)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((bh, s, n), np.float32) for _ in range(4))
    if decay == "spread":
        omega = -6.0 + 7.0 * np.linspace(0.0, 1.0, n) ** 1.5 + 0.1 * rng.standard_normal((bh, s, n))
    else:
        omega = rng.uniform(-6.0, 3.5 if decay == "extreme" else 1.5, (bh, s, n))
    logw = (-np.exp(omega)).astype(np.float32)
    u = (rng.standard_normal((bh, n)) * 0.3).astype(np.float32)
    st = (rng.standard_normal((bh, n, n)) * 0.1).astype(np.float32) if with_state else None
    ds = rng.standard_normal((bh, n, n)).astype(np.float32) if with_dstate else None
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]

    def t(a, d=torch.float32):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(d)

    return (t(r, dt), t(k, dt), t(v, dt), t(logw), t(u), t(st), t(do), t(ds))


def run_case_wkv6(lib, bh, s, n, dtype, with_state, with_dstate, decay, seed=0) -> bool:
    import torch

    from repro_torch.kernels.rwkv6._build import BWD_STAGES
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref

    x = wkv6_bwd_inputs(bh, s, n, dtype, with_state, with_dstate, decay, seed)
    r = x[0]
    dt = "f32" if dtype == "float32" else "bf16"
    outs = [torch.empty_like(r) for _ in range(3)] + [
        torch.empty(bh, s, n), torch.empty(bh, n), torch.empty(bh, n, n)]
    scratch = torch.empty(lib.wkv6_bwd_scratch_bytes(bh, s, n) // 4)
    ptrs = [None if a is None else a.data_ptr() for a in x] + [o.data_ptr() for o in outs]
    for stage in BWD_STAGES:
        assert getattr(lib, f"{stage}_{dt}")(*ptrs, scratch.data_ptr(), bh, s, n, None) == 0
    want = wkv6_bwd_ref(*x)
    errs = [rel(a, b) for a, b in zip(outs, want)]
    limits = [1e-4] * 6
    if dt == "bf16":  # dr, dk, dv are rounded to bf16 at the end: twice that rounding
        limits[:3] = [2 * rel(b.bfloat16(), b) for b in want[:3]]
    ok = all(e < lim for e, lim in zip(errs, limits))
    print(f"{'ok ' if ok else 'BAD'} WKV6 backward BH {bh} S {s} N {n} {dtype}, state "
          f"{with_state}, dS_T {with_dstate}, {decay} decay: dr/dk/dv/dlogw/du/dS0 "
          + "/".join(f"{e:.2e}" for e in errs) + " (limits "
          + "/".join(f"{x:.1e}" for x in limits) + ")", flush=True)
    return ok


def build_lease(csrc: Path, n_acceptors: int) -> Path:
    """The host build of ``lease_window.cu`` in ``csrc`` for
    ``n_acceptors`` (g++ -O1: the emulation's time is its threads', not its
    code's), unless a build of the same source exists."""
    t = (csrc / "lease_window.cu").read_text()
    t = t.replace("#include <cuda_runtime.h>", '#include "emu_cuda.h"')
    t = t.replace("extern __shared__ int smem[];", "int* smem = (int*)emu_smem();")
    t = re.sub(r"(\w+)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", t, flags=re.S)
    digest = hashlib.sha256((t + (EMU / "emu_cuda.h").read_text()).encode()).hexdigest()[:16]
    lib = OUT / f"liblease_emu_a{n_acceptors}_{digest}.so"
    if lib.exists():
        return lib
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"lease_window_emu_{digest}.cpp"
    src.write_text(t)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-DLEASE_ACCEPTORS={n_acceptors}", "-I", str(EMU), "-o", str(tmp),
                    str(src)], check=True)
    os.replace(tmp, lib)  # atomic: concurrent builders race harmlessly
    return lib


def load_lease(csrc: Path, n_acceptors: int) -> ctypes.CDLL:
    """``build_lease``'s library with the entry points' signatures declared
    (as ``lease_array._build.load`` declares them)."""
    from repro_torch.lease_array import _build

    lib = ctypes.CDLL(str(build_lease(csrc, n_acceptors)))
    for name in _build.ENTRY_POINTS:
        getattr(lib, name).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, name).restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def lease_on_host(libs: dict):
    """The port's lease wrappers, inside, launch the host libraries ``libs``
    ({A: CDLL}) on CPU tensors: ``_build.load`` returns them, the wrappers'
    CUDA-device check passes any device, and the stream and device lookups
    give stream 0 on a card of 132 SMs."""
    from unittest import mock

    import torch

    from repro_torch.lease_array import _build
    from repro_torch.lease_array import kernel as K

    class Stream:
        cuda_stream = 0

    with contextlib.ExitStack() as stack:
        for target, name, value in (
                (_build, "load", lambda a: libs[a]),
                (K, "_cuda_device", lambda t: t.device),
                (K, "_sm_count", lambda dev: 132),
                (torch.cuda, "current_stream", lambda dev=None: Stream),
                (torch.cuda, "device", lambda dev: contextlib.nullcontext())):
            stack.enter_context(mock.patch.object(target, name, value))
        yield


#: (window, skip_stable, collect) of each batched run in a lease case
LEASE_RUNS = ((16, True, "owners"), (1, False, "owners"), (16, False, "summary"),
              (1, True, "summary"))


def run_case_lease(libs, A, N, B, T, quiet, seed=1) -> bool:
    import itertools

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    from repro_torch.lease_array import kernel as K

    args, kw = CS.lane_case(torch.device("cpu"), A, N, B, T, quiet, seed)
    bad, runs, skipped = [], 0, 0
    with lease_on_host(libs):
        for bits in itertools.product((False, True), repeat=len(K.VARIANTS)):
            variant = tuple(v for v, on in zip(K.VARIANTS, bits) if on)
            vkw = CS.with_groups(kw, variant)
            want = K.lease_window_delayed_batched_torch(*args, **vkw)
            want = {"owners": want, "summary": K.window_summary(*want)}
            for lanes in K.lane_counts(A):
                for window, skip, collect in LEASE_RUNS:
                    ticked = torch.zeros(1, dtype=torch.int64)
                    got = K.lease_window_delayed_batched(
                        *args, **{**vkw, "collect": collect}, window=window,
                        skip_stable=skip, lanes=lanes, ticked=ticked)
                    runs += 1
                    skipped += int(ticked) < B * T * N
                    if not (all(torch.equal(x, y) for x, y in zip(got, want[collect]))
                            and (skip or int(ticked) == B * T * N)):
                        bad.append(f"{'+'.join(variant) or 'plain'} G {lanes} window "
                                   f"{window} skip {skip} {collect} ticked {int(ticked)}")
    ok = not bad and (skipped > 0 or not quiet)
    print(f"{'ok ' if ok else 'BAD'} lease A {A} N {N} B {B} T {T}{' quiet' if quiet else ''}: "
          f"{runs} runs (8 variants x G {K.lane_counts(A)} x {len(LEASE_RUNS)}), "
          f"{len(bad)} differ from plain or miscount ticked, {skipped} skipped a window"
          + (f"; first: {bad[0]}" if bad else ""), flush=True)
    return ok


def main(argv) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, default=_build.CSRC)
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 kernels (sm80_tf32.cuh) instead of the bf16 ones")
    ap.add_argument("--wkv6", action="store_true",
                    help="the WKV6 backward (kernels/rwkv6/csrc/wkv6_bwd.cu) instead")
    ap.add_argument("--lease", action="store_true",
                    help="the batched delayed lease kernel (lease_array/csrc/lease_window.cu)")
    ap.add_argument("cases", type=int, nargs="*")
    args = ap.parse_args(argv)
    if args.lease:
        sys.path.insert(0, str(ROOT))
        import chip_smoke as CS

        from repro_torch.lease_array import _build as lease_build

        csrc = lease_build.CSRC if args.csrc == _build.CSRC else args.csrc
        cases = [CS.LANE_CASES[i] for i in (args.cases or range(len(CS.LANE_CASES)))]
        libs = {a: load_lease(csrc, a) for a in sorted({c[0] for c in cases})}
        ok = all([run_case_lease(libs, *case) for case in cases])
        print("every case passed" if ok else "FAILED")
        return 0 if ok else 1
    if args.wkv6:
        from repro_torch.kernels.rwkv6 import _build as wkv_build

        csrc = wkv_build.CSRC if args.csrc == _build.CSRC else args.csrc
        lib = ctypes.CDLL(str(build_wkv6(csrc)))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in wkv_build.BWD_ENTRY_POINTS:
            getattr(lib, name).argtypes = [ptr] * 15 + [i32] * 3 + [ptr]
        lib.wkv6_bwd_scratch_bytes.argtypes = [i32] * 3
        lib.wkv6_bwd_scratch_bytes.restype = ctypes.c_longlong
        ok = all([run_case_wkv6(lib, *WKV6_CASES[i])
                  for i in (args.cases or range(len(WKV6_CASES)))])
        print("every case passed" if ok else "FAILED")
        return 0 if ok else 1
    dt = "f32" if args.fp32 else "bf16"
    lib = ctypes.CDLL(str((build_fp32 if args.fp32 else build)(args.csrc)))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    getattr(lib, f"flash_fwd_{dt}").argtypes = [ptr] * 5 + [i32] * 7 + [ctypes.c_float, ptr]
    for name in (f"flash_bwd_dkdv_{dt}", f"flash_bwd_dq_{dt}"):
        getattr(lib, name).argtypes = [ptr] * 8 + [i32] * 7 + [ctypes.c_float, ptr]
    cases, run = (FP32_CASES, run_case_fp32) if args.fp32 else (CASES, run_case)
    ok = all([run(lib, *cases[i]) for i in (args.cases or range(len(cases)))])
    print("every case passed" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
