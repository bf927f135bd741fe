#!/usr/bin/env python3
"""fp32 flash-attention kernels side by side on one card, in turns.

    python3 tools/flash_fp32_ab.py OTHER.cu [OTHER.cu ...]

Each OTHER.cu is an fp32 flash-attention source with the C entry point
``flash_fwd_f32`` of ``csrc/flash_attention.cu`` (for instance an earlier
commit's, from ``git show <commit>:src/repro_torch/kernels/flash_attention/
csrc/flash_attention.cu``). Each is built with the port's nvcc flags into
its own library under ``build/flash_fp32_ab/``; the port's library is built
as ``_build.build`` makes it. Then, on one card, for the port's kernel
("port") and each other source, in turns (port, the others, the others
again in reverse, port):

* the kernel's CUDA-event time at ``chip_smoke.py``'s phase-12 shapes
  (internlm2-1.8b's 4 x 2048 causal prefill: BHq 64, BHkv 32, S 2048,
  Dh 128) and at Dh 64, with its max |err| against ``attention_ref``;
* the host time (synchronised) of phase 9's full-width fp32 internlm2-1.8b
  prefill of 4 x 2048 tokens, with that kernel in every layer, warmed.

It prints the card's name and power limit first, then whether each other
source's forward kernel issues the port's SASS, instruction for
instruction, at every head width (``cuobjdump -sass``; opcodes and
operands, addresses aside). After the timings come
two probes of the instruction the fp32 kernel is built on: what the port's
``ldsm_x4`` and ``mma_tf32`` give on one warp against float64 products of
their operands with the 13 low bits cleared and with them rounded (which
of the two the tensor core reads, and how it rounds its sums), and the
rate that ``mma.sync.m16n8k8`` with tf32 operands reaches when nothing
else is issued (warps of a block x independent accumulators a warp, one
wave of blocks on every SM), beside the dense TF32 peak that the kernel's
bound uses.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_fp32_ab"


def build(src: Path, name: str, entry: str = "flash_fwd_f32") -> ctypes.CDLL:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library
    from repro_torch.kernels.flash_attention import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    lib.unlink(missing_ok=True)
    compile_library(lib, [src], [*NVCC_FLAGS, "-I", str(_build.CSRC)])
    dll = ctypes.CDLL(str(lib))
    if entry == "flash_fwd_f32":
        dll.flash_fwd_f32.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
    getattr(dll, entry).restype = ctypes.c_int
    return dll


CEILING_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b0 = 0x3f800000u + threadIdx.x, b1 = 0x3f000000u + threadIdx.x;
  for (int e = 0; e < 4; ++e) a[e] = 0x3c000000u + 16 * threadIdx.x + e;
  float d[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
          "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  if (s == 1234.5f) out[threadIdx.x] = s;
}
extern "C" int mma_loop_launch(int blocks, int warps, int chains, int iters, void* out) {
  if (chains == 4) mma_loop<4><<<blocks, 32 * warps>>>(static_cast<float*>(out), iters);
  else if (chains == 8) mma_loop<8><<<blocks, 32 * warps>>>(static_cast<float*>(out), iters);
  else mma_loop<16><<<blocks, 32 * warps>>>(static_cast<float*>(out), iters);
  return cudaGetLastError();
}
"""


PROBE_SRC = r"""
#include "{source}"
// one warp a block: d (16 x 8) = a (16 x 16, row-major) b^T (b: 8 keys x 16
// dims, as K lies in shared memory), by the kernel's ldsm_x4 addressing and
// mma_tf32, two k-steps
__global__ void probe_kernel(const float* a, const float* b, float* d) {
  __shared__ __align__(16) float as[16 * 20], bs[8 * 20];
  const int lane = threadIdx.x;
  a += blockIdx.x * 256; b += blockIdx.x * 128; d += blockIdx.x * 128;
  for (int i = lane; i < 256; i += 32) as[(i / 16) * 20 + i % 16] = a[i];
  for (int i = lane; i < 128; i += 32) bs[(i / 16) * 20 + i % 16] = b[i];
  __syncwarp();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t y[4];
  ldsm_x4(bs + (lane & 7) * 20 + 4 * (lane >> 3), y);
  for (int h = 0; h < 2; ++h) {
    uint32_t x[4];
    ldsm_x4(as + ((lane & 7) + 8 * ((lane >> 3) & 1)) * 20 + 4 * (lane >> 4) + 8 * h, x);
    mma_tf32(acc, x, y[2 * h], y[2 * h + 1]);
  }
  const int g = lane >> 2, t = lane & 3;
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}
extern "C" int probe(const void* a, const void* b, void* d, int n) {
  probe_kernel<<<n, 32>>>(static_cast<const float*>(a), static_cast<const float*>(b),
                          static_cast<float*>(d));
  return cudaGetLastError();
}
"""


def fragment_probe() -> str:
    """The port's ``ldsm_x4`` and ``mma_tf32`` (its source included) on
    4096 random 16 x 16 by 16 x 8 products, against float64 products of the
    operands with their 13 low bits cleared (what the kernel assumes the
    tensor core reads) and of the operands rounded to nearest: the largest
    difference from each, and the mean signed difference from the first in
    fp32 ulps of the result (negative: toward zero)."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "tf32_probe.cu"
    src.write_text(PROBE_SRC.replace("{source}", str(_build.SOURCE)))
    dll = build(src, "tf32_probe", entry="probe")
    dll.probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    n = 4096
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((n, 16, 16), np.float32))
    b = torch.from_numpy(rng.standard_normal((n, 8, 16), np.float32))
    ad, bd = a.cuda(), b.cuda()
    d = torch.empty(n, 16, 8, device="cuda")
    assert dll.probe(ad.data_ptr(), bd.data_ptr(), d.data_ptr(), n) == 0
    got = d.cpu().double()

    def product(x, y, keep):
        return keep(x).double() @ keep(y).double().transpose(1, 2)

    cleared = product(a, b, lambda x: (x.view(torch.int32) & -0x2000).view(torch.float32))
    rounded = product(a, b, lambda x: ((x.view(torch.int32) + 0x1000) & -0x2000)
                      .view(torch.float32))
    ulp = torch.from_numpy(np.spacing(np.abs(cleared.numpy()).astype(np.float32))
                           .astype(np.float64))
    signed = ((got - cleared) / ulp * cleared.sign()).mean()
    return (f"max |d - low bits cleared| {float((got - cleared).abs().max()):.3e} (mean "
            f"signed {float(signed):+.3f} ulp), max |d - rounded| "
            f"{float((got - rounded).abs().max()):.3e}")


def same_sass(port: Path, other: Path, CS) -> str:
    """For each head width, whether the forward kernel of ``other`` issues
    the SASS of the port's, instruction for instruction (predicate, opcode,
    operands; addresses aside), with the two instruction counts."""
    fwd = [{CS.flash_kind(n): [i[1:] for i in ins] for n, ins in
            CS.sass_functions(CS.library_sass(lib)).items() if "flash_fwd_kernel" in n}
           for lib in (port, other)]
    return ", ".join(f"{kind} {'same' if ins == fwd[1].get(kind) else 'DIFFERS'} "
                     f"({len(ins)} / {len(fwd[1].get(kind, []))})"
                     for kind, ins in sorted(fwd[0].items()))


def mma_ceiling(CS) -> str:
    """TFLOP/s of back-to-back tf32 mma.sync.m16n8k8 (2048 FLOP each) for
    (warps a block, accumulators a warp), one block an SM."""
    import torch

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "mma_loop.cu"
    src.write_text(CEILING_SRC)
    dll = build(src, "mma_loop", entry="mma_loop_launch")
    dll.mma_loop_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = torch.zeros(1024, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, rates = 4096, []
    for warps, chains in ((4, 8), (8, 4), (8, 8), (8, 16), (16, 8)):
        def run():
            assert dll.mma_loop_launch(sms, warps, chains, iters, out.data_ptr()) == 0

        ms = CS.time_ms(run, 5)
        rates.append(f"{warps} x {chains}: "
                     f"{sms * warps * chains * iters * 2048 / ms / 1e9:.1f} TFLOP/s")
    return ", ".join(rates)


def main(argv) -> int:
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_model

    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = {"port": FK._build.load()}
    for i, src in enumerate(argv):
        libs[f"{i + 1}:{Path(src).name}"] = build(Path(src), f"other{i + 1}")
        print(f"SASS of {i + 1}:{Path(src).name} against the port's forward: "
              + same_sass(FK._build.build(), OUT / f"libother{i + 1}.so", CS), flush=True)
    names = list(libs)
    order = names + names[::-1]  # port, the others, the others reversed, port
    saved = FK._build.load

    def using(name):
        FK._build.load = lambda: libs[name]

    try:
        dev = torch.device("cuda")
        b, s, hq, hkv = CS.LM_BATCH, CS.LM_SEQ, 16, 8
        for dh in (128, 64):
            g = torch.Generator(device=dev).manual_seed(13)
            q = torch.randn(b * hq, s, dh, generator=g, device=dev)
            k = torch.randn(b * hkv, s, dh, generator=g, device=dev)
            v = torch.randn(b * hkv, s, dh, generator=g, device=dev)
            want = attention_ref(q, k, v, causal=True)
            errs, times = {}, {n: [] for n in names}
            for name in names:
                using(name)
                errs[name] = float((FK.flash_attention_bhsd(q, k, v) - want).abs().max())
            for name in order:
                using(name)
                times[name].append(CS.time_ms(lambda: FK.flash_attention_bhsd(q, k, v), 10))
            flop = 4 * dh * b * hq * s * (s + 1) // 2
            print(f"kernel, BHq {b * hq}, BHkv {b * hkv}, S {s}, Dh {dh}, causal (3xTF32 bound "
                  f"{3 * flop / CS.TF32_FLOP_PER_S * 1e3:.4f} ms, fp32 FMA bound "
                  f"{flop / CS.FP32_FLOP_PER_S * 1e3:.4f} ms): " + "; ".join(
                      f"{n} {' / '.join(f'{t:.4f}' for t in times[n])} ms, max |err| "
                      f"{errs[n]:.3e}" for n in names), flush=True)
            del q, k, v, want

        cfg = get_config(CS.LM_ARCH)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params = init_model(cfg, 0, device=dev)
        toks = torch.from_numpy(np.random.default_rng(12).integers(
            0, cfg.vocab_size, (CS.LM_BATCH, CS.LM_SEQ)).astype(np.int32)).to(dev)
        prefill32 = make_prefill_step(cfg32, logits_mode="last")
        times = {n: [] for n in names}
        for name in order:
            using(name)
            times[name].append(CS.host_ms(lambda: prefill32(params, {"tokens": toks}), 3))
        print(f"fp32 prefill {CS.LM_ARCH} {CS.LM_BATCH} x {CS.LM_SEQ} (phase 9), host ms a "
              f"call: " + "; ".join(f"{n} {' / '.join(f'{t:.1f}' for t in times[n])}"
                                    for n in names), flush=True)
    finally:
        FK._build.load = saved
    print(f"fragment probe (the kernel's ldsm_x4 + mma_tf32, one warp): {fragment_probe()}",
          flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"mma.sync.m16n8k8 tf32 alone, {sms} blocks of warps x accumulators a warp "
          f"(dense TF32 peak "
          f"{CS.TF32_FLOP_PER_S / 1e12:.1f} TFLOP/s): {mma_ceiling(CS)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
