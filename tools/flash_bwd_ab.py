#!/usr/bin/env python3
"""Flash-attention backward kernels side by side on one card, in turns.

    python3 tools/flash_bwd_ab.py [--fp32] OTHER.cu [OTHER.cu ...]

Each OTHER.cu is a backward source with the C entries
``flash_bwd_dkdv_bf16`` and ``flash_bwd_dq_bf16`` of
``csrc/flash_attention_bwd_wgmma.cu`` or, with ``--fp32``,
``flash_bwd_dkdv_f32`` and ``flash_bwd_dq_f32`` of
``csrc/flash_attention_bwd_tf32.cu`` (for instance an earlier commit's
``csrc/flash_attention_bwd.cu``, from ``git show <commit>:src/repro_torch/
kernels/flash_attention/csrc/flash_attention_bwd.cu``, or a variant of the
port's source). Each is built with the port's nvcc flags, and ``csrc/`` on
the include path, into its own library under ``build/flash_bwd_ab/``; the
port's library is built as ``_build.build`` makes it. D = rowsum(do * o) is
the port's ``flash_bwd_pre_*`` for every source.

It prints the card's name and power limit first, then each library's
registers and spills from its ``-Xptxas -v`` report. Then, at the model
shapes of ``chip_smoke.py``'s ``BWD_CASES`` (internlm2-1.8b's train
microbatch, mixtral-8x22b's, hymba-1.5b's, whisper's encoder and
cross-attention), for the port's kernels ("port") and each other source, in
turns (port, the others, the others again in reverse, port):

* the backward's CUDA-event time (its three launches), and the dK/dV and
  dQ passes' times alone;
* each gradient's ||err||_2 / ||g||_2 against ``attention_bwd_ref`` in fp32
  on the same (upcast) inputs, beside the limit phase 42 holds it to (bf16:
  twice the bf16 plain run's error plus 1e-3; fp32: 1e-4);
* the bound: 10 Dh FLOP a live pair at the bf16 peak, or in fp32 three
  TF32 products each at the TF32 peak.
"""
from __future__ import annotations

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_bwd_ab"
PASSES = {dt: (f"flash_bwd_dkdv_{dt}", f"flash_bwd_dq_{dt}") for dt in ("bf16", "f32")}


def build(src: Path, name: str) -> Path:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library
    from repro_torch.kernels.flash_attention import _build

    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"lib{name}.so"
    lib.unlink(missing_ok=True)
    return compile_library(lib, [src], [*NVCC_FLAGS, "-I", str(_build.CSRC)])


def bind(path: Path, passes) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(path))
    for entry in passes:
        fn = getattr(dll, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return dll


class Mixed:
    """The port's library with the dK/dV and dQ entries ``passes`` of another."""

    def __init__(self, port, other, passes):
        self.port, self.other, self.passes = port, other, passes

    def __getattr__(self, name):
        return getattr(self.other if name in self.passes else self.port, name)


def main(argv) -> int:
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    fp32 = "--fp32" in argv
    argv = [a for a in argv if a != "--fp32"]
    if not torch.cuda.is_available() or not argv:
        print(__doc__, file=sys.stderr)
        return 2
    passes = PASSES["f32" if fp32 else "bf16"]
    dtype = torch.float32 if fp32 else torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    port = _build.load()
    paths = {"port": _build.build()}
    libs = {"port": port}
    for i, src in enumerate(argv):
        name = f"{i + 1}:{Path(src).name}"
        paths[name] = build(Path(src), f"other{i + 1}")
        libs[name] = Mixed(port, bind(paths[name], passes), passes)

    def kind(entry):  # the passes of this source and of earlier ones
        m = re.search(r"bwd_(dkdv|dq)_mma_kernelILi(\d+)E", entry)
        return f"bwd-mma-{m[1]}/Dh{m[2]}" if m else CS.flash_kind(entry)

    ours = ("bwd-f32",) if fp32 else ("bwd-wgmma", "bwd-mma")
    for name, path in paths.items():
        summary = CS.ptxas_summary(path.with_suffix(".log").read_text(), kind)
        print(f"{name} ({path.name}) ptxas: " + ", ".join(
            s for s in summary.split(", ") if s.startswith(ours)), flush=True)
    names = list(libs)
    order = names + names[::-1]  # port, the others, the others reversed, port
    saved = _build.load
    dev = torch.device("cuda")
    try:
        for n, (label, bhq, bhkv, sq, sk, dh, causal, w) in enumerate(CS.BWD_CASES):
            if label.startswith("ragged"):
                continue
            g = torch.Generator(device=dev).manual_seed(420 + n)
            q, k, v, do = (torch.randn(h, s, dh, generator=g, device=dev).to(dtype)
                           for h, s in ((bhq, sq), (bhkv, sk), (bhkv, sk), (bhq, sq)))
            with torch.no_grad():
                o, lse = FK.flash_attention_fwd(q, k, v, causal=causal, window=w, with_lse=True)
                want = attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)), lse,
                                         causal=causal, window=w)
                if fp32:
                    limits = [CS.BWD_FP32_TOL] * 3
                else:
                    plain = attention_bwd_ref(q, k, v, o, do, lse, causal=causal, window=w)
                    limits = [2 * CS.grad_rel(a, b) + CS.BWD_BF16_SLACK
                              for a, b in zip(plain, want)]
                    del plain
                delta = (do.float() * o.float()).sum(-1)
                outs = [torch.empty_like(x) for x in (k, v, q)]
                tail = (bhq, bhkv, sq, sk, dh, int(causal), 0 if w is None else w,
                        1.0 / math.sqrt(dh), torch.cuda.current_stream().cuda_stream)
                ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                       delta.data_ptr())
                errs, times = {}, {x: [] for x in names}
                per_pass = {x: {p: [] for p in passes} for x in names}
                for name in names:
                    _build.load = lambda name=name: libs[name]
                    got = FK.flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=w)
                    errs[name] = [CS.grad_rel(a, b) for a, b in zip(got, want)]
                    del got
                for name in order:
                    lib = libs[name]
                    _build.load = lambda name=name: libs[name]
                    times[name].append(CS.time_ms(lambda: FK.flash_attention_bwd(
                        q, k, v, o, do, lse, causal=causal, window=w), 5))
                    for entry, outs_ in ((passes[0], (outs[0].data_ptr(), outs[1].data_ptr())),
                                         (passes[1], (outs[2].data_ptr(), None))):
                        fn = getattr(lib, entry)
                        per_pass[name][entry].append(CS.time_ms(
                            lambda: fn(*ins, *outs_, *tail), 5))
            pairs = sum(min(i + 1 if causal else sk, sk) - max(0, i - w + 1 if w else 0)
                        for i in range(sq)) * bhq
            flop = 10 * dh * pairs
            bound = (3 * flop / CS.TF32_FLOP_PER_S if fp32 else flop / CS.BF16_FLOP_PER_S) * 1e3
            mean = lambda x: sum(x) / len(x)
            print(f"{label} ({dtype}, BHq {bhq}, BHkv {bhkv}, Sq {sq}, Sk {sk}, Dh {dh}, "
                  f"{'causal' if causal else 'non-causal'}, window {w}; bound {bound:.4f} ms, "
                  f"10 Dh FLOP a live pair{', 3xTF32' if fp32 else ''}): " + "; ".join(
                      f"{x} {mean(times[x]):.4f} ms ({' / '.join(f'{t:.4f}' for t in times[x])}; "
                      f"dK/dV {mean(per_pass[x][passes[0]]):.4f}, "
                      f"dQ {mean(per_pass[x][passes[1]]):.4f}), "
                      f"dq/dk/dv {'/'.join(f'{e:.3e}' for e in errs[x])}"
                      for x in names)
                  + " (limits " + "/".join(f"{x:.3e}" for x in limits) + ")", flush=True)
            del q, k, v, do, o, lse, want, delta, outs
            torch.cuda.empty_cache()
    finally:
        _build.load = saved
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
