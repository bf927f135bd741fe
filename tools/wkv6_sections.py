#!/usr/bin/env python3
"""Where a WKV6 kernel's time goes, on the card.

    python3 tools/wkv6_sections.py                      # bf16: csrc/wkv6_mma.cu
    python3 tools/wkv6_sections.py --fp32 [OTHER.cu ...] [--replace OLD NEW ...] [--prefill]

Builds the kernel's source as it is and a copy with a ``clock64()`` mark
just before each barrier of its round loop (``__syncthreads();``,
``__syncwarp();`` or an ``mbar_wait(...);`` on a line of its own), summed
per warp into a ``__device__`` array and read back with
``cudaMemcpyFromSymbol`` (there is no ``ncu`` on the machine with the
card). Each runs at the phase-17 shapes of ``chip_smoke.py`` (BH 160, S
2048, N 64; bf16 r/k/v for the tensor-core kernel, their fp32 cast with
``--fp32``) on two decay draws: rwkv6's decay_base spread, and the
uniform draw of phase 13's extreme cases (logw down to -33 a token). It
prints the cycles a round each warp takes from its arrival at one mark to
its arrival at the next, at the decay_base spread (so a stretch holds the
wait at the barrier it starts from: a clock read placed just after a
barrier is scheduled ahead of it); each build's error on both draws
against the plain chunked form (fp32, the tests' yardstick) and against
the recurrence token by token in float64 (the error of the kernel itself);
and the CUDA-event times of the builds in turns on both draws (as is),
then of the marked builds, which give the marks' cost. The first stretch
runs from the round before's last mark through the loop's head.

With ``--fp32``, each OTHER.cu (an fp32 source with the entry point
``wkv6_fwd_f32``, for instance an earlier commit's ``csrc/wkv6.cu`` from
``git show``) and each ``--replace OLD NEW`` (a copy of the port's
``wkv6.cu`` with every OLD replaced by NEW, written under ``build/``:
another tiling, or ``--replace "expf(" "__expf("``) is split and timed
beside the port's kernel; ``--prefill`` then times phase 14's fp32
rwkv6-3b prefill (4 x 2048, random weights from seed 0; host time of a
warmed, synchronised call) with each build in every layer, in turns.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/rwkv6/csrc"
OUT = ROOT / "build" / "wkv6_sections"
#: each kernel's round loop: the bf16 kernel's chunks, the fp32 kernel's rounds
LOOP = re.compile(r"for \(int (?:c = 0; c < chunks; \+\+c|t0 = 0; t0 < seq; t0 \+= CH)\) \{")
BARRIER = re.compile(
    r"^([ \t]*)(__syncthreads\(\)|__syncwarp\(\)|mbar_wait\([^;\n]*\));[ \t]*(?://[ \t]*(.*))?$",
    re.M)
MAX_WARPS = 32
MODES = {  # source, entry point, dtype code
    "bf16": (CSRC / "wkv6_mma.cu", "wkv6_fwd_bf16", 1),
    "fp32": (CSRC / "wkv6.cu", "wkv6_fwd_f32", 0),
}


def instrument(src: str, path: Path) -> tuple[str, list]:
    """-> (the source with the marks, a label for each mark: its line in
    the source, its kind and its comment)."""
    found = list(LOOP.finditer(src))
    if len(found) != 1:
        raise SystemExit(f"{path}: {len(found)} round loops, not one")
    head, loop = src[:found[0].end()], src[found[0].end():]
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
        raise SystemExit(f"no barrier in the round loop of {path}")
    nm = len(labels)
    loop_at = found[0].start()
    decl = (f"unsigned prof[{nm}] = {{0}}, n_rounds = 0;\n  long long t_last = clock64();\n"
            "#define MARK(i) { const long long now = clock64(); "
            "prof[i] += (unsigned)(now - t_last); t_last = now; }\n  ")
    flush = ("\n  if ((threadIdx.x & 31) == 0) {\n"
             f"    for (int i = 0; i < {nm}; ++i)\n"
             "      atomicAdd(&g_prof[threadIdx.x >> 5][i], (unsigned long long)prof[i]);\n"
             f"    atomicAdd(&g_prof[threadIdx.x >> 5][{nm}], (unsigned long long)n_rounds);\n  }}")
    src = (src[:loop_at] + decl + head[loop_at:] + "\n    ++n_rounds;" + body + "}" + flush
           + loop[end + 1:])
    last_include = list(re.finditer(r"^#include .*$", src, re.M))[-1].end()
    src = (src[:last_include]
           + f"\n__device__ unsigned long long g_prof[{MAX_WARPS}][{nm + 1}];"
           + src[last_include:])
    return src + (
        '\nextern "C" int read_prof(void* h) { return cudaMemcpyFromSymbol(h, g_prof, '
        'sizeof(g_prof)); }\n'), labels


def build(src: str, name: str, entry: str) -> ctypes.CDLL:
    from repro_torch._nvcc import NVCC_FLAGS, compile_library

    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = OUT / f"lib{name}.so"
    lib.unlink(missing_ok=True)
    compile_library(lib, [cu], list(NVCC_FLAGS))
    print(f"{name}: " + "; ".join(
        line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
        if "registers" in line or "spill" in line)[:600])
    dll = ctypes.CDLL(str(lib))
    getattr(dll, entry).argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return dll


def main() -> int:
    import numpy as np
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as CS
    from repro_torch.kernels.rwkv6.ref import wkv_chunked_bhsn

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true", help="the fp32 kernel (csrc/wkv6.cu)")
    ap.add_argument("others", nargs="*", type=Path, help="other fp32 sources (--fp32)")
    ap.add_argument("--replace", nargs=2, action="append", default=[], metavar=("OLD", "NEW"),
                    help="a variant of the port's fp32 source, every OLD replaced by NEW")
    ap.add_argument("--prefill", action="store_true",
                    help="time the fp32 rwkv6-3b prefill with each build (--fp32)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    if not opts.fp32 and (opts.others or opts.replace or opts.prefill):
        ap.error("other sources, --replace and --prefill need --fp32")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    mode = "fp32" if opts.fp32 else "bf16"
    source, entry, code = MODES[mode]
    dev = torch.device("cuda")
    dt = "float32" if opts.fp32 else "bfloat16"
    b, s, h, n = 4, 2048, 40, 64
    draws = {
        "decay_base": CS.wkv_inputs(dev, b, s, h, n, None, dt, False, seed=17,
                                    omega=CS.decay_base_omega(b, s, h, n, 18)),
        "to -33": CS.wkv_inputs(dev, b, s, h, n, 3.5, dt, False, seed=19),
    }
    bh = b * h
    plain = {d: wkv_chunked_bhsn(*a) for d, a in draws.items()}
    exact = {d: seq_f64(*a[:5]) for d, a in draws.items()}
    for d in draws:
        print(f"{d}: plain fp32 against float64, rel err {CS.rel_err(plain[d][0], exact[d][0]):.3e}, "
              f"state {CS.rel_err(plain[d][1], exact[d][1]):.3e}")

    def call(lib, draw="decay_base"):
        r, k, v, logw, u, _ = draws[draw]
        o = torch.empty(bh, s, n, device=dev)
        st = torch.zeros(bh, n, n, device=dev)
        err = getattr(lib, entry)(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                                  u.data_ptr(), o.data_ptr(), st.data_ptr(), bh, s, n, code,
                                  torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return o, st

    # name -> (what it is, source text); the other sources first, so that
    # their splits print before a build of the port's can fail
    variants = {f"other{i}": (str(other), other.read_text())
                for i, other in enumerate(opts.others)}
    variants["port"] = (str(source), source.read_text())
    for i, (old, new) in enumerate(opts.replace):
        if old not in variants["port"][1]:
            ap.error(f"{old!r} is not in {source}")
        variants[f"rep{i}"] = (f"{source.name} with {old!r} -> {new!r}",
                               variants["port"][1].replace(old, new))
    libs, labels = {}, {}
    ok = True
    for name, (what, src) in variants.items():
        print(f"{name}: {what}")
        marked_src, labels[name] = instrument(src, source)
        libs[name] = build(src, f"{name}_{mode}", entry)
        libs[name, "marked"] = build(marked_src, f"{name}_{mode}_marked", entry)
        for key in (name, (name, "marked")):
            for d in draws if key == name else ["decay_base"]:
                o, st = call(libs[key], d)
                torch.cuda.synchronize()
                e_o, e_st = CS.rel_err(o, plain[d][0]), CS.rel_err(st, plain[d][1])
                ok &= max(e_o, e_st) < CS.WKV_TOL[dt]
                print(f"{key} {d}: rel err vs plain {e_o:.3e}, state {e_st:.3e}; vs float64 "
                      f"{CS.rel_err(o, exact[d][0]):.3e}, state {CS.rel_err(st, exact[d][1]):.3e}")
        nm = len(labels[name])
        buf = (ctypes.c_ulonglong * (MAX_WARPS * (nm + 1)))()
        assert libs[name, "marked"].read_prof(buf) == 0
        prof = np.array(buf[:], dtype=np.float64).reshape(MAX_WARPS, nm + 1)
        prof = prof[prof[:, nm] > 0]
        cyc = prof[:, :nm] / prof[:, nm:]  # per warp, a round
        print(f"{name}: cycles a round, warps {'/'.join(map(str, range(len(cyc))))}, at the "
              "phase-17 shapes, from the arrival at the mark before:")
        for i, label in enumerate(labels[name]):
            print(f"  up to {label}: " + "/".join(f"{c:.0f}" for c in cyc[:, i])
                  + f" ({100 * cyc[:, i].sum() / cyc.sum():.1f} %)")
        print("  total: " + "/".join(f"{c:.0f}" for c in cyc.sum(1)))
    order = list(variants) + list(variants)[::-1]
    for d in draws:
        print(f"CUDA-event ms in turns ({mode}, BH {bh}, S {s}, N {n}, {d}): " + ", ".join(
            f"{name} {CS.time_ms(lambda: call(libs[name], d), 10):.4f}" for name in order))
    print("marked builds: " + ", ".join(
        f"{name} {CS.time_ms(lambda: call(libs[name, 'marked']), 10):.4f}" for name in variants))
    if opts.prefill:
        del draws, plain, exact
        prefill_in_turns(CS, {name: libs[name] for name in variants}, order, dev)
    return 0 if ok else 1


def seq_f64(r, k, v, logw, u):
    """The recurrence token by token in float64, from a zero state:
    o_t = r_t (S + diag(u) k_t^T v_t), then S = diag(e^{logw_t}) S + k_t^T v_t.
    -> (out, final state)."""
    import torch

    r, k, v, w, u = (x.double() for x in (r, k, v, logw, u))
    bh, s, n = r.shape
    st = torch.zeros(bh, n, n, dtype=torch.float64, device=r.device)
    out = torch.empty(bh, s, n, dtype=torch.float64, device=r.device)
    for t in range(s):
        kv = k[:, t, :, None] * v[:, t, None, :]
        out[:, t] = (r[:, t, None, :] @ (st + u[:, :, None] * kv))[:, 0]
        st = w[:, t].exp()[:, :, None] * st + kv
    return out, st


def prefill_in_turns(CS, libs: dict, order: list, dev) -> None:
    """Phase 14's fp32 rwkv6-3b prefill with each library's wkv6_fwd_f32 in
    every layer (the library the wrapper loads swapped), in turns."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6 import _build
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import init_model

    cfg = get_config(CS.RWKV_ARCH)
    params = init_model(cfg, 0, device=dev)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        0, cfg.vocab_size, (CS.LM_BATCH, CS.LM_SEQ)).astype(np.int32)).to(dev)
    prefill = make_prefill_step(dataclasses.replace(cfg, dtype="float32"), logits_mode="last")
    load, times = _build.load, []
    try:
        for name in order:
            _build.load = lambda lib=libs[name]: lib
            times.append(f"{name} {CS.host_ms(lambda: prefill(params, {'tokens': toks}), 3):.1f}")
    finally:
        _build.load = load
    print(f"fp32 {CS.RWKV_ARCH} prefill {CS.LM_BATCH} x {CS.LM_SEQ}, ms in turns: "
          + ", ".join(times), flush=True)


if __name__ == "__main__":
    sys.exit(main())
