"""Serving launcher: the continuous-batching engine over a config, on the
card (``--device cpu`` runs the plain PyTorch path on the CPU).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b --requests 8
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm20m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_model
    from repro_torch.train.serve import Request, ServeEngine

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = init_model(cfg, args.seed, device=args.device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_len=args.max_len, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(2, 12))
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
                           max_new=args.max_new))
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    seconds = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {eng.steps} engine "
          f"steps, {seconds:.3f} s ({toks / seconds:.1f} tokens/s) on {eng.device}")
    return {"requests": len(done), "tokens": toks, "steps": eng.steps, "seconds": seconds}


if __name__ == "__main__":
    main()
