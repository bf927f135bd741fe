"""Prefill cells: ``repro_torch.launch.steps.make_prefill_step``, one client
in a closed loop, one request a call.

The mix's requests (every length of the mix once, in the seed's order) are
replayed pass after pass. Set-up makes the weights and runs one pass, so
every shape is warm. The window runs whole passes until ``--seconds`` have
passed. A request's time to first token runs from the call until the
argmax of its last position's logits is on the host.

The check: a sample of requests drawn from the seed, the longest among
them, whose outputs from the window's last pass are kept. The reference
computes each prompt again in fp32 and compares the last position's logits
(max |Δ| over max |reference|), the served token (how far its reference
logit lies below the reference's best, over max |reference|) and every
layer's emitted cache leaf (max |Δ| over max |reference|, the worst layer).
"""
from __future__ import annotations

import gc
import math
import time

from .. import harness, traffic, weights
from ..reference.common import strict_fp32


def _p95(values: list) -> float:
    """Nearest-rank 95th percentile."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    import torch

    from repro_torch.launch.steps import make_prefill_step

    m, mix = cell.model, cell.traffic
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ref = harness.reference(cell)
    params = weights.make(ref.leaves(m), seed, device)
    step = make_prefill_step(harness.program_config(m))
    reqs = traffic.prompts(mix, m["vocab_size"], seed, device)
    lengths = [n for n, _ in reqs]
    picked = traffic.sample(len(reqs), mix["checked_requests"], lengths.index(max(lengths)), seed)
    kept: dict = {}

    def serve(i: int, keep: bool = False) -> float:
        """One request; its time to first token. ``keep``: its outputs are judged."""
        t = time.perf_counter()
        logits, cache = step(params, {"tokens": reqs[i][1][None]})
        token = int(torch.argmax(logits[0, -1]))
        ttft = time.perf_counter() - t
        if keep:
            kept[i] = (logits[0, -1], cache, token)
        return ttft

    for i in range(len(reqs)):  # set-up: every shape once
        serve(i)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    ttfts, tokens = [], 0
    while True:
        for i in range(len(reqs)):
            ttfts.append(serve(i, keep=i in picked))
            tokens += lengths[i]
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            break
    passes = len(ttfts) // len(reqs)

    tr_obj = None
    if trace:
        def one_pass():
            for i in range(len(reqs)):
                serve(i)
        tr_obj = harness.traced(one_pass, lambda: serve(0), len(reqs), device)
        tr_obj.extra["lengths"] = lengths
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = check(cell, seed, device, reqs, picked, kept)
    return {
        "e2e": {"prefill_tokens_per_s": tokens / elapsed, "ttft_p95_ms": _p95(ttfts) * 1e3,
                "setup_s": setup_s},
        "attempted": len(ttfts),
        "failed": 0,
        "readings": readings,
        "peak_bytes": peak,
        "ctx": {"kind": "prefill", "model": m, "cell": cell.name, "window_s": elapsed,
                "lengths": lengths * passes, "trace": tr_obj},
    }


def reference_outputs(cell, W: dict, tokens, quant=None) -> tuple:
    """The reference's last logits (V,) and each layer's cache leaves, fp32."""
    import torch

    m = cell.model
    ref = harness.reference(cell)
    layers: dict = {}
    with torch.no_grad():
        h = ref.hidden(m, W, tokens[None], quant=quant,
                       emit=lambda i, leaves: layers.__setitem__(i, leaves))
        logits = ref.logits(m, W, h[:, -1], quant)[0]
    return logits, layers


def _rel(got, want) -> float:
    return float((got.float() - want).abs().max() / want.abs().max().clamp(min=1e-30))


def compare_request(cell, got_logits, got_cache, token, want_logits, want_layers) -> dict:
    """One request's readings: its logits, its served token's gap, and each
    cache leaf's worst layer."""
    out = {"logits": _rel(got_logits, want_logits),
           "token_gap": float((want_logits.max() - want_logits[token])
                              / want_logits.abs().max().clamp(min=1e-30))}
    for i, leaves in want_layers.items():
        for name, want in leaves.items():
            got = got_cache[name][i]
            key = f"cache_{name}"
            out[key] = max(out.get(key, 0.0), _rel(got.reshape(want.shape), want))
    return out


def check(cell, seed: int, device, reqs: list, picked: list, kept: dict) -> dict:
    """The worst reading of each kind over the sampled requests."""
    import torch

    strict_fp32()
    W = weights.make(harness.reference(cell).leaves(cell.model), seed, device)
    worst: dict = {}
    for i in picked:
        want_logits, want_layers = reference_outputs(cell, W, reqs[i][1])
        got_logits, got_cache, token = kept[i]
        for k, v in compare_request(cell, got_logits, got_cache, token, want_logits,
                                    want_layers).items():
            worst[k] = max(worst.get(k, 0.0), v)
        del want_layers
    del W
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return worst
