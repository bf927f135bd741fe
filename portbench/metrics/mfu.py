"""Model FLOPs of the untraced window (``pbench.flops``: a training step's
times the steps, or every prefill request's) over the window's time, as a
share of one H100's bf16 peak. Reads ``mfu.<kind>``."""
from pbench import flops


def read(ctx):
    m = ctx["model"]
    if ctx["kind"] == "train":
        done = flops.train_step_flops(m, ctx["rows"], ctx["seq"]) * ctx["steps"]
    else:
        done = sum(flops.prefill_flops(m, n) for n in ctx["lengths"])
    if not done:
        return None
    return 100.0 * done / (ctx["window_s"] * flops.PEAK_BF16_FLOPS)
