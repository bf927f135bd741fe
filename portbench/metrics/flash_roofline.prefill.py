"""The flash forward's share of its roofline over a traced pass of prefill
requests: the least time at each request's shapes, every layer
(``pbench.flops.flash_fwd_ms``), over the kernel's device time by name."""
from pbench import flops

KERNEL = "flash_wgmma_kernel"


def read(ctx):
    tr, m = ctx["trace"], ctx["model"]
    if ctx["kind"] != "prefill" or tr is None or m.get("attention_free"):
        return None
    spent = tr.kernel_s(lambda name: KERNEL in name)
    if spent <= 0:
        return None
    least = sum(m["n_layers"] * flops.flash_fwd_ms(m["n_heads"], m["n_kv_heads"], n, m["d_head"])
                for n in tr.extra["lengths"]) / 1e3
    return 100.0 * least / spent
