"""The bf16 WKV6 forward's share of its roofline over a traced pass of
prefill requests: the least time at each request's shapes, every layer,
from a zero initial state as prefill passes one (``pbench.flops.wkv6_fwd_ms``),
over the kernel's device time by name."""
from pbench import flops

KERNEL = "wkv6_mma_kernel"


def read(ctx):
    tr, m = ctx["trace"], ctx["model"]
    if ctx["kind"] != "prefill" or tr is None or not m.get("attention_free"):
        return None
    spent = tr.kernel_s(lambda name: KERNEL in name)
    if spent <= 0:
        return None
    n = m["rwkv"]["head_size"]
    least = sum(m["n_layers"] * flops.wkv6_fwd_ms(m["d_model"] // n, s, n, True)
                for s in tr.extra["lengths"]) / 1e3
    return 100.0 * least / spent
