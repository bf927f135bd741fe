"""The WKV6 backward's share of its roofline in a traced training step: the
least time of its three passes (state, chunk, sum) at every microbatch's
shapes (``pbench.flops.wkv6_bwd_ms``) over their device time, by name."""
from pbench import flops

KERNELS = ("wkv6_bwd_state_kernel", "wkv6_bwd_chunk_kernel", "wkv6_bwd_sum_kernel")


def read(ctx):
    tr, m = ctx["trace"], ctx["model"]
    if ctx["kind"] != "train" or tr is None or not m.get("attention_free"):
        return None
    spent = tr.kernel_s(lambda name: any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    mb, n = ctx["microbatch_rows"], m["rwkv"]["head_size"]
    calls = m["n_layers"] * ctx["rows"] // mb * tr.units
    least = calls * flops.wkv6_bwd_ms(mb * m["d_model"] // n, ctx["seq"], n) / 1e3
    return 100.0 * least / spent
