"""The flash backward's share of its roofline in a traced training step: the
least time of its three kernels (D, dK/dV, dQ) at every microbatch's shapes
(``pbench.flops.flash_bwd_ms``) over their device time, by kernel name."""
from pbench import flops

KERNELS = ("bwd_pre_kernel", "bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel")


def read(ctx):
    tr, m = ctx["trace"], ctx["model"]
    if ctx["kind"] != "train" or tr is None or m.get("attention_free"):
        return None
    spent = tr.kernel_s(lambda name: any(k in name for k in KERNELS))
    if spent <= 0:
        return None
    mb = ctx["microbatch_rows"]
    calls = m["n_layers"] * ctx["rows"] // mb * tr.units
    least = calls * flops.flash_bwd_ms(mb * m["n_heads"], mb * m["n_kv_heads"], ctx["seq"],
                                       m["d_head"]) / 1e3
    return 100.0 * least / spent
