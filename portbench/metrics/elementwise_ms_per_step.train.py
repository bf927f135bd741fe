"""Device ms a traced training step in PyTorch's own kernels (every kernel
of the ``at::native`` namespace: elementwise, reductions, copies, indexing,
the foreach optimiser loops), from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None or not tr.kernels:
        return None
    return 1e3 * tr.kernel_s(lambda name: "at::native::" in name) / tr.units
