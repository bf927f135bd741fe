"""Device kernels a traced training step (copies and fills not counted),
from the profiler's trace."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "train" or tr is None or not tr.kernels:
        return None
    return tr.launches() / tr.units
