"""A step's FLOPs, counted (the port's counterpart of ``cost_analysis()``).

The reference reads XLA's ``Compiled.cost_analysis()``. The port has no
compiler to ask, so it runs the step under
``torch.utils.flop_counter.FlopCounterMode`` and counts what its matrix
products, convolutions and attention calls do. On ``meta`` tensors the run
allocates nothing and computes nothing (the kernels' wrappers take their
plain versions there, as on the CPU), so a full-size step counts in
seconds on the host; on CPU tensors it also computes. Elementwise work is
not counted, as XLA's ``flops`` counts it at about one a element.
"""
from __future__ import annotations


def cost_analysis_dict(fn, *args, **kwargs) -> dict:
    """``fn(*args, **kwargs)``'s FLOPs as a flat dict, ``{"flops": ...}``,
    the key the reference's dry-run artifacts and roofline checks read."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops())}
