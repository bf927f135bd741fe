"""PaxosLease on PyTorch and CUDA: the port of ``repro`` for NVIDIA Hopper.

``repro_torch.lease_array`` is the vectorized lease plane — the same
scenarios, engine and results as ``repro.lease_array``, with the TPU window
kernels replaced by hand-written CUDA kernels for the H100. It imports
torch and numpy only; the reference package is never imported here.
"""
