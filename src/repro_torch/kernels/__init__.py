"""Hand-written CUDA kernels of the LM data plane and their plain versions."""
