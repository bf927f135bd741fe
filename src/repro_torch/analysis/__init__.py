"""Static analysis of the port (``staticcheck``: leaselint for the CUDA
lease kernels and the port's conventions)."""
