"""Kernels of the serving path (each a plain version plus a CUDA kernel)."""
