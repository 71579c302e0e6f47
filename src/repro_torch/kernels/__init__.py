"""Kernels of the port: each CUDA kernel beside its plain PyTorch version."""
