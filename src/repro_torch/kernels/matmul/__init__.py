"""Blocked matmul: the CUDA counterpart of ``repro.kernels.matmul``."""
