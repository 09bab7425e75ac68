"""Operators of the port: plain attention and the CUDA attention kernels."""
