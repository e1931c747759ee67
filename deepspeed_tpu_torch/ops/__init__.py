"""Kernels of the port: CUDA C++ for Hopper with plain PyTorch twins."""
