"""Builders for the port's native kernels (``cuda.py``: nvcc + ctypes)."""
