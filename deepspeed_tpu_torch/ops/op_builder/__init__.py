"""Builders for the port's native code: ``cuda.py`` (nvcc + ctypes, the
CUDA kernels of ``deepspeed_tpu_torch/csrc``) and ``builder.py`` (g++ +
ctypes, the repo's host ops of ``csrc/``)."""
