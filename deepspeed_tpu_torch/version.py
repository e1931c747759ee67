"""Version of the deepspeed_tpu_torch port (counterpart of
``deepspeed_tpu/version.py``; the port tracks the JAX package's version)."""

__version__ = "0.1.0"
