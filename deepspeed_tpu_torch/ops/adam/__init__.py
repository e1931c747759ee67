"""Adam optimizers of the port (counterpart of ``deepspeed_tpu/ops/adam``):
``fused_adam`` on the device, ``cpu_adam`` on the host (the offload tier's
native step)."""
