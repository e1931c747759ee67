"""The NVMe tier's swap plumbing (counterpart of ``deepspeed_tpu/runtime/swap_tensor``)."""
