"""Adagrad of the port (counterpart of ``deepspeed_tpu/ops/adagrad``)."""
