"""Groupwise quantizer of the port (counterpart of
``deepspeed_tpu/ops/quantizer/``)."""

from .quantizer import Quantizer, dequantize, quantize

__all__ = ["Quantizer", "quantize", "dequantize"]
