"""Module injection of the port (counterpart of
``deepspeed_tpu/module_inject/``; weight quantization so far)."""

from .module_quantize import (QUANT_KEYS, QuantizedModel, default_predicate,
                              dequantize_tree, is_quantized_leaf, q_gather,
                              q_matmul, quantize_param_tree,
                              quantize_transformer_layer,
                              resolve_decode_params)

__all__ = ["QUANT_KEYS", "QuantizedModel", "default_predicate", "dequantize_tree",
           "is_quantized_leaf", "q_gather", "q_matmul", "quantize_param_tree",
           "quantize_transformer_layer", "resolve_decode_params"]
