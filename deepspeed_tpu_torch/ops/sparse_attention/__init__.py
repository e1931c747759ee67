"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``)."""

from .sparsity_config import (SparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, VariableSparsityConfig,
                              BigBirdSparsityConfig, BSLongformerSparsityConfig,
                              build_sparsity_config)
from .sparse_self_attention import SparseSelfAttention, BertSparseSelfAttention
from .sparse_attention_utils import (replace_model_self_attention,
                                     extend_position_embedding,
                                     pad_to_block_size, unpad_sequence_output)
