"""Model-level sparse-attention helpers.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``
(20-80): ``replace_model_self_attention`` (attach a
:class:`SparseSelfAttention` to a model whose blocks dispatch on it, the
BERT family), ``extend_position_embedding`` (tile the learned position
table to a longer maximum length), ``pad_to_block_size`` and
``unpad_sequence_output``.

Difference: parameters are tensors, so ``extend_position_embedding``
tiles the table with ``torch`` on its own device and dtype.  The pad
helpers work on host arrays, as JAX's do.
"""

import numpy as np

from .sparse_self_attention import SparseSelfAttention
from ...utils.logging import log_dist


def replace_model_self_attention(model, sparsity_config, max_seq_length=None):
    """Attach block-sparse attention to a framework model (Bert family).

    Returns the same model object with ``sparse_self_attention`` set; its
    blocks route attention through the block-sparse kernels."""
    sa = SparseSelfAttention(
        sparsity_config,
        max_seq_length=max_seq_length or getattr(model.config, "max_seq", 2048))
    if not hasattr(model, "sparse_self_attention"):
        # only models that pre-declare the attribute dispatch on it
        raise TypeError(
            f"{type(model).__name__} does not support sparse attention "
            "(no sparse_self_attention dispatch in its blocks)")
    model.sparse_self_attention = sa
    log_dist(f"sparse attention attached: mode="
             f"{type(sparsity_config).__name__} block={sparsity_config.block} "
             f"density@512={sa.density(512):.3f}", ranks=[0])
    return model


def extend_position_embedding(params, model, new_max_seq):
    """Stretch learned position embeddings by tiling (the trained
    positions repeat to cover the longer length).  Returns ``(params,
    model)`` with ``model.config.max_seq`` updated."""
    key = "position_embeddings" if "position_embeddings" in params else "wpe"
    wpe = params[key]
    old = wpe.shape[0]
    if new_max_seq <= old:
        raise ValueError("new_max_seq must exceed the current table")
    reps = -(-new_max_seq // old)
    params = dict(params)
    params[key] = wpe.repeat(reps, 1)[:new_max_seq].contiguous()
    model.config.max_seq = new_max_seq
    log_dist(f"position embeddings extended {old} → {new_max_seq}", ranks=[0])
    return params, model


def pad_to_block_size(block_size, input_ids, attention_mask=None, token_type_ids=None,
                      pad_token_id=0):
    """Right-pad token inputs to a block multiple (layouts are defined on
    block-aligned sequences).  Returns ``(pad_len, input_ids,
    attention_mask, token_type_ids)``."""
    B, T = np.shape(input_ids)
    pad_len = (-T) % block_size
    if pad_len == 0:
        return 0, input_ids, attention_mask, token_type_ids
    pad = lambda x, val: np.concatenate(
        [np.asarray(x), np.full((B, pad_len), val, np.asarray(x).dtype)], axis=1)
    input_ids = pad(input_ids, pad_token_id)
    if attention_mask is not None:
        attention_mask = pad(attention_mask, 0)
    if token_type_ids is not None:
        token_type_ids = pad(token_type_ids, 0)
    return pad_len, input_ids, attention_mask, token_type_ids


def unpad_sequence_output(pad_len, sequence_output):
    """Drop the padded tail added by :func:`pad_to_block_size`."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]
