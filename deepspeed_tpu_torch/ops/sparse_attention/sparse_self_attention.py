"""SparseSelfAttention: attention bound to one block-sparsity layout.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(30-144): ``SparseSelfAttention`` (``get_layout``, ``density``,
``__call__``, ``_to_additive``, the ``_masked_dense`` oracle) and
``BertSparseSelfAttention``.  Calls go to
``ops/transformer/flash_attention.py:sparse_flash_attention``, whose tile
LUTs drive the CUDA kernels; ``key_padding_mask`` (B, T) and ``attn_mask``
(T, T) enter the kernels as additive fp32 biases, in ``add`` mode as they
are and in ``mul`` mode (0 = masked) as 0 / ``NEG_INF``.

Differences: masks and tensors are torch tensors (numpy arrays are
accepted); ``max_seq_length`` is checked with ``ValueError`` in place of
``assert``.
"""

import math

import numpy as np
import torch

from .sparsity_config import FixedSparsityConfig
from ..transformer.flash_attention import NEG_INF, sparse_flash_attention


class SparseSelfAttention:
    """Callable attention op bound to one sparsity layout.

    ``attn = SparseSelfAttention(config); out = attn(q, k, v)`` with
    q/k/v shaped (B, T, H, d), as :func:`flash_attention` takes them."""

    def __init__(self, sparsity_config=None, key_padding_mask_mode="add",
                 attn_mask_mode="mul", max_seq_length=2048):
        self.sparsity_config = sparsity_config or FixedSparsityConfig(num_heads=4)
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        self._layout_cache = {}

    def get_layout(self, seq_len):
        """The host int32 layout at ``seq_len`` (built once per length)."""
        if seq_len not in self._layout_cache:
            self._layout_cache[seq_len] = np.asarray(
                self.sparsity_config.make_layout(seq_len), np.int32)
        return self._layout_cache[seq_len]

    def density(self, seq_len):
        layout = self.get_layout(seq_len)
        return float(layout.sum()) / layout[0].size / layout.shape[0]

    def _causal(self, causal):
        if causal is None and hasattr(self.sparsity_config, "attention"):
            return self.sparsity_config.attention == "unidirectional"
        return bool(causal)

    def __call__(self, query, key, value, *, causal=None, sm_scale=None,
                 key_padding_mask=None, attn_mask=None):
        T = query.shape[1]
        if T > self.max_seq_length:
            raise ValueError(f"seq_len {T} exceeds max_seq_length {self.max_seq_length}")
        kb = self._to_additive(key_padding_mask, self.key_padding_mask_mode, query)
        ab = self._to_additive(attn_mask, self.attn_mask_mode, query)
        return sparse_flash_attention(query, key, value, self.get_layout(T),
                                      causal=self._causal(causal), sm_scale=sm_scale,
                                      key_padding_bias=kb, attn_bias=ab)

    @staticmethod
    def _to_additive(mask, mode, like):
        """'add' masks are already additive scores; 'mul' masks (0 = masked)
        become 0 / NEG_INF biases for the kernels.  fp32 on ``like``'s
        device."""
        if mask is None:
            return None
        mask = torch.as_tensor(mask, device=like.device)
        if mode == "add":
            return mask.float()
        return torch.where(mask != 0, 0.0, NEG_INF).float()

    def _masked_dense(self, q, k, v, layout, causal, sm_scale, key_padding_mask,
                      attn_mask):
        """Dense path with layout + user masks (the numerics oracle): the
        layout expanded with ``kron``, ``-inf`` masking, softmax, fully
        masked rows 0, probabilities in the input dtype."""
        B, T, H, d = q.shape
        layout = torch.as_tensor(np.asarray(layout), device=q.device).float()
        Lh, nq, nk = layout.shape
        if sm_scale is None:
            sm_scale = 1.0 / math.sqrt(d)
        mask = torch.kron(layout, torch.ones((1, T // nq, T // nk), device=q.device)) > 0
        if causal:
            mask = mask & torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
        s = torch.where(mask[None], s, torch.full_like(s, -math.inf))
        if attn_mask is not None:
            am = torch.as_tensor(attn_mask, device=q.device)[None, None]
            if self.attn_mask_mode == "add":
                s = s + am.float()
            else:
                s = torch.where(am != 0, s, torch.full_like(s, -math.inf))
        if key_padding_mask is not None:
            kp = torch.as_tensor(key_padding_mask, device=q.device)[:, None, None, :]
            if self.key_padding_mask_mode == "add":
                s = s + kp.float()
            else:
                s = torch.where(kp != 0, s, torch.full_like(s, -math.inf))
        p = torch.softmax(s, dim=-1)
        p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


class BertSparseSelfAttention:
    """BERT-shaped wrapper: hidden states + projection params -> the
    attention context (reference ``bert_sparse_self_attention.py:78``)."""

    def __init__(self, num_attention_heads, hidden_size, sparsity_config=None):
        if hidden_size % num_attention_heads:
            raise ValueError("hidden_size must be a multiple of num_attention_heads")
        self.num_heads = num_attention_heads
        self.hidden_size = hidden_size
        self.head_dim = hidden_size // num_attention_heads
        self.attn = SparseSelfAttention(
            sparsity_config or FixedSparsityConfig(num_heads=num_attention_heads))

    def __call__(self, hidden, params, key_padding_mask=None):
        """params: {'q_w','q_b','k_w','k_b','v_w','v_b'} (``(in, out)``
        weights)."""
        B, T, D = hidden.shape
        proj = lambda w, b: (hidden @ w + b).reshape(B, T, self.num_heads, self.head_dim)
        q = proj(params["q_w"], params["q_b"])
        k = proj(params["k_w"], params["k_b"])
        v = proj(params["v_w"], params["v_b"])
        ctx = self.attn(q, k, v, causal=False, key_padding_mask=key_padding_mask)
        return ctx.reshape(B, T, D)
