"""BERT encoder with the masked-LM head: training forward and loss.

Counterpart of ``deepspeed_tpu/models/bert.py`` (26-272).  Ported:
``BertConfig``, ``PRESETS``, ``Bert.init``, ``_block`` (post-LN and
pre-LN, exact GELU, the dense attention and the block-sparse one that
``replace_model_self_attention`` attaches), ``apply``, ``mlm_logits``,
``loss``, ``num_params`` and ``flops_per_token``.

Parameters are a dict of tensors with the JAX pytree's keys and shapes
(``blocks`` stacked over layers, names of the fused transformer layer) and
the JAX ``(in, out)`` weight layout: :func:`bert_params_from_jax` converts
the JAX package's numpy parameters with no transpose.

The dense attention is JAX's, as written: scores are an einsum in the
compute dtype cast to fp32, scaled, plus the HF additive mask
(``(1 - attention_mask) * -10000``, shape (B, 1, 1, T)), softmax, dropout
on the probabilities, probabilities in the compute dtype.  On the sparse
path the (B, T) slice of that mask enters the kernels as a per-key
additive bias (``add`` mode, ``bert.py:156-160``) and attention dropout is
ignored with a warning.  The MLM head is JAX's fp32 product of fp32 casts
plus ``mlm_bias``.

Deliberate differences:

- the JAX ``lax.scan`` over stacked layers becomes a Python loop; the
  forward ``unbind``\\ s each stacked leaf once per call (indexing
  ``blocks[k][i]`` per layer would make autograd add a zero tensor of the
  whole stack per layer);
- ``init`` draws the same shapes and standard deviations (normal 0.02,
  output projections ``0.02 / sqrt(2 L)``, ones / zeros for norms and
  biases) from a ``torch.Generator`` seeded with ``rng`` (an int) on the
  model's device, not from JAX's PRNG; parity tests carry JAX's own
  weights across with :func:`bert_params_from_jax`;
- ``rng`` of ``apply``/``loss`` is an integer seed (or the engine
  step's ``FoldedSeed``, ``runtime/step_graph.py``): dropout masks come
  from generators re-seeded inside each block from a splitmix64 hash of
  (seed, layer, site), so ``remat`` (``torch.utils.checkpoint``,
  ``use_reentrant=False``, ``preserve_rng_state=False``) recomputes the
  same masks and a captured step's replay draws them too.  They cannot match
  JAX's Bernoulli bits; parity runs use dropout 0;
- ``partition_specs`` (tensor parallelism) is not ported.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .gpt2 import _dropout, _layer_norm
from ..runtime.step_graph import as_seed, fold as _fold
from ..utils.device import resolve_device
from ..utils.logging import warning_once


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    max_seq: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    intermediate_size: int = 3072
    n_layer: int = 12
    n_head: int = 12
    hidden_dropout: float = 0.1
    attn_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    pre_layer_norm: bool = False      # classic BERT is post-LN
    remat: bool = True

    @property
    def head_dim(self):
        if self.hidden_size % self.n_head:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible by "
                             f"n_head {self.n_head}")
        return self.hidden_size // self.n_head


PRESETS = {
    "bert-base": dict(hidden_size=768, n_layer=12, n_head=12, intermediate_size=3072),
    "bert-large": dict(hidden_size=1024, n_layer=24, n_head=16, intermediate_size=4096),
    "bert-tiny": dict(hidden_size=128, n_layer=4, n_head=4, intermediate_size=512,
                      vocab_size=1024, max_seq=128),
}

_TOP_KEYS = ("word_embeddings", "position_embeddings", "token_type_embeddings",
             "emb_ln_scale", "emb_ln_bias", "mlm_dense_w", "mlm_dense_b",
             "mlm_ln_scale", "mlm_ln_bias", "mlm_bias")
_BLOCK_KEYS = ("attn_qkvw", "attn_qkvb", "attn_ow", "attn_ob", "attn_nw", "attn_nb",
               "inter_w", "inter_b", "output_w", "output_b", "norm_w", "norm_b")


def bert_params_from_jax(np_params, device, dtype=torch.float32):
    """The JAX ``Bert.init`` pytree as numpy arrays -> the port's
    parameters: the same keys, stacked ``blocks`` shapes and ``(in, out)``
    layouts, as tensors of ``dtype`` on ``device``."""
    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(
            device=device, dtype=dtype)
    out = {k: conv(np_params[k]) for k in _TOP_KEYS}
    out["blocks"] = {k: conv(np_params["blocks"][k]) for k in _BLOCK_KEYS}
    return out


class Bert:
    """Bidirectional encoder with an MLM head over a params dict (see the
    module docstring).  ``dtype`` is the compute dtype; ``device``
    defaults to CUDA and raises when there is none (pass ``device="cpu"``
    for the plain path)."""

    def __init__(self, config: Optional[BertConfig] = None, preset: Optional[str] = None,
                 dtype=torch.bfloat16, device=None, **overrides):
        if config is None:
            base = dict(PRESETS[preset or "bert-base"])
            base.update(overrides)
            config = BertConfig(**base)
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        # set by sparse_attention_utils.replace_model_self_attention; blocks
        # then route attention through the block-sparse kernels
        self.sparse_self_attention = None

    # ------------------------------------------------------------------ init
    def init(self, rng=0):
        """fp32 parameters on the model's device, drawn from a generator
        seeded with ``rng`` (JAX ``Bert.init``'s shapes and scales)."""
        c = self.config
        D, I, L = c.hidden_size, c.intermediate_size, c.n_layer
        dev = self.device
        g = torch.Generator(device=dev)
        g.manual_seed(int(rng))
        std = 0.02
        out_std = std / math.sqrt(2.0 * L)   # adjust_init_range semantics

        def n(shape, s=std):
            return torch.randn(shape, generator=g, device=dev) * s

        zeros = lambda *shape: torch.zeros(shape, device=dev)
        ones = lambda *shape: torch.ones(shape, device=dev)
        return {
            "word_embeddings": n((c.vocab_size, D)),
            "position_embeddings": n((c.max_seq, D)),
            "token_type_embeddings": n((c.type_vocab_size, D)),
            "emb_ln_scale": ones(D),
            "emb_ln_bias": zeros(D),
            "blocks": {
                "attn_qkvw": n((L, D, 3 * D)),
                "attn_qkvb": zeros(L, 3 * D),
                "attn_ow": n((L, D, D), out_std),
                "attn_ob": zeros(L, D),
                "attn_nw": ones(L, D),
                "attn_nb": zeros(L, D),
                "inter_w": n((L, D, I)),
                "inter_b": zeros(L, I),
                "output_w": n((L, I, D), out_std),
                "output_b": zeros(L, D),
                "norm_w": ones(L, D),
                "norm_b": zeros(L, D),
            },
            # MLM transform head (dense + LN; decoder tied to word embeddings)
            "mlm_dense_w": n((D, D)),
            "mlm_dense_b": zeros(D),
            "mlm_ln_scale": ones(D),
            "mlm_ln_bias": zeros(D),
            "mlm_bias": zeros(c.vocab_size),
        }

    # --------------------------------------------------------------- forward
    def _block(self, x, p, mask, seed, deterministic):
        c = self.config
        B, T, D = x.shape
        H, hd = c.n_head, c.head_dim
        r1, r2, r3 = (_fold(seed, site) for site in range(3))

        def attention(h):
            qkv = h @ p["attn_qkvw"].to(h.dtype) + p["attn_qkvb"].to(h.dtype)
            # views of the fused product: the kernels read them through strides
            q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(D, dim=-1))
            if self.sparse_self_attention is not None:
                if c.attn_dropout > 0.0 and not deterministic:
                    warning_once("sparse attention has no in-kernel dropout; "
                                 "attn_dropout is ignored on this path")
                # the (B,1,1,T) additive BERT mask enters the kernels as a
                # per-key additive bias (mode 'add')
                kp = mask[:, 0, 0, :] if mask is not None else None
                ctx = self.sparse_self_attention(q, k, v, causal=False,
                                                 key_padding_mask=kp).reshape(B, T, D)
            else:
                scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
                scores = scores / math.sqrt(hd)
                if mask is not None:
                    scores = scores + mask.float()
                probs = torch.softmax(scores, dim=-1)
                probs = _dropout(probs, c.attn_dropout, r1, deterministic).to(h.dtype)
                ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, D)
            out = ctx @ p["attn_ow"].to(h.dtype) + p["attn_ob"].to(h.dtype)
            return _dropout(out, c.hidden_dropout, r2, deterministic)

        def mlp(h):
            inter = h @ p["inter_w"].to(h.dtype) + p["inter_b"].to(h.dtype)
            inter = F.gelu(inter)
            out = inter @ p["output_w"].to(h.dtype) + p["output_b"].to(h.dtype)
            return _dropout(out, c.hidden_dropout, r3, deterministic)

        eps = c.layer_norm_eps
        if c.pre_layer_norm:
            x = x + attention(_layer_norm(x, p["attn_nw"], p["attn_nb"], eps))
            x = x + mlp(_layer_norm(x, p["norm_w"], p["norm_b"], eps))
        else:
            x = _layer_norm(x + attention(x), p["attn_nw"], p["attn_nb"], eps)
            x = _layer_norm(x + mlp(x), p["norm_w"], p["norm_b"], eps)
        return x

    def apply(self, params, input_ids, attention_mask=None, token_type_ids=None, rng=None,
              deterministic=True):
        """input_ids: (B, T) int; attention_mask: (B, T) 1/0 -> encoder
        hidden states (B, T, D) in the compute dtype.  ``rng`` is an integer
        dropout seed (0 when None)."""
        c = self.config
        B, T = input_ids.shape
        if T > c.max_seq:
            raise ValueError(f"sequence length {T} exceeds max_seq {c.max_seq}")
        seed = as_seed(rng)
        dtype = self.dtype
        pos = torch.arange(T, device=input_ids.device)
        tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
        x = (params["word_embeddings"].to(dtype)[input_ids]
             + params["position_embeddings"].to(dtype)[pos]
             + params["token_type_embeddings"].to(dtype)[tt])
        x = _layer_norm(x, params["emb_ln_scale"], params["emb_ln_bias"], c.layer_norm_eps)
        x = _dropout(x, c.hidden_dropout, _fold(seed, 17), deterministic)

        # HF additive mask convention: (B, 1, 1, T), 0 keep / -10000 drop
        add_mask = None
        if attention_mask is not None:
            add_mask = ((1.0 - attention_mask.float()) * -10000.0)[:, None, None, :]

        # one unbind per stacked leaf: its backward is a single stack
        layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
        layer_seed = _fold(seed, 31)
        for i in range(c.n_layer):
            lp = {k: v[i] for k, v in layers.items()}
            args = (x, lp, add_mask, _fold(layer_seed, i), deterministic)
            # preserve_rng_state=False: as GPT-2's (models/gpt2.py)
            x = (checkpoint(self._block, *args, use_reentrant=False,
                            preserve_rng_state=False) if c.remat
                 else self._block(*args))
        return x

    def mlm_logits(self, params, hidden):
        """MLM head: dense -> gelu -> LN -> tied decoder + bias, the decoder
        an fp32 product of fp32 casts (B, T, V)."""
        h = hidden @ params["mlm_dense_w"].to(hidden.dtype) \
            + params["mlm_dense_b"].to(hidden.dtype)
        h = F.gelu(h)
        h = _layer_norm(h, params["mlm_ln_scale"], params["mlm_ln_bias"],
                        self.config.layer_norm_eps)
        return torch.einsum("btd,vd->btv", h.float(),
                            params["word_embeddings"].float()) + params["mlm_bias"]

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, rng=None):
        """Masked-LM loss.  ``batch``: dict with 'input_ids', optional
        'attention_mask' and 'token_type_ids', 'labels' (-100 = ignored, HF
        convention), or an ``(input_ids, labels)`` tuple."""
        if isinstance(batch, (tuple, list)):
            batch = {"input_ids": batch[0], "labels": batch[1]}
        labels = batch["labels"]
        hidden = self.apply(params, batch["input_ids"],
                            attention_mask=batch.get("attention_mask"),
                            token_type_ids=batch.get("token_type_ids"),
                            rng=rng, deterministic=False)
        logits = self.mlm_logits(params, hidden)
        valid = labels >= 0
        safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
        ll = (torch.gather(logits, -1, safe[..., None])[..., 0]
              - torch.logsumexp(logits, dim=-1))
        denom = valid.sum().clamp(min=1)
        return -torch.where(valid, ll, torch.zeros_like(ll)).sum() / denom

    # ----------------------------------------------------------- flop counts
    def num_params(self):
        c = self.config
        D, I = c.hidden_size, c.intermediate_size
        per_layer = (3 * D * D + D * D + 2 * D * I  # qkv, attn_ow, inter, output
                     + 3 * D + D + I + D            # their biases
                     + 4 * D)                       # 2 LayerNorms
        emb = (c.vocab_size + c.max_seq + c.type_vocab_size) * D + 2 * D
        head = D * D + D + 2 * D + c.vocab_size     # dense + LN + tied bias
        return emb + c.n_layer * per_layer + head

    def flops_per_token(self):
        """Training FLOPs/token = 6N + 12·L·D·T: the attention term counts
        dense attention at ``max_seq`` (JAX's accounting)."""
        c = self.config
        return 6 * self.num_params() + 12 * c.n_layer * c.hidden_size * c.max_seq
