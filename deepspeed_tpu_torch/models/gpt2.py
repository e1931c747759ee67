"""GPT-2 family for serving: prefill through a contiguous KV cache and
paged-KV decode.

Counterpart of ``deepspeed_tpu/models/gpt2.py``.  Ported: ``GPT2Config``,
``PRESETS``, ``_layer_norm`` (fp32 statistics, population variance),
``GPT2.init_numpy``, ``init_cache`` + ``apply_with_cache`` (the ``fused``
seq-major cache path only — the serving prefill), ``_qkv``,
``_masked_attend``, ``_attend_cached``, ``_ffn``, ``paged_attention_impl``
and ``decode_step_paged`` with its ``kernel|gather`` switch.  GELU is the
tanh approximation, as ``jax.nn.gelu(approximate=True)``.

Parameters are a dict of tensors with the JAX pytree's keys and shapes
(``wte``, ``wpe``, ``blocks`` stacked over layers, ``lnf_*``) and the JAX
``(in, out)`` weight layout: :func:`params_from_jax` converts the JAX
package's numpy parameters with no transpose.

Deliberate differences:

- the JAX ``lax.scan`` over stacked layers becomes a Python loop over
  layers (CUDA graphs come later);
- the KV cache and the pool are updated in place (JAX threads new arrays
  through donation);
- JAX clamps out-of-range gathers; the position clamp
  ``min(lengths + w, max_seq - 1)`` of ``decode_step_paged`` is explicit;
- the tied head is a matmul in the compute dtype whose result is cast to
  fp32 (JAX accumulates in fp32 and keeps the fp32 result; identical in
  fp32, rounded to bf16 in a bf16 model);
- ``paged_attention_mode`` (``auto|online|exact``) picks the CUDA kernel
  on the ``kernel`` path; JAX picks by backend;
- the ``gather`` path calls ``paged_attention_reference`` (``gather_kv``
  + ``_masked_attend``'s math, the kernels' plain version) in place of
  ``GPT2._attend_paged``;
- training (``apply``, ``loss``, remat, flash attention), int8 weights,
  tensor parallelism and the GPT-Neo knobs are not ported.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_seq: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_eps: float = 1e-5
    # serving decode attention: "kernel" (the paged-attention kernels,
    # reading K/V in place) | "gather" (gather_kv + _masked_attend, the
    # oracle) | "auto" (= "kernel")
    paged_attention_impl: str = "auto"
    # which kernel "kernel" launches on CUDA: "auto" (= "online") |
    # "online" | "exact" (mirrors _masked_attend op for op)
    paged_attention_mode: str = "auto"
    scale_attn: bool = True

    @property
    def head_dim(self):
        if self.n_embd % self.n_head:
            raise ValueError(f"n_embd {self.n_embd} not divisible by "
                             f"n_head {self.n_head}")
        return self.n_embd // self.n_head


PRESETS = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=32),
    "gpt2-tiny": dict(n_embd=128, n_layer=4, n_head=4, vocab_size=1024,
                      max_seq=256),
}

_BLOCK_KEYS = ("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w", "proj_b",
               "ln2_scale", "ln2_bias", "fc_w", "fc_b", "fc_proj_w",
               "fc_proj_b")


def _layer_norm(x, scale, bias, eps):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def params_from_jax(np_params, device, dtype=torch.float32):
    """The JAX parameter pytree as numpy arrays (``GPT2.init_numpy`` or
    the leaves of ``GPT2.init``) → the port's parameters: the same keys,
    stacked ``blocks`` shapes and ``(in, out)`` layouts, as tensors of
    ``dtype`` on ``device``."""
    def conv(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a))).to(
            device=device, dtype=dtype)
    return {"wte": conv(np_params["wte"]), "wpe": conv(np_params["wpe"]),
            "blocks": {k: conv(np_params["blocks"][k]) for k in _BLOCK_KEYS},
            "lnf_scale": conv(np_params["lnf_scale"]),
            "lnf_bias": conv(np_params["lnf_bias"])}


def _layer(blocks, i):
    return {k: v[i] for k, v in blocks.items()}


class GPT2:
    """Decoder-only LM over a params dict (see module docstring).

    ``dtype`` is the compute dtype; ``device`` defaults to CUDA and
    raises when there is none (pass ``device="cpu"`` for the plain
    path)."""

    def __init__(self, config: Optional[GPT2Config] = None,
                 preset: Optional[str] = None, dtype=torch.bfloat16,
                 device=None, **overrides):
        if config is None:
            base = dict(PRESETS[preset or "gpt2-125m"])
            base.update(overrides)
            config = GPT2Config(**base)
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init_numpy(self, seed=0):
        """Host numpy parameters, the same draws as the JAX
        ``GPT2.init_numpy(seed)`` (normal(0.02), output projections
        scaled by 1/sqrt(2L), wpe std 0.01)."""
        c = self.config
        D, L, V, T = c.n_embd, c.n_layer, c.vocab_size, c.max_seq
        rng = np.random.default_rng(seed)
        std = 0.02
        proj_std = std / np.sqrt(2.0 * L)
        n = lambda shape, s=std: rng.normal(0.0, s, shape).astype(np.float32)
        return {
            "wte": n((V, D)),
            "wpe": n((T, D), 0.01),
            "blocks": {
                "ln1_scale": np.ones((L, D), np.float32),
                "ln1_bias": np.zeros((L, D), np.float32),
                "qkv_w": n((L, D, 3 * D)),
                "qkv_b": np.zeros((L, 3 * D), np.float32),
                "proj_w": n((L, D, D), proj_std),
                "proj_b": np.zeros((L, D), np.float32),
                "ln2_scale": np.ones((L, D), np.float32),
                "ln2_bias": np.zeros((L, D), np.float32),
                "fc_w": n((L, D, 4 * D)),
                "fc_b": np.zeros((L, 4 * D), np.float32),
                "fc_proj_w": n((L, 4 * D, D), proj_std),
                "fc_proj_b": np.zeros((L, D), np.float32),
            },
            "lnf_scale": np.ones((D,), np.float32),
            "lnf_bias": np.zeros((D,), np.float32),
        }

    def init_params(self, seed=0):
        """``params_from_jax(init_numpy(seed))`` on this model's device
        and dtype."""
        return params_from_jax(self.init_numpy(seed), self.device, self.dtype)

    # ----------------------------------------------------------- layer parts
    @staticmethod
    def _mm(h, w, b=None):
        out = h @ w.to(h.dtype)
        if b is not None:
            out = out + b.to(out.dtype)
        return out

    def _qkv(self, p, h):
        c = self.config
        B, T, _ = h.shape
        H, hd = c.n_head, c.head_dim
        q, k, v = self._mm(h, p["qkv_w"], p["qkv_b"]).chunk(3, dim=-1)
        return (q.reshape(B, T, H, hd), k.reshape(B, T, H, hd),
                v.reshape(B, T, H, hd))

    def _masked_attend(self, q, keys, vals, valid, seq_major=False):
        """The attention core shared by every cache layout: scores in the
        input dtype, fp32, scale, mask with finfo(f32).min, softmax,
        probabilities in the input dtype, AV.  ``valid`` broadcasts to
        (B, H, T, S)."""
        c = self.config
        B, T = q.shape[0], q.shape[1]
        k_eq = "kbhd" if seq_major else "bkhd"
        scores = torch.einsum(f"bqhd,{k_eq}->bhqk", q, keys).float()
        if c.scale_attn:
            scores = scores / math.sqrt(c.head_dim)
        scores = torch.where(valid, scores, torch.full_like(
            scores, torch.finfo(torch.float32).min))
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum(f"bhqk,{k_eq}->bqhd", probs, vals).reshape(
            B, T, q.shape[2] * q.shape[3])

    def _attend_cached(self, q, cache_k, cache_v, index, seq_major=False):
        """Contiguous-cache attention: causal mask from the write
        ``index``, then :meth:`_masked_attend`."""
        T = q.shape[1]
        S = cache_k.shape[0] if seq_major else cache_k.shape[1]
        q_pos = index + torch.arange(T, device=q.device)[:, None]
        k_pos = torch.arange(S, device=q.device)[None, :]
        valid = k_pos <= q_pos
        return self._masked_attend(q, cache_k, cache_v, valid[None, None],
                                   seq_major=seq_major)

    def _ffn(self, p, x):
        """LN2 → fc → gelu(tanh) → fc_proj, plus the residual."""
        c = self.config
        h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"], c.layer_norm_eps)
        h = F.gelu(self._mm(h, p["fc_w"], p["fc_b"]), approximate="tanh")
        return x + self._mm(h, p["fc_proj_w"], p["fc_proj_b"])

    def _head(self, params, x):
        return (x @ params["wte"].to(x.dtype).t()).float()

    # ------------------------------------------------------- KV-cache decode
    def init_cache(self, batch_size: int, max_len: Optional[int] = None,
                   dtype=None):
        """Empty seq-major cache ``{"k", "v": (L, S, B, H, hd), "index"}``
        (the JAX ``fused`` layout; ``index`` is a host int)."""
        c = self.config
        max_len = max_len or c.max_seq
        if max_len > c.max_seq:
            raise ValueError(f"init_cache max_len={max_len} exceeds "
                             f"config.max_seq={c.max_seq}")
        shape = (c.n_layer, max_len, batch_size, c.n_head, c.head_dim)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "index": 0}

    def apply_with_cache(self, params, tokens, cache):
        """Forward ``tokens`` (B, T) from ``cache["index"]``; returns
        ``(logits (B, T, V) fp32, cache)`` with the cache updated in
        place and its index advanced by T."""
        c = self.config
        B, T = tokens.shape
        index = int(cache["index"])
        if index + T > cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                             f"cannot take {T} tokens at index {index}")
        pos = torch.arange(index, index + T, device=tokens.device)
        x = (params["wte"].to(self.dtype)[tokens]
             + params["wpe"].to(self.dtype)[pos])
        for i in range(c.n_layer):
            p = _layer(params["blocks"], i)
            h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
            q, k, v = self._qkv(p, h)
            ck, cv = cache["k"][i], cache["v"][i]          # (S, B, H, hd)
            ck[index:index + T] = k.transpose(0, 1).to(ck.dtype)
            cv[index:index + T] = v.transpose(0, 1).to(cv.dtype)
            attn = self._attend_cached(q, ck, cv, index, seq_major=True)
            x = self._ffn(p, x + self._mm(attn, p["proj_w"], p["proj_b"]))
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                        c.layer_norm_eps)
        cache["index"] = index + T
        return self._head(params, x), cache

    # ---------------------------------------------------- paged-KV decode
    def paged_attention_impl(self) -> str:
        """Resolve ``config.paged_attention_impl`` ("auto" → "kernel")."""
        impl = self.config.paged_attention_impl
        if impl == "auto":
            impl = "kernel"
        if impl not in ("kernel", "gather"):
            raise ValueError(f"paged_attention_impl must be auto|kernel|gather,"
                             f" got {impl!r}")
        return impl

    def decode_step_paged(self, params, toks, pool, block_tables, lengths):
        """One decode window for B slots over the paged pool.

        ``toks``: (B,) or (B, W) int tokens at positions ``lengths + w``;
        ``lengths``: (B,) int32 tokens already cached per slot;
        ``block_tables``: (B, nb_max) int32 (unused entries point at the
        scratch block 0).  Writes the window's K/V into the pool in place
        and returns ``(logits, pool)``: logits (B, V) fp32 for 1-D
        ``toks``, (B, W, V) for a window.  Inactive slots decode garbage
        into scratch block 0; the scheduler discards their outputs."""
        from ..inference import paged_kv as pk
        from ..ops.transformer.paged_attention import (
            paged_attention, paged_attention_reference)
        c = self.config
        squeeze = toks.dim() == 1
        if squeeze:
            toks = toks[:, None]
        W = toks.shape[1]
        impl = self.paged_attention_impl()
        pos = (lengths.long()[:, None]
               + torch.arange(W, device=toks.device)[None, :]).clamp(
                   max=c.max_seq - 1)
        x = (params["wte"].to(self.dtype)[toks]
             + params["wpe"].to(self.dtype)[pos])             # (B, W, D)
        for i in range(c.n_layer):
            p = _layer(params["blocks"], i)
            hn = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
            q, k, v = self._qkv(p, hn)                          # (B, W, H, hd)
            pk.write_tokens(pool, i, block_tables, lengths, k, v)
            if impl == "kernel":
                attn = paged_attention(q.contiguous(), pool, block_tables,
                                       lengths, i, scale_attn=c.scale_attn,
                                       mode=c.paged_attention_mode)
            else:
                # gather_kv + _masked_attend's math, on any device
                attn = paged_attention_reference(q, pool, block_tables,
                                                 lengths, i,
                                                 scale_attn=c.scale_attn)
            x = self._ffn(p, x + self._mm(attn, p["proj_w"], p["proj_b"]))
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                        c.layer_norm_eps)
        if squeeze:
            x = x[:, 0]
        return self._head(params, x), pool
