"""GPT-2 family: training forward and loss, prefill through a contiguous
KV cache, and paged-KV decode.

Counterpart of ``deepspeed_tpu/models/gpt2.py``.  Ported: ``GPT2Config``,
``PRESETS``, ``_layer_norm`` (fp32 statistics, population variance),
``_dropout``, ``_attention_jnp``, ``flash_or_jnp_attention``,
``gpt2_block_forward`` (with ``checkpoint_name``), ``resolve_remat_policy``,
``_chunked_head_nll``, ``GPT2.init_numpy``, ``apply``, ``loss`` (with
``_chunked_loss``),
``_split_batch``, ``num_params``, ``flops_per_token``, ``init_cache`` +
``apply_with_cache`` (the ``fused`` seq-major cache path only — the
serving prefill and generate's steps), ``_qkv``, ``_masked_attend``,
``_attend_cached``, ``_ffn``, ``paged_attention_impl``, ``decode_impl``
and ``decode_step_paged`` with its ``kernel|gather`` switch.  GELU is
the tanh approximation, as ``jax.nn.gelu(approximate=True)``.

Parameters are a dict of tensors with the JAX pytree's keys and shapes
(``wte``, ``wpe``, ``blocks`` stacked over layers, ``lnf_*``) and the JAX
``(in, out)`` weight layout: :func:`params_from_jax` converts the JAX
package's numpy parameters with no transpose.

Deliberate differences:

- the JAX ``lax.scan`` over stacked layers becomes a Python loop over
  layers; ``unroll_layers`` is accepted and has no effect.  With
  ``decode_impl`` "fused" (JAX's default) the serving and generate steps
  capture the whole loop into one CUDA graph each
  (``runtime/step_graph.py``); "unroll" runs the same loop eagerly, as
  JAX keeps it for A/B runs; "legacy_scan" raises.  The training forward ``unbind``\\ s each stacked leaf once
  per call: indexing ``blocks[k][i]`` per layer would make autograd add
  up one zero tensor of the whole stack per layer;
- the KV cache (its ``index`` too) and the pool are updated in place
  (JAX threads new arrays through donation);
- JAX clamps out-of-range gathers; the position clamp
  ``min(lengths + w, max_seq - 1)`` of ``decode_step_paged`` is explicit;
- the tied head (:func:`tied_head`) keeps JAX's fp32 accumulation of the
  compute-dtype operands; its gradient products take the fp32 cotangent
  rounded to the compute dtype (identical in fp32).  The decode paths
  (``apply_with_cache`` and ``decode_step_paged``, ``head=``) take the
  vocab-padded weight an engine made once (:class:`PaddedHead`,
  :meth:`GPT2.decode_head`); training pads per call;
- ``rng`` is an integer seed (or, inside the engine's step, the
  ``FoldedSeed`` of ``runtime/step_graph.py``), not a PRNG key: dropout
  masks come from ``torch.Generator``\\ s re-seeded inside each block
  from a splitmix64 hash of (seed, layer, site), so ``remat`` recomputes
  the same masks and a captured step's replay draws them too.  They
  cannot match JAX's Bernoulli bits; parity runs use dropout 0;
- ``remat=True`` checkpoints each block with ``torch.utils.checkpoint``
  (``use_reentrant=False``, ``preserve_rng_state=False``: no mask comes
  from the default generator, whose state a capture may not read).  A
  ``remat_policy`` is a selective-checkpoint policy
  (:func:`resolve_remat_policy`, ``torch.utils.checkpoint.
  create_selective_checkpoint_contexts``): ``"dots"`` saves the outputs of
  the block's four weight products (``aten.mm`` / ``aten.addmm``: JAX's
  dots with no batch dimensions; the attention's batched products and the
  flash kernels, which write a ``torch.empty`` buffer through ``ctypes``
  where no op records it, are recomputed), ``"names:a,b"`` saves the
  tensors :func:`checkpoint_name` marks with those names (``attn_out``,
  ``mlp_fc``, as JAX's ``checkpoint_name``), as an alias op the policy
  recognises.  Difference: the recompute reruns the whole block forward
  and takes the saved outputs from the cache where XLA prunes the work
  they make dead, so the saved tensors, and so the memory, are JAX's, the
  recomputed work is not.  The policies read no RNG state and make no
  host read, so a captured step runs them.  The sequence-parallel
  ``attention_impl``\\ s (``ring``, ``ring_flash``, ``ulysses``) raise
  ``NotImplementedError``;
- ``loss_chunk > 0`` (:func:`_chunked_head_nll`): each chunk of tokens
  under ``torch.utils.checkpoint`` where JAX maps ``jax.checkpoint`` over
  them, so a chunk's fp32 logits live only inside it, forward and
  backward; the chunk totals are summed in chunk order;
- ``attention_impl="auto"`` picks the flash kernels for CUDA tensors
  (JAX: on a TPU) unless attention dropout is active; ``scale_attn=False``
  runs on them too (``sm_scale=1``; JAX sends it to the jnp path);
- ``paged_attention_mode`` (``auto|online|exact``) picks the CUDA kernel
  on the ``kernel`` path; JAX picks by backend;
- the ``gather`` path calls ``paged_attention_reference`` (``gather_kv``
  + ``_masked_attend``'s math, the kernels' plain version) in place of
  ``GPT2._attend_paged``;
- int8 weights (``supports_quantized_decode``, gpt2.py:504-518): the
  cached and paged decode paths take ``{"q", "scale"}`` leaves through
  ``q_matmul`` / ``q_gather`` (``module_inject/module_quantize.py``), the
  product rounded to the compute dtype before the bias is added, as in
  JAX; a quantized ``wte`` makes the head ``q_matmul(x, wte,
  w_transposed=True, out_dtype=float32)``, a float one keeps
  :func:`tied_head`;
- ``stream_fns`` (the decomposed forward of the ZeRO-3 parameter-offload
  runner, ``runtime/zero/param_stream.py``) returns torch callables with
  JAX's keys; its dropout seeds follow :meth:`GPT2.apply`'s derivation
  (``fold(seed, 17)`` for the embedding, ``fold(fold(seed, 31), i)`` for
  layer ``i``), so a streamed step draws the monolithic step's masks, and
  its block and head are ``apply``'s own; ``local_flags`` passes through
  as JAX's does and no block reads it;
- ``init`` (JAX PRNG draws), tensor parallelism and ``local_attn_window``
  are not ported.
"""

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..runtime.activation_checkpointing.checkpointing import checkpoint_name, marking
from ..runtime.step_graph import as_seed, dropout_uniform, fold as _fold
from ..module_inject.module_quantize import is_quantized_leaf, q_gather, q_matmul
from ..utils.device import resolve_device
from ..utils.logging import warning_once


@dataclasses.dataclass
class GPT2Config:
    vocab_size: int = 50257
    max_seq: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    embd_pdrop: float = 0.1
    attn_pdrop: float = 0.1
    resid_pdrop: float = 0.1
    layer_norm_eps: float = 1e-5
    # checkpoint each block (torch.utils.checkpoint); remat_policy (with remat):
    # None (recompute the whole block) | "dots" (save the weight products'
    # outputs) | "names:a,b" (save the tensors checkpoint_name marks so)
    remat: bool = True
    remat_policy: Optional[str] = None
    # > 0: the tied head and the loss over chunks of this many tokens, each
    # checkpointed (the (B*T, V) fp32 logits never exist at once)
    loss_chunk: int = 0
    # accepted for config parity; the layer loop is always a Python loop
    unroll_layers: bool = False
    # KV-cache decode steps (serving and generate): "fused" (each step one
    # CUDA graph on the card, runtime/step_graph.py) | "unroll" (the same
    # step bodies run eagerly, op by op: the A/B path) | "auto" (= "fused");
    # JAX's "legacy_scan" raises NotImplementedError
    decode_impl: str = "auto"
    # training attention: "auto" (flash for CUDA tensors unless attention
    # dropout is active, else jnp) | "flash" | "jnp"
    attention_impl: str = "auto"
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
    """JAX ``_layer_norm``: fp32 statistics (population variance) of the
    fp32 upcast, the affine in fp32, the result in ``x.dtype``; one fused
    ``F.layer_norm`` (forward and backward) in place of ten eager ops."""
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                        eps).to(x.dtype)


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


def layer_slice(blocks, i):
    """Layer ``i`` of the stacked block params (JAX ``layer_slice``): an
    int8 ``{"q", "scale"}`` leaf slices both its payload and its (L,
    groups) scale."""
    return {k: ({n: t[i] for n, t in v.items()} if is_quantized_leaf(v) else v[i])
            for k, v in blocks.items()}


def _pad_vocab(t, dim):
    """``t`` zero-padded along ``dim`` (the vocab) to a multiple of 8."""
    pad = -t.shape[dim] % 8
    if pad == 0:
        return t
    return F.pad(t, (0, 0, 0, pad) if dim == 0 else (0, pad))


class _TiedHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wte, padded):
        ctx.save_for_backward(x, wte)
        V = wte.shape[0]
        x2 = x.reshape(-1, x.shape[-1])
        if x.dtype == torch.float32:
            out = x2 @ wte.t()
        elif x.is_cuda:
            w = _pad_vocab(wte, 0) if padded is None else padded
            out = torch.mm(x2, w.t(), out_dtype=torch.float32)[:, :V]
        else:
            w = wte if padded is None else padded
            out = (x2.float() @ w.float().t())[:, :V]
        return out.reshape(*x.shape[:-1], V)

    @staticmethod
    def backward(ctx, g):
        x, wte = ctx.saved_tensors
        V = wte.shape[0]
        g2 = g.reshape(-1, V).to(x.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype != torch.float32:
            g2, wte = _pad_vocab(g2, 1), _pad_vocab(wte, 0)
        dx = (g2 @ wte).reshape(x.shape)
        dw = (g2.t() @ x2)[:V]
        return dx, dw, None


def tied_head(x, wte, padded=None):
    """Logits ``x @ wte.T`` in fp32 from compute-dtype operands, as JAX's
    ``einsum(..., preferred_element_type=float32)``: fp32 products of the
    16-bit values summed in fp32, kept in fp32.  On CUDA a 16-bit model
    uses ``torch.mm(..., out_dtype=torch.float32)`` (a cuBLAS bf16 GEMM
    with fp32 output, not a full-fp32 GEMM), with the vocab rows of the
    operands zero-padded to a multiple of 8 so cuBLAS can take an aligned
    kernel (GPT-2's 50257 is odd); on the CPU the operands are upcast
    (exact for bf16) and multiplied in fp32.  The gradient takes the
    cotangent rounded to the compute dtype (identical in fp32).

    ``padded``: ``wte`` already padded (a :class:`PaddedHead`'s weight),
    which the decode steps pass so that no step copies the table.  Without
    it a 16-bit head pads ``wte`` on every call, as training does: there
    ``wte`` changes every step, and the backward pads both operands."""
    return _TiedHead.apply(x, wte, padded)


class PaddedHead:
    """The tied head's weight zero-padded to a multiple of 8 vocab rows
    once, for the decode steps of an engine (``InferenceEngine.
    decode_head``): decode-time state beside the parameters, which keep
    the reference shapes.  ``weight`` is None where the head takes no pad
    (an fp32 model, an int8 ``wte`` — ``int8_mm_t`` / ``int8_mm_t_prefill``
    take an odd N — or a vocab that is a multiple of 8), else the padded
    copy, one extra ``V x D`` buffer (77 MB at GPT-2 125M in bf16) at a
    fixed address that captured steps read.

    No port API rebinds or rewrites an engine's ``wte`` after it is built
    (a rebind would leave every captured step on the old tensors anyway).
    An in-place write to it (``engine.params["wte"][i] = ...``) bumps the
    tensor's version counter; :meth:`sync`, which the engines call before
    each step, copies ``wte`` into the copy's first V rows when the
    version moved, at the same address."""

    def __init__(self, wte, dtype):
        self.src = wte
        self.weight = None
        if (is_quantized_leaf(wte) or dtype == torch.float32
                or wte.shape[0] % 8 == 0):
            return
        self.weight = _pad_vocab(wte.to(dtype), 0)
        self._version = wte._version

    def sync(self):
        if self.weight is not None and self.src._version != self._version:
            self.weight[:self.src.shape[0]].copy_(self.src)
            self._version = self.src._version


def _dropout(x, rate, seed, deterministic):
    """``where(keep, x / (1 - rate), 0)`` with ``keep`` drawn from a
    generator seeded by ``seed`` (an int, or a captured step's
    ``FoldedSeed``: ``runtime/step_graph.py``), so a recompute under remat
    and a replay draw the same mask."""
    if deterministic or rate == 0.0:
        return x
    keep = dropout_uniform(x.shape, seed, x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x)).to(x.dtype)


def _attention_jnp(q, k, v, causal_mask, attn_drop, seed, deterministic,
                   scale=None):
    """Plain attention (JAX ``_attention_jnp``): scores in the input
    dtype, fp32 softmax, probabilities in the input dtype."""
    head_dim = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (1.0 / np.sqrt(head_dim) if scale is None else scale)
    scores = torch.where(causal_mask, scores, torch.full_like(
        scores, torch.finfo(torch.float32).min))
    probs = torch.softmax(scores, dim=-1)
    probs = _dropout(probs, attn_drop, seed, deterministic).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_or_jnp_attention(q, k, v, causal_mask, attn_pdrop, seed,
                           deterministic, impl, *, scale=None):
    """Standard-causal attention dispatch (JAX ``flash_or_jnp_attention``):
    resolve ``auto``, warn for unsupported flash combinations, run the
    flash kernels or the plain path.  ``scale`` (``None``: ``1/sqrt(d)``)
    reaches the kernels as ``sm_scale``, so ``scale_attn=False`` runs on
    them too (JAX keeps it on the jnp path with ``local_attn_window``,
    which the port does not have)."""
    wants_dropout = attn_pdrop > 0.0 and not deterministic
    if impl == "auto":
        impl = "flash" if q.is_cuda and not wants_dropout else "jnp"
    if impl == "flash":
        if wants_dropout:
            warning_once("attention_impl='flash' has no in-kernel "
                         "dropout; attn_pdrop is ignored on this path")
        from ..ops.transformer.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=True, sm_scale=scale)
    if impl != "jnp":
        raise ValueError(f"attention_impl must be auto|flash|jnp, got {impl!r}")
    return _attention_jnp(q, k, v, causal_mask, attn_pdrop, seed,
                          deterministic, scale=scale)


# the weight products of a block as the dispatcher sees them ("dots" saves their outputs)
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _names_policy(names, ctx, op, *args, **kwargs):
    saved = op is torch.ops.aten.alias.default and marking() in names
    return CheckpointPolicy.MUST_SAVE if saved else CheckpointPolicy.PREFER_RECOMPUTE


def resolve_remat_policy(spec):
    """``GPT2Config.remat_policy`` → the ``context_fn`` of a selective
    ``torch.utils.checkpoint`` (JAX ``resolve_remat_policy``: None
    recomputes everything, ``"dots"`` JAX's
    ``dots_with_no_batch_dims_saveable``, ``"names:a,b"``
    ``save_only_these_names``)."""
    if spec is None:
        return None
    if spec == "dots":
        policy = _dots_policy
    elif spec.startswith("names:"):
        names = frozenset(n.strip() for n in spec[len("names:"):].split(",") if n.strip())
        policy = functools.partial(_names_policy, names)
    else:
        raise ValueError(f"unknown remat_policy {spec!r} "
                         "(None | 'dots' | 'names:<n1,n2,...>')")
    return functools.partial(create_selective_checkpoint_contexts, policy)


def gpt2_block_forward(c, p, x, seed, deterministic, causal_mask, attend):
    """One GPT-2 block (LN → attn → residual → LN → MLP → residual);
    ``attend(q, k, v, mask, seed, deterministic)``.  q, k and v are views
    of the fused qkv product (no copies)."""
    B, T, D = x.shape
    H, hd = c.n_head, c.head_dim
    r1, r2, r3 = (_fold(seed, site) for site in range(3))
    h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
    qkv = h @ p["qkv_w"].to(h.dtype) + p["qkv_b"].to(h.dtype)
    q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(D, dim=-1))
    attn = attend(q, k, v, causal_mask, r1, deterministic).reshape(B, T, D)
    if c.remat and c.remat_policy is not None:
        attn = checkpoint_name(attn, "attn_out")
    attn = attn @ p["proj_w"].to(h.dtype) + p["proj_b"].to(h.dtype)
    x = x + _dropout(attn, c.resid_pdrop, r2, deterministic)
    h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"], c.layer_norm_eps)
    h = h @ p["fc_w"].to(h.dtype) + p["fc_b"].to(h.dtype)
    if c.remat and c.remat_policy is not None:
        h = checkpoint_name(h, "mlp_fc")
    h = F.gelu(h, approximate="tanh")
    h = h @ p["fc_proj_w"].to(h.dtype) + p["fc_proj_b"].to(h.dtype)
    return x + _dropout(h, c.resid_pdrop, r3, deterministic)


def _chunk_nll(xc, lc, vc, wte, head):
    """The summed NLL of one chunk of tokens (the tied head's fp32 logits
    live only here)."""
    logits = tied_head(xc, wte, head)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, lc[:, None])[:, 0]
    return ((lse - lab) * vc).sum()


def _chunked_head_nll(c, wte, x, labels):
    """Tied head + cross-entropy over chunks of ``c.loss_chunk`` tokens,
    each under ``torch.utils.checkpoint`` (JAX ``_chunked_head_nll``): a
    chunk's fp32 logits live only inside it, forward and backward.  The
    token axis pads to a chunk multiple with masked rows.  ``x``: the
    final-LN hidden states (B, T, D); returns the mean NLL over B*T."""
    B, T, D = x.shape
    BT = B * T
    chunk = min(int(c.loss_chunk), BT)
    n = -(-BT // chunk)
    pad = n * chunk - BT
    xf = F.pad(x.reshape(BT, D), (0, 0, 0, pad)).reshape(n, chunk, D)
    lf = F.pad(labels.reshape(BT).long(), (0, pad)).reshape(n, chunk)
    valid = F.pad(torch.ones(BT, dtype=torch.float32, device=x.device), (0, pad))
    valid = valid.reshape(n, chunk)
    wte = wte.to(x.dtype)
    # a 16-bit CUDA head pads the vocab once for every chunk's forward
    head = _pad_vocab(wte, 0) if x.is_cuda and x.dtype != torch.float32 else None
    total = torch.stack([
        checkpoint(_chunk_nll, xf[i], lf[i], valid[i], wte, head, use_reentrant=False,
                   preserve_rng_state=False)
        for i in range(n)])
    return total.sum() / BT


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
    # the cached and paged decode paths take int8 {"q", "scale"} leaves from
    # init_inference(dtype=torch.int8): their matmuls stream int8 through the
    # int8_matmul kernel; float leaves take the plain product
    supports_quantized_decode = True
    supports_paged_decode = True

    @staticmethod
    def _mm(h, w, b=None):
        """``h @ w (+ b)``: the product in ``h.dtype`` (rounded before the
        bias, gpt2.py:515-517), ``w`` float or a quantized leaf."""
        out = q_matmul(h, w)
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
        ``index`` (an int or a 0-d device tensor), then
        :meth:`_masked_attend`."""
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

    def _head(self, params, x, head=None):
        """fp32 logits of the tied head; an int8 ``wte`` streams through
        the ``int8_mm_t`` kernel.  ``head``: the padded weight of a
        :class:`PaddedHead` (decode), or None to pad per call."""
        wte = params["wte"]
        if is_quantized_leaf(wte):
            return q_matmul(x, wte, w_transposed=True, out_dtype=torch.float32)
        return tied_head(x, wte.to(x.dtype), head)

    # --------------------------------------------------------------- forward
    def _attend(self, q, k, v, causal_mask, seed, deterministic):
        c = self.config
        if c.attention_impl in ("ring", "ring_flash", "ulysses"):
            raise NotImplementedError(
                f"attention_impl={c.attention_impl!r} (sequence parallelism) "
                "is not ported")
        return flash_or_jnp_attention(
            q, k, v, causal_mask, c.attn_pdrop, seed, deterministic,
            c.attention_impl, scale=None if c.scale_attn else 1.0)

    def _block(self, x, lp, seed, deterministic, causal_mask):
        return gpt2_block_forward(self.config, lp, x, seed, deterministic,
                                  causal_mask, self._attend)

    def apply(self, params, tokens, rng=None, deterministic=True,
              return_hidden=False):
        """tokens: (B, T) int → logits (B, T, V) fp32 (or the final-LN
        hidden states (B, T, D) with ``return_hidden``).  ``rng`` is an
        integer dropout seed (0 when None)."""
        c = self.config
        B, T = tokens.shape
        if T > c.max_seq:
            raise ValueError(f"sequence length {T} exceeds max_seq {c.max_seq}")
        context = resolve_remat_policy(c.remat_policy) if c.remat else None
        remat_kw = {} if context is None else {"context_fn": context}
        seed = as_seed(rng)
        dtype = self.dtype
        pos = torch.arange(T, device=tokens.device)
        x = params["wte"].to(dtype)[tokens] + params["wpe"].to(dtype)[pos]
        x = _dropout(x, c.embd_pdrop, _fold(seed, 17), deterministic)
        causal_mask = torch.ones((T, T), dtype=torch.bool,
                                 device=tokens.device).tril()[None, None]
        # one unbind per stacked leaf: its backward is a single stack
        layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
        layer_seed = _fold(seed, 31)
        for i in range(c.n_layer):
            lp = {k: v[i] for k, v in layers.items()}
            args = (x, lp, _fold(layer_seed, i), deterministic, causal_mask)
            # no RNG state to preserve: masks come from seeded generators,
            # never the default one, whose state a capture may not read
            x = (checkpoint(self._block, *args, use_reentrant=False,
                            preserve_rng_state=False, **remat_kw)
                 if c.remat else self._block(*args))
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                        c.layer_norm_eps)
        if return_hidden:
            return x
        return self._head(params, x)

    def loss(self, params, batch, rng=None):
        """Next-token LM loss (mean over tokens) with dropout on.
        ``batch``: (B, T+1) int tokens, a dict with ``input_ids`` (and
        optional ``labels``), or a ``(tokens,)`` tuple."""
        tokens, labels = self._split_batch(batch)
        if self.config.loss_chunk > 0:
            return self._chunked_loss(params, tokens, labels, rng)
        logits = self.apply(params, tokens, rng=rng, deterministic=False)
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return (lse - label_logit).mean()

    def _chunked_loss(self, params, tokens, labels, rng):
        """The tied head and the loss over token chunks (JAX ``_chunked_loss``,
        :func:`_chunked_head_nll`)."""
        x = self.apply(params, tokens, rng=rng, deterministic=False, return_hidden=True)
        return _chunked_head_nll(self.config, params["wte"], x, labels)

    # ------------------------------------------------- param-offload streaming
    def stream_fns(self):
        """The forward in per-layer pieces for the ZeRO-3 parameter-offload
        runner (JAX ``gpt2.py:837-890``): ``embed(nonblock, tokens, seed,
        deterministic)``, ``layer_rngs(seed)`` (one seed a layer),
        ``block(layer_params, x, seed, is_local, deterministic)``,
        ``head_loss(nonblock, x, labels)`` (the final LN, the tied head
        and the mean NLL, chunked with ``loss_chunk``) and
        ``split_batch``; ``nonblock`` holds every leaf but ``blocks``."""
        c = self.config
        dtype = self.dtype

        def embed(nonblock, tokens, seed, deterministic):
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = nonblock["wte"].to(dtype)[tokens] + nonblock["wpe"].to(dtype)[pos]
            return _dropout(x, c.embd_pdrop, _fold(as_seed(seed), 17), deterministic)

        def layer_rngs(seed):
            layer_seed = _fold(as_seed(seed), 31)
            return [_fold(layer_seed, i) for i in range(c.n_layer)]

        def block(layer_p, x, seed, is_local, deterministic):
            T = x.shape[1]
            causal_mask = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()[None, None]
            return self._block(x, layer_p, seed, deterministic, causal_mask)

        def head_loss(nonblock, x, labels):
            x = _layer_norm(x, nonblock["lnf_scale"], nonblock["lnf_bias"], c.layer_norm_eps)
            if c.loss_chunk > 0:
                return _chunked_head_nll(c, nonblock["wte"], x, labels)
            logits = tied_head(x, nonblock["wte"].to(x.dtype))
            lse = torch.logsumexp(logits, dim=-1)
            label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
            return (lse - label_logit).mean()

        return {"stacked_key": "blocks", "n_layer": c.n_layer,
                "local_flags": np.arange(c.n_layer) % 2 == 1, "embed": embed,
                "layer_rngs": layer_rngs, "block": block, "head_loss": head_loss,
                "split_batch": self._split_batch}

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, dict):
            tokens = batch["input_ids"]
            labels = batch.get("labels")
            if labels is None:
                tokens, labels = tokens[:, :-1], tokens[:, 1:]
            return tokens, labels
        if isinstance(batch, (tuple, list)):
            batch = batch[0]
        return batch[:, :-1], batch[:, 1:]

    # ----------------------------------------------------------- flop counts
    def num_params(self):
        """Exact parameter count (matmuls + biases + LayerNorms + embeddings)."""
        c = self.config
        per_layer = 12 * c.n_embd ** 2 + 13 * c.n_embd
        return (c.vocab_size * c.n_embd + c.max_seq * c.n_embd +
                c.n_layer * per_layer + 2 * c.n_embd)

    def flops_per_token(self):
        """Training FLOPs/token ≈ 6N + 12·L·D·T (the attention-score
        products, forward and backward) — the MFU accounting."""
        c = self.config
        return 6 * self.num_params() + 12 * c.n_layer * c.n_embd * c.max_seq

    # ------------------------------------------------------- KV-cache decode
    def decode_impl(self) -> str:
        """Resolve ``config.decode_impl`` ("auto" → "fused"), as JAX's
        ``decode_impl`` (gpt2.py:469-476); ``"legacy_scan"`` (JAX's
        batch-major restacked cache) is not ported."""
        impl = self.config.decode_impl
        if impl == "auto":
            impl = "fused"
        if impl == "legacy_scan":
            raise NotImplementedError("decode_impl='legacy_scan' is not ported "
                                      "(fused and unroll are)")
        if impl not in ("fused", "unroll"):
            raise ValueError(f"decode_impl must be auto|fused|unroll|legacy_scan, "
                             f"got {impl!r}")
        return impl

    def decode_head(self, params) -> PaddedHead:
        """The tied head's weight padded once for decode (:class:`PaddedHead`
        over ``params["wte"]`` in the compute dtype)."""
        return PaddedHead(params["wte"], self.dtype)

    def init_cache(self, batch_size: int, max_len: Optional[int] = None,
                   dtype=None):
        """Empty seq-major cache ``{"k", "v": (L, S, B, H, hd), "index"}``
        (the JAX ``fused`` layout; ``index`` is a 0-d int64 tensor on the
        model's device, as JAX keeps it on its device)."""
        c = self.config
        max_len = max_len or c.max_seq
        if max_len > c.max_seq:
            raise ValueError(f"init_cache max_len={max_len} exceeds "
                             f"config.max_seq={c.max_seq}")
        shape = (c.n_layer, max_len, batch_size, c.n_head, c.head_dim)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device),
                "index": torch.zeros((), dtype=torch.long, device=self.device)}

    def apply_with_cache(self, params, tokens, cache, head=None):
        """Forward ``tokens`` (B, T) from ``cache["index"]``; returns
        ``(logits (B, T, V) fp32, cache)`` with the cache updated in
        place and its index advanced by T in place.  The write positions
        and the causal mask come from the device index (no host read, so
        a captured step replays it); positions past the cache raise
        (JAX clamps them).  ``head``: the tied head's padded weight
        (:class:`PaddedHead`), or None."""
        c = self.config
        B, T = tokens.shape
        if T > cache["k"].shape[1]:
            raise ValueError(f"cache of {cache['k'].shape[1]} positions "
                             f"cannot take {T} tokens")
        index = cache["index"]
        pos = index + torch.arange(T, device=tokens.device)
        x = (q_gather(params["wte"], tokens, self.dtype)
             + q_gather(params["wpe"], pos, self.dtype))
        for i in range(c.n_layer):
            p = layer_slice(params["blocks"], i)
            h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
            q, k, v = self._qkv(p, h)
            ck, cv = cache["k"][i], cache["v"][i]          # (S, B, H, hd)
            ck.index_copy_(0, pos, k.transpose(0, 1).to(ck.dtype))
            cv.index_copy_(0, pos, v.transpose(0, 1).to(cv.dtype))
            attn = self._attend_cached(q, ck, cv, index, seq_major=True)
            x = self._ffn(p, x + self._mm(attn, p["proj_w"], p["proj_b"]))
        x = _layer_norm(x, params["lnf_scale"], params["lnf_bias"],
                        c.layer_norm_eps)
        index.add_(T)
        return self._head(params, x, head), cache

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

    def decode_step_paged(self, params, toks, pool, block_tables, lengths, head=None):
        """One decode window for B slots over the paged pool.

        ``toks``: (B,) or (B, W) int tokens at positions ``lengths + w``;
        ``lengths``: (B,) int32 tokens already cached per slot;
        ``block_tables``: (B, nb_max) int32 (unused entries point at the
        scratch block 0).  Writes the window's K/V into the pool in place
        and returns ``(logits, pool)``: logits (B, V) fp32 for 1-D
        ``toks``, (B, W, V) for a window.  Inactive slots decode garbage
        into scratch block 0; the scheduler discards their outputs.
        ``head``: the tied head's padded weight (:class:`PaddedHead`), or
        None."""
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
        x = (q_gather(params["wte"], toks, self.dtype)
             + q_gather(params["wpe"], pos, self.dtype))      # (B, W, D)
        for i in range(c.n_layer):
            p = layer_slice(params["blocks"], i)
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
        return self._head(params, x, head), pool
