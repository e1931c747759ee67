"""In-place paged attention over the shared KV pool: CUDA kernels for Hopper.

Counterpart of ``deepspeed_tpu/ops/transformer/paged_attention.py``.
The two Pallas kernels there become two hand-written CUDA kernels in
``deepspeed_tpu_torch/csrc/paged_attention.cu``:

- ``paged_attention_online`` (for ``_online_kernel``): the default on
  CUDA; walks only the slot's live rows with an fp32 online softmax;
- ``paged_attention_exact`` (for ``_exact_kernel``): the full score
  row in shared memory and an epilogue that mirrors
  ``GPT2._masked_attend`` op for op, the card's exact mode.

Both read K/V straight from the pool through the block table (no
gathered copy) and dequantize int8 pools in registers.  Queries are a
``(B, W, H, hd)`` window (W=1 is plain decode, W <= 8), masked causally
inside the window: key position ``s`` is live for window row ``w`` iff
``s <= lengths[b] + w``.

:func:`paged_attention` launches a kernel for CUDA tensors and takes the
plain version, :func:`paged_attention_reference` (``gather_kv`` +
``_masked_attend``, the JAX oracle), only for CPU tensors.  Differences
from the JAX module: ``mode="auto"`` resolves to ``online`` on CUDA
(JAX: ``online`` on a TPU, ``exact`` under the interpreter); on the CPU
both modes are the plain version; a launch adds one to
``launches[<kernel name>]``.
"""

import ctypes
import math

import torch

from ...inference import paged_kv as pk

# the oracle's mask value (GPT2._masked_attend uses finfo(float32).min)
NEG_INF = float(torch.finfo(torch.float32).min)

KERNELS = {"exact": "paged_attention_exact", "online": "paged_attention_online"}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS.values()}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_WINDOW = 8
HEAD_DIMS = (64, 128)


def reset_launches():
    for name in launches:
        launches[name] = 0


def resolve_mode(mode: str) -> str:
    """``auto`` → ``online`` (the CUDA default)."""
    if mode == "auto":
        return "online"
    if mode not in KERNELS:
        raise ValueError(
            f"paged-attention mode must be auto|exact|online, got {mode!r}")
    return mode


def paged_attention_reference(q, pool, block_tables, lengths, layer, *,
                              scale_attn=True):
    """Plain PyTorch version: ``gather_kv`` + ``GPT2._masked_attend``'s
    math (scores in the input dtype, fp32, scale, mask, softmax,
    probabilities in the input dtype, AV).  Returns (B, W, H·hd)."""
    B, W, H, hd = q.shape
    keys, vals = pk.gather_kv(pool, layer, block_tables, q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, keys).float()
    if scale_attn:
        scores = scores / math.sqrt(hd)
    k_pos = torch.arange(keys.shape[1], device=q.device)
    valid = (k_pos[None, None, :]
             <= lengths.long()[:, None, None]
             + torch.arange(W, device=q.device)[None, :, None])   # (B, W, S)
    scores = torch.where(valid[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vals).reshape(B, W, H * hd)


def _check(q, pool, block_tables, lengths, layer):
    B, W, H, hd = q.shape
    k = pool["k"]
    if (k.dim() != 5 or k.shape[3] != H or k.shape[4] != hd
            or pool["v"].shape != k.shape):
        raise ValueError(f"pool {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if not 0 <= layer < k.shape[0]:
        raise ValueError(f"layer {layer} out of range for {k.shape[0]} layers")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} for batch {B}")
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} for batch {B}")


def paged_attention(q, pool, block_tables, lengths, layer: int, *,
                    scale_attn=True, mode="auto"):
    """Masked attention of a ``(B, W)`` query window over the paged pool.

    ``q``: (B, W, H, hd) in the compute dtype; ``pool``: the
    ``paged_kv`` pool (16-bit in the compute dtype, or int8 + scales);
    ``block_tables``: (B, nb_max) int32 (scratch-0 padded);
    ``lengths``: (B,) int32 position of the first window token (its K/V
    already written); ``layer``: the pool layer.  Returns (B, W, H·hd)
    in ``q.dtype``."""
    _check(q, pool, block_tables, lengths, layer)
    mode = resolve_mode(mode)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool, block_tables, lengths, layer,
                                         scale_attn=scale_attn)
    return _launch(KERNELS[mode], q, pool, block_tables, lengths, layer,
                   scale_attn)


def _launch(name, q, pool, block_tables, lengths, layer, scale_attn):
    B, W, H, hd = q.shape
    quantized = pk.is_quantized_pool(pool)
    tensors = [q, pool["k"], pool["v"], block_tables, lengths]
    if quantized:
        tensors += [pool["k_scale"], pool["v_scale"]]
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"paged_attention: tensor on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError("paged_attention: every operand must be contiguous")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention: unsupported compute dtype {q.dtype}")
    if quantized:
        scale_shape = pool["k_scale"].shape
        if (any(pool[n].dtype != torch.int8 for n in ("k", "v"))
                or any(pool[n].dtype != torch.float32
                       for n in ("k_scale", "v_scale"))
                or pool["v_scale"].shape != scale_shape
                or scale_shape[:-1] != pool["k"].shape[:-1]
                or hd % scale_shape[-1]):
            raise ValueError("paged_attention: int8 pools carry int8 payloads "
                             "and fp32 scales of shape (..., hd // qb)")
    elif pool["k"].dtype != q.dtype or pool["v"].dtype != q.dtype:
        raise ValueError(f"paged_attention: a 16-bit pool must be in the compute "
                         f"dtype {q.dtype}, got {pool['k'].dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention: block_tables and lengths must be int32")
    if not 1 <= W <= MAX_WINDOW:
        raise ValueError(f"paged_attention: window {W} not in [1, {MAX_WINDOW}]")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention: head_dim {hd} not in {HEAD_DIMS}")
    bs, nb_max = pool["k"].shape[2], block_tables.shape[1]
    n_scales = pool["k_scale"].shape[-1] if quantized else 1
    out = torch.empty((B, W, H, hd), dtype=q.dtype, device=q.device)
    fn = _entry(name)
    null = ctypes.c_void_p(0)
    rc = fn(_DTYPE_CODES[q.dtype], int(quantized), hd,
            q.data_ptr(), pool["k"][layer].data_ptr(), pool["v"][layer].data_ptr(),
            pool["k_scale"][layer].data_ptr() if quantized else null,
            pool["v_scale"][layer].data_ptr() if quantized else null,
            block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, W, H, bs, nb_max, pool["k"].shape[1], n_scales,
            int(bool(scale_attn)),
            1.0 / math.sqrt(hd) if scale_attn else 1.0,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}"
                           + (" (unsupported configuration)" if rc == -1 else ""))
    launches[name] += 1
    return out.reshape(B, W, H * hd)


def _entry(name):
    from ..op_builder import cuda as builder
    fn = getattr(builder.load("paged_attention"), name)
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, v, v, v, v, v, v, v, v,
                       i, i, i, i, i, i, i, i, ctypes.c_float, v]
        fn.restype = ctypes.c_int
    return fn
