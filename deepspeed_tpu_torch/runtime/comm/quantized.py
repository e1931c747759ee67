"""Symmetric block quantization along the last axis (8-bit).

Counterpart of ``deepspeed_tpu/runtime/comm/quantized.py``
(``pick_block``, ``quantize_blockwise``, ``dequantize_blockwise``).  The
int8 KV pool (``inference/paged_kv.py``) stores what this quantizer
produces, and the paged-attention kernels dequantize with the same
formula, so it must match the JAX package bit for bit:

- scale = amax / 127 per block, and 1 for an all-zero block;
- non-finite inputs are zeroed before the block amax is taken;
- values round half to even (``torch.round`` and ``jnp.round`` both do).

Differences: only ``bits=8`` and the default ``zero_scale=1`` are
ported (the int4 wire and the MoE zero-scale variant are not on the
serving path); the sharding-pinned wire collectives are not ported.
"""

import torch


def pick_block(n: int, block_size: int) -> int:
    """Largest divisor of ``n`` that is <= ``block_size`` (>= 1)."""
    n = int(n)
    if n <= 0:
        return 1
    b = min(int(block_size), n)
    while b > 1:
        if n % b == 0:
            return b
        b -= 1
    return 1


def quantize_blockwise(x: torch.Tensor, *, block_size: int = 1024,
                       bits: int = 8):
    """``x`` (..., K) → ``(q int8 (..., K), scales fp32 (..., K // B))``
    with ``B = pick_block(K, block_size)``."""
    if bits != 8:
        raise NotImplementedError(
            f"quantize_blockwise ports bits=8 only, got bits={bits}")
    if x.dim() < 1:
        raise ValueError("quantize_blockwise needs ndim >= 1")
    K = x.shape[-1]
    B = pick_block(K, block_size)
    if x.numel() == 0:
        return (torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                torch.zeros(x.shape[:-1] + (K // B if K else 0,),
                            dtype=torch.float32, device=x.device))
    nb = K // B
    xf = x.to(torch.float32)
    xf = torch.where(torch.isfinite(xf), xf, torch.zeros_like(xf))
    xb = xf.reshape(x.shape[:-1] + (nb, B))
    amax = xb.abs().amax(dim=-1)
    scales = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scales[..., None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(x.shape), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, *,
                         bits: int = 8, out_dtype=torch.float32):
    """Inverse of :func:`quantize_blockwise` (block size from the
    shapes): ``float(q) * scale`` in fp32, then cast to ``out_dtype``."""
    if bits != 8:
        raise NotImplementedError(
            f"dequantize_blockwise ports bits=8 only, got bits={bits}")
    if q.numel() == 0:
        return torch.zeros(q.shape, dtype=out_dtype, device=q.device)
    K = q.shape[-1]
    nb = scales.shape[-1]
    x = q.to(torch.float32).reshape(q.shape[:-1] + (nb, K // nb))
    x = x * scales[..., None]
    return x.reshape(q.shape).to(out_dtype)
