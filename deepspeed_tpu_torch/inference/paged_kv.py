"""Paged/block KV cache: a shared device pool + per-sequence block lists.

Counterpart of ``deepspeed_tpu/inference/paged_kv.py``.  Same layout,
same host allocator:

- ``pool["k"]/["v"]``: (L, num_blocks, block_size, H, hd) in the cache
  dtype, or int8 when the pool is quantized;
- ``pool["k_scale"]/["v_scale"]`` (int8 pools only): fp32 block scales
  (L, num_blocks, block_size, H, hd // qb) from
  ``runtime/comm/quantized.py``;
- block 0 is the reserved SCRATCH block: inactive slots carry all-zero
  tables and write there; :class:`BlockAllocator` hands out ``[1, n)``.

Deliberate differences from the JAX module:

- the pool is a dict of torch tensors that :func:`write_tokens` and
  :func:`write_prefill` update IN PLACE (JAX returns a new pytree and
  relies on donation); both still return the pool;
- JAX gathers and scatters clamp out-of-range indices, torch raises:
  the overflow-to-scratch redirect of :func:`write_tokens` is spelled
  out explicitly, as in the JAX code;
- ``PrefixIndex`` (prefix sharing) and block images (KV migration) are
  not ported yet.
"""

from typing import Optional

import torch

from ..runtime.comm.quantized import (dequantize_blockwise, pick_block,
                                      quantize_blockwise)

SCRATCH_BLOCK = 0     # reserved; never allocated (see module docstring)


def blocks_needed(total_tokens: int, block_size: int) -> int:
    """Blocks a sequence of ``total_tokens`` (prompt + max new) occupies."""
    return max(1, -(-int(total_tokens) // int(block_size)))


class BlockAllocator:
    """Host-side free-list over pool block ids ``[1, num_blocks)`` with
    per-block refcounts (a copy of the JAX allocator).

    Allocation is all-or-nothing; ``free`` drops one holder per block
    and returns a block to the free list (LIFO) only when its last
    holder lets go, returning the ids actually released."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                "need >= 2 blocks (block 0 is the reserved scratch block)")
        self.num_blocks = int(num_blocks)
        self._free = list(range(self.num_blocks - 1, SCRATCH_BLOCK, -1))
        self._in_use = set()
        self._refs = {}     # block id -> holder count (in-use blocks only)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._in_use)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def is_allocated(self, b: int) -> bool:
        return b in self._in_use

    def refcount(self, b: int) -> int:
        return self._refs.get(b, 0)

    def alloc(self, n: int):
        """``n`` block ids, or None when the pool cannot serve them."""
        if n < 1 or n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._in_use.update(out)
        for b in out:
            self._refs[b] = 1
        return out

    def incref(self, blocks):
        """Add one holder to each of ``blocks`` (all must be in use)."""
        blocks = list(blocks)
        for b in blocks:
            if b not in self._in_use:
                raise ValueError(
                    f"incref of block {b} which is not in use — only "
                    "allocated blocks can be shared")
        for b in blocks:
            self._refs[b] += 1

    def free(self, blocks):
        """Drop one holder from each block; return the ids RELEASED.
        A double free or a free of the scratch block raises before any
        state changes."""
        blocks = list(blocks)
        seen = set()
        for b in blocks:
            if b == SCRATCH_BLOCK:
                raise ValueError(
                    f"free of reserved scratch block {SCRATCH_BLOCK} — "
                    "it is never allocated and never freed")
            if b not in self._in_use or b in seen:
                raise ValueError(f"double free of block {b} (not in use)")
            seen.add(b)
        released = []
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b] > 0:
                continue
            del self._refs[b]
            self._in_use.discard(b)
            self._free.append(b)
            released.append(b)
        return released


# ------------------------------------------------------------- device pool
def init_pool(n_layer: int, num_blocks: int, block_size: int, n_head: int,
              head_dim: int, dtype=torch.bfloat16, kv_bits: int = 16,
              quant_block: int = 64, device="cpu"):
    """Zeroed pool (see module docstring for the layout).  ``kv_bits=8``
    stores int8 payloads + fp32 scales over the head dim."""
    if kv_bits not in (8, 16):
        raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
    shape = (n_layer, num_blocks, block_size, n_head, head_dim)
    if kv_bits == 16:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    qb = pick_block(head_dim, quant_block)
    sshape = shape[:-1] + (head_dim // qb,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            # scale 1 is the quantizer's all-zero-block convention
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=device)}


def is_quantized_pool(pool) -> bool:
    return "k_scale" in pool


def pool_quant_block(pool) -> Optional[int]:
    """The int8 pool's quantization block over the head dim (None for a
    full-width pool)."""
    if not is_quantized_pool(pool):
        return None
    return pool["k"].shape[-1] // pool["k_scale"].shape[-1]


def pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size() for t in pool.values())


def capacity_tokens(pool) -> int:
    """Token capacity of the allocatable pool (scratch block excluded)."""
    return (pool["k"].shape[1] - 1) * pool["k"].shape[2]


def write_tokens(pool, layer: int, block_tables, lengths, k, v):
    """Scatter a W-token window's K/V per slot into the pool, in place.

    ``block_tables``: (B, nb_max) int32; ``lengths``: (B,) int32, the
    first window token's position (token i lands at ``lengths + i``);
    ``k``/``v``: (B, W, H, hd) in the compute dtype.  All-scratch slots
    write block 0, and a position past the table's end is redirected to
    the scratch block instead of overwriting the table's last block."""
    bs = pool["k"].shape[2]
    nb_max = block_tables.shape[1]
    W = k.shape[1]
    pos = (lengths.long()[:, None]
           + torch.arange(W, device=lengths.device)[None, :])   # (B, W)
    idx = pos // bs
    blk = torch.gather(block_tables.long(), 1, idx.clamp(max=nb_max - 1))
    blk = torch.where(idx < nb_max, blk, torch.zeros_like(blk))
    off = pos % bs
    if not is_quantized_pool(pool):
        dt = pool["k"].dtype
        pool["k"][layer, blk, off] = k.to(dt)
        pool["v"][layer, blk, off] = v.to(dt)
        return pool
    qb = pool_quant_block(pool)
    qk, sk = quantize_blockwise(k, block_size=qb)
    qv, sv = quantize_blockwise(v, block_size=qb)
    pool["k"][layer, blk, off] = qk
    pool["v"][layer, blk, off] = qv
    pool["k_scale"][layer, blk, off] = sk
    pool["v_scale"][layer, blk, off] = sv
    return pool


def gather_kv(pool, layer: int, block_tables, dtype):
    """Per-slot gathered cache views for one layer: the ``gather``
    paged-attention path and the oracle the kernels are held against.
    Returns ``(keys, vals)`` (B, nb_max·block_size, H, hd) in ``dtype``;
    int8 pools dequantize with :func:`dequantize_blockwise`."""
    tables = block_tables.long()

    def view(name):
        x = pool[name][layer][tables]            # (B, nb, bs, H, hd)
        B, nb, bs = x.shape[:3]
        x = x.reshape(B, nb * bs, *x.shape[3:])
        if not is_quantized_pool(pool):
            return x.to(dtype)
        s = pool[name + "_scale"][layer][tables]
        s = s.reshape(B, nb * bs, *s.shape[3:])
        return dequantize_blockwise(x, s, out_dtype=dtype)
    return view("k"), view("v")


def write_prefill(pool, blocks, k, v):
    """Scatter a prefilled sequence's K/V into its blocks, in place.

    ``blocks``: (nb,) block ids; ``k``/``v``: (L, T, H, hd) with
    ``T == nb · block_size`` (rows past the prompt are masked by the
    slot's length at attention time)."""
    L, T, H, hd = k.shape
    bs = pool["k"].shape[2]
    nb = T // bs
    if nb * bs != T:
        raise ValueError(f"prefill length {T} is not a multiple of {bs}")
    blocks = torch.as_tensor(blocks, dtype=torch.long,
                             device=pool["k"].device)
    if blocks.shape != (nb,):
        raise ValueError(
            f"write_prefill needs exactly T//block_size={nb} block ids, got "
            f"{tuple(blocks.shape)}")

    def put(name, x):
        pool[name][:, blocks] = x.reshape(L, nb, bs, *x.shape[2:])

    if not is_quantized_pool(pool):
        dt = pool["k"].dtype
        put("k", k.to(dt))
        put("v", v.to(dt))
        return pool
    qb = pool_quant_block(pool)
    qk, sk = quantize_blockwise(k, block_size=qb)
    qv, sv = quantize_blockwise(v, block_size=qb)
    put("k", qk)
    put("v", qv)
    put("k_scale", sk)
    put("v_scale", sv)
    return pool
