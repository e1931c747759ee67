"""In-place paged attention over the shared KV pool: CUDA kernels for Hopper.

Counterpart of ``deepspeed_tpu/ops/transformer/paged_attention.py``.
The two Pallas kernels there become hand-written CUDA kernels in
``deepspeed_tpu_torch/csrc/paged_attention.cu``:

- ``paged_attention_online_sm90`` (for ``_online_kernel``): the default
  on CUDA; an fp32 online softmax over the slot's live rows, each
  (slot, head) split over a thread-block cluster of up to 8 blocks
  (:func:`online_sm90_plan`, :func:`exact_sm90_split`) whose partial
  (max, sum, O) merge through distributed shared memory in one exchange;
- ``paged_attention_exact_sm90`` (for ``_exact_kernel``): the card's
  exact mode, an epilogue that mirrors ``GPT2._masked_attend`` op for op,
  each (slot, head) split over a cluster the same way
  (:func:`exact_sm90_plan`) that reduce the row max and sum through
  distributed shared memory;
- ``paged_attention_online`` and ``paged_attention_exact``: the first
  designs of the two (one block a (slot, head)), callable by name
  through :func:`paged_attention_online_template` and
  :func:`paged_attention_exact_template` as the yardsticks beside their
  redesigns; no main path launches them.

All read K/V straight from the pool through the block table (no
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
``launches[<kernel name>]`` (inside a captured step, each replay adds the
launches its capture made: ``runtime/step_graph.py``).
"""

import ctypes
import math

import torch

from ...inference import paged_kv as pk

# the oracle's mask value (GPT2._masked_attend uses finfo(float32).min)
NEG_INF = float(torch.finfo(torch.float32).min)

KERNELS = {"exact": "paged_attention_exact_sm90", "online": "paged_attention_online_sm90"}
# the first design of each kernel, launched only by name (the yardsticks beside their redesigns)
TEMPLATES = {"exact": "paged_attention_exact", "online": "paged_attention_online"}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in (*KERNELS.values(), *TEMPLATES.values())}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
MAX_WINDOW = 8
HEAD_DIMS = (64, 128)
# the cluster split of paged_attention_exact_sm90 and paged_attention_online_sm90
# (csrc/paged_attention.cu: kMaxRanks, kRankRows, kStageBytes, kOnlineStageBytes): ranks of a
# (slot, head)'s cluster, rows a rank is planned for, bytes of K + V rows staged at once by
# each kernel
SPLIT_MAX_RANKS, SPLIT_RANK_ROWS = 8, 128
SPLIT_STAGE_BYTES, ONLINE_STAGE_BYTES = 24576, 16384
# paged_attention_online_sm90's block (kOnlineWarps): at most a 16-row tile a warp staged at once
ONLINE_WARPS = 4
ONLINE_MAX_ROWS = 16 * ONLINE_WARPS


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


def exact_sm90_plan(S, head_dim, itemsize, n_scales=0):
    """``paged_attention_exact_sm90``'s split of a launch, from the shapes
    alone, as the kernel's host side computes it: ``(C, cap, R)``, the
    ranks of each (slot, head)'s cluster (``ceil(S / 128)``, at most 8),
    the most rows a rank takes (``ceil(S / C)``) and the rows it stages in
    shared memory at once (its K and V rows of ``head_dim * itemsize``
    bytes and, for an int8 pool, ``n_scales`` fp32 scales each, within a
    24 KB budget; a longer chunk streams through the buffer in pieces)."""
    C = min(SPLIT_MAX_RANKS, max(1, -(-S // SPLIT_RANK_ROWS)))
    cap = -(-S // C)
    per_row = 2 * (head_dim * itemsize + 4 * n_scales)
    return C, cap, min(cap, max(1, SPLIT_STAGE_BYTES // per_row))


def exact_sm90_split(length, W, S, C):
    """The rows each of the ``C`` ranks of a slot's cluster takes, as the
    kernel splits them: ``[(r0, r1), ...]``, rank ``r`` the contiguous live
    rows ``[r c, min((r + 1) c, n))`` of the ``n = min(length + W, S)``
    rows the window reaches, ``c = ceil(n / C)`` (a rank past them takes
    none, and joins the cluster's reductions all the same)."""
    n = max(min(length + W, S), 0)
    c = -(-n // C)
    return [(min(r * c, n), min(r * c + c, n)) for r in range(C)]


def online_sm90_plan(S, head_dim, itemsize, n_scales=0):
    """``paged_attention_online_sm90``'s split of a launch: ``(C, cap,
    R)``, the ranks and ``cap`` of :func:`exact_sm90_plan`, and ``R``, the
    rows staged at once: what a 16 KB budget holds, but 32 to 64 (a 16-row
    tile for each of the block's 4 warps) and at most ``cap``.  The rows
    of each rank are :func:`exact_sm90_split`'s and go through the buffer
    as :func:`online_sm90_pieces` says."""
    C, cap, _ = exact_sm90_plan(S, head_dim, itemsize, n_scales)
    per_row = 2 * (head_dim * itemsize + 4 * n_scales)
    return C, cap, min(cap, ONLINE_MAX_ROWS, max(32, ONLINE_STAGE_BYTES // per_row))


def online_sm90_pieces(rows, R, mma=False):
    """How ``paged_attention_online_sm90`` streams a rank's ``rows`` rows
    through its staging buffer of ``R`` rows: ``[(s0, n, slot), ...]``,
    piece k the chunk's rows ``[s0, s0 + n)`` staged from buffer row
    ``slot``; one piece when they fit, else pieces of ``R // 2`` rows (with
    ``mma``, the tensor-core path of 16-bit compute, rounded down to whole
    16-row tiles) in the buffer's two halves in turn (the next piece's
    copies in flight while the current one is consumed)."""
    pr = R if rows <= R else (R // 2) & ~15 if mma else R // 2
    return [(s0, min(pr, rows - s0), (k % 2) * pr)
            for k, s0 in enumerate(range(0, rows, pr))]


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
    return _paged(KERNELS[resolve_mode(mode)], q, pool, block_tables, lengths, layer,
                  scale_attn)


def paged_attention_exact_template(q, pool, block_tables, lengths, layer: int, *,
                                   scale_attn=True):
    """:func:`paged_attention` in exact mode through the first design of
    the exact kernel, ``paged_attention_exact`` (for CUDA tensors; the
    plain version for CPU tensors)."""
    return _paged(TEMPLATES["exact"], q, pool, block_tables, lengths, layer, scale_attn)


def paged_attention_online_template(q, pool, block_tables, lengths, layer: int, *,
                                    scale_attn=True):
    """:func:`paged_attention` in online mode through the first design of
    the online kernel, ``paged_attention_online`` (for CUDA tensors; the
    plain version for CPU tensors)."""
    return _paged(TEMPLATES["online"], q, pool, block_tables, lengths, layer, scale_attn)


def _paged(name, q, pool, block_tables, lengths, layer, scale_attn):
    _check(q, pool, block_tables, lengths, layer)
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool, block_tables, lengths, layer,
                                         scale_attn=scale_attn)
    return _launch(name, q, pool, block_tables, lengths, layer, scale_attn)


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
    if any(t.data_ptr() % 16 for t in (q, pool["k"][layer], pool["v"][layer])):
        raise ValueError("paged_attention: q and the pool's K/V layers must start 16-byte "
                         "aligned for the kernels' vector loads")
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
