"""Weight-int8 matmul: bf16 activations times int8 weights, streaming int8.

Counterpart of ``deepspeed_tpu/ops/transformer/int8_matmul.py``.  The two
Pallas kernels there become hand-written CUDA kernels for Hopper:

- ``int8_mm_nt_decode`` (for ``_kernel_nt`` at M <= 16), in
  ``deepspeed_tpu_torch/csrc/int8_matmul_decode_sm90.cu``: ``q`` is
  (K, N), N contiguous -- every block weight of GPT-2 at decode; TMA
  streams the weight into an mbarrier ring and the consumer warps widen
  it in registers;
- ``int8_mm_nt_prefill`` (for ``_kernel_nt`` at M > 16), in
  ``deepspeed_tpu_torch/csrc/int8_matmul_prefill_sm90.cu``: the block
  weights at prefill; TMA feeds int8 weight and bf16 x tiles into an
  mbarrier ring, and two consumer warpgroups widen the weight in
  registers into the A fragments of ``wgmma`` with x as its
  shared-memory B operand;
- ``int8_mm_t_prefill`` (for ``_kernel_t`` at M > 16: ``q`` is (N, K),
  K contiguous -- the tied head at prefill), in the same source: the
  design of ``int8_mm_nt_prefill``, a K-contiguous weight row read
  straight into the A fragments of ``wgmma``;
- ``int8_mm_nt`` (for ``_kernel_nt``, every (K, N) case neither takes:
  N % 16 != 0, a ``q`` that is not 16-byte aligned) and ``int8_mm_t``
  (for ``_kernel_t`` at M <= 16 -- the head at decode -- and every (N, K)
  case ``int8_mm_t_prefill`` does not take), in
  ``deepspeed_tpu_torch/csrc/int8_matmul.cu``.

All compute what both branches of the JAX ``int8_matmul`` compute:
``bf16(x) @ bf16(q)`` with the products summed in fp32, times the scale
(per tensor, or per output channel with ``w_transposed``), cast to
``out_dtype`` last.  The widened weight never reaches device memory.

:func:`int8_matmul` launches the kernel that :func:`int8_nt_kernel` (or,
for an (N, K) weight, :func:`int8_t_kernel`) names for CUDA tensors, at
any M, and takes the plain version
:func:`int8_matmul_reference` only for CPU tensors;
:func:`int8_matmul_tiled` always takes the ``int8_matmul.cu`` kernels.
Differences from the JAX module: ``use_pallas`` and ``block_n`` are
accepted for signature parity and have no effect (the JAX default
``use_pallas=False`` sends every call to XLA's fused convert-in-dot; on
the GPU no library call streams int8 into a bf16 product, so the kernels
serve both branches); outputs other than bf16 and fp32 are computed in
fp32 and cast (one rounding either way); a launch adds one to
``launches[<kernel name>]`` (inside a captured step, each replay adds the
launches its capture made: ``runtime/step_graph.py``).
"""

import ctypes
import math

import torch

KERNELS = {"nt": "int8_mm_nt", "t": "int8_mm_t", "decode": "int8_mm_nt_decode",
           "prefill": "int8_mm_nt_prefill", "t_prefill": "int8_mm_t_prefill"}
# the csrc/<library>.cu each kernel is built from
LIBRARIES = {"int8_mm_nt": "int8_matmul", "int8_mm_t": "int8_matmul",
             "int8_mm_nt_decode": "int8_matmul_decode_sm90",
             "int8_mm_nt_prefill": "int8_matmul_prefill_sm90",
             "int8_mm_t_prefill": "int8_matmul_prefill_sm90"}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS.values()}

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# tile configurations of the tiled kernels (int8_matmul.cu): (BM, BN, BK)
TILES = {0: (16, 64, 128),     # M <= 16
         1: (64, 128, 64)}     # larger M
_counters = {}                 # (device, stream) -> zeroed int32 split-K tile counters
_retired = []                  # outgrown counter buffers, kept for the graphs that hold them
# int8_mm_nt_decode (its source's kBN, kBK, kConsumers): weight columns and rows
# of a TMA box (8 KB), the consumer threads (one warp per 32 columns)
DECODE_BN, DECODE_BK = 128, 64
DECODE_THREADS = 128
DECODE_MAX_M = 16
# int8_mm_nt_prefill (its source's kBM, kBN, kBK): tokens and weight columns of an output
# tile, weight rows of a k box; two blocks an SM; a split keeps at least 4 k boxes
PREFILL_BM, PREFILL_BN, PREFILL_BK = 128, 128, 64
PREFILL_BLOCKS_PER_SM = 2
PREFILL_MIN_BOXES = 4
# int8_mm_t_prefill (its source's kBN, kBK and instances): weight rows of an output tile, k
# of a box, the token tiles built; one block an SM
T_PREFILL_BN, T_PREFILL_BK = 128, 64
T_PREFILL_TILES = (136, 256)
T_PREFILL_MIN_K = 16                 # the q map's row stride of K bytes: K % 16 == 0


def reset_launches():
    for name in launches:
        launches[name] = 0


def _shapes(x, q, w_transposed):
    if q.dim() != 2:
        raise ValueError(f"int8_matmul: q must be 2-D, got {tuple(q.shape)}")
    if q.dtype != torch.int8:
        raise ValueError(f"int8_matmul: q must be int8, got {q.dtype}")
    if not x.is_floating_point():
        raise ValueError(f"int8_matmul: x must be floating, got {x.dtype}")
    K = x.shape[-1]
    N, Kq = (q.shape[0], q.shape[1]) if w_transposed else (q.shape[1], q.shape[0])
    if Kq != K:
        raise ValueError(f"int8_matmul: x (..., {K}) does not match q "
                         f"{tuple(q.shape)} (w_transposed={w_transposed})")
    lead = tuple(x.shape[:-1])
    return lead, math.prod(lead), N, K


def _scale_vector(scale, N, w_transposed, device):
    """The fp32 scale as 1 (per-tensor) or N (per-output-channel) values;
    any other size raises the reference's ValueError."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(-1)
    if scale.numel() == 1 or (w_transposed and scale.numel() == N):
        return scale
    raise ValueError(
        f"scale size {scale.numel()} does not map to per-tensor or "
        f"per-output-channel (N={N}, w_transposed={w_transposed})")


def int8_matmul_reference(x, q, scale, *, w_transposed=False, out_dtype=None):
    """Plain PyTorch version: ``x`` rounded to bf16, products of the
    bf16 values with the int8 weights summed in fp32 (``x.float() @
    q.float()``: every product is exact in fp32), times the scale, cast
    to ``out_dtype`` (default ``x.dtype``).  Returns (..., N)."""
    out_dtype = out_dtype or x.dtype
    lead, M, N, K = _shapes(x, q, w_transposed)
    x2 = x.reshape(M, K).to(torch.bfloat16).float()
    w = q.float()
    acc = x2 @ (w.t() if w_transposed else w)
    acc = acc * _scale_vector(scale, N, w_transposed, x.device)[None, :]
    return acc.to(out_dtype).reshape(*lead, N)


def int8_matmul(x, q, scale, *, w_transposed=False, block_n=512,
                out_dtype=None, use_pallas=False):
    """``x @ dequant(q)`` (or ``x @ dequant(q).T``) streaming int8 weights.

    ``x``: (..., K) floating, rounded to bf16 (as JAX does, whatever its
    dtype); ``q``: int8 (K, N), or (N, K) when ``w_transposed``;
    ``scale``: per-tensor (size 1) or per-output-channel (size N, only
    with ``w_transposed``).  Returns (..., N) in ``out_dtype`` (default
    ``x.dtype``).  ``block_n`` and ``use_pallas`` have no effect."""
    del block_n, use_pallas                  # signature parity only
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, w_transposed=w_transposed,
                                     out_dtype=out_dtype)
    return _launch(x, q, scale, w_transposed, out_dtype, routed=True)


def int8_matmul_tiled(x, q, scale, *, w_transposed=False, out_dtype=None):
    """:func:`int8_matmul` through the ``int8_matmul.cu`` kernels
    (``int8_mm_nt`` / ``int8_mm_t``) whatever M is, for CUDA tensors; the
    plain version for CPU tensors."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_matmul_reference(x, q, scale, w_transposed=w_transposed,
                                     out_dtype=out_dtype)
    return _launch(x, q, scale, w_transposed, out_dtype, routed=False)


def int8_nt_kernel(M, N, K, q_aligned):
    """The kernel an (M, K) x (K, N) product takes on the card, when K >= 1,
    N % 16 == 0 and ``q`` is 16-byte aligned (its TMA map's row stride and
    base; x gets a padded copy where its own rows do not suit a map):
    ``int8_mm_nt_decode`` for 1 <= M <= 16 with fewer than 2^21 boxes of
    128 x 64 (its 32-bit box arithmetic), ``int8_mm_nt_prefill`` for M > 16
    with fewer than 2^31 (output tile, k box) pairs (its 32-bit block
    index); else the tiled ``int8_mm_nt``.  Decided before any launch,
    never by a failure."""
    if not (K >= 1 and N > 0 and N % 16 == 0 and q_aligned):
        return KERNELS["nt"]
    boxes = -(-N // DECODE_BN) * -(-K // DECODE_BK)
    if 1 <= M <= DECODE_MAX_M and boxes < 2 ** 21:
        return KERNELS["decode"]
    pairs = -(-M // PREFILL_BM) * -(-N // PREFILL_BN) * -(-K // PREFILL_BK)
    if M > DECODE_MAX_M and pairs < 2 ** 31:
        return KERNELS["prefill"]
    return KERNELS["nt"]


def int8_t_kernel(M, N, K, q_aligned):
    """The kernel an (M, K) x (N, K)^T product takes on the card:
    ``int8_mm_t_prefill`` for M > 16 when K % 16 == 0 (its TMA map's row
    stride; x gets a padded copy where its own rows do not suit a map),
    ``q`` is 16-byte aligned and fewer than 2^31 (output tile, k box) pairs
    keep its block index in 32 bits; else ``int8_mm_t``.  Decided before
    any launch, never by a failure."""
    if not (M > DECODE_MAX_M and N > 0 and K >= T_PREFILL_MIN_K and K % T_PREFILL_MIN_K == 0
            and q_aligned):
        return KERNELS["t"]
    pairs = -(-M // min(T_PREFILL_TILES)) * -(-N // T_PREFILL_BN) * -(-K // T_PREFILL_BK)
    return KERNELS["t_prefill"] if pairs < 2 ** 31 else KERNELS["t"]


def int8_t_tile(M):
    """``int8_mm_t_prefill``'s token tile for M rows: the built tile that
    pads M the least, the wider on a tie (more products per widened
    weight fragment)."""
    return min(T_PREFILL_TILES, key=lambda tm: (-(-M // tm) * tm, -tm))


def int8_t_prefill_plan(M, N, K, sms, tm=None):
    """``(token tile, token tiles, weight-row tiles, k boxes, splits, k
    boxes per split)`` of ``int8_mm_t_prefill`` on a card of ``sms`` SMs:
    128 weight rows x ``tm`` tokens an output tile (``tm`` by default
    :func:`int8_t_tile`) over 64-wide k boxes; split-K while the tiles
    number fewer than the SMs (one block an SM), each split keeping at
    least four boxes and none empty."""
    tm = tm or int8_t_tile(M)
    mt, nt, kb = -(-M // tm), -(-N // T_PREFILL_BN), -(-K // T_PREFILL_BK)
    splits = max(1, min(sms // (mt * nt), kb // PREFILL_MIN_BOXES))
    per = -(-kb // splits)
    return tm, mt, nt, kb, -(-kb // per), per


def int8_t_prefill_blocks(M, N, K, tm, splits, per):
    """``int8_mm_t_prefill``'s blocks in launch order, as the kernel computes
    them: block b is split ``b % splits`` of tile ``b // splits``, tile
    ``weight-row tile * token tiles + token tile``.  Returns, per block,
    ``(tile, token tile, weight-row tile, split, first k box, end k box)``."""
    mt, nt, kb = -(-M // tm), -(-N // T_PREFILL_BN), -(-K // T_PREFILL_BK)
    return [(b // splits, (b // splits) % mt, (b // splits) // mt, b % splits,
             (b % splits) * per, min(kb, (b % splits) * per + per))
            for b in range(mt * nt * splits)]


def int8_prefill_plan(M, N, K, sms):
    """``(token tiles, column tiles, k boxes, splits, k boxes per split)``
    of ``int8_mm_nt_prefill`` on a card of ``sms`` SMs: 128 x 128 output
    tiles over 64-row k boxes; split-K while the tiles fill fewer than two
    blocks an SM, each split keeping at least four boxes and none empty."""
    mt, nt, kb = -(-M // PREFILL_BM), -(-N // PREFILL_BN), -(-K // PREFILL_BK)
    splits = max(1, min(PREFILL_BLOCKS_PER_SM * sms // (mt * nt), kb // PREFILL_MIN_BOXES))
    per = -(-kb // splits)
    return mt, nt, kb, -(-kb // per), per


def int8_prefill_blocks(M, N, K, splits, per):
    """``int8_mm_nt_prefill``'s blocks in launch order, as the kernel
    computes them: block b is split ``b % splits`` of tile ``b // splits``,
    tile ``column tile * token tiles + token tile``.  Returns, per block,
    ``(tile, token tile, column tile, split, first k box, end k box)``."""
    mt, nt, kb = -(-M // PREFILL_BM), -(-N // PREFILL_BN), -(-K // PREFILL_BK)
    blocks = []
    for b in range(mt * nt * splits):
        split, tile = b % splits, b // splits
        blocks.append((tile, tile % mt, tile // mt, split, split * per,
                       min(kb, split * per + per)))
    return blocks


def int8_decode_plan(N, K, sms):
    """``(column tiles, k boxes per tile, blocks)`` of ``int8_mm_nt_decode``
    on a card of ``sms`` SMs: 128 x 64 boxes, a persistent grid of one
    block per SM, never more blocks than boxes."""
    nt, kb = -(-N // DECODE_BN), -(-K // DECODE_BK)
    return nt, kb, min(nt * kb, sms)


def int8_decode_block_of(i, W, G):
    """The block whose range holds box ``i`` (the kernel's ``block_of``):
    the largest ``b`` with ``b W // G <= i``."""
    return ((i + 1) * G + W - 1) // W - 1


def int8_decode_blocks(N, K, blocks):
    """``int8_mm_nt_decode``'s schedule, as the kernel computes it: the
    boxes, ordered by (column tile, k box), cut into ``blocks`` contiguous
    ranges (block b: ``[b W // G, (b + 1) W // G)``).  Returns, per block,
    its segments ``(tile, first k box, end k box, slot)``: ``slot`` is the
    workspace slot of a partial (``2 b``, or ``2 b + 1`` when the tile is
    not the block's first), None when the block holds the whole tile and
    stores it; and, per split tile, the blocks that share it, in the order
    the last of them to count itself in adds their partials."""
    nt, kb = -(-N // DECODE_BN), -(-K // DECODE_BK)
    W, G = nt * kb, blocks
    per_block, shared = [], {}
    for b in range(G):
        lo, hi = b * W // G, (b + 1) * W // G
        segs, i = [], lo
        while i < hi:
            tile, end = i // kb, min(hi, (i // kb + 1) * kb)
            bf = int8_decode_block_of(tile * kb, W, G)
            bl = int8_decode_block_of(tile * kb + kb - 1, W, G)
            slot = None
            if bf != bl:
                slot = 2 * b + (tile != lo // kb)
                shared[tile] = list(range(bf, bl + 1))
            segs.append((tile, i - tile * kb, end - tile * kb, slot))
            i = end
        per_block.append(segs)
    return per_block, shared


def plan(M, N, K, sms):
    """``(tile, splits, k tiles per split)`` for an (M, N, K) product on a
    card of ``sms`` SMs: the decode tile for M <= 16, else the large one;
    split-K only while the output tiles number fewer than the SMs, up to
    two blocks per SM, each split keeping at least two K tiles."""
    tile = 0 if M <= 16 else 1
    BM, BN, BK = TILES[tile]
    tiles = -(-M // BM) * -(-N // BN)
    kt = -(-K // BK)
    splits = 1
    if tiles < sms and kt > 1:
        splits = max(1, min(-(-2 * sms // tiles), kt // 2))
    per = -(-kt // splits) if kt else 0
    splits = -(-kt // per) if per else 1
    return tile, splits, per


def _tile_counters(device, stream, n):
    """A zeroed int32 counter per output tile, kept per (device, stream):
    the kernel's last block of each tile sets its counter back to 0.

    A captured CUDA graph bakes the buffer's address in, so a buffer is
    never freed once made (a larger one is added beside it), and none is
    made while the stream captures: the step's warm-up on the capture
    stream makes it (``runtime/step_graph.py``)."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"int8_matmul: no split-K tile counters of {n} for this stream while it "
                "captures a CUDA graph; run the step once on the capture stream first")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _launch(x, q, scale, w_transposed, out_dtype, routed):
    lead, M, N, K = _shapes(x, q, w_transposed)
    dev = x.device
    if q.device != dev:
        raise ValueError(f"int8_matmul: q on {q.device}, x on {dev}")
    if not q.is_contiguous():
        raise ValueError("int8_matmul: q must be contiguous")
    scale = _scale_vector(scale, N, w_transposed, dev).contiguous()
    x2 = x.reshape(M, K).to(torch.bfloat16).contiguous()
    kernel_out = out_dtype if out_dtype in _OUT_CODES else torch.float32
    out = torch.empty((M, N), dtype=kernel_out, device=dev)
    if M == 0 or N == 0:
        return out.to(out_dtype).reshape(*lead, N)
    name = KERNELS["t" if w_transposed else "nt"]
    if routed:
        name = (int8_t_kernel if w_transposed else int8_nt_kernel)(M, N, K,
                                                                  q.data_ptr() % 16 == 0)
    fn = _entry(name)                   # builds the library, or raises
    if name == KERNELS["decode"]:
        return _launch_decode(fn, x2, q, scale, out, lead, M, N, K, out_dtype)
    if name == KERNELS["prefill"]:
        return _launch_prefill(fn, x2, q, scale, out, lead, M, N, K, out_dtype)
    if name == KERNELS["t_prefill"]:
        return _launch_t_prefill(fn, x2, q, scale, out, lead, M, N, K, out_dtype)
    tile, splits, per = plan(M, N, K, _sm_count(dev))
    BM, BN, _ = TILES[tile]
    tiles = -(-M // BM) * -(-N // BN)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty(tiles * splits * BM * BN, dtype=torch.float32, device=dev)
        counters = _tile_counters(dev, stream, tiles)
    x_vec = int(K % 8 == 0 and x2.data_ptr() % 16 == 0)
    q_vec = int((K if w_transposed else N) % 16 == 0 and q.data_ptr() % 16 == 0)
    null = ctypes.c_void_p(0)
    rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), int(scale.numel() > 1),
            out.data_ptr(), _OUT_CODES[kernel_out],
            ws.data_ptr() if ws is not None else null,
            counters.data_ptr() if counters is not None else null,
            M, N, K, tile, splits, per, x_vec, q_vec, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}"
                           + (" (unsupported configuration)" if rc == -1 else ""))
    launches[name] += 1
    if kernel_out != out_dtype:
        out = out.to(out_dtype)
    return out.reshape(*lead, N)


def _tma_rows(x2):
    """x as its TMA map needs it: a 16-byte base and row stride, else a
    copy padded to a multiple of 8 columns."""
    M, K = x2.shape
    if K % 8 == 0 and x2.data_ptr() % 16 == 0:
        return x2
    xp = torch.empty((M, -(-K // 8) * 8), dtype=torch.bfloat16, device=x2.device)
    xp[:, :K] = x2
    return xp


def _finish_tma(name, rc, out, lead, N, out_dtype):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}" + {
            -1: " (unsupported configuration)", -2: " (tensor map not encodable)",
            -3: " (the CUDA driver has no cuTensorMapEncodeTiled)"}.get(rc, ""))
    launches[name] += 1
    if out.dtype != out_dtype:
        out = out.to(out_dtype)
    return out.reshape(*lead, N)


def _launch_decode(fn, x2, q, scale, out, lead, M, N, K, out_dtype):
    dev = x2.device
    nt, _, blocks = int8_decode_plan(N, K, _sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = torch.empty(2 * blocks * DECODE_THREADS * (8 if M <= 8 else 16), dtype=torch.float32,
                     device=dev)
    counters = _tile_counters(dev, stream, nt)
    x2 = _tma_rows(x2)                  # at most 16 x K when copied
    rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _OUT_CODES[out.dtype], ws.data_ptr(), counters.data_ptr(), M, N, K, x2.shape[1],
            blocks, stream)
    return _finish_tma(KERNELS["decode"], rc, out, lead, N, out_dtype)


def _launch_prefill(fn, x2, q, scale, out, lead, M, N, K, out_dtype):
    dev = x2.device
    mt, nt, _, splits, per = int8_prefill_plan(M, N, K, _sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty(mt * nt * splits * PREFILL_BM * PREFILL_BN, dtype=torch.float32,
                         device=dev)
        counters = _tile_counters(dev, stream, mt * nt)
    x2 = _tma_rows(x2)
    null = ctypes.c_void_p(0)
    rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            _OUT_CODES[out.dtype], ws.data_ptr() if ws is not None else null,
            counters.data_ptr() if counters is not None else null, M, N, K, x2.shape[1],
            splits, per, stream)
    return _finish_tma(KERNELS["prefill"], rc, out, lead, N, out_dtype)


def _launch_t_prefill(fn, x2, q, scale, out, lead, M, N, K, out_dtype):
    dev = x2.device
    tm, mt, nt, _, splits, per = int8_t_prefill_plan(M, N, K, _sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = counters = None
    if splits > 1:
        ws = torch.empty(mt * nt * splits * T_PREFILL_BN * tm, dtype=torch.float32, device=dev)
        counters = _tile_counters(dev, stream, mt * nt)
    x2 = _tma_rows(x2)
    null = ctypes.c_void_p(0)
    rc = fn(x2.data_ptr(), q.data_ptr(), scale.data_ptr(), int(scale.numel() > 1),
            out.data_ptr(), _OUT_CODES[out.dtype], ws.data_ptr() if ws is not None else null,
            counters.data_ptr() if counters is not None else null, M, N, K, x2.shape[1], tm,
            splits, per, stream)
    return _finish_tma(KERNELS["t_prefill"], rc, out, lead, N, out_dtype)


_sms = {}


def _sm_count(device):
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _entry(name):
    from ..op_builder import cuda as builder
    fn = getattr(builder.load(LIBRARIES[name]), name)
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        if name == KERNELS["decode"]:
            fn.argtypes = [v, v, v, v, i, v, v, i, i, i, i, i, v]
        elif name == KERNELS["prefill"]:
            fn.argtypes = [v, v, v, v, i, v, v, i, i, i, i, i, i, v]
        elif name == KERNELS["t_prefill"]:
            fn.argtypes = [v, v, v, i, v, i, v, v, i, i, i, i, i, i, i, v]
        else:
            fn.argtypes = [v, v, v, i, v, i, v, v, i, i, i, i, i, i, i, i, v]
        fn.restype = ctypes.c_int
    return fn
