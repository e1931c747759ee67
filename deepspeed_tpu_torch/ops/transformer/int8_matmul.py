"""Weight-int8 matmul: bf16 activations times int8 weights, streaming int8.

Counterpart of ``deepspeed_tpu/ops/transformer/int8_matmul.py``.  The two
Pallas kernels there become one hand-written CUDA kernel for Hopper in
``deepspeed_tpu_torch/csrc/int8_matmul.cu`` with two entries:

- ``int8_mm_nt`` (for ``_kernel_nt``): ``q`` is (K, N), N contiguous --
  every block weight of GPT-2;
- ``int8_mm_t`` (for ``_kernel_t``): ``q`` is (N, K), K contiguous --
  the tied head.

Both compute what both branches of the JAX ``int8_matmul`` compute:
``bf16(x) @ bf16(q)`` with the products summed in fp32, times the scale
(per tensor, or per output channel with ``w_transposed``), cast to
``out_dtype`` last.  The widened weight never reaches device memory.

:func:`int8_matmul` launches the kernel for CUDA tensors, at any M, and
takes the plain version :func:`int8_matmul_reference` only for CPU
tensors.  Differences from the JAX module: ``use_pallas`` and
``block_n`` are accepted for signature parity and have no effect (the
JAX default ``use_pallas=False`` sends every call to XLA's fused
convert-in-dot; on the GPU no library call streams int8 into a bf16
product, so the kernel serves both branches); outputs other than bf16
and fp32 are computed in fp32 and cast (one rounding either way); a
launch adds one to ``launches[<kernel name>]``.
"""

import ctypes
import math

import torch

KERNELS = {"nt": "int8_mm_nt", "t": "int8_mm_t"}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS.values()}

_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}
# tile configurations of the kernel: (BM, BN, BK)
TILES = {0: (16, 64, 128),     # M <= 16: decode
         1: (64, 128, 64)}     # larger M: prefill
_counters = {}                 # (device, stream) -> zeroed int32 split-K tile counters


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
    return _launch(x, q, scale, w_transposed, out_dtype)


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
    the kernel's last block of each tile sets its counter back to 0."""
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _launch(x, q, scale, w_transposed, out_dtype):
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
    fn = _entry(name)                   # builds the library, or raises
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


_sms = {}


def _sm_count(device):
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _entry(name):
    from ..op_builder import cuda as builder
    fn = getattr(builder.load("int8_matmul"), name)
    if fn.argtypes is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [v, v, v, i, v, i, v, v, i, i, i, i, i, i, i, i, v]
        fn.restype = ctypes.c_int
    return fn
