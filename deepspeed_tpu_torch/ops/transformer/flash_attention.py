"""Flash attention, dense, biased and block-sparse: CUDA kernels for Hopper.

Counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``: the
dense path (``flash_attention`` 913-934 over ``_flash_bhtd``'s custom VJP
901-910), the biased path (``flash_attention(key_padding_bias=,
attn_bias=)`` 923-925, ``_make_biased_bhtd``/``_biased_call`` 1177-1242)
and the block-sparse path (``sparse_flash_attention`` 1108-1173 with the
LUTs of ``_sparse_luts`` 84-127 / ``_layout_luts`` 1037-1050).  Its Pallas
kernels become hand-written CUDA kernels (``deepspeed_tpu_torch/csrc/
flash_attention.cuh``, entries in ``flash_attention.cu``,
``flash_attention_sparse_fwd.cu`` and ``flash_attention_sparse_bwd.cu``),
one wrapper and one launch counter per entry:

- ``flash_fwd`` / ``flash_fwd_biased`` / ``flash_fwd_lut`` (for
  ``_fwd_kernel`` 144: dense; with the (B, T) key bias and the (T, T)
  score bias; over the live tiles of a LUT, with the biases): online
  softmax over the visited k tiles, O in the input dtype and the fp32
  logsumexp;
- ``flash_fwd_lut_ring`` (for ``_fwd_kernel_dma`` 306): the unbiased LUT
  forward with a 3-deep ring of K/V tiles in flight;
- ``flash_bwd_dkdv`` / ``_biased`` / ``_lut`` (for ``_bwd_dkdv_kernel``
  617): per k tile over the (live) q tiles, P recomputed from the lse, dV
  and dK;
- ``flash_bwd_dq`` / ``_biased`` / ``_lut`` (for ``_bwd_dq_kernel`` 691):
  per q tile over the (live) k tiles, dQ.

:func:`flash_attention` and :func:`sparse_flash_attention` are
``torch.autograd.Function``\\ s saving ``(q, k, v, o, lse)`` (and the
biases), as the JAX rules do; ``delta = rowsum(dO * O)`` is computed in
fp32 by plain torch before the backward kernels, as XLA computes it
outside Pallas (line 776).  Bias cotangents are zeros (1214-1215).  For
CUDA tensors the wrappers launch the kernels or raise; only CPU tensors
take the plain versions :func:`flash_attention_reference_fwd` and
``flash_attention_reference_bwd_*``, which run the kernels' math in fp32
(P recomputed from the lse in the backward, lines 657-683 and 729-749),
expand a layout to its element mask with ``kron`` (as
``sparse_attention_reference`` 1265 does), add the biases after the
scale, mask to ``NEG_INF`` and round P and dS to the input dtype where the
kernels do.

Block-sparse LUTs: the kernels tile by 64 rows, the layout by its block
(``T // num_blocks``).  :class:`TileLut` compresses a layout into 64 x 64
tile LUTs on the host, cached by the layout's bytes: per q tile the live k
tiles (``kmap``/``klen``, the forward's and dQ's loop) and the transpose
(``qmap``/``qlen``, dK/dV's loop).  For blocks that are multiples of 64 a
tile is live iff its layout cell is; for blocks 16 and 32 a tile is live
iff any of its (64/b)^2 cells is, and it carries a bit mask of its live
cells that the kernel applies beside the causal and length masks (the
generalisation of the merged-row sub-masks, 245-255).  Other block sizes
raise.  A layout shared by the heads stays one layout (``Lh = 1``); a
per-head layout is indexed by ``h``, as at 200-202.

Differences from the JAX module: no block-size arguments for the kernels
(64-row tiles, the ragged tail masked in place of padding T to
lcm(bq, bk)); bf16 inputs run on the tensor cores, fp32 inputs on the
CUDA cores (head dims 64, 96 and 128); a causal band layout, which JAX
sends to its banded kernel (1162-1169), and every other layout take the
LUT kernels (the banded and merged-row kernels are not ported;
``block_q_merge=2`` raises ``NotImplementedError``); an all-ones layout
takes the dense kernels (the same numbers, no LUT); a row with no live key
(O = 0, lse = NEG_INF) gets no gradient, where the JAX backward computes
``exp(S - lse) = 1`` on it (ROADMAP.md section C); the
lse-differentiable variant (``flash_attention_with_lse``) is not ported; a
launch adds one to ``launches[<kernel name>]``.
"""

import ctypes
import functools
import math

import numpy as np
import torch

# flash_attention.py NEG_INF: masked scores, and the lse of a row with no live key
NEG_INF = -1e30
DENSE_KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
BIASED_KERNELS = ("flash_fwd_biased", "flash_bwd_dkdv_biased", "flash_bwd_dq_biased")
LUT_KERNELS = ("flash_fwd_lut", "flash_fwd_lut_ring", "flash_bwd_dkdv_lut",
               "flash_bwd_dq_lut")
KERNELS = DENSE_KERNELS + BIASED_KERNELS + LUT_KERNELS
# entry -> (library = csrc/<library>.cu, C function, variant argument or None)
ENTRIES = {
    "flash_fwd": ("flash_attention", "flash_fwd", None),
    "flash_bwd_dkdv": ("flash_attention", "flash_bwd_dkdv", None),
    "flash_bwd_dq": ("flash_attention", "flash_bwd_dq", None),
    "flash_fwd_biased": ("flash_attention_sparse_fwd", "flash_fwd_variant", 1),
    "flash_fwd_lut": ("flash_attention_sparse_fwd", "flash_fwd_variant", 2),
    "flash_fwd_lut_ring": ("flash_attention_sparse_fwd", "flash_fwd_variant", 3),
    "flash_bwd_dkdv_biased": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 1),
    "flash_bwd_dkdv_lut": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 2),
    "flash_bwd_dq_biased": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 1),
    "flash_bwd_dq_lut": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 2),
}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS}
HEAD_DIMS = {torch.bfloat16: (64, 96, 128), torch.float32: (64, 96, 128)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64            # the kernels' q and k tile rows (kBQ, kBK)


def reset_launches():
    for name in launches:
        launches[name] = 0


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


# ------------------------------------------------------------- tile LUTs
def _lut_rows(tmask):
    """(Lh, rows, cols) tile masks -> ``(map, mask, len)``: per row the live
    columns in ascending order (slots past ``len`` hold 0)."""
    live = tmask != 0
    length = live.sum(-1).astype(np.int32)
    width = max(1, int(length.max(initial=0)))
    order = np.argsort(~live, axis=-1, kind="stable")[..., :width]
    slot = np.arange(width) < length[..., None]
    tmap = np.where(slot, order, 0).astype(np.int32)
    mask = np.where(slot, np.take_along_axis(tmask, order, axis=-1), 0).astype(np.int32)
    return np.ascontiguousarray(tmap), np.ascontiguousarray(mask), length


class TileLut:
    """The 64 x 64 tile LUTs of one block layout ``(Lh, nb, nb)`` at
    sequence length ``T`` (see the module docstring).

    ``kmap``/``kmask`` (Lh, nt, Lk) and ``klen`` (Lh, nt): per q tile the
    live k tiles and their cell masks (-1: every element live; else bit
    ``(q_cell << (6 - cell_shift)) + k_cell``); ``qmap``/``qmask``/``qlen``:
    the transpose, per k tile.  Causal pruning is applied at the layout
    cell (``k_block <= q_block``, as ``_sparse_luts`` 104-107 does), the
    element-level causal and length masks in the kernel."""

    def __init__(self, layout, T, causal):
        layout = np.array(layout, np.int32)
        Lh, nb, nb2 = layout.shape
        block = T // nb if nb else 0
        if nb != nb2 or nb == 0 or block * nb != T:
            raise ValueError(f"layout {layout.shape} does not tile T={T} in square blocks")
        if block not in (16, 32) and block % TILE:
            raise ValueError(f"layout block {block} is not supported by the kernels' "
                             f"{TILE}-row tiles: use 16, 32 or a multiple of {TILE}")
        self.layout, self.T, self.causal, self.block = layout, int(T), bool(causal), block
        cells = layout > 0
        if causal:
            cells = cells & np.tril(np.ones((nb, nb), bool))
        nt = -(-T // TILE)
        if block >= TILE:
            r = block // TILE
            tiles = cells.repeat(r, axis=1).repeat(r, axis=2)
            tmask = np.where(tiles, -1, 0)
            self.cell_shift = 6
        else:
            R = TILE // block
            pad = nt * R - nb
            c = np.pad(cells, ((0, 0), (0, pad), (0, pad)))
            c = c.reshape(Lh, nt, R, nt, R).transpose(0, 1, 3, 2, 4)   # (Lh, i, j, u, w)
            bits = (c * (1 << np.arange(R * R)).reshape(R, R)).sum((-2, -1))
            tmask = np.where(bits == (1 << R * R) - 1, -1, bits)
            self.cell_shift = int(math.log2(block))
        self.tile_mask = tmask.astype(np.int32)                      # (Lh, nt, nt)
        self.kmap, self.kmask, self.klen = _lut_rows(self.tile_mask)
        self.qmap, self.qmask, self.qlen = _lut_rows(
            np.ascontiguousarray(self.tile_mask.transpose(0, 2, 1)))
        self._device = {}

    @property
    def heads(self):
        return self.layout.shape[0]

    @property
    def tile_density(self):
        """Live tiles over all tiles (mean over the head layouts)."""
        return float((self.tile_mask != 0).mean())

    @property
    def element_density(self):
        """Live (q, k) pairs of the layout (and causal mask) over T^2."""
        return float(self.element_mask("cpu").float().mean())

    def tensors(self, device):
        """The six LUT arrays as int32 tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._device:
            self._device[key] = {
                name: torch.as_tensor(getattr(self, name), device=device)
                for name in ("kmap", "kmask", "klen", "qmap", "qmask", "qlen")}
        return self._device[key]

    def element_mask(self, device):
        """(Lh, T, T) bool: the layout expanded with ``kron`` and the causal
        mask, as ``sparse_attention_reference`` 1265-1270 builds it."""
        key = ("mask", str(device))
        if key not in self._device:
            b = self.block
            lay = torch.as_tensor(self.layout, device=device).float()
            mask = torch.kron(lay, torch.ones((1, b, b), device=device)) > 0
            if self.causal:
                mask = mask & torch.ones((self.T, self.T), dtype=torch.bool,
                                         device=device).tril()
            self._device[key] = mask
        return self._device[key]


@functools.lru_cache(maxsize=64)
def _tile_lut_cached(layout_bytes, shape, T, causal):
    return TileLut(np.frombuffer(layout_bytes, np.int32).reshape(shape), T, causal)


def layout_luts(layout, T, H, causal):
    """Host-static layout ``(Lh, nb, nb)`` -> its :class:`TileLut` at ``T``
    (cached by layout content, as ``_layout_luts`` 1037 caches
    ``_sparse_luts``); ``Lh`` is 1 (shared) or ``H``."""
    if isinstance(layout, torch.Tensor):
        layout = layout.cpu().numpy()
    layout = np.ascontiguousarray(np.asarray(layout, np.int32))
    if layout.ndim != 3 or layout.shape[0] not in (1, H):
        raise ValueError(f"layout {layout.shape}: expected (1 or H={H}, nb, nb)")
    return _tile_lut_cached(layout.tobytes(), layout.shape, int(T), bool(causal))


# --------------------------------------------------------- plain versions
def _scores(q, k, causal, sm_scale, lut=None, kbias=None, abias=None):
    """fp32 ``(B, H, T, T)`` scaled scores plus the biases, masked to
    NEG_INF, and the mask (the layout's element mask when ``lut`` is given,
    with the causal mask; ``k_pos < T`` holds by construction here)."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if kbias is not None:
        s = s + kbias.float()[:, None, None, :]
    if abias is not None:
        s = s + abias.float()
    if lut is not None:
        valid = lut.element_mask(q.device)
    else:
        pos = torch.arange(T, device=q.device)
        valid = (pos[:, None] >= pos[None, :]) if causal else torch.ones(
            (T, T), dtype=torch.bool, device=q.device)
    return torch.where(valid, s, torch.full_like(s, NEG_INF)), valid


def flash_attention_reference_fwd(q, k, v, causal=True, sm_scale=None, *, lut=None,
                                  key_padding_bias=None, attn_bias=None):
    """Plain version of the forward kernels: ``(o (B, T, H, d) in q.dtype,
    lse (B, H, T) fp32)``.  One softmax pass over the whole row (the
    kernel rounds P to the input dtype tile by tile against its running
    max, so in bf16 the two differ by rounding).  A row whose every score
    is masked (or NEG_INF-biased) gives O = 0 and lse = NEG_INF."""
    sm_scale = _scale(q, sm_scale)
    if lut is not None:
        causal = lut.causal
    s, valid = _scores(q, k, causal, sm_scale, lut, key_padding_bias, attn_bias)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    live = m > NEG_INF * 0.5
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype).float(), v.float())
    o = torch.where(live, acc / l_safe, torch.zeros_like(acc))
    lse = torch.where(live, m + torch.log(l_safe), torch.full_like(m, NEG_INF))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def attention_delta(o, do):
    """``rowsum(dO * O)`` in fp32, (B, H, T) contiguous (line 776)."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _p_ds(q, k, v, do, lse, delta, causal, sm_scale, lut=None, kbias=None, abias=None):
    """fp32 ``P = exp(S - lse)`` (0 where masked and on rows with no live
    key) and ``dS = P * (dO V^T - delta) * scale``, (B, H, T, T)."""
    if lut is not None:
        causal = lut.causal
    s, valid = _scores(q, k, causal, sm_scale, lut, kbias, abias)
    valid = valid & (lse > NEG_INF * 0.5)[..., None]
    p = torch.where(valid, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * sm_scale


def flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal=True,
                                       sm_scale=None, *, lut=None,
                                       key_padding_bias=None, attn_bias=None):
    """Plain version of the dK/dV kernels: ``(dk, dv)`` with P and dS
    rounded to the input dtype before the products with dO and Q."""
    dt = q.dtype
    p, ds = _p_ds(q, k, v, do, lse, delta, causal, _scale(q, sm_scale), lut,
                  key_padding_bias, attn_bias)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(dt).float(), q.float())
    return dk.to(dt), dv.to(dt)


def flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal=True,
                                     sm_scale=None, *, lut=None, key_padding_bias=None,
                                     attn_bias=None):
    """Plain version of the dQ kernels: ``dq`` with dS rounded to the
    input dtype before the product with K."""
    dt = q.dtype
    _, ds = _p_ds(q, k, v, do, lse, delta, causal, _scale(q, sm_scale), lut,
                  key_padding_bias, attn_bias)
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(dt).float(), k.float()).to(dt)


def flash_attention_reference_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """Plain version of the backward: ``delta = rowsum(dO * O)`` in fp32,
    then :func:`flash_attention_reference_bwd_dkdv` and
    :func:`flash_attention_reference_bwd_dq` (P recomputed from ``lse``
    (B, H, T)).  Returns ``(dq, dk, dv)`` in the input dtype, (B, T, H, d)."""
    delta = attention_delta(o, do)
    dk, dv = flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal, sm_scale)
    dq = flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


# ------------------------------------------------------------- wrappers
def _check(name, tensors, dtype, head_dim):
    q = tensors[0]
    for t in tensors:
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name}: every operand must match q's device, dtype and "
                             f"shape {tuple(q.shape)}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name}: operands are (B, T, H, d) with the last dim "
                             f"contiguous (strides {t.stride()})")
        es = t.element_size()
        if t.data_ptr() % 16 or any((s * es) % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: operand base and (b, t, h) strides must be "
                             f"16-byte aligned for the kernel's vector loads")
    if dtype not in HEAD_DIMS:
        raise ValueError(f"{name}: dtype {dtype} unsupported (bf16 on the tensor cores, "
                         f"fp32 on the CUDA cores)")
    if head_dim not in HEAD_DIMS[dtype]:
        raise ValueError(f"{name}: head dim {head_dim} not built for {dtype} "
                         f"(supported {HEAD_DIMS[dtype]})")
    B, _, H, _ = q.shape
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid's 65535")


class _Extra(ctypes.Structure):
    """``Extra`` of ``csrc/flash_attention.cuh``: the LUT and the biases."""
    _fields_ = [("map", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("len", ctypes.c_void_p), ("kbias", ctypes.c_void_p),
                ("abias", ctypes.c_void_p), ("width", ctypes.c_int),
                ("heads", ctypes.c_int), ("cell_shift", ctypes.c_int)]


def _extra(name, q, lut, kbias, abias, rows):
    """The ``Extra`` of one launch (``rows``: "k" for the forward and dQ
    loops over the LUT's k tiles, "q" for dK/dV's over its q tiles),
    after checking the biases and the LUT against ``q``."""
    B, T, H, _ = q.shape
    for label, bias, shape in (("key_padding_bias", kbias, (B, T)),
                               ("attn_bias", abias, (T, T))):
        if bias is not None and (bias.shape != shape or bias.dtype != torch.float32
                                 or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError(f"{name}: {label} must be a contiguous fp32 {shape} tensor "
                             "on q's device")
    x = _Extra()
    x.kbias = None if kbias is None else kbias.data_ptr()
    x.abias = None if abias is None else abias.data_ptr()
    if lut is not None:
        if lut.T != T or lut.heads not in (1, H):
            raise ValueError(f"{name}: LUT of T={lut.T}, {lut.heads} head layouts does "
                             f"not fit q {tuple(q.shape)}")
        t = lut.tensors(q.device)
        x.map, x.mask, x.len = (t[f"{rows}{s}"].data_ptr() for s in ("map", "mask", "len"))
        x.width = t[f"{rows}map"].shape[-1]
        x.heads, x.cell_shift = lut.heads, lut.cell_shift
    return x


def _strides(*tensors):
    vals = []
    for t in tensors:
        vals += list(t.stride()[:3])
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _entry(name):
    from ..op_builder import cuda as builder
    lib, fn_name, variant = ENTRIES[name]
    fn = getattr(builder.load(lib), fn_name)
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        n_ptr = {"fwd": 5, "dkdv": 8, "dq": 7}[fn_name.split("_")[-2 if variant else -1]]
        args = [i, i] + [v] * n_ptr + [v, i, i, i, i, f]
        fn.argtypes = (args + [v]) if variant is None else ([i] + args + [v, v])
        fn.restype = ctypes.c_int
    return fn if variant is None else functools.partial(fn, variant)


def _run(name, *args, device):
    rc = _entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}"
                           + (" (unsupported configuration)" if rc == -1 else ""))
    launches[name] += 1


def _fwd(name, q, k, v, causal, sm_scale, lut=None, kbias=None, abias=None):
    if q.device.type == "cpu":
        return flash_attention_reference_fwd(q, k, v, causal, sm_scale, lut=lut,
                                             key_padding_bias=kbias, attn_bias=abias)
    B, T, H, d = q.shape
    _check(name, (q, k, v), q.dtype, d)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "k")]
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    _run(name, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides), B, T, H, int(causal),
         _scale(q, sm_scale), *(ctypes.addressof(x) for x in extra), device=q.device)
    return o, lse


def flash_fwd(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)`` of (B, T, H, d) q/k/v: the ``flash_fwd`` kernel for
    CUDA tensors, the plain version for CPU tensors."""
    return _fwd("flash_fwd", q, k, v, causal, sm_scale)


def flash_fwd_biased(q, k, v, key_padding_bias=None, attn_bias=None, causal=True,
                     sm_scale=None):
    """``(o, lse)`` with the additive fp32 biases ``key_padding_bias``
    (B, T) and ``attn_bias`` (T, T), each optional: ``flash_fwd_biased``."""
    return _fwd("flash_fwd_biased", q, k, v, causal, sm_scale, None, key_padding_bias,
                attn_bias)


def flash_fwd_lut(q, k, v, lut, key_padding_bias=None, attn_bias=None, sm_scale=None):
    """``(o, lse)`` over the live tiles of ``lut`` (a :class:`TileLut`,
    causal as it was built) with the optional biases: ``flash_fwd_lut``."""
    return _fwd("flash_fwd_lut", q, k, v, lut.causal, sm_scale, lut, key_padding_bias,
                attn_bias)


def flash_fwd_lut_ring(q, k, v, lut, sm_scale=None):
    """``(o, lse)`` over the live tiles of ``lut``, no biases: the
    ``flash_fwd_lut_ring`` kernel (K/V tiles fetched three deep)."""
    return _fwd("flash_fwd_lut_ring", q, k, v, lut.causal, sm_scale, lut)


def _bwd_args(name, q, k, v, do, lse, delta):
    B, T, H, d = q.shape
    _check(name, (q, k, v, do), q.dtype, d)
    for stat in (lse, delta):
        if (stat.shape != (B, H, T) or stat.dtype != torch.float32
                or not stat.is_contiguous() or stat.device != q.device):
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 (B, H, T) "
                             "on q's device")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())


def _bwd_dkdv(name, q, k, v, do, lse, delta, causal, sm_scale, lut=None, kbias=None,
              abias=None):
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dkdv(
            q, k, v, do, lse, delta, causal, sm_scale, lut=lut, key_padding_bias=kbias,
            attn_bias=abias)
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "q")]
    B, T, H, d = q.shape
    dk = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do)
    _run(name, _DTYPE_CODES[q.dtype], d, *ptrs, dk.data_ptr(), dv.data_ptr(),
         ctypes.addressof(strides), B, T, H, int(causal), _scale(q, sm_scale),
         *(ctypes.addressof(x) for x in extra), device=q.device)
    return dk, dv


def _bwd_dq(name, q, k, v, do, lse, delta, causal, sm_scale, lut=None, kbias=None,
            abias=None):
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dq(
            q, k, v, do, lse, delta, causal, sm_scale, lut=lut, key_padding_bias=kbias,
            attn_bias=abias)
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "k")]
    B, T, H, d = q.shape
    dq = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, do)
    _run(name, _DTYPE_CODES[q.dtype], d, *ptrs, dq.data_ptr(), ctypes.addressof(strides),
         B, T, H, int(causal), _scale(q, sm_scale), *(ctypes.addressof(x) for x in extra),
         device=q.device)
    return dq


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``(dk, dv)``: the ``flash_bwd_dkdv`` kernel for CUDA tensors, the
    plain version for CPU tensors."""
    return _bwd_dkdv("flash_bwd_dkdv", q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``dq``: the ``flash_bwd_dq`` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return _bwd_dq("flash_bwd_dq", q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dkdv_biased(q, k, v, do, lse, delta, key_padding_bias=None, attn_bias=None,
                          causal=True, sm_scale=None):
    """``(dk, dv)`` with the biases: ``flash_bwd_dkdv_biased``."""
    return _bwd_dkdv("flash_bwd_dkdv_biased", q, k, v, do, lse, delta, causal, sm_scale,
                     None, key_padding_bias, attn_bias)


def flash_bwd_dq_biased(q, k, v, do, lse, delta, key_padding_bias=None, attn_bias=None,
                        causal=True, sm_scale=None):
    """``dq`` with the biases: ``flash_bwd_dq_biased``."""
    return _bwd_dq("flash_bwd_dq_biased", q, k, v, do, lse, delta, causal, sm_scale,
                   None, key_padding_bias, attn_bias)


def flash_bwd_dkdv_lut(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                       attn_bias=None, sm_scale=None):
    """``(dk, dv)`` over the live q tiles of each k tile of ``lut`` (its
    transpose, ``qmap``/``qlen``), with the optional biases:
    ``flash_bwd_dkdv_lut``."""
    return _bwd_dkdv("flash_bwd_dkdv_lut", q, k, v, do, lse, delta, lut.causal, sm_scale,
                     lut, key_padding_bias, attn_bias)


def flash_bwd_dq_lut(q, k, v, do, lse, delta, lut, key_padding_bias=None, attn_bias=None,
                     sm_scale=None):
    """``dq`` over the live k tiles of each q tile of ``lut``, with the
    optional biases: ``flash_bwd_dq_lut``."""
    return _bwd_dq("flash_bwd_dq_lut", q, k, v, do, lse, delta, lut.causal, sm_scale,
                   lut, key_padding_bias, attn_bias)


def flash_bwd(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """``(dq, dk, dv)``: ``delta = rowsum(dO * O)`` in fp32 by plain
    torch, then :func:`flash_bwd_dkdv` and :func:`flash_bwd_dq`."""
    delta = attention_delta(o, do)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, causal, sm_scale)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale), dk, dv


# -------------------------------------------------------------- autograd
class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


class _MaskedFlashAttention(torch.autograd.Function):
    """The biased (``lut is None``) and block-sparse paths: the unbiased
    LUT forward takes the ring kernel, the biased ones ``flash_fwd_lut``
    / ``flash_fwd_biased``; the backward the matching LUT or biased
    kernels.  Bias cotangents are zeros (the masks are constants)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, abias, lut, causal, sm_scale):
        if lut is None:
            o, lse = flash_fwd_biased(q, k, v, kbias, abias, causal, sm_scale)
        elif kbias is None and abias is None:
            o, lse = flash_fwd_lut_ring(q, k, v, lut, sm_scale)
        else:
            o, lse = flash_fwd_lut(q, k, v, lut, kbias, abias, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, kbias, abias)
        ctx.lut, ctx.causal, ctx.sm_scale = lut, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kbias, abias = ctx.saved_tensors
        delta = attention_delta(o, do)
        if ctx.lut is None:
            dk, dv = flash_bwd_dkdv_biased(q, k, v, do, lse, delta, kbias, abias,
                                           ctx.causal, ctx.sm_scale)
            dq = flash_bwd_dq_biased(q, k, v, do, lse, delta, kbias, abias, ctx.causal,
                                     ctx.sm_scale)
        else:
            dk, dv = flash_bwd_dkdv_lut(q, k, v, do, lse, delta, ctx.lut, kbias, abias,
                                        ctx.sm_scale)
            dq = flash_bwd_dq_lut(q, k, v, do, lse, delta, ctx.lut, kbias, abias,
                                  ctx.sm_scale)
        zero = (lambda t: None if t is None else torch.zeros_like(t))
        return dq, dk, dv, zero(kbias), zero(abias), None, None, None


def _as_bias(bias, q):
    if bias is None:
        return None
    return torch.as_tensor(bias).to(device=q.device, dtype=torch.float32).contiguous()


def flash_attention(q, k, v, *, causal=True, sm_scale=None, key_padding_bias=None,
                    attn_bias=None):
    """Flash attention over (B, T, H, d) tensors (the model layout);
    returns (B, T, H, d) in the input dtype.  ``sm_scale`` defaults to
    ``1/sqrt(d)``; the softmax statistics are fp32.  ``key_padding_bias``
    (B, T) and ``attn_bias`` (T, T) are additive score biases applied
    in-kernel after the scale (``NEG_INF`` entries mask)."""
    sm_scale = _scale(q, sm_scale)
    if key_padding_bias is None and attn_bias is None:
        return _FlashAttention.apply(q, k, v, bool(causal), sm_scale)
    return _MaskedFlashAttention.apply(q, k, v, _as_bias(key_padding_bias, q),
                                       _as_bias(attn_bias, q), None, bool(causal), sm_scale)


def sparse_flash_attention(q, k, v, layout, *, causal=True, sm_scale=None, block_q=None,
                           block_k=None, block_q_merge=1, key_padding_bias=None,
                           attn_bias=None):
    """Block-sparse flash attention over (B, T, H, d).

    ``layout``: (n_heads_or_1, nq, nk) host-static int block mask from a
    ``SparsityConfig``; the block size is implied (``T // nq``) and must
    be 16, 32 or a multiple of 64.  The layout compiles into the tile
    LUTs of :class:`TileLut` that drive the kernels' loops, so skipped
    tiles are neither read nor computed.  ``key_padding_bias`` /
    ``attn_bias`` as in :func:`flash_attention`.  An all-ones layout runs
    the dense kernels; ``block_q_merge`` other than 1 raises."""
    B, T, H, d = q.shape
    if isinstance(layout, torch.Tensor):
        layout = layout.cpu().numpy()
    layout = np.asarray(layout, np.int32)
    _, nq, nk = layout.shape
    block_q = T // nq if block_q is None else int(block_q)
    block_k = T // nk if block_k is None else int(block_k)
    if block_q * nq != T or block_k * nk != T or block_q != block_k:
        raise ValueError(f"layout {layout.shape} incompatible with T={T} (square blocks "
                         f"{block_q} x {block_k})")
    if block_q_merge != 1:
        raise NotImplementedError("block_q_merge=2 (two layout rows per kernel row, "
                                  "a TPU grid option) is not ported")
    sm_scale = _scale(q, sm_scale)
    kb, ab = _as_bias(key_padding_bias, q), _as_bias(attn_bias, q)
    lut = layout_luts(layout, T, H, causal)
    if (layout > 0).all():
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               key_padding_bias=kb, attn_bias=ab)
    return _MaskedFlashAttention.apply(q, k, v, kb, ab, lut, bool(causal), sm_scale)


def sparse_attention_reference(q, k, v, layout, *, causal=True, sm_scale=None):
    """Dense oracle (``sparse_attention_reference`` 1258): expand the
    block layout to an element mask with ``kron``, softmax with ``-inf``
    masking, fully masked rows 0."""
    B, T, H, d = q.shape
    layout = torch.as_tensor(np.asarray(layout), device=q.device).float()
    Lh, nq, nk = layout.shape
    sm_scale = _scale(q, sm_scale)
    mask = torch.kron(layout, torch.ones((1, T // nq, T // nk), device=q.device)) > 0
    if causal:
        mask = mask & torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * sm_scale
    s = torch.where(mask[None], s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
