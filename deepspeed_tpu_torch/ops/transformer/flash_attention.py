"""Flash attention, dense, biased and block-sparse: CUDA kernels for Hopper.

Counterpart of ``deepspeed_tpu/ops/transformer/flash_attention.py``: the
dense path (``flash_attention`` 913-934 over ``_flash_bhtd``'s custom VJP
901-910), ``flash_attention_with_lse`` (937-970), the biased path
(``flash_attention(key_padding_bias=, attn_bias=)`` 923-925,
``_make_biased_bhtd``/``_biased_call`` 1177-1242) and the block-sparse path
(``sparse_flash_attention`` 1108-1173 with the LUTs of ``_sparse_luts``
84-127 / ``_layout_luts`` 1037-1050, the band detection of
``_banded_structure`` 999-1034 and the merged-row LUTs of
``_merged_luts_cached`` 1053-1073).  Its Pallas kernels become hand-written
CUDA kernels (``deepspeed_tpu_torch/csrc/flash_attention.cuh``, entries in
``flash_attention.cu``, ``flash_attention_sparse_fwd.cu``,
``flash_attention_sparse_bwd.cu`` and ``flash_attention_band_merge_fwd.cu``;
the dense bf16 forward at head dims 64 and 128 in
``flash_attention_fwd_sm90.cu``), one wrapper and one launch counter per
entry:

- ``flash_fwd_sm90`` (for ``_fwd_kernel`` 144, dense): the bf16 forward
  at head dims 64 and 128 with TMA, an mbarrier ring fed by a producer
  warp, ``wgmma`` and 128-row q tiles over two consumer warpgroups;
  :func:`flash_fwd` sends CUDA tensors of that dtype and head dim there
  (:func:`dense_fwd_kernel`), by dtype and head dim alone, and
  :func:`flash_fwd_sm90_schedule` is its schedule in Python;
- ``flash_fwd`` / ``flash_fwd_biased`` / ``flash_fwd_lut`` (for
  ``_fwd_kernel`` 144: dense, fp32 and bf16 at head dim 96; with the (B,
  T) key bias and the (T, T) score bias; over the live tiles of a LUT,
  with the biases): online softmax over the visited k tiles, O in the
  input dtype and the fp32 logsumexp;
- ``flash_fwd_lut_ring`` (for ``_fwd_kernel_dma`` 306): the unbiased LUT
  forward with a 3-deep ring of K/V tiles in flight;
- ``flash_fwd_banded`` (for ``_fwd_kernel`` with ``use_banded`` 180-198,
  230-244): the causal forward over a :class:`BandLut`, its k tiles from
  affine arithmetic on the band and a positional element mask;
- ``flash_fwd_merged`` (for ``_fwd_kernel`` / ``_fwd_kernel_dma`` with
  ``use_merge`` 161-164, 245-255, 317-319, 384-390): the forward over a
  :class:`MergedLut`, two q tiles per kernel row;
- ``flash_bwd_dkdv`` / ``_biased`` / ``_lut`` (for ``_bwd_dkdv_kernel``
  617): per k tile over the (live) q tiles, P recomputed from the lse, dV
  and dK;
- ``flash_bwd_dq`` / ``_biased`` / ``_lut`` (for ``_bwd_dq_kernel`` 691):
  per q tile over the (live) k tiles, dQ.

:func:`flash_attention`, :func:`flash_attention_with_lse` and
:func:`sparse_flash_attention` are ``torch.autograd.Function``\\ s saving
``(q, k, v, o, lse)`` (and the biases), as the JAX rules do; ``delta =
rowsum(dO * O)`` is computed in fp32 by plain torch before the backward
kernels, as XLA computes it outside Pallas (line 776), and the lse
cotangent of :func:`flash_attention_with_lse` enters as ``delta - dlse``
(777-781).  Bias cotangents are zeros (1214-1215).  For
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

Banded and merged rows: a causal layout shared by the heads whose live
blocks are a band of ``W`` blocks below the diagonal plus global columns
(:func:`banded_structure`, JAX's detector) runs the banded forward over a
:class:`BandLut` (``T <= 65536``, the size of the kernel's band
parameter), as JAX routes it (1157-1172); ``block_q_merge=2`` runs the
merged-row forward over a :class:`MergedLut` for every layout.  Both
backwards are the unmerged LUT kernels with the layout's :class:`TileLut`,
as JAX's rules (988-993, 1093-1102).  JAX merges pairs of layout rows into
kernel rows of ``2 * block_q``; here the kernels' rows are 64-row tiles, so
the merge pairs q tiles (see :class:`MergedLut`): the same function, the
same validation (``block_q_merge`` 1 or 2, an even number of layout rows,
no biases; ``ValueError`` where JAX asserts).

Differences from the JAX module: no block-size arguments for the kernels
(64-row tiles, the ragged tail masked in place of padding T to
lcm(bq, bk)); bf16 inputs run on the tensor cores, fp32 inputs on the
CUDA cores (head dims 64, 96 and 128); an all-ones layout takes the dense
kernels (the same numbers, no LUT) unless ``block_q_merge=2``; a row with
no live key (O = 0, lse = NEG_INF) gets no gradient, where the JAX backward
computes ``exp(S - lse) = 1`` on it (ROADMAP.md section C); the backward
makes the output cotangent contiguous before the kernels (a cotangent
expanded from a sum has stride 0); a launch adds one to
``launches[<kernel name>]``.
"""

import ctypes
import functools
import math

import numpy as np
import torch

# flash_attention.py NEG_INF: masked scores, and the lse of a row with no live key
NEG_INF = -1e30
DENSE_KERNELS = ("flash_fwd", "flash_fwd_sm90", "flash_bwd_dkdv", "flash_bwd_dq")
BIASED_KERNELS = ("flash_fwd_biased", "flash_bwd_dkdv_biased", "flash_bwd_dq_biased")
LUT_KERNELS = ("flash_fwd_lut", "flash_fwd_lut_ring", "flash_fwd_banded",
               "flash_fwd_merged", "flash_bwd_dkdv_lut", "flash_bwd_dq_lut")
KERNELS = DENSE_KERNELS + BIASED_KERNELS + LUT_KERNELS
# entry -> (library = csrc/<library>.cu, C function, variant argument or None)
ENTRIES = {
    "flash_fwd": ("flash_attention", "flash_fwd", None),
    "flash_fwd_sm90": ("flash_attention_fwd_sm90", "flash_fwd_sm90", None),
    "flash_bwd_dkdv": ("flash_attention", "flash_bwd_dkdv", None),
    "flash_bwd_dq": ("flash_attention", "flash_bwd_dq", None),
    "flash_fwd_biased": ("flash_attention_sparse_fwd", "flash_fwd_variant", 1),
    "flash_fwd_lut": ("flash_attention_sparse_fwd", "flash_fwd_variant", 2),
    "flash_fwd_lut_ring": ("flash_attention_sparse_fwd", "flash_fwd_variant", 3),
    "flash_fwd_banded": ("flash_attention_band_merge_fwd", "flash_fwd_variant", 4),
    "flash_fwd_merged": ("flash_attention_band_merge_fwd", "flash_fwd_variant", 5),
    "flash_bwd_dkdv_biased": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 1),
    "flash_bwd_dkdv_lut": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 2),
    "flash_bwd_dq_biased": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 1),
    "flash_bwd_dq_lut": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 2),
}
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS}
HEAD_DIMS = {torch.bfloat16: (64, 96, 128), torch.float32: (64, 96, 128)}
# flash_fwd_sm90: the dtype and head dims it is built for, its q tile and its k tile
# (csrc/flash_attention_fwd_sm90.cu: kBQ, Cfg<D>::kBN)
SM90_HEAD_DIMS = {torch.bfloat16: (64, 128)}
SM90_BLOCK_Q, SM90_BLOCK_N = 128, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64            # the kernels' q and k tile rows (kBQ, kBK)
# the banded kernel's Band parameter (csrc/flash_attention.cuh): global tiles, layout columns
MAX_GLOBAL_TILES, MAX_LAYOUT_COLS = 1024, 4096
MAX_BAND_T = MAX_LAYOUT_COLS * 16


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
        self._merged = None

    @property
    def heads(self):
        return self.layout.shape[0]

    @property
    def tile_density(self):
        """Live tiles over all tiles (mean over the head layouts)."""
        return float((self.tile_mask != 0).mean())

    @property
    def merged(self):
        """The :class:`MergedLut` of these tiles (built once)."""
        if self._merged is None:
            self._merged = MergedLut(self)
        return self._merged

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


def _tile_elements(tile_mask, cell_shift, T, device):
    """(Lh, nt, nt) tile masks (-1: every element live; else cell bits, as
    :class:`TileLut` keeps them) -> (Lh, T, T) bool of the (q, k) pairs they
    hold, decoded as the kernels decode them."""
    R = TILE >> cell_shift if cell_shift < 6 else 1        # cells per tile side
    tm = torch.as_tensor(np.asarray(tile_mask), dtype=torch.int64, device=device)
    Lh, nt, _ = tm.shape
    bit = torch.arange(R * R, device=device).reshape(R, R)
    tm = tm[..., None, None]
    cells = (tm == -1) | ((tm >> bit) & 1).bool()             # (Lh, i, j, u, w)
    cells = cells.permute(0, 1, 3, 2, 4).reshape(Lh, nt * R, nt * R)
    size = TILE // R
    return cells.repeat_interleave(size, 1).repeat_interleave(size, 2)[:, :T, :T]


# ------------------------------------------------ banded and merged rows
@functools.lru_cache(maxsize=64)
def _banded_structure_cached(layout_bytes, shape, causal):
    H, nq, nk = shape
    if H != 1 or nq != nk or not causal:
        return None
    lay = np.frombuffer(layout_bytes, np.int32).reshape(shape)[0] > 0
    ii, jj = np.meshgrid(np.arange(nq), np.arange(nk), indexing="ij")
    live = lay & (jj <= ii)                       # causal block pruning
    causal_rows = ii >= jj
    gcols = tuple(int(c) for c in range(nk)
                  if np.array_equal(live[:, c], causal_rows[:, c]))
    rest = live.copy()
    rest[:, list(gcols)] = False
    deltas = np.unique((ii - jj)[rest])
    W = int(deltas.max()) + 1 if deltas.size else 0
    if deltas.size and not np.array_equal(deltas, np.arange(W)):
        return None                               # non-contiguous band
    implied = ((ii - jj) >= 0) & ((ii - jj) < W)
    for c in gcols:
        implied[:, c] |= causal_rows[:, c]
    if not np.array_equal(implied, live):
        return None
    if W + len(gcols) >= nk:                      # no sparsity to exploit
        return None
    return W, gcols


def banded_structure(layout, causal):
    """``(W, gcols)`` when a layout ``(1, nb, nb)`` shared by the heads is,
    under the causal mask, a band plus global columns: live(i, j) iff
    ``0 <= i - j < W`` or (``j`` in ``gcols`` and ``j <= i``); else None.
    The port's copy of ``_banded_structure`` (999-1034), cached by the
    layout's bytes: a global column is one live in every causal row it
    meets, which takes in the last columns (their rows all lie in the
    band), and a layout whose band and global columns cover every column
    (``W + len(gcols) >= nb``) returns None, as do per-head layouts and
    ``causal=False``."""
    if isinstance(layout, torch.Tensor):
        layout = layout.cpu().numpy()
    layout = np.ascontiguousarray(np.asarray(layout, np.int32))
    return _banded_structure_cached(layout.tobytes(), layout.shape, bool(causal))


class _Band(ctypes.Structure):
    """``Band`` of ``csrc/flash_attention.cuh``: the banded kernel's schedule."""
    _fields_ = [("w", ctypes.c_int), ("lb", ctypes.c_int), ("cell_shift", ctypes.c_int),
                ("n_gtiles", ctypes.c_int), ("gtile", ctypes.c_ushort * MAX_GLOBAL_TILES),
                ("gbits", ctypes.c_uint * (MAX_LAYOUT_COLS // 32))]


class BandLut:
    """The banded forward's schedule for a layout of :func:`banded_structure`
    ``(W, gcols)`` with layout block ``block`` at ``T`` (causal, one layout
    for all heads).

    The kernel visits, for the 64-row q tile whose first layout row is
    ``r0``, the tiles of the band from ``floor(max(r0 - W + 1, 0) * block /
    64)`` up to the diagonal tile, and before them the tiles of
    ``kernel_gcols`` that lie below that range (``gtiles``, ascending).
    ``kernel_gcols`` are the global columns some row reaches outside its
    band: a column ``c`` is reached so only from a row ``r >= c + W``, and
    with ``c + W > nb - 1`` no such row exists while every row that may see
    ``c`` (``r >= c``) has it in its band, so dropping ``c`` leaves the live
    set unchanged (the trailing "global" columns of :func:`banded_structure`
    are all of this kind).  ``T`` is at most ``MAX_BAND_T``, the size of
    the kernel's band parameter."""

    causal = True
    heads = 1

    def __init__(self, W, gcols, block, T):
        nb = T // block
        if nb * block != T or T > MAX_BAND_T or (block not in (16, 32) and block % TILE):
            raise ValueError(f"banded forward: T={T} at layout block {block} (T at most "
                             f"{MAX_BAND_T}; blocks 16, 32 or multiples of {TILE})")
        self.W, self.gcols, self.block, self.T = int(W), tuple(gcols), int(block), int(T)
        self.kernel_gcols = tuple(c for c in self.gcols if c + self.W <= nb - 1)
        self.cell_shift = int(math.log2(block)) if block < TILE else 6
        self.gtiles = np.array(sorted({
            t for c in self.kernel_gcols
            for t in range(c * block // TILE, ((c + 1) * block - 1) // TILE + 1)}), np.int32)
        self._device = {}
        self._param = None

    def param(self):
        """The kernel's ``Band`` parameter (built once)."""
        if self._param is None:
            band = _Band(w=self.W, lb=self.block, cell_shift=self.cell_shift,
                         n_gtiles=len(self.gtiles))
            band.gtile[:len(self.gtiles)] = self.gtiles.tolist()
            bits = np.zeros(MAX_LAYOUT_COLS, bool)
            bits[list(self.kernel_gcols)] = True
            band.gbits[:] = np.packbits(bits, bitorder="little").view("<u4").tolist()
            self._param = band
        return self._param

    def element_mask(self, device):
        """(1, T, T) bool: the live (q, k) pairs from the band alone, ``k <=
        q`` and ``row(q) - col(k) < W`` or ``col(k)`` in ``kernel_gcols``
        (positional, as the kernel masks)."""
        key = str(device)
        if key not in self._device:
            pos = torch.arange(self.T, device=device, dtype=torch.int32)
            r = pos // self.block
            glob = torch.zeros(self.T // self.block, dtype=torch.bool, device=device)
            glob[torch.as_tensor(self.kernel_gcols, dtype=torch.long, device=device)] = True
            band = (r[:, None] - r[None, :] < self.W) | glob[r.long()][None, :]
            self._device[key] = (band & (pos[:, None] >= pos[None, :]))[None]
        return self._device[key]


@functools.lru_cache(maxsize=64)
def band_lut(W, gcols, block, T):
    """The :class:`BandLut` of ``(W, gcols)`` at ``block`` and ``T`` (cached)."""
    return BandLut(W, tuple(gcols), block, T)


class MergedLut:
    """``block_q_merge=2`` on the kernels' tiles: the merged-row forward's
    LUT, built from a :class:`TileLut`.

    JAX (``_merged_luts_cached`` 1053-1073) pairs layout rows ``2i`` and
    ``2i + 1`` into one kernel row of ``2 * block_q`` queries over the union
    of their live k blocks, each half gated by its own row of the layout.
    The port's kernels work in 64-row q tiles that already carry the layout
    at cell level (a 64 x 64 tile spans 4 x 4 cells at block 16, 2 x 2 at
    32, part of one cell at 64 and above), so the merge pairs q tiles: kernel
    row ``i`` is q tiles ``2i`` and ``2i + 1`` (128 queries), its k list
    ``kmap[h, i, :klen[h, i]]`` the ascending union of the two tiles' LUT
    rows, and ``kmask[h, i, j, half]`` the tile mask of q tile ``2i + half``
    at k tile ``kmap[h, i, j]``: -1, its cell bits, or 0 where that half has
    no such tile (an odd last tile leaves half 1 at 0).  Each half sees
    exactly its own tiles with their own masks, so the function is the
    layout's, as in JAX; at block 64 the pairs are JAX's pairs of layout
    rows, at block 128 and above both halves lie in one layout row, and at
    blocks 16 and 32 each half already merges 4 or 2 layout rows."""

    def __init__(self, lut):
        tm = lut.tile_mask
        Lh, nt, _ = tm.shape
        if nt % 2:
            tm = np.concatenate([tm, np.zeros((Lh, 1, nt), tm.dtype)], axis=1)
        pair = tm.reshape(Lh, -1, 2, nt)                          # (Lh, row, half, k tile)
        self.kmap, _, self.klen = _lut_rows((pair != 0).any(axis=2).astype(np.int32))
        idx = np.repeat(self.kmap[:, :, None, :], 2, axis=2)
        halves = np.take_along_axis(pair, idx, axis=3)            # (Lh, row, half, slot)
        slot = np.arange(self.kmap.shape[-1]) < self.klen[..., None]
        self.kmask = np.ascontiguousarray(
            np.where(slot[:, :, None, :], halves, 0).transpose(0, 1, 3, 2)).astype(np.int32)
        self.T, self.causal, self.cell_shift = lut.T, lut.causal, lut.cell_shift
        self.heads = lut.heads
        self._device = {}

    def tensors(self, device):
        """``kmap``, ``kmask``, ``klen`` as int32 tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._device:
            self._device[key] = {name: torch.as_tensor(getattr(self, name), device=device)
                                 for name in ("kmap", "kmask", "klen")}
        return self._device[key]

    def element_mask(self, device):
        """(Lh, T, T) bool: the (q, k) pairs the merged rows' lists and
        per-half masks hold, decoded as the kernel decodes them, with the
        causal mask."""
        key = ("mask", str(device))
        if key not in self._device:
            Lh, rows, _ = self.kmap.shape
            nt = -(-self.T // TILE)
            tm = np.zeros((Lh, rows, 2, nt), np.int32)
            hh, ii, jj = np.nonzero(np.arange(self.kmap.shape[-1]) < self.klen[..., None])
            for half in (0, 1):
                tm[hh, ii, half, self.kmap[hh, ii, jj]] = self.kmask[hh, ii, jj, half]
            mask = _tile_elements(tm.reshape(Lh, 2 * rows, nt)[:, :nt], self.cell_shift,
                                  self.T, device)
            if self.causal:
                mask = mask & torch.ones((self.T, self.T), dtype=torch.bool,
                                         device=device).tril()
            self._device[key] = mask
        return self._device[key]


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
    is masked (or NEG_INF-biased) gives O = 0 and lse = NEG_INF.  ``lut``
    (its ``causal`` overrides ``causal``): a :class:`TileLut`, or for the
    banded and merged kernels a :class:`BandLut` (the live pairs derived
    from the band alone) or a :class:`MergedLut` (decoded from the merged
    rows' lists and per-half masks)."""
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
def _check(name, tensors, dtype, head_dim, dims=HEAD_DIMS):
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
    if dtype not in dims:
        raise ValueError(f"{name}: dtype {dtype} unsupported (supported "
                         f"{', '.join(str(t) for t in dims)})")
    if head_dim not in dims[dtype]:
        raise ValueError(f"{name}: head dim {head_dim} not built for {dtype} "
                         f"(supported {dims[dtype]})")
    B, _, H, _ = q.shape
    if B * H > 65535:
        raise ValueError(f"{name}: B*H = {B * H} exceeds the grid's 65535")


class _Extra(ctypes.Structure):
    """``Extra`` of ``csrc/flash_attention.cuh``: the LUT, the biases, the band."""
    _fields_ = [("map", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("len", ctypes.c_void_p), ("kbias", ctypes.c_void_p),
                ("abias", ctypes.c_void_p), ("width", ctypes.c_int),
                ("heads", ctypes.c_int), ("cell_shift", ctypes.c_int),
                ("band", ctypes.c_void_p)]


def _extra(name, q, lut, kbias, abias, rows):
    """The ``Extra`` of one launch (``rows``: "k" for the forward and dQ
    loops over the LUT's k tiles, "q" for dK/dV's over its q tiles; ``lut``
    a :class:`TileLut`, :class:`MergedLut` or :class:`BandLut`), after
    checking the biases and the LUT against ``q``."""
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
        if isinstance(lut, BandLut):
            x.band = ctypes.addressof(lut.param())
            return x
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
        n_ptr = 8 if "dkdv" in fn_name else 7 if "_dq" in fn_name else 5
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
    _check(name, (q, k, v), q.dtype, d,
           SM90_HEAD_DIMS if name == "flash_fwd_sm90" else HEAD_DIMS)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "k")]
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    _run(name, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides), B, T, H, int(causal),
         _scale(q, sm_scale), *(ctypes.addressof(x) for x in extra), device=q.device)
    return o, lse


def dense_fwd_kernel(dtype, head_dim):
    """The dense forward kernel a CUDA tensor of ``dtype`` and ``head_dim``
    takes: ``flash_fwd_sm90`` for bf16 at head dims 64 and 128, else the
    template ``flash_fwd``.  Decided before any launch, never by a failure."""
    return "flash_fwd_sm90" if head_dim in SM90_HEAD_DIMS.get(dtype, ()) else "flash_fwd"


def flash_fwd(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)`` of (B, T, H, d) q/k/v: for CUDA tensors the kernel of
    :func:`dense_fwd_kernel`, for CPU tensors the plain version."""
    return _fwd(dense_fwd_kernel(q.dtype, q.shape[-1]), q, k, v, causal, sm_scale)


def flash_fwd_template(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)``: the template ``flash_fwd`` kernel whatever the dtype
    and head dim (for CUDA tensors; the plain version for CPU tensors)."""
    return _fwd("flash_fwd", q, k, v, causal, sm_scale)


def flash_fwd_sm90(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)``: the ``flash_fwd_sm90`` kernel (bf16, head dims 64 and
    128; others raise) for CUDA tensors, the plain version for CPU ones."""
    return _fwd("flash_fwd_sm90", q, k, v, causal, sm_scale)


def flash_fwd_sm90_blocks(n_work, n_sms):
    """The work items each block of ``flash_fwd_sm90``'s persistent grid
    takes, as the kernel deals them: ``min(n_sms, n_work)`` blocks; in
    round ``r`` block ``x`` takes item ``r G + x``, or ``r G + G - 1 - x``
    when ``r`` is odd (a snake, so the blocks that take the longer of the
    longest-first items in one round take the shorter in the next)."""
    G = min(n_sms, n_work)
    out = []
    for x in range(G):
        items, r = [], 0
        while True:
            w = r * G + (G - 1 - x if r % 2 else x)
            if w >= n_work:
                break
            items.append(w)
            r += 1
        out.append(items)
    return out


def flash_fwd_sm90_schedule(T, causal, block_n=SM90_BLOCK_N):
    """The schedule of ``flash_fwd_sm90`` in Python, as the kernel computes
    it, for one (b, h): its 128-row q tiles in the order of the kernel's
    work items (item ``w`` is q tile ``nq - 1 - w // (B*H)``, so the
    longest causal rows come first), and per q tile the k tiles of
    ``block_n`` keys it visits in the kernel's order (the last first:
    every tile under T and, when causal, those holding a key at or below
    the tile's last row) with, for each 64-row half (one per consumer
    warpgroup), whether the tile takes the per-element mask (it crosses T
    or, when causal, the half's diagonal).  Returns ``[(q0, [(k0,
    (masked_half0, masked_half1)), ...]), ...]``."""
    bq = SM90_BLOCK_Q
    nq = -(-T // bq)
    out = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bq
        nk = -(-T // block_n)
        if causal:
            nk = min(nk, (q0 + bq - 1) // block_n + 1)
        tiles = []
        for it in range(nk):
            k0 = (nk - 1 - it) * block_n
            tiles.append((k0, tuple(k0 + block_n > T or (causal and k0 + block_n - 1 > q0 + 64 * c)
                                    for c in range(2))))
        out.append((q0, tiles))
    return out


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


def flash_fwd_banded(q, k, v, band, sm_scale=None):
    """``(o, lse)`` of causal attention over the band and global columns of
    ``band`` (a :class:`BandLut`): the ``flash_fwd_banded`` kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return _fwd("flash_fwd_banded", q, k, v, True, sm_scale, band)


def flash_fwd_merged(q, k, v, merged, sm_scale=None):
    """``(o, lse)`` over the merged rows of ``merged`` (a :class:`MergedLut`,
    causal as its layout was built): the ``flash_fwd_merged`` kernel for
    CUDA tensors, the plain version for CPU tensors."""
    return _fwd("flash_fwd_merged", q, k, v, merged.causal, sm_scale, merged)


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
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


class _FlashAttentionWithLse(torch.autograd.Function):
    """``_flash_lse_bhtd`` (937-953): the dense kernels, ``(o, lse)`` both
    outputs; the lse cotangent enters the backward as ``delta - dlse``
    (``_bwd`` 777-781; autograd passes zeros for an output the loss does
    not use)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (attention_delta(o, do) - dlse.float()).contiguous()
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


class _MaskedFlashAttention(torch.autograd.Function):
    """The biased (``lut is None``) and block-sparse paths.  The forward:
    ``sched`` a :class:`BandLut` takes ``flash_fwd_banded``, a
    :class:`MergedLut` ``flash_fwd_merged``; else the unbiased LUT forward
    takes the ring kernel, the biased ones ``flash_fwd_lut`` /
    ``flash_fwd_biased``.  The backward takes the LUT kernels over ``lut``
    (or the biased ones).  Bias cotangents are zeros (the masks are
    constants)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, abias, lut, causal, sm_scale, sched=None):
        if lut is None:
            o, lse = flash_fwd_biased(q, k, v, kbias, abias, causal, sm_scale)
        elif isinstance(sched, BandLut):
            o, lse = flash_fwd_banded(q, k, v, sched, sm_scale)
        elif isinstance(sched, MergedLut):
            o, lse = flash_fwd_merged(q, k, v, sched, sm_scale)
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
        do = do.contiguous()
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
        return dq, dk, dv, zero(kbias), zero(abias), None, None, None, None


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


def flash_attention_with_lse(q, k, v, *, causal=True, sm_scale=None):
    """Flash attention returning ``(out (B, T, H, d), lse (B, H, T))`` with
    both outputs differentiable (JAX ``flash_attention_with_lse`` 956-970),
    the building block of ring attention, where partial results merge by
    their logsumexp.  The dense kernels; lse fp32."""
    return _FlashAttentionWithLse.apply(q, k, v, bool(causal), _scale(q, sm_scale))


def sparse_flash_attention(q, k, v, layout, *, causal=True, sm_scale=None, block_q=None,
                           block_k=None, block_q_merge=1, key_padding_bias=None,
                           attn_bias=None):
    """Block-sparse flash attention over (B, T, H, d).

    ``layout``: (n_heads_or_1, nq, nk) host-static int block mask from a
    ``SparsityConfig``; the block size is implied (``T // nq``) and must
    be 16, 32 or a multiple of 64.  The layout compiles into the tile
    LUTs of :class:`TileLut` that drive the kernels' loops, so skipped
    tiles are neither read nor computed.  ``key_padding_bias`` /
    ``attn_bias`` as in :func:`flash_attention`.

    The forward, in JAX's order: ``block_q_merge=2`` (unbiased, ``nq``
    even) runs the merged-row kernel on every layout; an all-ones layout
    the dense kernels; biases the biased LUT kernel; a causal band layout
    (:func:`banded_structure`, ``T <= MAX_BAND_T``) the banded kernel; any
    other layout the LUT ring.  The backward is the LUT (or dense, or
    biased) kernels."""
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
    if block_q_merge not in (1, 2):
        raise ValueError(f"block_q_merge={block_q_merge}: 2 is the supported row-merge "
                         "factor (1: no merge)")
    sm_scale = _scale(q, sm_scale)
    kb, ab = _as_bias(key_padding_bias, q), _as_bias(attn_bias, q)
    if block_q_merge == 2 and (kb is not None or ab is not None):
        raise ValueError("block_q_merge=2 composes with the unbiased path only")
    if block_q_merge == 2 and nq % 2:
        raise ValueError(f"block_q_merge=2 pairs layout rows: {nq} rows is odd")
    lut = layout_luts(layout, T, H, causal)
    if block_q_merge == 2:
        return _MaskedFlashAttention.apply(q, k, v, None, None, lut, bool(causal), sm_scale,
                                           lut.merged)
    if (layout > 0).all():
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                               key_padding_bias=kb, attn_bias=ab)
    sched = None
    if kb is None and ab is None and T <= MAX_BAND_T:
        band = banded_structure(layout, causal)
        if band is not None:
            sched = band_lut(band[0], band[1], block_q, T)
    return _MaskedFlashAttention.apply(q, k, v, kb, ab, lut, bool(causal), sm_scale, sched)


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
