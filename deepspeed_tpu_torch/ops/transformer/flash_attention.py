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
the dense 16-bit forward at head dims 64 and 128 in
``flash_attention_fwd_sm90.cu``, the dense and the block-sparse 16-bit dK/dV
and dQ at head dim 64 in ``flash_attention_sparse_bwd_sm90.cu``, the
block-sparse 16-bit forward at head dim 64 in
``flash_attention_sparse_fwd_sm90.cu``; the last two share the helpers of
``flash_attention_sm90.cuh``), one wrapper and one launch counter per entry.
Every kernel is built for bf16 and fp16 (dtype codes 1 and 2, the element
type a template parameter) wherever it is built for one of them, and the
templates for fp32 too:

- ``flash_fwd_sm90`` (for ``_fwd_kernel`` 144, dense, with or without
  ``use_kbias`` 218): the 16-bit forward at head dims 64 and 128 with TMA,
  an mbarrier ring fed by a producer warp, ``wgmma`` and 128-row q tiles
  over two consumer warpgroups; with the (B, T) key bias (its key-bias
  instances) the producer warp's lanes copy each K tile's bias with
  ``cp.async`` beside it and the softmax adds it in log2 units.
  :func:`flash_fwd` sends CUDA tensors of that dtype and head dim there
  (:func:`dense_fwd_kernel`), by dtype and head dim alone, and so does
  :func:`flash_fwd_biased` with no (T, T) score bias
  (:func:`biased_fwd_kernel`); :func:`flash_fwd_sm90_schedule` is its
  schedule in Python;
- ``flash_fwd`` / ``flash_fwd_biased`` / ``flash_fwd_lut`` (for
  ``_fwd_kernel`` 144: dense, fp32, and 16-bit at head dim 96; with the (B,
  T) key bias and the (T, T) score bias, for fp32, head dim 96 and any
  score bias; over the live tiles of a LUT, with the biases): online
  softmax over the visited k tiles, O in the input dtype and the fp32
  logsumexp;
- ``flash_fwd_lut_ring`` (for ``_fwd_kernel_dma`` 306): the unbiased LUT
  forward with a 3-deep ring of K/V tiles in flight;
- ``flash_fwd_lut_sm90`` (for ``_fwd_kernel`` with ``use_lut`` and
  ``use_kbias`` 144-283, and ``_fwd_kernel_dma`` 306-415): the block-sparse
  forward in 16 bits at head dim 64, with or without the key bias, over
  ``GroupLut(side="q")`` (the schedule dQ runs: Q gathered once per output
  tile, the visits' K, V and key bias streamed, S and P V on ``wgmma``, the
  online softmax on the accumulators); the sparse path sends CUDA tensors
  there by dtype, head dim and the absence of a (T, T) score bias
  (:func:`sparse_fwd_kernel`), and :func:`flash_fwd_lut_sm90_schedule` is
  its schedule in Python; the templates ``flash_fwd_lut`` and
  ``flash_fwd_lut_ring`` keep the rest;
- ``flash_fwd_banded_sm90`` / ``flash_fwd_merged_sm90`` (for
  ``_fwd_kernel`` with ``use_banded`` 180-198, 230-244, and with
  ``use_merge`` 161-164, 245-255, and ``_fwd_kernel_dma`` with
  ``use_merge`` 317-319, 384-390): schedule instances of
  ``flash_fwd_sm90``'s block (TMA ring, producer warp, ``wgmma``, 128-row
  q tiles over two consumer warpgroups, persistent grid), 16-bit at head dims
  64 and 128: the causal forward over a :class:`BandLut`, its 128-key
  tiles computed in the kernel from the band and a positional element mask
  on the tiles that need it; the forward over a :class:`MergedLut`, one
  merged row (two 64-row q tiles) a work item, each consumer warpgroup one
  half under its own tile masks.  :func:`flash_fwd_banded` and
  :func:`flash_fwd_merged` send CUDA tensors there by dtype and head dim
  (:func:`banded_fwd_kernel`, :func:`merged_fwd_kernel`);
  :func:`flash_fwd_banded_sm90_schedule` and
  :func:`flash_fwd_merged_sm90_schedule` are their schedules in Python;
- ``flash_fwd_banded`` / ``flash_fwd_merged`` (the same TPU kernels): the
  templates for fp32 and head dim 96, 64-row q tiles on ``mma.sync``;
  ``flash_fwd_banded_template`` / ``flash_fwd_merged_template`` take them
  at any dtype;
- ``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90`` (for ``_bwd_dkdv_kernel``
  617 and ``_bwd_dq_kernel`` 691, dense, with or without ``use_kbias``,
  659-660 and 731-732): the 16-bit backward at head dim 64, the group
  kernels' design below over a schedule the kernels compute from (B, H, T,
  causal), 64-row output tiles, each visit one 64-row TMA box per operand;
  with the (B, T) key bias (their key-bias instances) dK/dV loads a work
  item's 64 bias rows once beside its K and V, dQ streams each visit's
  beside its K and V, both copied by the producer warp with ``cp.async``,
  and the softmax step adds them in log2 units; the operations bound both,
  as without the bias (8·D and 6·D flops a pair).  :func:`flash_bwd_dkdv`
  and :func:`flash_bwd_dq` send CUDA tensors of that dtype and head dim
  there (:func:`dense_bwd_kernel`), and so do :func:`flash_bwd_dkdv_biased`
  and :func:`flash_bwd_dq_biased` with a key bias and no (T, T) score bias
  (:func:`biased_bwd_kernel`); :func:`flash_bwd_dkdv_sm90_schedule` /
  :func:`flash_bwd_dq_sm90_schedule` are their schedules in Python;
- ``flash_bwd_dkdv`` / ``_biased`` / ``_lut`` (for ``_bwd_dkdv_kernel``
  617): per k tile over the (live) q tiles, P recomputed from the lse, dV
  and dK (the dense one: fp32, and 16-bit at head dims 96 and 128; the biased
  one: fp32, head dims 96 and 128, and any (T, T) score bias);
- ``flash_bwd_dkdv_lut_sm90`` (for ``_bwd_dkdv_kernel`` with ``use_lut``):
  the block-sparse dK/dV in 16 bits at head dim 64 over a
  :class:`GroupLut` (key blocks grouped by their live query blocks, both
  sides gathered by TMA into 64-row tiles, every product a ``wgmma``);
  :func:`flash_bwd_dkdv_lut` sends CUDA tensors there by dtype, head dim and
  the absence of a (T, T) score bias (:func:`sparse_dkdv_kernel`), and
  :func:`flash_bwd_dkdv_lut_sm90_schedule` is its schedule in Python;
- ``flash_bwd_dq`` / ``_biased`` / ``_lut`` (for ``_bwd_dq_kernel`` 691):
  per q tile over the (live) k tiles, dQ (the dense one as its dK/dV);
- ``flash_bwd_dq_lut_sm90`` (for ``_bwd_dq_kernel`` with ``use_lut``, 691-753):
  the block-sparse dQ in 16 bits at head dim 64, the dK/dV design with the
  roles swapped, over ``GroupLut(side="q")`` (query blocks grouped by their
  live key blocks); :func:`flash_bwd_dq_lut` sends CUDA tensors there by the
  same rule (:func:`sparse_dq_kernel`), and
  :func:`flash_bwd_dq_lut_sm90_schedule` is its schedule in Python.

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
lcm(bq, bk)); bf16 and fp16 inputs run on the tensor cores (the JAX
kernels take any dtype; every route takes both, each kernel's fp16
instance the bf16 one with the operand type swapped: P and dS rounded to
fp16 where bf16 rounds them to bf16, the scores, biases, lse and delta in
fp32, an output past 65504 inf), fp32 inputs on the CUDA cores (head
dims 64, 96 and 128); the plain versions compute fp16 as they compute
bf16, rounding P and dS to the input dtype; an all-ones layout takes the dense
kernels (the same numbers, no LUT) unless ``block_q_merge=2``; a row with
no live key (O = 0, lse = NEG_INF: a ``mul`` key bias's fully padded batch
row) gets no gradient, where the JAX backward computes ``exp(S - lse) = 1``
on it (ROADMAP.md section C), in every backward kernel, the sm90 ones with a
key bias included (the row's lse enters as +inf, so its P is 0); the backward
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
DENSE_KERNELS = ("flash_fwd", "flash_fwd_sm90", "flash_bwd_dkdv", "flash_bwd_dq",
                 "flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")
BIASED_KERNELS = ("flash_fwd_biased", "flash_bwd_dkdv_biased", "flash_bwd_dq_biased")
LUT_KERNELS = ("flash_fwd_lut", "flash_fwd_lut_ring", "flash_fwd_lut_sm90",
               "flash_fwd_banded", "flash_fwd_banded_sm90", "flash_fwd_merged",
               "flash_fwd_merged_sm90", "flash_bwd_dkdv_lut",
               "flash_bwd_dkdv_lut_sm90", "flash_bwd_dq_lut", "flash_bwd_dq_lut_sm90")
KERNELS = DENSE_KERNELS + BIASED_KERNELS + LUT_KERNELS
# entry -> (library = csrc/<library>.cu, C function, variant argument or None)
ENTRIES = {
    "flash_fwd": ("flash_attention", "flash_fwd", None),
    "flash_fwd_sm90": ("flash_attention_fwd_sm90", "flash_fwd_sm90", None),
    "flash_bwd_dkdv": ("flash_attention", "flash_bwd_dkdv", None),
    "flash_bwd_dq": ("flash_attention", "flash_bwd_dq", None),
    "flash_bwd_dkdv_sm90": ("flash_attention_sparse_bwd_sm90", "flash_bwd_dkdv_sm90", None),
    "flash_bwd_dq_sm90": ("flash_attention_sparse_bwd_sm90", "flash_bwd_dq_sm90", None),
    "flash_fwd_biased": ("flash_attention_sparse_fwd", "flash_fwd_variant", 1),
    "flash_fwd_lut": ("flash_attention_sparse_fwd", "flash_fwd_variant", 2),
    "flash_fwd_lut_ring": ("flash_attention_sparse_fwd", "flash_fwd_variant", 3),
    "flash_fwd_lut_sm90": ("flash_attention_sparse_fwd_sm90", "flash_fwd_lut_sm90", None),
    "flash_fwd_banded": ("flash_attention_band_merge_fwd", "flash_fwd_variant", 4),
    "flash_fwd_merged": ("flash_attention_band_merge_fwd", "flash_fwd_variant", 5),
    "flash_fwd_banded_sm90": ("flash_attention_fwd_sm90", "flash_fwd_banded_sm90", None),
    "flash_fwd_merged_sm90": ("flash_attention_fwd_sm90", "flash_fwd_merged_sm90", None),
    "flash_bwd_dkdv_biased": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 1),
    "flash_bwd_dkdv_lut": ("flash_attention_sparse_bwd", "flash_bwd_dkdv_variant", 2),
    "flash_bwd_dkdv_lut_sm90": ("flash_attention_sparse_bwd_sm90", "flash_bwd_dkdv_lut_sm90",
                                None),
    "flash_bwd_dq_biased": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 1),
    "flash_bwd_dq_lut": ("flash_attention_sparse_bwd", "flash_bwd_dq_variant", 2),
    "flash_bwd_dq_lut_sm90": ("flash_attention_sparse_bwd_sm90", "flash_bwd_dq_lut_sm90", None),
}
# the entries that take a GroupLut's schedule (csrc/flash_attention_sparse_bwd_sm90.cu,
# csrc/flash_attention_sparse_fwd_sm90.cu)
GROUP_KERNELS = ("flash_bwd_dkdv_lut_sm90", "flash_bwd_dq_lut_sm90", "flash_fwd_lut_sm90")
# launches per kernel since the last reset_launches(); only kernel launches count
launches = {name: 0 for name in KERNELS}
# the templates (csrc/flash_attention.cuh): fp32 on the CUDA cores, bf16 and fp16 on the
# tensor cores
HEAD_DIMS = {torch.bfloat16: (64, 96, 128), torch.float16: (64, 96, 128),
             torch.float32: (64, 96, 128)}
# flash_fwd_sm90 and its schedule instances: the dtypes and head dims they are built for
# (csrc/flash_attention_fwd_sm90.cu; its q tile and k tile kBQ, Cfg<D>::kBN below)
SM90_HEAD_DIMS = {torch.bfloat16: (64, 128), torch.float16: (64, 128)}
# the entries of csrc/flash_attention_sparse_bwd_sm90.cu and sparse_fwd_sm90.cu
# (GROUP_KERNELS and DENSE_BWD_SM90): the dtypes and head dim they are built for (at 128 the
# dK/dV instances spill and two pipes of four stages do not fit in shared memory)
SM90_BWD_HEAD_DIMS = {torch.bfloat16: (64,), torch.float16: (64,)}
DENSE_BWD_SM90 = ("flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")
# the dense sm90 entries, which take the (B, T) key bias's pointer (null for none) last
DENSE_SM90 = ("flash_fwd_sm90",) + DENSE_BWD_SM90
# the schedule instances of flash_fwd_sm90 (csrc/flash_attention_fwd_sm90.cu), which take
# their schedule (a _BandSm90, a _MergedSched) last; built for SM90_HEAD_DIMS
SCHED_SM90 = ("flash_fwd_banded_sm90", "flash_fwd_merged_sm90")
SM90_BLOCK_Q, SM90_BLOCK_N = 128, 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
TILE = 64            # the kernels' q and k tile rows (kBQ, kBK)
# the banded kernel's Band parameter (csrc/flash_attention.cuh): global tiles, layout columns
MAX_GLOBAL_TILES, MAX_LAYOUT_COLS = 1024, 4096
# flash_fwd_banded_sm90's BandSm90 parameter: global tiles of 128 keys
MAX_GLOBAL_TILES_SM90 = 512
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
        self._groups = {}

    @property
    def heads(self):
        return self.layout.shape[0]

    def groups(self, side):
        """The :class:`GroupLut` of one side of the backward (built once):
        ``"k"`` for dK/dV, ``"q"`` for dQ."""
        if side not in self._groups:
            self._groups[side] = GroupLut(self, side)
        return self._groups[side]

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


class GroupLut:
    """The grouped schedule of one side of the block-sparse backward, built
    from a :class:`TileLut`'s layout: ``side="k"`` (dK/dV: output key rows,
    visited query rows) or ``"q"`` (dQ: the roles swapped).

    The layout is taken in units of ``unit = min(block, 64)`` rows, ``slots
    = 64 // unit`` to a 64-row tile; at blocks 64 and above a unit is a
    64-row slice of a block.  A pair of units is live iff its layout cell
    is and, when causal, the key unit is at or below the query unit (exact:
    units never straddle the diagonal).  For each head layout the output
    units are grouped by the set of units live for them (groups in order of
    their first unit, units ascending), and each group is packed ``slots``
    units to an **output tile**; an output tile's **visits** are its
    group's live units in ascending order, ``slots`` at a time.  So a pair
    of a visit is live unless a slot is empty (``-1``: the last tile or
    visit of a group whose size is not a multiple of ``slots``) or the pair
    is a causal diagonal unit, and a visit is ``masked`` iff it has an
    empty visited slot or, when causal, shares a unit with its tile (an
    empty output slot needs no mask: its rows are not written and no other
    row reads them).  Every live pair lies in exactly one visit, every
    output row in exactly one tile (a unit with no live partner in a tile
    with no visits: its rows get zeros), and units never cross ``T`` (a
    multiple of the block).

    Arrays (int32): ``out_slots`` (tiles, slots), ``vbeg`` (tiles + 1: tile
    ``t``'s visits are ``vbeg[t]:vbeg[t + 1]``), ``visit_slots`` (visits,
    slots), ``masked`` (visits), ``tile_off`` (heads + 1: head layout
    ``l``'s tiles are ``tile_off[l]:tile_off[l + 1]``)."""

    def __init__(self, lut, side):
        if side not in ("k", "q"):
            raise ValueError(f"side {side!r}: 'k' (dK/dV) or 'q' (dQ)")
        U = min(lut.block, TILE)
        R, f, nu = TILE // U, lut.block // U, lut.T // U
        live = (lut.layout > 0).repeat(f, axis=1).repeat(f, axis=2)   # (Lh, q unit, k unit)
        if lut.causal:
            live = live & np.tril(np.ones((nu, nu), bool))
        if side == "k":
            live = live.transpose(0, 2, 1)                           # (Lh, out unit, visited)
        self.unit, self.slots, self.heads = U, R, lut.heads
        pad = lambda units: list(units) + [-1] * (R - len(units))    # noqa: E731
        out, vbeg, visits, masked, tile_off = [], [0], [], [], [0]
        for rows in live:
            sets, first, inverse = np.unique(rows, axis=0, return_index=True,
                                             return_inverse=True)
            for gid in np.argsort(first, kind="stable"):
                units = np.flatnonzero(inverse.reshape(-1) == gid).tolist()
                seen = np.flatnonzero(sets[gid]).tolist()
                for t0 in range(0, len(units), R):
                    tile = pad(units[t0:t0 + R])
                    out.append(tile)
                    for v0 in range(0, len(seen), R):
                        slots = pad(seen[v0:v0 + R])
                        visits.append(slots)
                        masked.append(-1 in slots or (lut.causal and bool(
                            set(slots) & set(tile) - {-1})))
                    vbeg.append(len(visits))
            tile_off.append(len(out))
        self.out_slots = np.array(out, np.int32).reshape(-1, R)
        self.vbeg = np.array(vbeg, np.int32)
        self.visit_slots = np.array(visits, np.int32).reshape(-1, R)
        self.masked = np.array(masked, np.int32)
        self.tile_off = np.array(tile_off, np.int32)
        self._device = {}

    @property
    def visits_per_head(self):
        """Visits of each head layout."""
        return np.diff(self.vbeg[self.tile_off])

    @property
    def tiles_per_head(self):
        """Output tiles of each head layout."""
        return np.diff(self.tile_off)

    def order(self, B, H):
        """The work items of a (B, T, H) call, ``(n_work, 2)`` int32 rows
        ``(b * H + h, tile)``: every output tile of every (b, h), longest
        (most visits) first, then by (b, h) and tile, so the tiles of one
        (b, h) run side by side and share its Q and dO in L2."""
        key = ("order", B, H)
        if key not in self._device:
            bh, tile = [], []
            for x in range(B * H):
                l = x % H if self.heads > 1 else 0
                lo, hi = self.tile_off[l], self.tile_off[l + 1]
                bh.append(np.full(hi - lo, x, np.int32))
                tile.append(np.arange(lo, hi, dtype=np.int32))
            bh, tile = np.concatenate(bh), np.concatenate(tile)
            nv = np.diff(self.vbeg)[tile]
            pick = np.lexsort((tile, bh, -nv))
            self._device[key] = np.ascontiguousarray(np.stack([bh[pick], tile[pick]], 1))
        return self._device[key]

    def tensors(self, device, B, H):
        """``out_slots`` and ``visit_slots`` (padded to 4 slots with -1:
        one 16-byte row each), ``vbeg``, ``masked`` and the ``order`` of a
        (B, T, H) call as int32 tensors on ``device`` (cached)."""
        key = (str(device), B, H)
        if key not in self._device:
            pad = lambda a: np.pad(a, ((0, 0), (0, 4 - a.shape[1])),  # noqa: E731
                                   constant_values=-1)
            arrays = {"out_slots": pad(self.out_slots), "vbeg": self.vbeg,
                      "visit_slots": pad(self.visit_slots), "masked": self.masked,
                      "order": self.order(B, H)}
            self._device[key] = {name: torch.as_tensor(a, device=device)
                                 for name, a in arrays.items()}
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


class _BandSm90(ctypes.Structure):
    """``BandSm90`` of ``csrc/flash_attention_fwd_sm90.cu``: the schedule of
    ``flash_fwd_banded_sm90``."""
    _fields_ = [("w", ctypes.c_int), ("lb", ctypes.c_int), ("n_gtiles", ctypes.c_int),
                ("gtile", ctypes.c_ushort * MAX_GLOBAL_TILES_SM90),
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
    the kernel's band parameter.  ``gtiles_sm90``: the same for
    ``flash_fwd_banded_sm90``'s 128-key tiles (see
    :func:`flash_fwd_banded_sm90_schedule`)."""

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
        self.gtiles, self.gtiles_sm90 = (np.array(sorted({
            t for c in self.kernel_gcols
            for t in range(c * block // n, ((c + 1) * block - 1) // n + 1)}), np.int32)
            for n in (TILE, SM90_BLOCK_N))
        self._device = {}
        self._param = None
        self._param_sm90 = None

    def _gbits(self):
        bits = np.zeros(MAX_LAYOUT_COLS, bool)
        bits[list(self.kernel_gcols)] = True
        return np.packbits(bits, bitorder="little").view("<u4").tolist()

    def param(self):
        """The kernel's ``Band`` parameter (built once)."""
        if self._param is None:
            band = _Band(w=self.W, lb=self.block, cell_shift=self.cell_shift,
                         n_gtiles=len(self.gtiles))
            band.gtile[:len(self.gtiles)] = self.gtiles.tolist()
            band.gbits[:] = self._gbits()
            self._param = band
        return self._param

    def param_sm90(self):
        """``flash_fwd_banded_sm90``'s ``BandSm90`` parameter (built once)."""
        if self._param_sm90 is None:
            band = _BandSm90(w=self.W, lb=self.block, n_gtiles=len(self.gtiles_sm90))
            band.gtile[:len(self.gtiles_sm90)] = self.gtiles_sm90.tolist()
            band.gbits[:] = self._gbits()
            self._param_sm90 = band
        return self._param_sm90

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

    def slots(self):
        """``flash_fwd_merged_sm90``'s slot arrays: ``(map, mask, len)`` per
        head layout and merged row, the key tiles of ``SM90_BLOCK_N`` (128)
        keys either half holds, ascending, each pairing the LUT's 64-key
        tiles ``2p`` and ``2p + 1``; ``mask`` (Lh, rows, width, 2, 2) holds
        one a half and 64-key subtile (0 where the half has no such tile).
        When causal, a tile wholly above a half's diagonal (a k tile past
        its q tile, which a layout block of 128 or more holds: its cells
        repeat over the block's tiles) gets 0 for that half, and a slot with
        no live half is dropped: such tiles hold no live pair."""
        Lh, rows, width = self.kmap.shape
        sub = SM90_BLOCK_N // TILE
        ncol = -(-self.T // SM90_BLOCK_N) * sub                    # 64-key tiles, whole slots
        dense = np.zeros((Lh, rows, 2, ncol), np.int32)            # (.., half, k tile)
        hh, ii, jj = np.nonzero(np.arange(width) < self.klen[..., None])
        for half in (0, 1):
            dense[hh, ii, half, self.kmap[hh, ii, jj]] = self.kmask[hh, ii, jj, half]
        if self.causal:
            q_tile = 2 * np.arange(rows)[:, None, None] + np.arange(2)[None, :, None]
            dense[:, np.arange(ncol)[None, None, :] > q_tile] = 0
        dense = dense.reshape(Lh, rows, 2, ncol // sub, sub)       # (.., half, slot, sub)
        smap, _, slen = _lut_rows((dense != 0).any(axis=(2, 4)).astype(np.int32))
        idx = np.broadcast_to(smap[:, :, None, :, None], (Lh, rows, 2, smap.shape[-1], sub))
        masks = np.take_along_axis(dense, idx, axis=3)
        live = np.arange(smap.shape[-1]) < slen[..., None]
        masks = np.where(live[:, :, None, :, None], masks, 0).transpose(0, 1, 3, 2, 4)
        return smap, np.ascontiguousarray(masks), slen

    def sched_tensors(self, device):
        """:meth:`slots` as int32 tensors on ``device`` (cached)."""
        key = ("slots", str(device))
        if key not in self._device:
            self._device[key] = [torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
                                 for a in self.slots()]
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


def _check_extra(name, q, lut, kbias, abias):
    """Raise unless the biases and the LUT fit ``q``."""
    B, T, H, _ = q.shape
    for label, bias, shape in (("key_padding_bias", kbias, (B, T)),
                               ("attn_bias", abias, (T, T))):
        if bias is not None and (bias.shape != shape or bias.dtype != torch.float32
                                 or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError(f"{name}: {label} must be a contiguous fp32 {shape} tensor "
                             "on q's device")
    if lut is not None and (lut.T != T or lut.heads not in (1, H)):
        raise ValueError(f"{name}: LUT of T={lut.T}, {lut.heads} head layouts does "
                         f"not fit q {tuple(q.shape)}")


def _extra(name, q, lut, kbias, abias, rows):
    """The ``Extra`` of one launch (``rows``: "k" for the forward and dQ
    loops over the LUT's k tiles, "q" for dK/dV's over its q tiles; ``lut``
    a :class:`TileLut`, :class:`MergedLut` or :class:`BandLut`), after
    checking the biases and the LUT against ``q``."""
    _check_extra(name, q, lut, kbias, abias)
    x = _Extra()
    x.kbias = None if kbias is None else kbias.data_ptr()
    x.abias = None if abias is None else abias.data_ptr()
    if lut is not None:
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


class _GroupSchedule(ctypes.Structure):
    """``GroupSchedule`` of ``csrc/flash_attention_sparse_bwd_sm90.cu``: a
    :class:`GroupLut`'s arrays, the work order and the key bias."""
    _fields_ = [("out_slots", ctypes.c_void_p), ("vbeg", ctypes.c_void_p),
                ("visit_slots", ctypes.c_void_p), ("masked", ctypes.c_void_p),
                ("order", ctypes.c_void_p), ("kbias", ctypes.c_void_p),
                ("n_work", ctypes.c_int), ("unit", ctypes.c_int)]


def _entry(name):
    from ..op_builder import cuda as builder
    lib, fn_name, variant = ENTRIES[name]
    fn = getattr(builder.load(lib), fn_name)
    if fn.argtypes is None:
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        n_ptr = 8 if "dkdv" in fn_name else 7 if "_dq" in fn_name else 5
        args = [i, i] + [v] * n_ptr + [v, i, i, i, i, f]
        # a variant takes its Extra, a group kernel or a schedule instance its schedule, a
        # dense sm90 entry its key bias (or null), before the stream
        structs = 0 if variant is None and name not in (GROUP_KERNELS + DENSE_SM90
                                                        + SCHED_SM90) else 1
        fn.argtypes = ([] if variant is None else [i]) + args + [v] * structs + [v]
        fn.restype = ctypes.c_int
    return fn if variant is None else functools.partial(fn, variant)


def _run(name, *args, device):
    rc = _entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}"
                           + (" (unsupported configuration)" if rc == -1 else ""))
    launches[name] += 1


def _fwd(name, q, k, v, causal, sm_scale, lut=None, kbias=None, abias=None, sched=None):
    """Launch the forward ``name`` after checking its operands: a template
    takes its ``Extra``, a dense sm90 entry its key bias, a schedule
    instance (``SCHED_SM90``) the struct ``sched()`` builds over ``lut``."""
    if q.device.type == "cpu":
        return flash_attention_reference_fwd(q, k, v, causal, sm_scale, lut=lut,
                                             key_padding_bias=kbias, attn_bias=abias)
    B, T, H, d = q.shape
    _check(name, (q, k, v), q.dtype, d,
           SM90_HEAD_DIMS if name in ("flash_fwd_sm90",) + SCHED_SM90 else HEAD_DIMS)
    template = ENTRIES[name][2] is not None       # the variants take both biases in their Extra
    for label, bias, taken in (("key_padding_bias", kbias, template or name in DENSE_SM90),
                               ("attn_bias", abias, template)):
        if bias is not None and not taken:
            raise ValueError(f"{name}: takes no {label}")
    if template:
        extra = [_extra(name, q, lut, kbias, abias, "k")]    # checks the biases and the LUT
    else:
        _check_extra(name, q, lut, kbias, abias)
        extra = [sched()] if sched else []
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    _run(name, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides), B, T, H, int(causal),
         _scale(q, sm_scale), *(ctypes.addressof(x) for x in extra), *_dense_kbias(name, kbias),
         device=q.device)
    return o, lse


def dense_fwd_kernel(dtype, head_dim):
    """The dense forward kernel a CUDA tensor of ``dtype`` and ``head_dim``
    takes: ``flash_fwd_sm90`` for bf16 and fp16 at head dims 64 and 128,
    else the template ``flash_fwd``.  Decided before any launch, never by a
    failure."""
    return "flash_fwd_sm90" if head_dim in SM90_HEAD_DIMS.get(dtype, ()) else "flash_fwd"


def flash_fwd(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)`` of (B, T, H, d) q/k/v: for CUDA tensors the kernel of
    :func:`dense_fwd_kernel`, for CPU tensors the plain version."""
    return _fwd(dense_fwd_kernel(q.dtype, q.shape[-1]), q, k, v, causal, sm_scale)


def flash_fwd_template(q, k, v, causal=True, sm_scale=None):
    """``(o, lse)``: the template ``flash_fwd`` kernel whatever the dtype
    and head dim (for CUDA tensors; the plain version for CPU tensors)."""
    return _fwd("flash_fwd", q, k, v, causal, sm_scale)


def flash_fwd_sm90(q, k, v, causal=True, sm_scale=None, key_padding_bias=None):
    """``(o, lse)``: the ``flash_fwd_sm90`` kernel (bf16 and fp16, head dims
    64 and 128; others raise), with the optional fp32 (B, T) key bias (its
    kBias instances), for CUDA tensors, the plain version for CPU ones."""
    return _fwd("flash_fwd_sm90", q, k, v, causal, sm_scale, kbias=key_padding_bias)


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


def biased_fwd_kernel(dtype, head_dim, has_abias):
    """The dense biased forward kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_fwd_sm90`` (its key-bias instance) for bf16
    and fp16 at head dims 64 and 128 with no (T, T) score bias, else the
    template ``flash_fwd_biased`` (fp32, head dim 96, any score bias).  Decided
    before any launch, never by a failure."""
    if not has_abias and head_dim in SM90_HEAD_DIMS.get(dtype, ()):
        return "flash_fwd_sm90"
    return "flash_fwd_biased"


def flash_fwd_biased(q, k, v, key_padding_bias=None, attn_bias=None, causal=True,
                     sm_scale=None):
    """``(o, lse)`` with the additive fp32 biases ``key_padding_bias``
    (B, T) and ``attn_bias`` (T, T), each optional: for CUDA tensors the
    kernel of :func:`biased_fwd_kernel`, for CPU tensors the plain
    version."""
    name = biased_fwd_kernel(q.dtype, q.shape[-1], attn_bias is not None)
    return _fwd(name, q, k, v, causal, sm_scale, None, key_padding_bias, attn_bias)


def flash_fwd_biased_template(q, k, v, key_padding_bias=None, attn_bias=None, causal=True,
                              sm_scale=None):
    """``(o, lse)``: the template ``flash_fwd_biased`` kernel whatever the
    dtype, head dim and biases (for CUDA tensors; the plain version for CPU
    ones)."""
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


def sparse_fwd_kernel(dtype, head_dim, has_abias, has_kbias=False):
    """The block-sparse forward kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_fwd_lut_sm90`` where :func:`_group_route`
    holds (bf16 and fp16 at head dim 64, no (T, T) score bias; with or
    without the key bias), else the template it took before: ``flash_fwd_lut`` with a
    bias, ``flash_fwd_lut_ring`` without."""
    if _group_route(dtype, head_dim, has_abias):
        return "flash_fwd_lut_sm90"
    return "flash_fwd_lut" if has_abias or has_kbias else "flash_fwd_lut_ring"


def sparse_fwd(name, q, k, v, lut, kbias=None, abias=None, sm_scale=None):
    """``(o, lse)`` of the LUT forward ``name`` (one that
    :func:`sparse_fwd_kernel` names) over ``lut`` with the biases it
    takes."""
    if name == "flash_fwd_lut_sm90":
        return flash_fwd_lut_sm90(q, k, v, lut, kbias, sm_scale)
    if name == "flash_fwd_lut_ring":
        return flash_fwd_lut_ring(q, k, v, lut, sm_scale)
    return flash_fwd_lut(q, k, v, lut, kbias, abias, sm_scale)


def flash_fwd_lut_sm90(q, k, v, lut, key_padding_bias=None, sm_scale=None):
    """``(o, lse)``: the ``flash_fwd_lut_sm90`` kernel over
    ``lut.groups("q")`` with the optional (B, T) key bias (bf16 and fp16,
    head dim 64; others raise) for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference_fwd(q, k, v, lut.causal, sm_scale, lut=lut,
                                             key_padding_bias=key_padding_bias)
    name = "flash_fwd_lut_sm90"
    B, T, H, d = q.shape
    _check(name, (q, k, v), q.dtype, d, SM90_BWD_HEAD_DIMS)
    _check_extra(name, q, lut, key_padding_bias, None)
    sched = _group_sched(name, q, lut, "q", key_padding_bias)
    o = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    _run(name, _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides), B, T, H, int(lut.causal),
         _scale(q, sm_scale), ctypes.addressof(sched), device=q.device)
    return o, lse


def flash_fwd_lut_sm90_schedule(lut, B, H, n_pipes):
    """The schedule of ``flash_fwd_lut_sm90`` in Python, as the kernel runs
    it on a (B, T, H) call with ``n_pipes`` persistent pipes: the one of
    :func:`flash_bwd_dq_lut_sm90_schedule` (the forward and dQ visit the
    same pairs), per pipe its work items ``(b, h, query units, visits)``,
    ``visits`` a list of ``(key units, masked)``; a unit ``u`` is rows ``u *
    unit .. u * unit + unit - 1``, -1 an empty slot."""
    return _group_schedule(lut.groups("q"), B, H, n_pipes)


class _MergedSched(ctypes.Structure):
    """``MergedSched`` of ``csrc/flash_attention_fwd_sm90.cu``: a
    :class:`MergedLut`'s slot arrays (:meth:`MergedLut.slots`)."""
    _fields_ = [("map", ctypes.c_void_p), ("mask", ctypes.c_void_p), ("len", ctypes.c_void_p),
                ("width", ctypes.c_int), ("heads", ctypes.c_int), ("cell_shift", ctypes.c_int)]


def banded_fwd_kernel(dtype, head_dim):
    """The banded forward kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_fwd_banded_sm90`` for bf16 and fp16 at head
    dims 64 and 128, else the template ``flash_fwd_banded``.  Decided before any
    launch, never by a failure."""
    sm90 = head_dim in SM90_HEAD_DIMS.get(dtype, ())
    return "flash_fwd_banded_sm90" if sm90 else "flash_fwd_banded"


def merged_fwd_kernel(dtype, head_dim):
    """The merged-row forward kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_fwd_merged_sm90`` for bf16 and fp16 at head
    dims 64 and 128, else the template ``flash_fwd_merged``.  Decided before any
    launch, never by a failure."""
    sm90 = head_dim in SM90_HEAD_DIMS.get(dtype, ())
    return "flash_fwd_merged_sm90" if sm90 else "flash_fwd_merged"


def flash_fwd_banded(q, k, v, band, sm_scale=None):
    """``(o, lse)`` of causal attention over the band and global columns of
    ``band`` (a :class:`BandLut`): for CUDA tensors the kernel of
    :func:`banded_fwd_kernel`, for CPU tensors the plain version."""
    if banded_fwd_kernel(q.dtype, q.shape[-1]) == "flash_fwd_banded_sm90":
        return flash_fwd_banded_sm90(q, k, v, band, sm_scale)
    return flash_fwd_banded_template(q, k, v, band, sm_scale)


def flash_fwd_banded_template(q, k, v, band, sm_scale=None):
    """``(o, lse)``: the template ``flash_fwd_banded`` kernel whatever the
    dtype and head dim (for CUDA tensors; the plain version for CPU ones)."""
    return _fwd("flash_fwd_banded", q, k, v, True, sm_scale, band)


def flash_fwd_banded_sm90(q, k, v, band, sm_scale=None):
    """``(o, lse)``: the ``flash_fwd_banded_sm90`` kernel (bf16 and fp16,
    head dims 64 and 128; others raise) over ``band.param_sm90()`` for CUDA tensors,
    the plain version for CPU ones."""
    return _fwd("flash_fwd_banded_sm90", q, k, v, True, sm_scale, band, sched=band.param_sm90)


def flash_fwd_merged(q, k, v, merged, sm_scale=None):
    """``(o, lse)`` over the merged rows of ``merged`` (a :class:`MergedLut`,
    causal as its layout was built): for CUDA tensors the kernel of
    :func:`merged_fwd_kernel`, for CPU tensors the plain version."""
    if merged_fwd_kernel(q.dtype, q.shape[-1]) == "flash_fwd_merged_sm90":
        return flash_fwd_merged_sm90(q, k, v, merged, sm_scale)
    return flash_fwd_merged_template(q, k, v, merged, sm_scale)


def flash_fwd_merged_template(q, k, v, merged, sm_scale=None):
    """``(o, lse)``: the template ``flash_fwd_merged`` kernel whatever the
    dtype and head dim (for CUDA tensors; the plain version for CPU ones)."""
    return _fwd("flash_fwd_merged", q, k, v, merged.causal, sm_scale, merged)


def flash_fwd_merged_sm90(q, k, v, merged, sm_scale=None):
    """``(o, lse)``: the ``flash_fwd_merged_sm90`` kernel (bf16 and fp16,
    head dims 64 and 128; others raise) over ``merged.slots()`` for CUDA tensors, the
    plain version for CPU ones."""
    return _fwd("flash_fwd_merged_sm90", q, k, v, merged.causal, sm_scale, merged,
                sched=lambda: merged_sched(merged, q.device))


def merged_sched(merged, device):
    """The ``_MergedSched`` of ``merged.slots()`` on ``device`` (the arrays
    cached on ``merged``)."""
    tmap, tmask, tlen = merged.sched_tensors(device)
    return _MergedSched(tmap.data_ptr(), tmask.data_ptr(), tlen.data_ptr(), tmap.shape[-1],
                        merged.heads, merged.cell_shift)


def flash_fwd_banded_sm90_schedule(band):
    """The schedule of ``flash_fwd_banded_sm90`` in Python, as the kernel
    computes it from ``band.param_sm90()``, for one (b, h): its 128-row q
    tiles in the order of the kernel's work items (as
    :func:`flash_fwd_sm90_schedule`), and per q tile at ``q0`` (first
    layout row ``r0``) its visits in the kernel's order, the last first:
    the 128-key tiles of ``gtiles_sm90`` below the band's first tile
    ``floor(max(r0 - W + 1, 0) * block / 128)``, then the band's tiles up to
    the one holding ``q0 + 127`` (and below T).  Per visit and 64-row half
    (one per consumer warpgroup) whether it takes the element mask: the
    tile crosses T or the half's diagonal, or a 16-key chunk of it lies in
    a non-global layout column below the band of the half's last row.
    Returns ``[(q0, [(k0, (masked_half0, masked_half1)), ...]), ...]``."""
    bq = bn = SM90_BLOCK_N
    T, lb, W = band.T, band.block, band.W
    nq, nk = -(-T // bq), -(-T // bn)
    glob = set(band.kernel_gcols)

    def masked(k0, qw):
        r_last = (qw + 63) // lb
        edge = any(r_last - c >= W and not (c < MAX_LAYOUT_COLS and c in glob)
                   for c in ((k0 + 16 * u) // lb for u in range(bn // 16)))
        return k0 + bn > T or k0 + bn - 1 > qw or edge

    out = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bq
        lo = max(q0 // lb - W + 1, 0) * lb // bn
        hi = min((q0 + bq - 1) // bn, nk - 1)
        tiles = [int(t) for t in band.gtiles_sm90 if t < lo] + list(range(lo, hi + 1))
        out.append((q0, [(t * bn, tuple(masked(t * bn, q0 + 64 * c) for c in range(2)))
                         for t in reversed(tiles)]))
    return out


def flash_fwd_merged_sm90_schedule(merged, h=0):
    """The schedule of ``flash_fwd_merged_sm90`` in Python, as the kernel
    runs it over ``merged.slots()`` for head ``h``: its 128-row q
    tiles (merged rows) in the order of the kernel's work items (as
    :func:`flash_fwd_sm90_schedule`), and per q tile its row's slots in
    the kernel's order, the last first, each ``(k0, (half0, half1))``: a
    half is None where its masks are all 0 (the consumer skips both
    products), else ``(masked, masks)`` with its mask per 64-key subtile and
    whether it takes the element mask (a mask is not -1, or the tile
    crosses T or, when causal, the half's diagonal)."""
    tmap, tmask, tlen = merged.slots()
    l = h if merged.heads > 1 else 0
    T, bq, bn = merged.T, SM90_BLOCK_Q, SM90_BLOCK_N
    nq = -(-T // bq)
    out = []
    for y in range(nq):
        q0 = (nq - 1 - y) * bq
        r = q0 // bq
        visits = []
        for j in reversed(range(int(tlen[l, r]))):
            k0 = int(tmap[l, r, j]) * bn
            halves = []
            for c in range(2):
                ms = tuple(int(x) for x in tmask[l, r, j, c])
                qw = q0 + 64 * c
                halves.append(None if not any(ms) else (
                    any(m != -1 for m in ms) or k0 + bn > T
                    or (merged.causal and k0 + bn - 1 > qw), ms))
            visits.append((k0, tuple(halves)))
        out.append((q0, visits))
    return out


def _bwd_args(name, q, k, v, do, lse, delta, kbias=None, abias=None):
    """The operands' pointers, after checking them: q, k, v, dO, lse and
    delta, and the biases an entry takes (the templates ``_biased`` and
    ``_lut`` both, the sm90 ones the key bias, the dense templates none):
    contiguous fp32, (B, T) and (T, T), on q's device."""
    B, T, H, d = q.shape
    sm90 = name in GROUP_KERNELS or name in DENSE_BWD_SM90
    _check(name, (q, k, v, do), q.dtype, d, SM90_BWD_HEAD_DIMS if sm90 else HEAD_DIMS)
    template = ENTRIES[name][2] is not None      # the _biased and _lut templates
    for label, bias, taken in (("key_padding_bias", kbias, template or sm90),
                               ("attn_bias", abias, template)):
        if bias is not None and not taken:
            raise ValueError(f"{name}: takes no {label}")
    _check_extra(name, q, None, kbias, abias)
    for stat in (lse, delta):
        if (stat.shape != (B, H, T) or stat.dtype != torch.float32
                or not stat.is_contiguous() or stat.device != q.device):
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 (B, H, T) "
                             "on q's device")
        if name in GROUP_KERNELS and stat.data_ptr() % 16:
            raise ValueError(f"{name}: lse and delta must start 16-byte aligned for the "
                             "kernel's TMA maps")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr())


def _bwd_dkdv(name, q, k, v, do, lse, delta, causal, sm_scale, lut=None, kbias=None,
              abias=None):
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dkdv(
            q, k, v, do, lse, delta, causal, sm_scale, lut=lut, key_padding_bias=kbias,
            attn_bias=abias)
    ptrs = _bwd_args(name, q, k, v, do, lse, delta, kbias, abias)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "q")]
    B, T, H, d = q.shape
    dk = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    strides = _strides(q, k, v, do)
    _run(name, _DTYPE_CODES[q.dtype], d, *ptrs, dk.data_ptr(), dv.data_ptr(),
         ctypes.addressof(strides), B, T, H, int(causal), _scale(q, sm_scale),
         *(ctypes.addressof(x) for x in extra), *_dense_kbias(name, kbias), device=q.device)
    return dk, dv


def _bwd_dq(name, q, k, v, do, lse, delta, causal, sm_scale, lut=None, kbias=None,
            abias=None):
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dq(
            q, k, v, do, lse, delta, causal, sm_scale, lut=lut, key_padding_bias=kbias,
            attn_bias=abias)
    ptrs = _bwd_args(name, q, k, v, do, lse, delta, kbias, abias)
    extra = [] if ENTRIES[name][2] is None else [_extra(name, q, lut, kbias, abias, "k")]
    B, T, H, d = q.shape
    dq = torch.empty((B, T, H, d), dtype=q.dtype, device=q.device)
    strides = _strides(q, k, v, do)
    _run(name, _DTYPE_CODES[q.dtype], d, *ptrs, dq.data_ptr(), ctypes.addressof(strides),
         B, T, H, int(causal), _scale(q, sm_scale), *(ctypes.addressof(x) for x in extra),
         *_dense_kbias(name, kbias), device=q.device)
    return dq


def _dense_kbias(name, kbias):
    """The key-bias argument of a dense sm90 entry (null for none; its
    kernels read it with 4-byte copies); no argument for the rest."""
    if name not in DENSE_SM90:
        return []
    return [None if kbias is None else kbias.data_ptr()]


def dense_bwd_kernel(dtype, head_dim):
    """The dense backward kernels ``(dK/dV, dQ)`` a CUDA tensor of ``dtype``
    and ``head_dim`` takes: ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``
    for bf16 and fp16 at head dim 64, else the templates ``flash_bwd_dkdv``
    and ``flash_bwd_dq``.  Decided before any launch, never by a failure."""
    if head_dim in SM90_BWD_HEAD_DIMS.get(dtype, ()):
        return DENSE_BWD_SM90
    return "flash_bwd_dkdv", "flash_bwd_dq"


def flash_bwd_dkdv(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``(dk, dv)``: for CUDA tensors the dK/dV kernel of
    :func:`dense_bwd_kernel`, for CPU tensors the plain version."""
    return _bwd_dkdv(dense_bwd_kernel(q.dtype, q.shape[-1])[0], q, k, v, do, lse, delta,
                     causal, sm_scale)


def flash_bwd_dq(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``dq``: for CUDA tensors the dQ kernel of :func:`dense_bwd_kernel`,
    for CPU tensors the plain version."""
    return _bwd_dq(dense_bwd_kernel(q.dtype, q.shape[-1])[1], q, k, v, do, lse, delta, causal,
                   sm_scale)


def flash_bwd_dkdv_template(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``(dk, dv)``: the template ``flash_bwd_dkdv`` kernel whatever the
    dtype and head dim (for CUDA tensors; the plain version for CPU ones)."""
    return _bwd_dkdv("flash_bwd_dkdv", q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dq_template(q, k, v, do, lse, delta, causal=True, sm_scale=None):
    """``dq``: the template ``flash_bwd_dq`` kernel whatever the dtype and
    head dim (for CUDA tensors; the plain version for CPU ones)."""
    return _bwd_dq("flash_bwd_dq", q, k, v, do, lse, delta, causal, sm_scale)


def flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, causal=True, sm_scale=None,
                        key_padding_bias=None):
    """``(dk, dv)``: the ``flash_bwd_dkdv_sm90`` kernel (bf16 and fp16, head
    dim 64; others raise), with the optional fp32 (B, T) key bias, for CUDA
    tensors, the plain version for CPU ones."""
    return _bwd_dkdv("flash_bwd_dkdv_sm90", q, k, v, do, lse, delta, causal, sm_scale,
                     kbias=key_padding_bias)


def flash_bwd_dq_sm90(q, k, v, do, lse, delta, causal=True, sm_scale=None,
                      key_padding_bias=None):
    """``dq``: the ``flash_bwd_dq_sm90`` kernel (bf16 and fp16, head dim 64;
    others raise), with the optional fp32 (B, T) key bias, for CUDA tensors,
    the plain version for CPU ones."""
    return _bwd_dq("flash_bwd_dq_sm90", q, k, v, do, lse, delta, causal, sm_scale,
                   kbias=key_padding_bias)


def flash_bwd_dkdv_sm90_schedule(B, T, H, causal, n_pipes):
    """The schedule of ``flash_bwd_dkdv_sm90`` in Python, as the kernel
    computes it on a (B, T, H) call with ``n_pipes`` persistent pipes (two a
    block, one block an SM): work item ``w`` is key tile ``w // (B*H)`` of
    ``(b, h) = divmod(w % (B*H), H)`` (the causal items longest first), dealt
    over the pipes as :func:`flash_fwd_sm90_blocks` deals; per pipe its items
    in order, each ``(b, h, key tile, visits)`` with ``visits`` a list of
    ``(query tile, masked)``: the query tiles from the key tile on when
    causal, else all, ``masked`` on the causal diagonal and on the tile
    that crosses T.  A tile ``t`` is rows ``64 t .. 64 t + 63``."""
    return _dense_schedule(B, T, H, causal, n_pipes, "k")


def flash_bwd_dq_sm90_schedule(B, T, H, causal, n_pipes):
    """The schedule of ``flash_bwd_dq_sm90`` in Python, as
    :func:`flash_bwd_dkdv_sm90_schedule` with the roles swapped: item ``w``
    is query tile ``nt - 1 - w // (B*H)``; each ``(b, h, query tile,
    visits)`` with ``visits`` a list of ``(key tile, masked)``: the key
    tiles up to the query tile when causal, else all."""
    return _dense_schedule(B, T, H, causal, n_pipes, "q")


def _dense_schedule(B, T, H, causal, n_pipes, side):
    nt, BH = -(-T // TILE), B * H
    ragged = T % TILE != 0
    out = []
    for items in flash_fwd_sm90_blocks(nt * BH, n_pipes):
        pipe = []
        for w in items:
            y, bh = divmod(w, BH)
            if side == "k":
                tile, visits = y, range(y if causal else 0, nt)
            else:
                tile = nt - 1 - y
                visits = range(tile + 1 if causal else nt)
            pipe.append((bh // H, bh % H, tile,
                         [(u, (causal and u == tile) or (ragged and u == nt - 1))
                          for u in visits]))
        out.append(pipe)
    return out


def biased_bwd_kernel(dtype, head_dim, has_abias):
    """The dense biased backward kernels ``(dK/dV, dQ)`` a CUDA tensor of
    ``dtype`` and ``head_dim`` takes: ``flash_bwd_dkdv_sm90`` and
    ``flash_bwd_dq_sm90`` (their key-bias instances) where
    :func:`_group_route` holds (bf16 and fp16 at head dim 64, no (T, T)
    score bias), else the templates ``flash_bwd_dkdv_biased`` and ``flash_bwd_dq_biased``
    (fp32, head dims 96 and 128, any score bias).  Decided before any
    launch, never by a failure."""
    if _group_route(dtype, head_dim, has_abias):
        return DENSE_BWD_SM90
    return "flash_bwd_dkdv_biased", "flash_bwd_dq_biased"


def flash_bwd_dkdv_biased(q, k, v, do, lse, delta, key_padding_bias=None, attn_bias=None,
                          causal=True, sm_scale=None):
    """``(dk, dv)`` with the biases: for CUDA tensors the dK/dV kernel of
    :func:`biased_bwd_kernel`, for CPU tensors the plain version."""
    name = biased_bwd_kernel(q.dtype, q.shape[-1], attn_bias is not None)[0]
    return _bwd_dkdv(name, q, k, v, do, lse, delta, causal, sm_scale, None, key_padding_bias,
                     attn_bias)


def flash_bwd_dq_biased(q, k, v, do, lse, delta, key_padding_bias=None, attn_bias=None,
                        causal=True, sm_scale=None):
    """``dq`` with the biases: for CUDA tensors the dQ kernel of
    :func:`biased_bwd_kernel`, for CPU tensors the plain version."""
    name = biased_bwd_kernel(q.dtype, q.shape[-1], attn_bias is not None)[1]
    return _bwd_dq(name, q, k, v, do, lse, delta, causal, sm_scale, None, key_padding_bias,
                   attn_bias)


def flash_bwd_dkdv_biased_template(q, k, v, do, lse, delta, key_padding_bias=None,
                                   attn_bias=None, causal=True, sm_scale=None):
    """``(dk, dv)``: the template ``flash_bwd_dkdv_biased`` kernel whatever
    the dtype, head dim and biases (for CUDA tensors; the plain version for
    CPU ones)."""
    return _bwd_dkdv("flash_bwd_dkdv_biased", q, k, v, do, lse, delta, causal, sm_scale,
                     None, key_padding_bias, attn_bias)


def flash_bwd_dq_biased_template(q, k, v, do, lse, delta, key_padding_bias=None,
                                 attn_bias=None, causal=True, sm_scale=None):
    """``dq``: the template ``flash_bwd_dq_biased`` kernel whatever the
    dtype, head dim and biases (for CUDA tensors; the plain version for CPU
    ones)."""
    return _bwd_dq("flash_bwd_dq_biased", q, k, v, do, lse, delta, causal, sm_scale,
                   None, key_padding_bias, attn_bias)


def _group_route(dtype, head_dim, has_abias):
    """Whether a CUDA tensor takes the sm90 kernels that carry the key bias
    (``GROUP_KERNELS``, and the dense pair ``DENSE_BWD_SM90`` on the biased
    path): bf16 and fp16 at head dim 64 with no (T, T) score bias (the key
    bias is optional).  Decided before any launch, never by a failure."""
    return not has_abias and head_dim in SM90_BWD_HEAD_DIMS.get(dtype, ())


def sparse_dkdv_kernel(dtype, head_dim, has_abias):
    """The block-sparse dK/dV kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_bwd_dkdv_lut_sm90`` where
    :func:`_group_route` holds, else the template ``flash_bwd_dkdv_lut``."""
    sm90 = _group_route(dtype, head_dim, has_abias)
    return "flash_bwd_dkdv_lut_sm90" if sm90 else "flash_bwd_dkdv_lut"


def sparse_dq_kernel(dtype, head_dim, has_abias):
    """The block-sparse dQ kernel a CUDA tensor of ``dtype`` and
    ``head_dim`` takes: ``flash_bwd_dq_lut_sm90`` where
    :func:`_group_route` holds, else the template ``flash_bwd_dq_lut``."""
    return "flash_bwd_dq_lut_sm90" if _group_route(dtype, head_dim, has_abias) else \
        "flash_bwd_dq_lut"


def flash_bwd_dkdv_lut(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                       attn_bias=None, sm_scale=None):
    """``(dk, dv)`` over the live pairs of ``lut`` with the optional biases:
    for CUDA tensors the kernel of :func:`sparse_dkdv_kernel`, for CPU
    tensors the plain version."""
    if sparse_dkdv_kernel(q.dtype, q.shape[-1], attn_bias is not None) == \
            "flash_bwd_dkdv_lut_sm90":
        return flash_bwd_dkdv_lut_sm90(q, k, v, do, lse, delta, lut, key_padding_bias,
                                       sm_scale)
    return flash_bwd_dkdv_lut_tiled(q, k, v, do, lse, delta, lut, key_padding_bias,
                                    attn_bias, sm_scale)


def flash_bwd_dkdv_lut_tiled(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                             attn_bias=None, sm_scale=None):
    """``(dk, dv)``: the template ``flash_bwd_dkdv_lut`` kernel (64 x 64
    tiles over the LUT's transpose, ``qmap``/``qlen``, with their cell
    masks) whatever the dtype and head dim (for CUDA tensors; the plain
    version for CPU tensors)."""
    return _bwd_dkdv("flash_bwd_dkdv_lut", q, k, v, do, lse, delta, lut.causal, sm_scale,
                     lut, key_padding_bias, attn_bias)


def flash_bwd_dkdv_lut_sm90(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                            sm_scale=None):
    """``(dk, dv)``: the ``flash_bwd_dkdv_lut_sm90`` kernel over
    ``lut.groups("k")`` (bf16 and fp16, head dim 64; others raise) for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut.causal,
                                                  sm_scale, lut=lut,
                                                  key_padding_bias=key_padding_bias)
    return tuple(_group_launch("flash_bwd_dkdv_lut_sm90", "k", 2, q, k, v, do, lse, delta, lut,
                               key_padding_bias, sm_scale))


def _group_launch(name, side, n_out, q, k, v, do, lse, delta, lut, kbias, sm_scale):
    """Launch a group kernel (``GROUP_KERNELS``) over ``lut.groups(side)``
    after checking its operands; returns its ``n_out`` outputs, (B, T, H,
    d) in q's dtype."""
    B, T, H, d = q.shape
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    _check_extra(name, q, lut, kbias, None)
    sched = _group_sched(name, q, lut, side, kbias)
    outs = [torch.empty((B, T, H, d), dtype=q.dtype, device=q.device) for _ in range(n_out)]
    strides = _strides(q, k, v, do)
    _run(name, _DTYPE_CODES[q.dtype], d, *ptrs, *(o.data_ptr() for o in outs),
         ctypes.addressof(strides), B, T, H, int(lut.causal), _scale(q, sm_scale),
         ctypes.addressof(sched), device=q.device)
    return outs


def _group_sched(name, q, lut, side, kbias):
    """The ``_GroupSchedule`` of ``lut.groups(side)`` for a (B, T, H, d)
    call of ``q``'s shape, with the key bias (or None), which must start
    16-byte aligned for the kernels' TMA map."""
    if kbias is not None and kbias.data_ptr() % 16:
        raise ValueError(f"{name}: key_padding_bias must start 16-byte aligned for the "
                         "kernel's TMA map")
    B, _, H, _ = q.shape
    groups = lut.groups(side)
    t = groups.tensors(q.device, B, H)
    return _GroupSchedule(*(t[n].data_ptr() for n in ("out_slots", "vbeg", "visit_slots",
                                                       "masked", "order")),
                          None if kbias is None else kbias.data_ptr(),
                          t["order"].shape[0], groups.unit)


def flash_bwd_dkdv_lut_sm90_schedule(lut, B, H, n_pipes):
    """The schedule of ``flash_bwd_dkdv_lut_sm90`` in Python, as the kernel
    runs it on a (B, T, H) call with ``n_pipes`` persistent pipes (two a
    block, one block an SM: each pipe a consumer warpgroup with its own
    stream of work): per pipe its work items in order (dealt from
    ``GroupLut.order`` as :func:`flash_fwd_sm90_blocks` deals), each ``(b,
    h, key units, visits)`` with ``visits`` a list of ``(query units,
    masked)``; a unit ``u`` is rows ``u * unit .. u * unit + unit - 1``, -1
    an empty slot."""
    return _group_schedule(lut.groups("k"), B, H, n_pipes)


def flash_bwd_dq_lut_sm90_schedule(lut, B, H, n_pipes):
    """The schedule of ``flash_bwd_dq_lut_sm90`` in Python, as
    :func:`flash_bwd_dkdv_lut_sm90_schedule` with the roles swapped: per
    pipe its work items ``(b, h, query units, visits)``, ``visits`` a list
    of ``(key units, masked)``."""
    return _group_schedule(lut.groups("q"), B, H, n_pipes)


def _group_schedule(g, B, H, n_pipes):
    order = g.order(B, H)
    out = []
    for items in flash_fwd_sm90_blocks(len(order), n_pipes):
        block = []
        for w in items:
            bh, tile = (int(x) for x in order[w])
            visits = [(tuple(int(u) for u in g.visit_slots[j]), bool(g.masked[j]))
                      for j in range(g.vbeg[tile], g.vbeg[tile + 1])]
            block.append((bh // H, bh % H, tuple(int(u) for u in g.out_slots[tile]), visits))
        out.append(block)
    return out


def flash_bwd_dq_lut(q, k, v, do, lse, delta, lut, key_padding_bias=None, attn_bias=None,
                     sm_scale=None):
    """``dq`` over the live pairs of ``lut`` with the optional biases: for
    CUDA tensors the kernel of :func:`sparse_dq_kernel`, for CPU tensors the
    plain version."""
    if sparse_dq_kernel(q.dtype, q.shape[-1], attn_bias is not None) == "flash_bwd_dq_lut_sm90":
        return flash_bwd_dq_lut_sm90(q, k, v, do, lse, delta, lut, key_padding_bias, sm_scale)
    return flash_bwd_dq_lut_tiled(q, k, v, do, lse, delta, lut, key_padding_bias, attn_bias,
                                  sm_scale)


def flash_bwd_dq_lut_tiled(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                           attn_bias=None, sm_scale=None):
    """``dq``: the template ``flash_bwd_dq_lut`` kernel (64 x 64 tiles over
    the LUT's ``kmap``/``klen``, with their cell masks) whatever the dtype
    and head dim (for CUDA tensors; the plain version for CPU tensors)."""
    return _bwd_dq("flash_bwd_dq_lut", q, k, v, do, lse, delta, lut.causal, sm_scale,
                   lut, key_padding_bias, attn_bias)


def flash_bwd_dq_lut_sm90(q, k, v, do, lse, delta, lut, key_padding_bias=None,
                          sm_scale=None):
    """``dq``: the ``flash_bwd_dq_lut_sm90`` kernel over ``lut.groups("q")``
    (bf16 and fp16, head dim 64; others raise) for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut.causal, sm_scale,
                                                lut=lut, key_padding_bias=key_padding_bias)
    return _group_launch("flash_bwd_dq_lut_sm90", "q", 1, q, k, v, do, lse, delta, lut,
                         key_padding_bias, sm_scale)[0]


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
    ``sched`` a :class:`BandLut` takes :func:`flash_fwd_banded`, a
    :class:`MergedLut` :func:`flash_fwd_merged` (their sm90 instances, or
    the templates, by :func:`banded_fwd_kernel` / :func:`merged_fwd_kernel`);
    else the LUT forward takes the
    kernel :func:`sparse_fwd_kernel` names (``flash_fwd_lut_sm90``, or the
    templates ``flash_fwd_lut_ring`` and ``flash_fwd_lut``), and the dense
    biased one the kernel :func:`biased_fwd_kernel` names (the key-bias
    instance of ``flash_fwd_sm90``, or the template ``flash_fwd_biased``).
    The backward takes the LUT kernels
    over ``lut``, or without one the dense biased route
    (:func:`biased_bwd_kernel`: the key-bias instances of
    ``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90``, or the templates).
    Bias cotangents are zeros (the masks are constants)."""

    @staticmethod
    def forward(ctx, q, k, v, kbias, abias, lut, causal, sm_scale, sched=None):
        if lut is None:
            o, lse = flash_fwd_biased(q, k, v, kbias, abias, causal, sm_scale)
        elif isinstance(sched, BandLut):
            o, lse = flash_fwd_banded(q, k, v, sched, sm_scale)
        elif isinstance(sched, MergedLut):
            o, lse = flash_fwd_merged(q, k, v, sched, sm_scale)
        else:
            name = sparse_fwd_kernel(q.dtype, q.shape[-1], abias is not None,
                                     kbias is not None)
            o, lse = sparse_fwd(name, q, k, v, lut, kbias, abias, sm_scale)
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
    the dense kernels; a causal band layout with no bias
    (:func:`banded_structure`, ``T <= MAX_BAND_T``) the banded kernel; any
    other the LUT forward :func:`sparse_fwd_kernel` names
    (``flash_fwd_lut_sm90`` for bf16 and fp16 at head dim 64 with no score
    bias,
    else the biased LUT template with a bias and the LUT ring without).
    The backward is the LUT (or dense, or biased) kernels."""
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
