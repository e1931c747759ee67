"""The banded and merged-row forwards for Hopper, ``flash_fwd_banded_sm90``
and ``flash_fwd_merged_sm90`` (schedule instances of ``flash_fwd_sm90`` in
deepspeed_tpu_torch/csrc/flash_attention_fwd_sm90.cu), on the CPU.

The kernels run only on a card (``chip_smoke.py`` phases 13 and 14, and the
``cuda``-marked test below).  Here:

- their schedules in Python, ``flash_fwd_banded_sm90_schedule`` over a
  ``BandLut`` and ``flash_fwd_merged_sm90_schedule`` over a ``MergedLut``'s
  128-key slots: under the kernels' element rule (an unmasked visit
  computes every pair of its 128 x 128 tile, a masked one the pairs its
  rule keeps; a skipped half none) each query row meets
  each of its live keys exactly once and no other key, and a visit is
  unmasked for a half only where every pair of the half's rows is live.
  The live set is the layout's (``kron`` of the block layout, and the causal
  mask), at BSLongformer blocks 16 to 512, windows 1 / 3 / 5, globals [0]
  and [0, 3], phase 14's layouts at T 4096 / 8192 / 16384, a ragged T=1008,
  an odd tile count (T=1088), and for the merged schedule per-head Fixed
  layouts, the empty-rows layouts and BERT's tutorial layout; the banded
  schedule's live set also equals what JAX's ``_banded_structure`` implies;
- the routes ``banded_fwd_kernel`` / ``merged_fwd_kernel`` through
  ``flash_fwd_banded`` / ``flash_fwd_merged`` and ``sparse_flash_attention``
  on meta tensors (standing for CUDA ones) with ``_run`` replaced, the
  schedule structs handed to the C entries, the entries' argument lists
  against ``_entry``'s argtypes, the refusals; with no nvcc the call raises
  and counts no launch.

The JAX package is imported inside the one test that needs it, so the card
test runs without it."""

import ctypes
import importlib
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

BANDED, MERGED = fa.SCHED_SM90
BN = fa.SM90_BLOCK_N
BQ = fa.SM90_BLOCK_Q
BF16_TOL = (2 ** -5, 2 ** -7)      # chip_smoke.py FLASH_TOL: the card test's limits


def _longformer(block, T, window, globals_, causal=True):
    return tsc.BSLongformerSparsityConfig(
        num_heads=1, block=block, num_sliding_window_blocks=window,
        global_block_indices=globals_,
        attention="unidirectional" if causal else "bidirectional").make_layout(T).astype(np.int32)


def _workload(block, T):
    """Phase 14's layout: a 3 x 512-token window, the first 512 tokens global."""
    return _longformer(block, T, 1536 // block, list(range(512 // block)))


def _layout_rows(layout, causal, h, q0, q1, T):
    """(q1 - q0, T) bool: the layout's live pairs of query rows q0 .. q1 - 1
    (head layout ``h``), with the causal mask."""
    lay = np.asarray(layout)[h if layout.shape[0] > 1 else 0] > 0
    block = T // lay.shape[0]
    rows, cols = np.arange(q0, q1), np.arange(T)
    live = lay[rows // block][:, cols // block]
    if causal:
        live &= rows[:, None] >= cols[None, :]
    return live


def _band(layout, T):
    st = fa.banded_structure(layout, True)
    assert st is not None
    return fa.band_lut(*st, T // layout.shape[1], T)


def _band_kept(band, rows, k0):
    """The banded kernel's element rule on a masked tile at ``k0``: (rows,
    128 keys) bool, k < T, k <= q and each 16-key chunk's layout column in
    the row's band or global (the consumers' ``live`` bits)."""
    keys = k0 + np.arange(BN)
    chunk_col = (k0 + 16 * (np.arange(BN) // 16)) // band.block
    glob = np.isin(chunk_col, band.kernel_gcols)
    band_ok = (rows[:, None] // band.block - chunk_col[None, :] < band.W) | glob[None, :]
    return (keys[None, :] < band.T) & (rows[:, None] >= keys[None, :]) & band_ok


def _merged_kept(merged, rows, qw, k0, masks):
    """The merged kernel's element rule on a tile at ``k0`` for a half's
    ``rows`` (first row ``qw``) and its masks per 64-key subtile: k < T,
    when causal k <= q, and the cell bit of the subtile's mask (-1: all)."""
    keys = k0 + np.arange(BN)
    cs = merged.cell_shift
    kept = np.zeros((len(rows), BN), bool)
    for sub, m in enumerate(masks):
        ki = np.arange(64)
        bit = (((rows[:, None] - qw) >> cs) << (6 - cs)) + (ki[None, :] >> cs)
        kept[:, 64 * sub:64 * sub + 64] = ((np.int64(m) >> bit) & 1).astype(bool)
    kept &= keys[None, :] < merged.T
    if merged.causal:
        kept &= rows[:, None] >= keys[None, :]
    return kept


def _check_cover(sched, T, live_rows, kept):
    """Each q tile's visits: every live pair of its rows below T met once,
    no other pair, and an unmasked half wholly live.  ``kept(rows, qw, k0,
    flag)`` is the pairs a masked (or, merged, any) visit computes."""
    nq = -(-T // BQ)
    assert [q0 for q0, _ in sched] == [(nq - 1 - y) * BQ for y in range(nq)]
    for q0, visits in sched:
        q1 = min(q0 + BQ, T)
        live = live_rows(q0, q1)
        cover = np.zeros((q1 - q0, -(-T // BN) * BN + BN), np.int32)
        k0s = [k0 for k0, _ in visits]
        assert len(set(k0s)) == len(k0s)
        for k0, halves in visits:
            for c, flag in enumerate(halves):
                qw = q0 + 64 * c
                if flag is None or qw >= q1:
                    continue
                rows = np.arange(qw, min(qw + 64, q1))
                got = kept(rows, qw, k0, flag)
                masked = flag if isinstance(flag, bool) else flag[0]
                if not masked:   # wholly live for the half's rows
                    assert k0 + BN <= T and live[rows - q0][:, k0:k0 + BN].all(), (q0, k0, c)
                    got = np.ones_like(got)
                cover[rows - q0, k0:k0 + BN] += got
        assert (cover[:, :T] == live).all(), q0
        assert not cover[:, T:].any()


def _check_banded(layout, T):
    band = _band(layout, T)
    sched = fa.flash_fwd_banded_sm90_schedule(band)
    _check_cover(sched, T, lambda q0, q1: _layout_rows(layout, True, 0, q0, q1, T),
                 lambda rows, qw, k0, masked: _band_kept(band, rows, k0))
    return band, sched


def _check_merged(layout, T, causal):
    lut = fa.layout_luts(layout, T, layout.shape[0], causal)
    merged = lut.merged
    for h in range(layout.shape[0]):
        sched = fa.flash_fwd_merged_sm90_schedule(merged, h)
        _check_cover(sched, T, lambda q0, q1: _layout_rows(layout, causal, h, q0, q1, T),
                     lambda rows, qw, k0, flag: _merged_kept(merged, rows, qw, k0, flag[1]))
    return merged


# ------------------------------------------------------------- schedules
LONGFORMER_CASES = [(block, T, window, g) for block, T in ((16, 1024), (32, 1024), (64, 2048),
                                                            (128, 2048), (512, 8192))
                    for window in (1, 3, 5) for g in ([0], [0, 3])]
# the band-expressible ones (W + globals short of every column)
BAND_CASES = [c for c in LONGFORMER_CASES
              if fa.banded_structure(_longformer(*c), True) is not None]


@pytest.mark.parametrize("block,T,window,globals_", BAND_CASES)
def test_banded_schedule_meets_every_live_pair_once(block, T, window, globals_):
    _check_banded(_longformer(block, T, window, globals_), T)


@pytest.mark.parametrize("block,T", [(64, 4096), (64, 8192), (64, 16384), (512, 4096),
                                     (512, 8192), (512, 16384)])
def test_banded_schedule_at_the_workload(block, T):
    band, sched = _check_banded(_workload(block, T), T)
    if (block, T) == (64, 8192):
        # W = 13 at block 64: 7 band tiles and 4 global tiles from q tile 10 on, 649 in all;
        # of each q tile's visits only the diagonal (both halves) and the band's first
        # tile (the lower half) take the element mask
        assert band.W == 13 and list(band.gtiles_sm90) == [0, 1, 2, 3]
        assert sum(len(v) for _, v in sched) == 649
        for q0, visits in sched:
            if q0 >= 10 * BQ:
                assert [m for _, m in visits] == [(True, True)] + [(False, False)] * 5 + [
                    (False, True)] + [(False, False)] * 4


@pytest.mark.parametrize("block,T,window", [(16, 1008, 5), (32, 1088, 5), (16, 1088, 5)])
def test_banded_schedule_ragged(block, T, window):
    _check_banded(_longformer(block, T, window, [0, 3]), T)


def test_banded_schedule_matches_jax_banded_structure():
    """The banded schedule's live set is the one JAX's ``_banded_structure``
    implies: live(i, j) iff 0 <= i - j < W or (j in gcols and j <= i), at
    the block level, expanded with the causal mask."""
    jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
    for block, T, window, g in ((16, 1008, 5, [0, 3]), (32, 1024, 3, [0]), (64, 4096, 24,
                                                                             list(range(8)))):
        layout = _longformer(block, T, window, g)
        W, gcols = jfa._banded_structure(layout.tobytes(), layout.shape, True)
        nb = T // block
        ii, jj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
        implied = ((ii - jj >= 0) & (ii - jj < W)) | (np.isin(jj, gcols) & (jj <= ii))
        band = _band(layout, T)
        sched = fa.flash_fwd_banded_sm90_schedule(band)
        pos = np.arange(T)
        _check_cover(sched, T, lambda q0, q1: implied[pos[q0:q1, None] // block,
                                                      pos[None, :] // block]
                     & (pos[q0:q1, None] >= pos[None, :]),
                     lambda rows, qw, k0, masked: _band_kept(band, rows, k0))


def _empty_rows(T):
    """The diagonal blocks of block 16 but for the first 64 queries and keys."""
    layout = np.zeros((1, T // 16, T // 16), np.int32)
    live = np.arange(4, T // 16)
    layout[0, live, live] = 1
    return layout


def _alternate_empty_rows(T):
    """Block 16, the diagonal blocks of the odd 64-row q tiles only: each
    merged row's upper half has no live tile."""
    layout = np.zeros((1, T // 16, T // 16), np.int32)
    live = np.arange(T // 16)
    live = live[(live // 4) % 2 == 1]
    layout[0, live, live] = 1
    return layout


def _fixed(T, H, causal, per_head):
    return tsc.FixedSparsityConfig(
        num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
        different_layout_per_head=per_head, num_different_global_patterns=4 if per_head else 1,
        attention="unidirectional" if causal else "bidirectional").make_layout(T).astype(
            np.int32)


def _tutorial(T, H):
    cfg = tsc.FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                  num_global_blocks=1, different_layout_per_head=True,
                                  num_different_global_patterns=4)
    return cfg.make_layout(T).astype(np.int32)


MERGED_CASES = [
    ("longformer16", lambda: _longformer(16, 1024, 5, [0, 3]), 1024, True),
    ("longformer32", lambda: _longformer(32, 1024, 3, [0]), 1024, True),
    ("longformer64", lambda: _longformer(64, 2048, 5, [0, 3]), 2048, True),
    ("longformer128", lambda: _longformer(128, 2048, 1, [0]), 2048, True),
    ("longformer512", lambda: _longformer(512, 8192, 3, [0]), 8192, True),
    ("ragged1008", lambda: _longformer(16, 1008, 5, [0, 3]), 1008, True),
    ("odd1088", lambda: _longformer(32, 1088, 5, [0, 3]), 1088, True),
    ("fixed-causal", lambda: _fixed(1024, 1, True, False), 1024, True),
    ("fixed-per-head-causal", lambda: _fixed(512, 4, True, True), 512, True),
    ("fixed-per-head", lambda: _fixed(512, 4, False, True), 512, False),
    ("empty-rows-causal", lambda: _empty_rows(256), 256, True),
    ("empty-rows", lambda: _empty_rows(256), 256, False),
    ("alternate-empty-rows", lambda: _alternate_empty_rows(512), 512, True),
    ("tutorial", lambda: _tutorial(2048, 2), 2048, False),
    ("workload64-4096", lambda: _workload(64, 4096), 4096, True),
    ("workload512-8192", lambda: _workload(512, 8192), 8192, True),
    ("workload64-16384", lambda: _workload(64, 16384), 16384, True),
]


@pytest.mark.parametrize("name,make,T,causal", MERGED_CASES, ids=[c[0] for c in MERGED_CASES])
def test_merged_schedule_meets_every_live_pair_once(name, make, T, causal):
    _check_merged(make(), T, causal)


@pytest.mark.parametrize("block,T,window,globals_", LONGFORMER_CASES)
def test_merged_schedule_longformer(block, T, window, globals_):
    """Every causal BSLongformer layout of the grid, bands or not."""
    _check_merged(_longformer(block, T, window, globals_), T, True)


def test_merged_schedule_skips_the_empty_half():
    """A merged row whose upper half has no live tile: that half's slots
    are all skipped (None), the lower half's visited; 128-key slots pair
    the 64-key tiles, one slot for each pair either half holds."""
    T = 512
    merged = fa.layout_luts(_alternate_empty_rows(T), T, 1, True).merged
    for q0, visits in fa.flash_fwd_merged_sm90_schedule(merged, 0):
        assert visits and all(h0 is None and h1 is not None for _, (h0, h1) in visits)
    tmap, tmask, tlen = merged.slots()
    assert tmask.shape[-2:] == (2, 2) and (tlen == 1).all()
    assert (tmap[0, :, 0] == np.arange(T // BQ)).all()
    assert (tmask[0, :, 0, 0] == 0).all() and (tmask[0, :, 0, 1, 1] != 0).all()


def test_merged_slots_hold_no_tile_above_a_causal_diagonal():
    """At layout block 512 a diagonal block's cells repeat over its tiles,
    so the ``MergedLut`` lists tiles past a half's q tile; the slots give
    each such (half, subtile) 0 and drop slots left with none, so the
    merged rows visit exactly the banded schedule's tiles."""
    T = 8192
    layout = _workload(512, T)
    merged = fa.layout_luts(layout, T, 1, True).merged
    assert (merged.kmap[0, 0, :merged.klen[0, 0]] > 1).any()    # row 0: q tiles 0 and 1
    tmap, tmask, tlen = merged.slots()
    for r in range(tmap.shape[1]):
        for j in range(int(tlen[0, r])):
            for half in (0, 1):
                for sub in (0, 1):
                    if tmask[0, r, j, half, sub]:
                        assert tmap[0, r, j] * 2 + sub <= 2 * r + half
    assert tlen.sum() == sum(len(v) for _, v in fa.flash_fwd_banded_sm90_schedule(
        _band(layout, T)))


# --------------------------------------------------------------- routes
def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _recorded(monkeypatch):
    """Replace ``_run``: record (name, the arguments before the stream, the
    schedule struct's fields read while the call holds it)."""
    calls = []

    def run(name, *args, device):
        fields = None
        if name == BANDED:
            s = fa._BandSm90.from_address(args[-1])
            fields = (s.w, s.lb, s.n_gtiles, list(s.gtile[:s.n_gtiles]), list(s.gbits))
        elif name == MERGED:
            s = fa._MergedSched.from_address(args[-1])
            fields = (s.width, s.heads, s.cell_shift)
        calls.append((name, args, fields))
    monkeypatch.setattr(fa, "_run", run)
    return calls


@pytest.mark.parametrize("dtype,d,banded,merged", [
    (torch.bfloat16, 64, BANDED, MERGED), (torch.bfloat16, 128, BANDED, MERGED),
    (torch.bfloat16, 96, "flash_fwd_banded", "flash_fwd_merged"),
    (torch.float32, 64, "flash_fwd_banded", "flash_fwd_merged"),
    (torch.float32, 128, "flash_fwd_banded", "flash_fwd_merged")])
def test_routes(monkeypatch, dtype, d, banded, merged):
    """bf16 at head dims 64 and 128 takes the sm90 instances, decided by
    dtype and head dim before any launch; fp32 and head dim 96 keep the template
    kernels; the ``_template`` wrappers take the templates at any dtype; the sparse
    path's forward takes the same routes."""
    calls = _recorded(monkeypatch)
    T, H = 256, 2
    layout = _longformer(16, T, 5, [0, 3])
    band, lut = _band(layout, T), fa.layout_luts(layout, T, H, True)
    q = _meta((1, T, H, d), dtype)
    assert (fa.banded_fwd_kernel(dtype, d), fa.merged_fwd_kernel(dtype, d)) == (banded, merged)
    for out in (fa.flash_fwd_banded(q, q, q, band), fa.flash_fwd_merged(q, q, q, lut.merged),
                fa.flash_fwd_banded_template(q, q, q, band),
                fa.flash_fwd_merged_template(q, q, q, lut.merged)):
        assert out[0].shape == q.shape and out[1].shape == (1, H, T)
    leaves = [_meta((1, T, H, d), dtype).requires_grad_(True) for _ in range(3)]
    fa.sparse_flash_attention(*leaves, layout, causal=True)
    fa.sparse_flash_attention(*leaves, layout, causal=True, block_q_merge=2)
    assert [n for n, *_ in calls] == [banded, merged, "flash_fwd_banded", "flash_fwd_merged",
                                      banded, merged]
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_schedule_structs_handed_to_the_entries(monkeypatch):
    """The banded entry gets ``band.param_sm90()`` (W, the layout block, the
    128-key global tiles, the global-column bits), the merged one the
    ``MergedLut``'s slot arrays, with their width, head layouts and cell
    size; the scalar arguments as ``flash_fwd_sm90``'s."""
    calls = _recorded(monkeypatch)
    B, T, H, d = 2, 8192, 8, 64
    layout = _workload(64, T)
    band = _band(layout, T)
    merged = fa.layout_luts(layout, T, H, True).merged
    q = _meta((B, T, H, d))
    fa.flash_fwd_banded_sm90(q, q, q, band)
    fa.flash_fwd_merged_sm90(q, q, q, merged)
    (name, args, fields), (mname, margs, mfields) = calls
    assert name == BANDED and args[:2] == (1, d) and args[-6:-3] == (B, T, H)
    assert args[-3] == 1 and args[-2] == pytest.approx(1 / 8)
    w, lb, n_gtiles, gtile, gbits = fields
    assert (w, lb, n_gtiles, gtile) == (13, 64, 4, [0, 1, 2, 3])
    assert gbits[0] == 0xFF and not any(gbits[1:])
    tmap, tmask, tlen = merged.slots()
    assert mname == MERGED and margs[-3] == 1
    assert mfields == (tmap.shape[-1], 1, 6)
    assert tmask.shape == tmap.shape + (2, 2) and tlen.shape == (1, T // BQ)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_entries_take_their_schedule_last(monkeypatch):
    """The argument lists the wrappers hand to the two C entries match the
    ``argtypes`` ``_entry`` gives them: ``flash_fwd_sm90``'s list with the
    schedule struct's address in the key bias's place, then the stream."""
    calls = _recorded(monkeypatch)
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace(argtypes=None, restype=None)
                                    for n in fa.SCHED_SM90})
    monkeypatch.setattr(builder, "load", lambda lib: fake)
    T, H = 1024, 2
    layout = _longformer(32, T, 5, [0, 3])
    q = _meta((1, T, H, 128))
    fa.flash_fwd_banded(q, q, q, _band(layout, T))
    fa.flash_fwd_merged(q, q, q, fa.layout_luts(layout, T, H, True).merged)
    for name, args, _ in calls:
        argtypes = fa._entry(name).argtypes
        assert len(args) + 1 == len(argtypes) == 15
        assert argtypes[-2] is argtypes[-1] is ctypes.c_void_p     # schedule, stream
        assert argtypes[-3] is ctypes.c_float and isinstance(args[-1], int) and args[-1]
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_wrappers_refuse_what_they_were_not_built_for():
    """The sm90 wrappers raise on a dtype or head dim they were not built
    for and on a schedule of another T."""
    T = 256
    layout = _longformer(16, T, 5, [0, 3])
    band, merged = _band(layout, T), fa.layout_luts(layout, T, 2, True).merged
    for q, match in ((_meta((1, T, 2, 64), torch.float32), "dtype"),
                     (_meta((1, T, 2, 96)), "head dim"), (_meta((1, 128, 2, 64)), "LUT")):
        for call in (lambda: fa.flash_fwd_banded_sm90(q, q, q, band),
                     lambda: fa.flash_fwd_merged_sm90(q, q, q, merged)):
            with pytest.raises(ValueError, match=match):
                call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_route_without_nvcc_raises(monkeypatch):
    """With no nvcc the routes raise and count no launch: nothing falls back
    to the templates or the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    T = 256
    layout = _longformer(16, T, 5, [0, 3])
    q = _meta((1, T, 2, 64))
    for call in (lambda: fa.flash_fwd_banded(q, q, q, _band(layout, T)),
                 lambda: fa.flash_fwd_merged(q, q, q, fa.layout_luts(layout, T, 2, True).merged),
                 lambda: fa.sparse_flash_attention(q, q, q, layout, causal=True)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the sm90 wrappers return the plain forward over their
    schedule (the routes do not matter there)."""
    T, H, d = 256, 2, 64
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, H, d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    layout = _longformer(16, T, 5, [0, 3])
    band, merged = _band(layout, T), fa.layout_luts(layout, T, H, True).merged
    for got, sched in ((fa.flash_fwd_banded_sm90(q, k, v, band), band),
                       (fa.flash_fwd_merged_sm90(q, k, v, merged), merged)):
        want = fa.flash_attention_reference_fwd(q, k, v, lut=sched)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_banded_and_merged_match_their_plain_versions_on_the_card():
    """Both instances against their plain versions on a CUDA card, O and
    lse, bf16 at head dims 64 and 128, a ragged T and an odd tile count;
    the merged one also on non-causal per-head and empty-rows layouts
    (``chip_smoke.py`` phase 13 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    H = 4
    cases = []
    for block, T, d in ((16, 1008, 64), (32, 1088, 128), (64, 4096, 64)):
        layout = _longformer(block, T, 5, [0, 3])
        cases.append((T, d, [(BANDED, _band(layout, T), fa.flash_fwd_banded_sm90),
                             (MERGED, fa.layout_luts(layout, T, H, True).merged,
                              fa.flash_fwd_merged_sm90)]))
    for layout, T in ((_fixed(512, H, False, True), 512), (_empty_rows(256), 256)):
        cases.append((T, 64, [(MERGED, fa.layout_luts(layout, T, H, False).merged,
                               fa.flash_fwd_merged_sm90)]))
    for T, d, runs in cases:
        q, k, v = (torch.randn((2, T, H, d), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        for name, sched, call in runs:
            before = fa.launches[name]
            o, lse = call(q, k, v, sched)
            assert fa.launches[name] == before + 1
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=sched)
            ro = ro.float()
            limit = BF16_TOL[0] * ro.pow(2).mean().sqrt() + BF16_TOL[1] * ro.abs()
            assert ((o.float() - ro).abs() <= limit).all(), (name, T, d)
            assert ((lse - rlse).abs() <= 1e-4).all(), (name, T, d)
