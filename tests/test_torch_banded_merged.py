"""The port's banded and merged-row block-sparse forwards and
``flash_attention_with_lse`` against the JAX package's, in fp32 on the CPU:
``banded_structure``, ``BandLut``, ``MergedLut``, ``flash_fwd_banded`` /
``flash_fwd_merged`` and the routes of ``sparse_flash_attention`` in
deepspeed_tpu_torch/ops/transformer/flash_attention.py against
``_banded_structure``, ``_fwd(banded=...)``, ``_merged_luts_cached`` with
``_fwd(sub01=...)`` and ``_fwd_kernel_dma(use_merge=True)``, and
``flash_attention_with_lse`` of deepspeed_tpu/ops/transformer/flash_attention.py.

On the CPU the port's wrappers take their plain versions, which build the
element mask from the kernels' own schedules (the band's positional test;
the merged rows' lists and per-half tile masks).  The CUDA kernels are held
against those plain versions on the card by ``chip_smoke.py`` and by the
``cuda``-marked test below; the kernels' schedules are emulated here tile by
tile.  The JAX side runs its Pallas kernels in interpret mode.  Inputs are
made with numpy from a seed.

Tolerances: 2e-5 on O and lse (magnitude ~1, the same fp32 formula, sums
in another order, one softmax pass against the interpreted kernel's online
one); 1e-4 on gradients (fp32, larger sums over T)."""

import functools
import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
fa = importlib.import_module("deepspeed_tpu_torch.ops.transformer.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, B=1, T=128, H=2, d=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _bhtd(x):
    B, T, H, d = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, d)


def _from_bhtd(o, lse, B, H):
    BH, T, d = o.shape
    return (np.asarray(o).reshape(B, H, T, d).transpose(0, 2, 1, 3),
            np.asarray(lse).reshape(B, H, T))


def _longformer(block, T, window, globals_, causal=True, heads=1):
    cfg = tsc.BSLongformerSparsityConfig(
        num_heads=heads, block=block, num_sliding_window_blocks=window,
        global_block_indices=globals_,
        attention="unidirectional" if causal else "bidirectional")
    return cfg.make_layout(T).astype(np.int32)


# ------------------------------------------------------ band detection
STRUCTURE_CASES = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(block=32, num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("VariableSparsityConfig", dict(block=16, local_window_blocks=[2, 4],
                                    global_block_indices=[1], attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(block=64, num_random_blocks=1)),
    ("BigBirdSparsityConfig", dict(block=64, num_random_blocks=0, num_global_blocks=1,
                                   attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[0, 3])),
    ("BSLongformerSparsityConfig", dict(block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[0, 3],
                                        attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=32, num_sliding_window_blocks=1,
                                        global_block_indices=[0],
                                        attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=64, num_sliding_window_blocks=5,
                                        global_block_indices=[1],
                                        global_block_end_indices=[3],
                                        attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=128, num_sliding_window_blocks=7,
                                        global_block_indices=[0],
                                        attention="unidirectional",
                                        different_layout_per_head=True)),
    # examples/bench_sparse_attention.py's workload at layout blocks 512 and 64
    ("BSLongformerSparsityConfig", dict(block=512, num_sliding_window_blocks=3,
                                        global_block_indices=[0],
                                        attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=64, num_sliding_window_blocks=24,
                                        global_block_indices=list(range(8)),
                                        attention="unidirectional")),
]


@pytest.mark.parametrize("name,kw", STRUCTURE_CASES, ids=lambda x: str(x)[:48])
def test_banded_structure_equals_jax(name, kw):
    """``banded_structure`` returns JAX's ``(W, gcols)`` or None, trailing
    "global" columns included, for every config class, both attention
    directions through ``causal``, at 8, 16 and 64 layout blocks."""
    found = 0
    for nb in (8, 16, 64):
        T = kw["block"] * nb
        layout = np.ascontiguousarray(
            getattr(jsc, name)(num_heads=2, **kw).make_layout(T).astype(np.int32))
        for causal in (True, False):
            want = jfa._banded_structure(layout.tobytes(), layout.shape, causal)
            assert fa.banded_structure(layout, causal) == want
            found += want is not None
    if name == "BSLongformerSparsityConfig" and kw.get("attention") == "unidirectional" \
            and not kw.get("different_layout_per_head"):
        assert found > 0
    assert fa.banded_structure(layout, True) is fa.banded_structure(layout.copy(), True)


def test_bench_workload_structure():
    """The block-64 workload: W = 13 and 21 "global" columns, of which the
    13 trailing ones are band columns the kernel drops."""
    T = 4096
    layout = _longformer(64, T, 24, list(range(8)))
    W, gcols = fa.banded_structure(layout, True)
    assert (W, gcols) == (13, tuple(range(8)) + tuple(range(51, 64)))
    band = fa.band_lut(W, gcols, 64, T)
    assert band.kernel_gcols == tuple(range(8))
    assert band.gtiles.tolist() == list(range(8))


# ------------------------------------------------- the kernels' schedules
def _band_schedule_mask(band):
    """(T, T) bool: the pairs the banded kernel treats as live, emulating
    its schedule (global tiles below the band, then the band's tiles up to
    the diagonal) and its positional element test, tile by tile."""
    T, Lb, W = band.T, band.block, band.W
    nt = -(-T // fa.TILE)
    glob = np.zeros(T // Lb + fa.TILE, bool)
    glob[list(band.kernel_gcols)] = True
    out = np.zeros((nt * fa.TILE, nt * fa.TILE), bool)
    seen = set()
    for qt in range(nt):
        q0 = qt * fa.TILE
        kt_lo = max(q0 // Lb - W + 1, 0) * Lb // fa.TILE
        tiles = [t for t in band.gtiles if t < kt_lo] + list(range(kt_lo, qt + 1))
        assert len(set(tiles)) == len(tiles) and all(0 <= t < nt for t in tiles)
        rows = np.arange(q0, q0 + fa.TILE)[:, None]
        for t in tiles:
            cols = np.arange(t * fa.TILE, (t + 1) * fa.TILE)[None, :]
            live = (cols < T) & (rows >= cols) & (
                (rows // Lb - cols // Lb < W) | glob[cols // Lb])
            out[q0:q0 + fa.TILE, t * fa.TILE:(t + 1) * fa.TILE] = live
            seen.add((qt, t, bool(live.any())))
    return out[:T, :T], seen


BAND_CASES = [  # (block, T, window, global blocks)
    (16, 256, 3, [0]), (16, 1008, 5, [0, 3]), (16, 64, 1, [0]), (32, 320, 1, [0]),
    (32, 1024, 5, [0, 3]), (64, 1024, 5, [0, 3]), (64, 1024, 1, [0]),
    (128, 1024, 3, [0]), (128, 2048, 5, [0, 3]), (512, 4096, 3, [0]),
]


@pytest.mark.parametrize("block,T,window,globals_", BAND_CASES)
def test_band_schedule_holds_the_layout(block, T, window, globals_):
    """The banded kernel's schedule visits exactly the layout's live pairs:
    its positional mask over the visited tiles, the plain version's mask and
    the tile LUT's mask agree; dropped "global" columns lie in the band of
    every row that sees them; the band start clamps at tile 0."""
    layout = _longformer(block, T, window, globals_)
    st = fa.banded_structure(layout, True)
    assert st is not None
    band = fa.band_lut(*st, block, T)
    want = fa.layout_luts(layout, T, 2, True).element_mask("cpu")[0].numpy()
    got, seen = _band_schedule_mask(band)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(band.element_mask("cpu")[0].numpy(), want)
    nb = T // block
    assert set(band.kernel_gcols) <= set(st[1])
    assert all(c + st[0] > nb - 1 for c in set(st[1]) - set(band.kernel_gcols))
    # every visited tile of the schedule holds a live pair (no dead work)
    if block >= fa.TILE:
        assert all(live for _, _, live in seen)
    # the kernel parameter: the global tiles and one bit per global column
    param = band.param()
    assert (param.w, param.lb, param.n_gtiles) == (st[0], block, len(band.gtiles))
    assert list(param.gtile[:param.n_gtiles]) == band.gtiles.tolist()
    bits = [c for c in range(fa.MAX_LAYOUT_COLS) if param.gbits[c >> 5] >> (c & 31) & 1]
    assert bits == list(band.kernel_gcols)


def _merged_schedule_mask(merged):
    """(Lh, T, T) bool: the pairs the merged kernel treats as live, emulating
    its walk over the union lists with each half's tile masks."""
    Lh, rows, _ = merged.kmap.shape
    T, cs = merged.T, merged.cell_shift
    n = rows * 2 * fa.TILE
    out = np.zeros((Lh, n, n), bool)
    pos = np.arange(fa.TILE)
    bit = ((pos[:, None] >> cs) << (6 - cs)) + (pos[None, :] >> cs) if cs < 6 else 0 * pos
    for h in range(Lh):
        for i in range(rows):
            cols = merged.kmap[h, i, :merged.klen[h, i]]
            assert (np.diff(cols) > 0).all()
            for j, kt in enumerate(cols):
                for half in (0, 1):
                    m = int(merged.kmask[h, i, j, half])
                    q0 = (2 * i + half) * fa.TILE
                    out[h, q0:q0 + fa.TILE, kt * fa.TILE:(kt + 1) * fa.TILE] = (
                        True if m == -1 else (m >> bit) & 1 == 1)
    out = out[:, :T, :T]
    return out & np.tril(np.ones((T, T), bool)) if merged.causal else out


MERGE_LAYOUTS = {
    "longformer16": lambda T, H: _longformer(16, T, 5, [0, 3]),
    "longformer64": lambda T, H: _longformer(64, T, 3, [0]),
    "fixed32-causal-per-head": lambda T, H: tsc.FixedSparsityConfig(
        num_heads=H, block=32, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional", different_layout_per_head=True,
        num_different_global_patterns=2).make_layout(T).astype(np.int32),
    "bigbird64-bidirectional": lambda T, H: tsc.BigBirdSparsityConfig(
        num_heads=H, block=64, num_random_blocks=1).make_layout(T).astype(np.int32),
    "longformer128": lambda T, H: _longformer(128, T, 3, [0]),
}


@pytest.mark.parametrize("name,T", [(name, T) for name in sorted(MERGE_LAYOUTS)
                                    for T in (256, 320, 1024) if T % 128 == 0
                                    or "128" not in name])
def test_merged_lut_holds_the_layout(name, T):
    """The merged rows' union lists and per-half masks hold exactly the
    tile LUT's pairs (an odd tile count leaves the last lower half empty)."""
    H = 2
    layout = MERGE_LAYOUTS[name](T, H)
    causal = "bidirectional" not in name
    lut = fa.layout_luts(layout, T, H, causal)
    merged = lut.merged
    assert merged is lut.merged and merged.heads == lut.heads
    assert merged.kmap.shape[1] == -(-lut.tile_mask.shape[1] // 2)
    want = lut.element_mask("cpu").numpy()
    np.testing.assert_array_equal(_merged_schedule_mask(merged), want)
    np.testing.assert_array_equal(merged.element_mask("cpu").numpy(), want)


# ------------------------------------------------------ forward vs JAX
@pytest.mark.parametrize("block,T,window,globals_", [
    (16, 128, 3, [0]), (16, 256, 5, [0, 3]), (32, 256, 1, [0]), (64, 512, 3, [0])])
def test_banded_forward_matches_jax_banded_kernel(block, T, window, globals_):
    """The plain banded forward's O and lse against JAX ``_fwd`` with
    ``banded=(W, gcols, Lb, block_q)`` in interpret mode; the route of
    ``sparse_flash_attention`` gives the same output."""
    B, H, d = 1, 2, 16
    q, k, v = _qkv(block + window, B=B, T=T, H=H, d=d)
    layout = _longformer(block, T, window, globals_)
    W, gcols = fa.banded_structure(layout, True)
    luts = jfa._layout_luts(layout, T, H, True, block, block)
    jo, jlse = jfa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), 1.0 / np.sqrt(d), True, block, block,
                        n_heads=H, kmap=luts[0], klen=luts[1],
                        banded=(W, gcols, block, block))
    jo, jlse = _from_bhtd(jo, jlse, B, H)
    band = fa.band_lut(W, gcols, block, T)
    o, lse = fa.flash_fwd_banded(*_t(q, k, v), band)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)
    ro, rlse = fa.flash_attention_reference_fwd(*_t(q, k, v), True, lut=band)
    assert torch.equal(ro, o) and torch.equal(rlse, lse)
    out = fa.sparse_flash_attention(*_t(q, k, v), layout, causal=True)
    np.testing.assert_array_equal(out.numpy(), o.numpy())
    assert fa.launches == {name: 0 for name in fa.KERNELS}   # no kernel on the CPU


def _jax_merged_fwd(q, k, v, layout, causal):
    """JAX's merged-row forward (the BlockSpec ``_fwd_kernel`` with
    ``use_merge``, interpret mode) -> (o, lse) in (B, T, H, d), (B, H, T)."""
    B, T, H, d = q.shape
    bq = T // layout.shape[1]
    lay = np.ascontiguousarray(np.broadcast_to(layout, (H,) + layout.shape[1:]))
    mk, ml, s0, s1 = jfa._merged_luts_cached(lay.tobytes(), lay.shape, causal, bq, bq)
    o, lse = jfa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), 1.0 / np.sqrt(d), causal, 2 * bq, bq,
                      n_heads=H, kmap=jnp.asarray(mk), klen=jnp.asarray(ml),
                      sub01=(jnp.asarray(s0), jnp.asarray(s1)))
    return _from_bhtd(o, lse, B, H)


@pytest.mark.parametrize("name,T", [("longformer16", 128), ("longformer64", 256),
                                    ("fixed32-causal-per-head", 256),
                                    ("bigbird64-bidirectional", 256)])
def test_merged_forward_matches_jax_merged_kernel(name, T):
    """The plain merged forward's O and lse against JAX's merged-row
    forward in interpret mode, and ``sparse_flash_attention(block_q_merge=2)``
    against the JAX call."""
    B, H, d = 1, 2, 16
    q, k, v = _qkv(T + len(name), B=B, T=T, H=H, d=d)
    causal = "bidirectional" not in name
    layout = MERGE_LAYOUTS[name](T, H)
    jo, jlse = _jax_merged_fwd(q, k, v, layout, causal)
    merged = fa.layout_luts(layout, T, H, causal).merged
    o, lse = fa.flash_fwd_merged(*_t(q, k, v), merged)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)
    ro, rlse = fa.flash_attention_reference_fwd(*_t(q, k, v), causal, lut=merged)
    assert torch.equal(ro, o) and torch.equal(rlse, lse)
    out = fa.sparse_flash_attention(*_t(q, k, v), layout, causal=causal, block_q_merge=2)
    want = jfa.sparse_flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      jnp.asarray(layout), causal=causal, block_q_merge=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)


def test_merged_dma_kernel_matches_in_the_tpu_interpreter():
    """``_fwd_kernel_dma`` with ``use_merge`` (the compiled-TPU route of the
    merged forward, ``_fwd`` 479-480) run through a test-local
    ``pallas_call`` in ``pltpu.InterpretParams()``, whose interpreter runs
    its DMAs and semaphores, against the port's merged forward.  Its
    operands are built as ``_fwd`` builds them (K and V interleaved,
    per-block transposed, an all-zeros block for padded slots)."""
    B, H, d, T, bq = 1, 2, 16, 256, 32
    q, k, v = _qkv(11, B=B, T=T, H=H, d=d)
    layout = _longformer(bq, T, 3, [0])
    lay = np.ascontiguousarray(np.broadcast_to(layout, (H,) + layout.shape[1:]))
    mk, ml, s0, s1 = jfa._merged_luts_cached(lay.tobytes(), lay.shape, True, bq, bq)
    BQ, nkb, BH = 2 * bq, T // bq, B * H
    kt, vt = _bhtd(k), _bhtd(v)
    kv = jnp.concatenate([kt.reshape(BH, nkb, bq, d).swapaxes(2, 3),
                          vt.reshape(BH, nkb, bq, d).swapaxes(2, 3)], axis=2)
    kv = jnp.concatenate([kv, jnp.zeros((BH, 1, 2 * d, bq), kv.dtype)], axis=1)
    kmap = np.where(np.arange(mk.shape[2]) < ml[..., None], mk, nkb)
    q_idx = lambda b, i, km, kl, a0, a1: (b, i, 0)
    kernel = functools.partial(jfa._fwd_kernel_dma, sm_scale=1.0 / np.sqrt(d), causal=True,
                               block_q=BQ, block_k=bq, num_k_blocks=mk.shape[2], seq_len=T,
                               n_heads=H, use_merge=True)
    call = pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=4, grid=(BH, T // BQ),
            in_specs=[pl.BlockSpec((1, BQ, d), q_idx), pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=[pl.BlockSpec((1, BQ, d), q_idx),
                       pl.BlockSpec((1, BQ, jfa.MIN_LANES), q_idx)],
            scratch_shapes=[pltpu.VMEM((BQ, d), jnp.float32), pltpu.VMEM((BQ, 1), jnp.float32),
                            pltpu.VMEM((BQ, 1), jnp.float32),
                            pltpu.VMEM((jfa._N_KV_BUF, 2 * d, bq), jnp.float32),
                            pltpu.SemaphoreType.DMA((jfa._N_KV_BUF,))]),
        out_shape=[jax.ShapeDtypeStruct((BH, T, d), jnp.float32),
                   jax.ShapeDtypeStruct((BH, T, jfa.MIN_LANES), jnp.float32)],
        interpret=pltpu.InterpretParams())
    jo, jlse = call(jnp.asarray(kmap), jnp.asarray(ml), jnp.asarray(s0), jnp.asarray(s1),
                    _bhtd(q), kv)
    jo, jlse = _from_bhtd(jo, jlse[..., 0], B, H)
    o, lse = fa.flash_fwd_merged(*_t(q, k, v), fa.layout_luts(layout, T, H, True).merged)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("T,rows_empty", [(64, (0,)), (256, (0, 1, 2, 3))])
def test_merged_empty_half_row_outputs_zero(T, rows_empty):
    """Twin of ``test_block_q_merge_empty_row_outputs_zero``: layout rows
    with no live block, merged with live siblings (at T=256 the whole first
    64-row tile, the upper half of a kernel row whose lower half is live),
    give O = 0 and lse = NEG_INF, equal to the unmerged path and to JAX."""
    blk, H = 16, 2
    n = T // blk
    layout = np.zeros((1, n, n), np.int32)
    for i in range(n):
        if i not in rows_empty:
            layout[0, i, i] = 1
    q, k, v = _qkv(5, T=T, H=H)
    merged = fa.layout_luts(layout, T, H, True).merged
    o, lse = fa.flash_fwd_merged(*_t(q, k, v), merged)
    dead = slice(0, blk * len(rows_empty))
    assert float(o[:, dead].abs().max()) == 0.0
    assert (lse[:, :, dead] == fa.NEG_INF).all()
    ref = fa.sparse_flash_attention(*_t(q, k, v), layout, causal=True)
    np.testing.assert_allclose(o.numpy(), ref.numpy(), rtol=0, atol=FWD_TOL)
    jo, jlse = _jax_merged_fwd(q, k, v, layout, True)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)


# ------------------------------------------------------ gradients vs JAX
@pytest.mark.parametrize("merge", [1, 2])
@pytest.mark.parametrize("block,window,globals_", [(16, 5, [0, 3]), (64, 3, [0])])
def test_banded_and_merged_gradients_match_jax_grad(block, window, globals_, merge):
    """Gradients through ``sparse_flash_attention`` on a causal band layout
    (the banded route, or with ``block_q_merge=2`` the merged one; both
    backwards the LUT kernels) against ``jax.grad`` of JAX's."""
    B, T, H = 1, 256, 2
    q, k, v, w = _qkv(60 + block + merge, B=B, T=T, H=H, n=4)
    layout = _longformer(block, T, window, globals_)

    def jloss(q, k, v):
        return jnp.sum(jfa.sparse_flash_attention(q, k, v, jnp.asarray(layout), causal=True,
                                                  block_q_merge=merge) * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = fa.sparse_flash_attention(*leaves, layout, causal=True, block_q_merge=merge)
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_sparse_self_attention_unidirectional_matches_jax():
    """``SparseSelfAttention`` with a unidirectional BSLongformer config (the
    banded route) against JAX's module, forward and gradients."""
    from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
        SparseSelfAttention as JSparseSelfAttention)
    B, T, H = 2, 256, 2
    q, k, v, w = _qkv(90, B=B, T=T, H=H, n=4)
    kw = dict(num_heads=H, block=32, num_sliding_window_blocks=3, global_block_indices=[0],
              attention="unidirectional")
    jattn = JSparseSelfAttention(jsc.BSLongformerSparsityConfig(**kw))
    tattn = SparseSelfAttention(tsc.BSLongformerSparsityConfig(**kw))
    assert fa.banded_structure(tattn.get_layout(T), True) is not None

    def jloss(q, k, v):
        return jnp.sum(jattn(q, k, v) * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = tattn(*leaves)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jattn(*(jnp.asarray(x) for x in (q, k, v)))),
                               rtol=0, atol=FWD_TOL)
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


# ------------------------------------------------ flash_attention_with_lse
@pytest.mark.parametrize("T", [64, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_lse_matches_jax(T, causal):
    """Out, lse and the gradients under a loss on both outputs against JAX
    ``flash_attention_with_lse`` (interpret mode, blocks of 32)."""
    q, k, v, w = _qkv(200 + T, B=2, T=T, H=2, d=16, n=4)
    u = np.random.default_rng(300 + T).standard_normal((2, 2, T)).astype(np.float32)

    def jfun(q, k, v):
        return jfa.flash_attention_with_lse(q, k, v, causal=causal, block_q=32, block_k=32)

    def jloss(q, k, v):
        o, lse = jfun(q, k, v)
        return jnp.sum(o * jnp.asarray(w)) + jnp.sum(lse * jnp.asarray(u))

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo, jlse = jfun(jq, jk, jv)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    o, lse = fa.flash_attention_with_lse(*leaves, causal=causal)
    assert lse.shape == (2, 2, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse), rtol=0, atol=FWD_TOL)
    ((o * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(u)).sum()).backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_flash_attention_with_lse_lse_only_and_out_only():
    """A loss on one output alone: the other's cotangent counts as zeros
    (lse alone: the gradient of a logsumexp), against JAX."""
    q, k, v = _qkv(7, B=1, T=64, H=2, d=16)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for pick in (0, 1):
        jgrads = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention_with_lse(
            q, k, v, block_q=32, block_k=32)[pick] ** 2), argnums=(0, 1, 2))(jq, jk, jv)
        leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
        (fa.flash_attention_with_lse(*leaves)[pick] ** 2).sum().backward()
        for name, leaf, jg in zip("qkv", leaves, jgrads):
            np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                       atol=GRAD_TOL, err_msg=f"d{name} output {pick}")


# --------------------------------------------------------------- routes
def _routes(monkeypatch, layout, T=256, H=2, causal=True, merge=1, bias=False,
            dtype=torch.bfloat16, d=64):
    """The kernels ``sparse_flash_attention`` launches, forward then
    backward, on meta tensors (standing for CUDA ones) with ``_run``
    recording names instead of launching."""
    names = []
    monkeypatch.setattr(fa, "_run", lambda name, *a, device: names.append(name))
    q, k, v = (torch.empty((1, T, H, d), dtype=dtype, device="meta",
                           requires_grad=True) for _ in range(3))
    kb = torch.zeros((1, T), device="meta") if bias else None
    out = fa.sparse_flash_attention(q, k, v, layout, causal=causal, block_q_merge=merge,
                                    key_padding_bias=kb)
    fwd = list(names)
    out.sum().backward()        # a cotangent of stride 0
    return fwd, names[len(fwd):]


# bf16 at head dim 64: dK/dV on flash_bwd_dkdv_lut_sm90 (sparse_dkdv_kernel), dQ on
# flash_bwd_dq_lut_sm90 (sparse_dq_kernel)
LUT_BWD = ["flash_bwd_dkdv_lut_sm90", "flash_bwd_dq_lut_sm90"]


@pytest.mark.parametrize("layout,causal,merge,bias,fwd,bwd", [
    ("band", True, 1, False, ["flash_fwd_banded_sm90"], LUT_BWD),
    ("band", False, 1, False, ["flash_fwd_lut_sm90"], LUT_BWD),
    ("band-per-head", True, 1, False, ["flash_fwd_lut_sm90"], LUT_BWD),
    ("band", True, 2, False, ["flash_fwd_merged_sm90"], LUT_BWD),
    ("band", True, 1, True, ["flash_fwd_lut_sm90"], LUT_BWD),
    ("fixed", True, 1, False, ["flash_fwd_lut_sm90"], LUT_BWD),
    ("fixed", True, 2, False, ["flash_fwd_merged_sm90"], LUT_BWD),
    ("all-ones", True, 1, False, ["flash_fwd_sm90"], ["flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"]),
    ("all-ones", True, 2, False, ["flash_fwd_merged_sm90"], LUT_BWD),
    ("all-ones", True, 1, True, ["flash_fwd_sm90"],
     ["flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"]),
])
def test_routes(monkeypatch, layout, causal, merge, bias, fwd, bwd):
    """Which kernels each layout and argument launches, as JAX routes them:
    merge first, then all-ones, biases, a causal band shared by the heads,
    and the ring for the rest."""
    T, H = 256, 2
    band = _longformer(16, T, 5, [0, 3])
    fixed = tsc.FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                    attention="unidirectional").make_layout(T).astype(np.int32)
    assert fa.banded_structure(band, True) is not None
    assert fa.banded_structure(fixed, True) is None
    layouts = {"band": band, "band-per-head": band.repeat(H, 0), "fixed": fixed,
               "all-ones": np.ones((1, 8, 8), np.int32)}
    assert _routes(monkeypatch, layouts[layout], T, H, causal, merge, bias) == (fwd, bwd)
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.parametrize("dtype,d,banded", [(torch.float32, 64, "flash_fwd_banded"),
                                            (torch.bfloat16, 96, "flash_fwd_banded"),
                                            (torch.bfloat16, 128, "flash_fwd_banded_sm90")])
def test_routes_keep_the_template_dkdv_off_the_sm90_dtypes(monkeypatch, dtype, d, banded):
    """fp32, and bf16 at head dims 96 and 128, keep the template LUT dK/dV
    and dQ under every forward route."""
    band = _longformer(16, 256, 5, [0, 3])
    fwd, bwd = _routes(monkeypatch, band, dtype=dtype, d=d)
    assert (fwd, bwd) == ([banded], ["flash_bwd_dkdv_lut", "flash_bwd_dq_lut"])
    assert _routes(monkeypatch, band, merge=2, dtype=dtype, d=d)[1] == bwd
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 96),
                                     (torch.bfloat16, 128)])
@pytest.mark.parametrize("layout,causal,bias,fwd", [
    ("band", False, False, "flash_fwd_lut_ring"), ("fixed", True, False, "flash_fwd_lut_ring"),
    ("band", True, True, "flash_fwd_lut")])
def test_routes_keep_the_template_lut_forward_off_the_sm90_dtypes(monkeypatch, dtype, d, layout,
                                                                  causal, bias, fwd):
    """fp32, and bf16 at head dims 96 and 128, keep the template LUT
    forwards: the ring without a bias, the biased LUT kernel with one."""
    T, H = 256, 2
    layouts = {"band": _longformer(16, T, 5, [0, 3]),
               "fixed": tsc.FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                                attention="unidirectional").make_layout(T)}
    assert _routes(monkeypatch, layouts[layout].astype(np.int32), T, H, causal, bias=bias,
                   dtype=dtype, d=d) == ([fwd], ["flash_bwd_dkdv_lut", "flash_bwd_dq_lut"])
    assert fa.sparse_fwd_kernel(dtype, d, False, bias) == fwd
    assert fa.launches == {name: 0 for name in fa.KERNELS}


def test_band_and_merged_wrappers_check_their_inputs():
    """Off the CPU the new wrappers launch or raise (meta tensors stand for
    device tensors), and a schedule of another T is refused."""
    layout = _longformer(16, 256, 5, [0, 3])
    band = fa.band_lut(*fa.banded_structure(layout, True), 16, 256)
    merged = fa.layout_luts(layout, 256, 2, True).merged
    q64 = torch.empty((1, 256, 2, 64), dtype=torch.float64, device="meta")   # no fp64 kernel
    q = torch.empty((1, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    for call, match in ((lambda: fa.flash_fwd_banded(q64, q64, q64, band), "dtype"),
                        (lambda: fa.flash_fwd_merged(q64, q64, q64, merged), "dtype"),
                        (lambda: fa.flash_fwd_banded(q, q, q, band), "LUT"),
                        (lambda: fa.flash_fwd_merged(q, q, q, merged), "LUT")):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match="banded forward"):
        fa.BandLut(2, (0,), 16, fa.MAX_BAND_T + 16)
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.cuda
def test_banded_and_merged_kernels_match_plain_versions_on_the_card():
    """The banded and merged kernels against their plain versions on a CUDA
    card (``chip_smoke.py`` phase 13 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, H = 1024, 4
    layout = _longformer(32, T, 5, [0, 3])
    band = fa.band_lut(*fa.banded_structure(layout, True), 32, T)
    merged = fa.layout_luts(layout, T, H, True).merged
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v = (torch.randn((2, T, H, 64), generator=gen, device="cuda").to(dt)
                   for _ in range(3))
        for got, want in ((fa.flash_fwd_banded(q, k, v, band),
                           fa.flash_attention_reference_fwd(q, k, v, lut=band)),
                          (fa.flash_fwd_merged(q, k, v, merged),
                           fa.flash_attention_reference_fwd(q, k, v, lut=merged))):
            for a, b in zip(got, want):
                err = (a.float() - b.float()).abs().max().item()
                assert err <= tol * max(1.0, b.float().abs().max().item())
