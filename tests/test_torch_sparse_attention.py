"""The port's block-sparse and biased attention against the JAX package's,
in fp32 on the CPU (deepspeed_tpu_torch/ops/sparse_attention/ and the LUT
and biased paths of ops/transformer/flash_attention.py vs
deepspeed_tpu/ops/sparse_attention/ and deepspeed_tpu/ops/transformer/
flash_attention.py).

Layouts are pure numpy on both sides and must be equal bit for bit.  On
the CPU the port's wrappers take their plain versions (the CUDA kernels
are held against the same plain versions on the card by ``chip_smoke.py``
and by the ``cuda``-marked test below); the JAX side runs its Pallas
kernels in interpret mode.  Inputs are made with numpy from a seed.

Tolerances: 2e-5 on O and lse (magnitude ~1, the same fp32 formula, sums
in another order, one softmax pass against the interpreted kernel's
online one); 1e-4 on gradients (fp32, larger sums over T).  JAX's biased
Pallas backward is compile-heavy in interpret mode (its own test is
slow-marked, tests/test_sparse_attention.py:210), so biased gradients are
held against ``jax.grad`` of JAX's ``_masked_dense`` oracle."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
    SparseSelfAttention as JSparseSelfAttention)
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention import (
    BertSparseSelfAttention, SparseSelfAttention)

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
fa = importlib.import_module("deepspeed_tpu_torch.ops.transformer.flash_attention")

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, B=2, T=64, H=2, d=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ----------------------------------------------------------------- layouts
LAYOUT_CASES = [
    ("DenseSparsityConfig", dict(block=16)),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(block=16, num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("FixedSparsityConfig", dict(block=32, num_local_blocks=4, num_global_blocks=2,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2,
                                 horizontal_global_attention=True)),
    ("VariableSparsityConfig", dict(block=16, num_random_blocks=2,
                                    local_window_blocks=[2, 4], global_block_indices=[1],
                                    different_layout_per_head=True)),
    ("VariableSparsityConfig", dict(block=16, global_block_indices=[0, 5],
                                    global_block_end_indices=[2, 7],
                                    attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(block=16, num_random_blocks=2,
                                   different_layout_per_head=True)),
    ("BigBirdSparsityConfig", dict(block=64, attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(block=16, num_sliding_window_blocks=5,
                                        global_block_indices=[0, 3])),
    ("BSLongformerSparsityConfig", dict(block=32, global_block_indices=[1],
                                        global_block_end_indices=[3],
                                        different_layout_per_head=True)),
]


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("name,kw", LAYOUT_CASES, ids=lambda x: str(x)[:40])
def test_layouts_equal_jax_bit_for_bit(name, kw, heads):
    for T in (256, 512, 1024):
        want = getattr(jsc, name)(num_heads=heads, **kw).make_layout(T)
        got = getattr(tsc, name)(num_heads=heads, **kw).make_layout(T)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_build_sparsity_config_and_validation_match_jax():
    section = {"mode": "bslongformer", "block": 32, "num_sliding_window_blocks": 5}
    j = jsc.build_sparsity_config(section, num_heads=8)
    t = tsc.build_sparsity_config(section, num_heads=8)
    assert type(t).__name__ == type(j).__name__ and vars(t) == vars(j)
    for bad in ({"mode": "diagonal"}, {"mode": "fixed", "num_local_blocks": 3,
                                       "num_global_blocks": 2}):
        for mod in (jsc, tsc):
            with pytest.raises(ValueError):
                mod.build_sparsity_config(bad, num_heads=4)
    with pytest.raises(ValueError, match="divisible"):
        tsc.FixedSparsityConfig(num_heads=2, block=16).make_layout(40)


# ------------------------------------------------------------- tile LUTs
def _live_elements(lut):
    """(Lh, T, T) bool: the (q, k) pairs the LUT kernels treat as live (the
    visited tiles and their cell masks, before the causal and length
    masks), decoded the way the kernels decode them."""
    Lh, nt, _ = lut.tile_mask.shape
    tile = fa.TILE
    out = np.zeros((Lh, nt * tile, nt * tile), bool)
    pos = np.arange(tile)
    cs = lut.cell_shift
    bit = ((pos[:, None] >> cs) << (6 - cs)) + (pos[None, :] >> cs)
    for h in range(Lh):
        for i in range(nt):
            for s in range(lut.klen[h, i]):
                j, m = lut.kmap[h, i, s], int(lut.kmask[h, i, s])
                out[h, i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = (
                    True if m == -1 else (m >> bit) & 1 == 1)
    return out[:, :lut.T, :lut.T]


LUT_CASES = [
    (16, 256, False), (16, 256, True), (16, 1008, False), (32, 320, False),
    (32, 320, True), (64, 512, False), (64, 512, True), (128, 1024, False),
]


@pytest.mark.parametrize("block,T,causal", LUT_CASES)
def test_tile_luts_reproduce_the_layout(block, T, causal):
    """The tiles the LUT kernels visit, with their cell masks, hold exactly
    the layout's live (q, k) pairs (the causal and length masks are the
    kernel's own)."""
    cfg = tsc.FixedSparsityConfig(num_heads=4, block=block, num_local_blocks=4,
                                  num_global_blocks=1, different_layout_per_head=True,
                                  num_different_global_patterns=4)
    layout = cfg.make_layout(T).astype(np.int32)
    lut = fa.layout_luts(layout, T, 4, causal)
    want = np.kron(layout, np.ones((1, block, block), np.int32)) > 0
    got = _live_elements(lut)
    if causal:
        tril = np.tril(np.ones((T, T), bool))
        got, want = got & tril, want & tril
        assert (lut.kmap <= np.arange(lut.kmap.shape[1])[None, :, None]).all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lut.element_mask("cpu").numpy(), want)
    assert lut.klen.sum() == lut.qlen.sum() == (lut.tile_mask != 0).sum()
    for h in range(4):      # the transpose visits the same tiles with the same masks
        fwd = {(i, int(lut.kmap[h, i, s]), int(lut.kmask[h, i, s]))
               for i in range(lut.klen.shape[1]) for s in range(lut.klen[h, i])}
        bwd = {(int(lut.qmap[h, j, s]), j, int(lut.qmask[h, j, s]))
               for j in range(lut.qlen.shape[1]) for s in range(lut.qlen[h, j])}
        assert fwd == bwd
    assert lut is fa.layout_luts(layout, T, 4, causal)         # cached by content


@pytest.mark.parametrize("causal", [False, True])
def test_block64_luts_equal_jax_sparse_luts(causal):
    cfg = jsc.BSLongformerSparsityConfig(num_heads=1, block=64, num_sliding_window_blocks=3,
                                         global_block_indices=[2])
    T, H = 1024, 2
    layout = cfg.make_layout(T).astype(np.int32)
    jk, jl, jq, jql = map(np.asarray, jfa._layout_luts(layout, T, H, causal, 64, 64))
    lut = fa.layout_luts(layout, T, H, causal)
    assert lut.heads == 1
    for h in range(H):
        np.testing.assert_array_equal(lut.klen[0], jl[h])
        np.testing.assert_array_equal(lut.qlen[0], jql[h])
        for i in range(jl.shape[1]):
            np.testing.assert_array_equal(lut.kmap[0, i, :jl[h, i]], jk[h, i, :jl[h, i]])
            np.testing.assert_array_equal(lut.qmap[0, i, :jql[h, i]], jq[h, i, :jql[h, i]])
    assert (lut.kmask[0][np.arange(lut.kmap.shape[2]) < lut.klen[0][:, None]] == -1).all()


def test_tutorial_block16_layout_has_every_tile_live():
    """The bert-pretraining tutorial's layout (fixed, block 16, local 4,
    global 1, per head): each 64-key tile column holds a global block, so
    the tile density is 1.0 while the element density is ~0.27."""
    cfg = tsc.FixedSparsityConfig(num_heads=16, block=16, num_local_blocks=4,
                                  num_global_blocks=1, different_layout_per_head=True)
    lut = fa.layout_luts(cfg.make_layout(2048), 2048, 16, False)
    assert lut.tile_density == 1.0
    assert 0.25 < lut.element_density < 0.29


@pytest.mark.parametrize("block", [8, 48])
def test_unsupported_block_size_raises(block):
    layout = np.ones((1, 192 // block, 192 // block), np.int32)
    with pytest.raises(ValueError, match="not supported"):
        fa.layout_luts(layout, 192, 2, False)
    q = torch.zeros((1, 192, 2, 64))
    with pytest.raises(ValueError, match="not supported"):
        fa.sparse_flash_attention(q, q, q, layout)


# ------------------------------------------------------- forward vs JAX
def _layout(block, T, H, per_head=True):
    cfg = jsc.FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=2,
                                  num_global_blocks=1, different_layout_per_head=per_head,
                                  num_different_global_patterns=2 if per_head else 1)
    return cfg.make_layout(T).astype(np.int32)


def _biases(seed, B, T, kind):
    rng = np.random.default_rng(seed)
    kb = ab = None
    if kind in ("kb", "both"):
        kb = np.where(rng.random((B, T)) < 0.8, 0.0, -1e4).astype(np.float32)
        kb[:, 0] = 0.0
    if kind in ("ab", "both"):
        ab = np.where(rng.random((T, T)) < 0.9, rng.standard_normal((T, T)),
                      -1e30).astype(np.float32)
    return kb, ab


def _jax_fwd(q, k, v, layout, causal, kb, ab):
    """JAX ``_fwd`` over its LUTs (interpret mode) -> (o (B,T,H,d), lse (B,H,T))."""
    B, T, H, d = q.shape
    bq = T // layout.shape[1]
    luts = jfa._layout_luts(layout, T, H, causal, bq, bq)
    bhtd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, d)
    o, lse = jfa._fwd(bhtd(q), bhtd(k), bhtd(v), 1.0 / np.sqrt(d), causal, bq, bq,
                      n_heads=H, kmap=luts[0], klen=luts[1],
                      k_bias=None if kb is None else jnp.asarray(kb),
                      attn_bias=None if ab is None else jnp.asarray(ab))
    return (np.asarray(o).reshape(B, H, T, d).transpose(0, 2, 1, 3),
            np.asarray(lse).reshape(B, H, T))


@pytest.mark.parametrize("bias", ["none", "kb", "ab", "both"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_sparse_forward_and_lse_match_jax(block, causal, bias):
    B, T, H = 2, 128, 2
    q, k, v = _qkv(block + 3 * causal, B=B, T=T, H=H)
    layout = _layout(block, T, H, per_head=block != 64)
    kb, ab = _biases(block, B, T, bias)
    jo, jlse = _jax_fwd(q, k, v, layout, causal, kb, ab)
    lut = fa.layout_luts(layout, T, H, causal)
    tkb = None if kb is None else torch.from_numpy(kb)
    tab = None if ab is None else torch.from_numpy(ab)
    if bias == "none":
        o, lse = fa.flash_fwd_lut_ring(*_t(q, k, v), lut)
    else:
        o, lse = fa.flash_fwd_lut(*_t(q, k, v), lut, tkb, tab)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)
    out = fa.sparse_flash_attention(*_t(q, k, v), layout, causal=causal,
                                    key_padding_bias=tkb, attn_bias=tab)
    np.testing.assert_array_equal(out.detach().numpy(), o.numpy())
    if bias == "none":
        ref = jfa.sparse_flash_attention(*_j(q, k, v), jnp.asarray(layout), causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)
    assert fa.launches == {name: 0 for name in fa.KERNELS}   # no kernel on the CPU


def test_sparse_reference_and_ragged_length_match_jax():
    """T = 80 (not a multiple of the 64-row tiles) at block 16; the port's
    ``sparse_attention_reference`` against JAX's."""
    q, k, v = _qkv(5, T=80)
    layout = _layout(16, 80, 2)
    for causal in (False, True):
        want = np.asarray(jfa.sparse_attention_reference(*_j(q, k, v), jnp.asarray(layout),
                                                         causal=causal))
        ref = fa.sparse_attention_reference(*_t(q, k, v), layout, causal=causal)
        np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=FWD_TOL)
        out = fa.sparse_flash_attention(*_t(q, k, v), layout, causal=causal)
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=FWD_TOL)


def test_all_ones_layout_takes_the_dense_path(monkeypatch):
    q, k, v = _t(*_qkv(6))
    calls = []
    monkeypatch.setattr(fa, "flash_fwd", lambda *a, **kw: calls.append("dense") or
                        fa.flash_attention_reference_fwd(*a, **kw))
    out = fa.sparse_flash_attention(q, k, v, np.ones((1, 4, 4), np.int32), causal=True)
    assert calls == ["dense"]
    np.testing.assert_allclose(out.numpy(), np.asarray(jfa.attention_reference(
        *_j(*(x.numpy() for x in (q, k, v))), causal=True)), rtol=0, atol=FWD_TOL)


# ------------------------------------------------------ gradients vs JAX
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [16, 32, 64])
def test_unbiased_sparse_gradients_match_jax_grad(block, causal):
    B, T, H = 1, 128, 2
    q, k, v, w = _qkv(40 + block, B=B, T=T, H=H, n=4)
    layout = _layout(block, T, H)

    def jloss(q, k, v):
        return jnp.sum(jfa.sparse_flash_attention(q, k, v, jnp.asarray(layout),
                                                  causal=causal) * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    (fa.sparse_flash_attention(*leaves, layout, causal=causal) * torch.from_numpy(w)).sum() \
        .backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("kp_mode,am_mode", [("add", "add"), ("mul", "mul"), ("add", "mul")])
def test_biased_sparse_gradients_match_jax_oracle(kp_mode, am_mode):
    """Gradients through the biased LUT path (``SparseSelfAttention`` with
    both masks) against ``jax.grad`` of JAX's ``_masked_dense``."""
    B, T, H = 2, 64, 2
    q, k, v, w = _qkv(70, B=B, T=T, H=H, n=4)
    rng = np.random.default_rng(71)
    if kp_mode == "mul":
        kp = np.ones((B, T), np.int32)
        kp[0, 48:] = 0
        kp[1, 20:30] = 0
    else:
        kp = np.where(rng.random((B, T)) < 0.8, 0.0, -1e4).astype(np.float32)
    am = ((rng.random((T, T)) > 0.2) | np.eye(T, dtype=bool)).astype(np.int32)
    if am_mode == "add":
        am = np.where(am > 0, 0.0, -1e4).astype(np.float32)
    kw = dict(key_padding_mask_mode=kp_mode, attn_mask_mode=am_mode)
    jattn = JSparseSelfAttention(jsc.FixedSparsityConfig(num_heads=H, block=16,
                                                         num_local_blocks=2), **kw)
    tattn = SparseSelfAttention(tsc.FixedSparsityConfig(num_heads=H, block=16,
                                                        num_local_blocks=2), **kw)
    layout = jattn.get_layout(T)

    def jloss(q, k, v):
        return jnp.sum(jattn._masked_dense(q, k, v, layout, False, None, jnp.asarray(kp),
                                           jnp.asarray(am)) * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = tattn(*leaves, causal=False, key_padding_mask=torch.from_numpy(kp),
                attn_mask=torch.from_numpy(am))
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


# ---------------------------------------------- SparseSelfAttention modes
@pytest.mark.parametrize("mode", ["add", "mul"])
def test_sparse_self_attention_modes_match_jax(mode):
    """Both mask modes against JAX's module; in ``mul`` mode batch row 1
    is fully padded: O = 0 there in both packages, and the port's
    gradients on it are 0 (JAX's Pallas backward gives exp(0) = 1 there:
    ROADMAP.md section C)."""
    B, T, H = 2, 128, 4
    q, k, v, w = _qkv(80, B=B, T=T, H=H, n=4)
    kp = np.ones((B, T), np.int32)
    kp[0, 100:] = 0
    if mode == "mul":
        kp[1] = 0
    else:
        kp = np.where(kp > 0, 0.0, -10000.0).astype(np.float32)
    cfg = dict(num_heads=H, block=32, num_local_blocks=2)
    jattn = JSparseSelfAttention(jsc.FixedSparsityConfig(**cfg), key_padding_mask_mode=mode)
    tattn = SparseSelfAttention(tsc.FixedSparsityConfig(**cfg), key_padding_mask_mode=mode)
    want = np.asarray(jattn(*_j(q, k, v), causal=False, key_padding_mask=jnp.asarray(kp)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    got = tattn(*leaves, causal=False, key_padding_mask=torch.from_numpy(kp))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=FWD_TOL)
    assert tattn.get_layout(T) is tattn.get_layout(T)
    assert tattn.density(T) == jattn.density(T)
    (got * torch.from_numpy(w)).sum().backward()
    if mode == "mul":
        assert float(np.abs(want[1]).max()) == 0.0
        for leaf in leaves:
            assert float(leaf.grad[1].abs().max()) == 0.0
            assert float(leaf.grad[0].abs().max()) > 0.0
    with pytest.raises(ValueError, match="max_seq_length"):
        SparseSelfAttention(tsc.FixedSparsityConfig(**cfg), max_seq_length=64)(
            *_t(q, k, v))


def test_bert_sparse_self_attention_matches_jax():
    from deepspeed_tpu.ops.sparse_attention.sparse_self_attention import (
        BertSparseSelfAttention as JBertSparse)
    rng = np.random.default_rng(90)
    B, T, D, H = 2, 64, 64, 2
    hidden = rng.standard_normal((B, T, D)).astype(np.float32)
    params = {f"{n}_{s}": (rng.standard_normal((D, D) if s == "w" else (D,)) * 0.1)
              .astype(np.float32) for n in "qkv" for s in "wb"}
    kp = np.where(np.arange(T)[None] < np.array([[50], [64]]), 0.0, -1e4).astype(np.float32)
    cfg = dict(num_heads=H, block=16, num_local_blocks=2)
    want = JBertSparse(H, D, jsc.FixedSparsityConfig(**cfg))(
        jnp.asarray(hidden), {k: jnp.asarray(p) for k, p in params.items()},
        key_padding_mask=jnp.asarray(kp))
    got = BertSparseSelfAttention(H, D, tsc.FixedSparsityConfig(**cfg))(
        torch.from_numpy(hidden), {k: torch.from_numpy(p) for k, p in params.items()},
        key_padding_mask=torch.from_numpy(kp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FWD_TOL)


# ------------------------------------------------- dense biased flash
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_biases_matches_jax(causal):
    B, T, H = 2, 96, 2
    q, k, v, w = _qkv(95, B=B, T=T, H=H, n=4)
    kb, ab = _biases(96, B, T, "both")
    jout = jfa.flash_attention(*_j(q, k, v), causal=causal, key_padding_bias=jnp.asarray(kb),
                               attn_bias=jnp.asarray(ab), block_q=32, block_k=32)
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, key_padding_bias=torch.from_numpy(kb),
                             attn_bias=torch.from_numpy(ab))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=0, atol=FWD_TOL)
    o, lse = fa.flash_fwd_biased(*_t(q, k, v), torch.from_numpy(kb), torch.from_numpy(ab),
                                 causal)
    np.testing.assert_array_equal(o.numpy(), out.detach().numpy())

    def jloss(q, k, v):      # a dense oracle with the same biases
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1]) + kb[:, None, None] + ab
        if causal:
            s = jnp.where(jnp.tril(jnp.ones((T, T), bool)), s, -jnp.inf)
        return jnp.sum(jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v) * w)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    (out * torch.from_numpy(w)).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("T,merge,bias,match", [(64, 3, False, "row-merge factor"),
                                                  (48, 2, False, "odd"),
                                                  (64, 2, True, "unbiased")])
def test_block_q_merge_invalid_arguments_raise(T, merge, bias, match):
    """JAX's conditions on ``block_q_merge`` (1137-1138, 1143-1144), as
    ``ValueError``: the factor is 1 or 2, the layout rows pair up, and the
    merged rows take no bias."""
    q, k, v = _t(*_qkv(1, T=T))
    kb = torch.zeros((2, T)) if bias else None
    with pytest.raises(ValueError, match=match):
        fa.sparse_flash_attention(q, k, v, _layout(16, T, 2), block_q_merge=merge,
                                  key_padding_bias=kb)


# ------------------------------------------ the device path: launch or raise
@pytest.mark.parametrize("dtype,d,match", [(torch.float64, 64, "dtype"),
                                           (torch.bfloat16, 32, "head dim")])
def test_lut_wrappers_reject_unsupported_configs(dtype, d, match):
    """Off the CPU the wrappers launch or raise; they never take the plain
    version.  (Meta tensors stand for device tensors here.)"""
    lut = fa.layout_luts(_layout(16, 128, 2), 128, 2, False)
    q = torch.empty((2, 128, 2, d), dtype=dtype, device="meta")
    lse = torch.empty((2, 2, 128), device="meta")
    for call in (lambda: fa.flash_fwd_lut(q, q, q, lut),
                 lambda: fa.flash_fwd_lut_ring(q, q, q, lut),
                 lambda: fa.flash_fwd_biased(q, q, q),
                 lambda: fa.flash_bwd_dkdv_lut(q, q, q, q, lse, lse, lut),
                 lambda: fa.flash_bwd_dq_biased(q, q, q, q, lse, lse)):
        with pytest.raises(ValueError, match=match):
            call()


def test_lut_wrappers_check_biases_and_lut_shape():
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    lut = fa.layout_luts(_layout(16, 128, 2), 128, 2, False)
    with pytest.raises(ValueError, match="key_padding_bias"):
        fa.flash_fwd_lut(q, q, q, lut, torch.empty((2, 128), device="meta",
                                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="LUT"):
        fa.flash_fwd_lut_ring(q, q, q, fa.layout_luts(_layout(16, 64, 2), 64, 2, False))
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.cuda
def test_sparse_kernels_match_plain_versions_on_the_card():
    """The LUT and biased kernels against their plain versions on a CUDA
    card (``chip_smoke.py`` phase 7 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, H = 320, 4
    lut = fa.layout_luts(_layout(16, T, H), T, H, False)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v, do = (torch.randn((2, T, H, 64), generator=gen, device="cuda").to(dt)
                       for _ in range(4))
        kb = torch.where(torch.rand((2, T), generator=gen, device="cuda") < 0.8, 0.0, -1e4)
        o, lse = fa.flash_fwd_lut(q, k, v, lut, kb)
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
        delta = fa.attention_delta(o, do)
        got = fa.flash_bwd_dkdv_lut(q, k, v, do, lse, delta, lut, kb) + (
            fa.flash_bwd_dq_lut(q, k, v, do, lse, delta, lut, kb),)
        want = fa.flash_attention_reference_bwd_dkdv(
            q, k, v, do, lse, delta, lut=lut, key_padding_bias=kb) + (
            fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut,
                                                key_padding_bias=kb),)
        for a, b in zip((o, lse) + got, (ro, rlse) + want):
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * max(1.0, b.float().abs().max().item())
