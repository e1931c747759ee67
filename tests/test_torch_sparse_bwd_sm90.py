"""The block-sparse dK/dV backward for Hopper, ``flash_bwd_dkdv_lut_sm90``
(deepspeed_tpu_torch/csrc/flash_attention_sparse_bwd_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 7, 8, 9 and 14,
and the ``cuda``-marked test below).  Here:

- its schedule, ``GroupLut`` (both sides: ``"k"`` for dK/dV, ``"q"`` for
  dQ), against the layout: every live (q, k) pair in exactly one visit,
  every output row in exactly one output tile, no unflagged visit holding a
  dead pair or a causal diagonal unit; at blocks of 64 and above the visits
  are ``TileLut``'s transposed rows less the tiles wholly above the
  diagonal; the tutorial layout at T=2048 gives 288 visits and 40 output
  tiles per head; ``flash_bwd_dkdv_lut_sm90_schedule`` deals every work item
  once over the kernel's pipes, longest first;
- the kernel's arithmetic: a torch emulation over its schedule (slots
  gathered, rows from T on read as zeros, fp32 products per visit, P and dS
  rounded where the kernel rounds them, the mask rule, lse NEG_INF entering
  as +inf) against the plain ``flash_attention_reference_bwd_dkdv`` and
  against JAX's LUT backward (``jax.grad`` through the sparse path, Pallas
  in interpret mode);
- the route, on meta tensors standing for CUDA ones, with ``_run``
  replaced; with no nvcc the call raises and counts no launch.

Tolerances: 2e-5 against the plain version in fp32 (the same formula with
exp2 for exp, summed per visit in another order); 1e-4 against ``jax.grad``
(fp32, as ``test_torch_sparse_attention.py``); with P and dS rounded to
bf16 on both sides, 2^-5 of the rms plus 2^-7 of each element (the limits
``chip_smoke.py`` holds the kernels to: rounding at other points, fp32 sums
in another order)."""

import importlib
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention import build_sparsity_config
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

FP32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = (2 ** -5, 2 ** -7)
TUTORIAL = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
            "num_local_blocks": 4, "num_global_blocks": 1, "attention": "bidirectional"}


def _empty_rows(T):
    """Block 16, the diagonal blocks only, the first 64 queries and keys in
    no live block (``chip_smoke.py`` phase 7's layout)."""
    layout = np.zeros((1, T // 16, T // 16), np.int32)
    live = np.arange(4, T // 16)
    layout[0, live, live] = 1
    return layout


def _layout(name, T, H):
    if name == "tutorial16":
        return build_sparsity_config(TUTORIAL, H).make_layout(T)
    if name == "fixed32":
        return tsc.FixedSparsityConfig(num_heads=H, block=32, num_local_blocks=4,
                                       num_global_blocks=1).make_layout(T)
    if name == "bigbird64":
        return tsc.BigBirdSparsityConfig(num_heads=H, block=64, num_random_blocks=1,
                                         num_sliding_window_blocks=3).make_layout(T)
    if name == "longformer128":
        return tsc.BSLongformerSparsityConfig(num_heads=H, block=128,
                                              num_sliding_window_blocks=3,
                                              global_block_indices=[0]).make_layout(T)
    if name == "longformer16":
        return tsc.BSLongformerSparsityConfig(num_heads=H, block=16,
                                              num_sliding_window_blocks=5,
                                              global_block_indices=[0, 3],
                                              attention="unidirectional").make_layout(T)
    assert name == "empty-rows"
    return _empty_rows(T)


# (layout, T, causal): the tutorial per-head layout, Fixed 32, BigBird 64,
# BSLongformer 128 causal, the empty-rows layout, a ragged T=1008 at block 16
SCHEDULE_CASES = [("tutorial16", 256, False), ("tutorial16", 256, True),
                  ("fixed32", 512, False), ("bigbird64", 512, False),
                  ("longformer128", 1024, True), ("empty-rows", 256, False),
                  ("tutorial16", 1008, False), ("longformer16", 1008, True)]


def _live(lut):
    """(Lh, T, T) bool [q, k]: the layout's live pairs (``lut``'s element mask)."""
    return lut.element_mask("cpu").numpy()


def _rows(units, U):
    """Row indices of a slot list (empty slots dropped)."""
    return np.concatenate([np.arange(u * U, u * U + U) for u in units if u >= 0] or
                          [np.zeros(0, int)])


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("side", ["k", "q"])
@pytest.mark.parametrize("name,T,causal", SCHEDULE_CASES)
def test_group_schedule_covers_the_layout(name, T, causal, side):
    """Every live pair in exactly one visit, every output row in exactly
    one output tile, no unflagged visit with a dead pair, an empty slot or a
    causal diagonal unit; the element mask the kernel applies (slot filled,
    causal order) leaves exactly the live pairs of a flagged visit."""
    H = 2
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    g = lut.groups(side)
    U, R = g.unit, g.slots
    assert U == min(lut.block, 64) and R * U == 64
    live = _live(lut)
    if side == "k":
        live = live.transpose(0, 2, 1)                 # [out row, visited row]
    for l in range(lut.heads):
        seen = np.zeros((T, T), np.int32)
        owned = np.zeros(T, np.int32)
        for t in range(g.tile_off[l], g.tile_off[l + 1]):
            orows = _rows(g.out_slots[t], U)
            owned[orows] += 1
            for j in range(g.vbeg[t], g.vbeg[t + 1]):
                slots = g.visit_slots[j]
                vrows = _rows(slots, U)
                pairs = live[l][np.ix_(orows, vrows)]
                diagonal = causal and bool(set(slots.tolist()) & set(g.out_slots[t].tolist())
                                           - {-1})
                if not g.masked[j]:
                    assert pairs.all() and -1 not in slots and not diagonal
                else:
                    assert -1 in slots or diagonal
                # the kernel's rule over the filled slots: q >= k when causal
                kpos, qpos = (orows, vrows) if side == "k" else (vrows, orows)
                rule = (np.ones(pairs.shape, bool) if not causal else
                        (qpos[None, :] >= kpos[:, None]) if side == "k" else
                        (qpos[:, None] >= kpos[None, :]))
                assert np.array_equal(rule, pairs)
                np.add.at(seen, np.ix_(orows, vrows), pairs.astype(np.int32))
        assert (owned == 1).all()
        assert np.array_equal(seen, live[l].astype(np.int32))


@pytest.mark.parametrize("name,T,causal", [("bigbird64", 512, False),
                                           ("longformer128", 1024, True),
                                           ("longformer128", 1024, False)])
def test_group_schedule_at_block_64_and_up_is_the_tile_lut(name, T, causal):
    """At blocks of 64 and above a unit is a 64-row tile: each output tile's
    visits are ``TileLut``'s transposed row (``qmap``/``qlen``; ``kmap``/
    ``klen`` for dQ) less the tiles wholly above the causal diagonal, which
    the template kernel visits and masks whole."""
    H = 2
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    for side, tmap, tlen in (("k", lut.qmap, lut.qlen), ("q", lut.kmap, lut.klen)):
        g = lut.groups(side)
        assert g.slots == 1
        for l in range(lut.heads):
            tiles = range(g.tile_off[l], g.tile_off[l + 1])
            assert sorted(int(g.out_slots[t, 0]) for t in tiles) == list(range(T // 64))
            for t in tiles:
                o = int(g.out_slots[t, 0])
                want = [int(x) for x in tmap[l, o, :tlen[l, o]]
                        if not causal or (x >= o if side == "k" else x <= o)]
                got = [int(g.visit_slots[j, 0]) for j in range(g.vbeg[t], g.vbeg[t + 1])]
                assert got == want
                assert all(bool(g.masked[j]) == (causal and g.visit_slots[j, 0] == o)
                           for j in range(g.vbeg[t], g.vbeg[t + 1]))


def test_tutorial_layout_at_bert_shape_takes_288_visits_per_head():
    """The tutorial layout (fixed, block 16, local 4, global 1, per head) at
    T=2048: 1024 live 64 x 64 tiles per head for the template kernels, 288
    visits on 40 output tiles for dK/dV (32 for dQ), every visit unmasked."""
    H = 16
    lut = fa.layout_luts(_layout("tutorial16", 2048, H), 2048, H, False)
    assert lut.tile_density == 1.0 and (lut.qlen.sum(-1) == 1024).all()
    k, q = lut.groups("k"), lut.groups("q")
    assert (k.visits_per_head == 288).all() and (k.tiles_per_head == 40).all()
    assert (q.visits_per_head == 288).all() and (q.tiles_per_head == 32).all()
    assert not k.masked.any()
    live = lut.element_mask("cpu").sum().item() / H
    assert live / (288 * 64 * 64) > 0.97


@pytest.mark.parametrize("B,H,n_pipes", [(2, 2, 7), (8, 16, 264), (1, 1, 3)])
def test_sm90_schedule_deals_every_item_once_longest_first(B, H, n_pipes):
    """``flash_bwd_dkdv_lut_sm90_schedule``: every output tile of every
    (b, h) exactly once over the pipes, each pipe's items in non-increasing
    visit count, the visits those of ``GroupLut``."""
    T = 512
    lut = fa.layout_luts(_layout("tutorial16", T, H), T, H, False)
    g = lut.groups("k")
    sched = fa.flash_bwd_dkdv_lut_sm90_schedule(lut, B, H, n_pipes)
    assert len(sched) == min(n_pipes, len(g.order(B, H)))
    seen = {}
    for pipe in sched:
        counts = [len(visits) for *_, visits in pipe]
        assert counts == sorted(counts, reverse=True)
        for b, h, out, visits in pipe:
            key = (b, h, out)
            seen[key] = seen.get(key, 0) + 1
    want = {(b, h, tuple(int(u) for u in g.out_slots[t]))
            for b in range(B) for h in range(H)
            for t in range(g.tile_off[h if g.heads > 1 else 0],
                           g.tile_off[(h if g.heads > 1 else 0) + 1])}
    assert set(seen) == want and set(seen.values()) == {1}
    order = g.order(B, H)
    nv = np.diff(g.vbeg)[order[:, 1]]
    assert (np.diff(nv) <= 0).all()                  # longest first


# ------------------------------------------------ the kernel's arithmetic
def emulate_dkdv(q, k, v, do, lse, delta, lut, kbias=None, sm_scale=None, round_to=None):
    """``flash_bwd_dkdv_lut_sm90`` in torch, over its schedule as the kernel
    runs it: per output tile its slots' K and V rows (an empty slot reads
    rows from T on: zeros), per visit the slots' Q, dO, lse and delta (zeros
    for an empty slot), S^T = K Q^T and dP^T = V dO^T in fp32, P = 2^(S
    scale log2e + kbias log2e - l2) with l2 = lse log2e, or +inf where lse
    is NEG_INF, masked only in flagged visits (the slot filled and, when
    causal, q >= k), dS = P (dP scale - delta scale), P and dS rounded to
    ``round_to`` before dV += P^T dO and dK += dS^T Q; rows of empty slots
    dropped, rows of tiles with no visit zero."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    g = lut.groups("k")
    U = g.unit
    log2e = 1.0 / math.log(2.0)
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    f = lambda x: torch.cat([x.float(), torch.zeros_like(x[:, :U].float())], 1)  # noqa: E731
    q, k, v, do = f(q), f(k), f(v), f(do)                      # row T.. reads zeros
    lse = torch.cat([lse, torch.zeros_like(lse[..., :U])], -1)
    delta = torch.cat([delta, torch.zeros_like(delta[..., :U])], -1)
    kb = None if kbias is None else torch.cat([kbias.float(), torch.zeros_like(
        kbias[:, :U])], 1)
    dk = torch.zeros((B, T + U, H, d))
    dv = torch.zeros((B, T + U, H, d))
    rows = lambda slots: torch.cat([torch.arange(U) + (u * U if u >= 0 else T)   # noqa: E731
                                    for u in slots.tolist()])
    for b in range(B):
        for h in range(H):
            l = h if g.heads > 1 else 0
            for t in range(g.tile_off[l], g.tile_off[l + 1]):
                kr = rows(g.out_slots[t])
                acc_k, acc_v = torch.zeros((64, d)), torch.zeros((64, d))
                kb2 = torch.zeros(64) if kb is None else kb[b, kr] * log2e
                for j in range(g.vbeg[t], g.vbeg[t + 1]):
                    slots = g.visit_slots[j]
                    qr = rows(slots)
                    st = k[b, kr, h] @ q[b, qr, h].T                  # (key, query)
                    dpt = v[b, kr, h] @ do[b, qr, h].T
                    ls = lse[b, h, qr]
                    l2 = torch.where(ls > fa.NEG_INF * 0.5, ls * log2e,
                                     torch.full_like(ls, math.inf))
                    p = torch.exp2(st * (scale * log2e) + (kb2[:, None] - l2[None, :]))
                    if g.masked[j]:
                        filled = torch.tensor([u >= 0 for u in slots.tolist()]
                                              ).repeat_interleave(U)
                        valid = filled[None, :].expand(64, 64)
                        if lut.causal:
                            valid = valid & (qr[None, :] >= kr[:, None])
                        p = torch.where(valid, p, torch.zeros_like(p))
                    ds = p * (dpt * scale - delta[b, h, qr][None, :] * scale)
                    acc_v += rnd(p) @ do[b, qr, h]
                    acc_k += rnd(ds) @ q[b, qr, h]
                keep = torch.tensor([u >= 0 for u in g.out_slots[t].tolist()]
                                    ).repeat_interleave(U)
                dk[b, kr[keep], h] = acc_k[keep]
                dv[b, kr[keep], h] = acc_v[keep]
    return dk[:, :T], dv[:, :T]


def _inputs(seed, B, T, H, d, lut, bias, dtype=torch.float32):
    """q, k, v, dO from numpy, the plain forward's (O, lse), delta, and the
    key bias of ``bias``: None, ``add`` (-10000 past each row's length) or
    ``mul`` (0 / NEG_INF, batch row 1 fully padded)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    kb = None
    if bias is not None:
        keep = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, B)[:, None]
        if bias == "mul":
            keep[1 % B] = False
        kb = torch.from_numpy(np.where(keep, 0.0, -10000.0 if bias == "add" else fa.NEG_INF)
                              .astype(np.float32))
    o, lse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    return q, k, v, do, lse, fa.attention_delta(o, do), kb


# every layout with each key bias; the empty-rows layout (each row sees its
# own block alone) not with ``add``: a row whose every live key carries
# -10000 has scores of magnitude 1e4, resolved to ~1e-3 in fp32 by the plain
# version and the kernels alike (chip_smoke.py phase 7 leaves it out too)
EMULATION_CASES = [(name, T, causal, bias)
                   for name, T, causal in (("tutorial16", 256, False), ("tutorial16", 1008, True),
                                           ("fixed32", 256, True), ("bigbird64", 256, False),
                                           ("longformer128", 512, True),
                                           ("empty-rows", 256, False))
                   for bias in (None, "add", "mul")
                   if not (name == "empty-rows" and bias == "add")]


@pytest.mark.parametrize("name,T,causal,bias", EMULATION_CASES)
def test_emulation_reproduces_the_plain_version(name, T, causal, bias):
    """fp32: the emulation over the schedule equals the plain version (the
    fully padded ``mul`` row's dK and dV are exactly 0); the empty rows'
    keys get zeros."""
    B, H, d = 2, 2, 16
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, do, lse, delta, kb = _inputs(T + len(name), B, T, H, d, lut, bias)
    dk, dv = emulate_dkdv(q, k, v, do, lse, delta, lut, kb)
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut,
                                                      key_padding_bias=kb)
    # the wrapper on CPU tensors is the plain version
    wdk, wdv = fa.flash_bwd_dkdv_lut(q, k, v, do, lse, delta, lut, kb)
    assert torch.equal(wdk, rdk) and torch.equal(wdv, rdv)
    np.testing.assert_allclose(dk.numpy(), rdk.numpy(), rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(dv.numpy(), rdv.numpy(), rtol=0, atol=FP32_TOL)
    if bias == "mul":
        assert not dk[1].any() and not dv[1].any()
    if name == "empty-rows":
        assert not dk[:, :64].any() and not dv[:, :64].any()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("name,T,causal", [("tutorial16", 256, False),
                                           ("longformer16", 1008, True)])
def test_emulation_with_bf16_rounding_matches_the_plain_version(name, T, causal):
    """bf16 inputs, P and dS rounded to bf16 as the kernel rounds them,
    within the limits the kernel is held to on the card."""
    B, H, d = 1, 2, 64
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, do, lse, delta, kb = _inputs(3, B, T, H, d, lut, "add", torch.bfloat16)
    got = emulate_dkdv(q, k, v, do, lse, delta, lut, kb, round_to=torch.bfloat16)
    want = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut,
                                                 key_padding_bias=kb)
    for a, r in zip(got, want):
        r = r.float()
        limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
        assert ((a.to(torch.bfloat16).float() - r).abs() <= limit).all()


@pytest.mark.parametrize("block,causal", [(16, False), (32, True)])
def test_emulation_matches_jax_lut_backward(block, causal):
    """dK and dV of the emulation, fed the port's forward, against
    ``jax.grad`` through JAX's ``sparse_flash_attention`` (its LUT backward,
    Pallas in interpret mode), fp32."""
    B, T, H, d = 1, 128, 2, 16
    layout = tsc.FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=2,
                                     num_global_blocks=1, different_layout_per_head=True,
                                     num_different_global_patterns=2).make_layout(T)
    rng = np.random.default_rng(block)
    q, k, v, w = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jfa.sparse_flash_attention(q, k, v, jnp.asarray(layout),
                                                  causal=causal) * jnp.asarray(w))

    _, jdk, jdv = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    lut = fa.layout_luts(layout, T, H, causal)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, lut=lut)
    dk, dv = emulate_dkdv(tq, tk, tv, tw, lse, fa.attention_delta(o, tw), lut)
    np.testing.assert_allclose(dk.numpy(), np.asarray(jdk), rtol=0, atol=GRAD_TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=0, atol=GRAD_TOL)


# --------------------------------------------------------------- routes
def _recorded(monkeypatch):
    """Replace ``_run``: record (name, a group kernel's schedule fields)."""
    calls = []

    def run(name, *args, device):
        sched = None
        if name in fa.GROUP_KERNELS:
            s = fa._GroupSchedule.from_address(args[-1])
            sched = (s.n_work, s.unit)
        calls.append((name, sched))
    monkeypatch.setattr(fa, "_run", run)
    return calls


@pytest.mark.parametrize("dtype,d,kbias,abias,want", [
    (torch.bfloat16, 64, False, False, "flash_bwd_dkdv_lut_sm90"),
    (torch.bfloat16, 64, True, False, "flash_bwd_dkdv_lut_sm90"),
    (torch.bfloat16, 128, True, False, "flash_bwd_dkdv_lut"),
    (torch.float32, 64, True, False, "flash_bwd_dkdv_lut"),
    (torch.bfloat16, 96, False, False, "flash_bwd_dkdv_lut"),
    (torch.bfloat16, 64, True, True, "flash_bwd_dkdv_lut"),
])
def test_dkdv_routes(monkeypatch, dtype, d, kbias, abias, want):
    """bf16 at head dim 64 with no (T, T) score bias takes the sm90 kernel
    over ``lut.groups("k")`` (its work items and slot rows in the schedule
    it is handed); fp32, head dims 96 and 128 and a score bias the template
    kernel; ``flash_bwd_dkdv_lut_tiled`` always the template."""
    calls = _recorded(monkeypatch)
    B, T, H = 2, 256, 2
    lut = fa.layout_luts(_layout("tutorial16", T, H), T, H, False)
    q = torch.empty((B, T, H, d), dtype=dtype, device="meta")
    lse = torch.empty((B, H, T), device="meta")
    kb = torch.empty((B, T), device="meta") if kbias else None
    ab = torch.empty((T, T), device="meta") if abias else None
    assert fa.sparse_dkdv_kernel(dtype, d, abias) == want
    dk, dv = fa.flash_bwd_dkdv_lut(q, q, q, q, lse, lse, lut, kb, ab)
    assert dk.shape == dv.shape == q.shape and dk.dtype == dtype
    fa.flash_bwd_dkdv_lut_tiled(q, q, q, q, lse, lse, lut, kb, ab)
    sched = (B * H * int(lut.groups("k").tiles_per_head.sum() // lut.heads), 16)
    assert calls == [(want, sched if want.endswith("sm90") else None),
                     ("flash_bwd_dkdv_lut", None)]
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("name,causal,merge,fwd", [
    ("tutorial16", False, 1, "flash_fwd_lut_sm90"),
    ("longformer16", True, 1, "flash_fwd_banded_sm90"),
    ("longformer16", True, 2, "flash_fwd_merged_sm90")])
def test_sparse_path_backward_takes_the_sm90_kernel(monkeypatch, name, causal, merge, fwd):
    """``sparse_flash_attention(...).backward()`` in bf16 at head dim 64
    launches the forward of its route, then the sm90 dK/dV and the sm90 dQ,
    each handed its own side's schedule (block 16: 16-row slots)."""
    calls = _recorded(monkeypatch)
    T, H = 256, 2
    layout = _layout(name, T, H)
    q, k, v = (torch.empty((1, T, H, 64), dtype=torch.bfloat16, device="meta",
                           requires_grad=True) for _ in range(3))
    fa.sparse_flash_attention(q, k, v, layout, causal=causal, block_q_merge=merge
                              ).sum().backward()
    lut = fa.layout_luts(layout, T, H, causal)
    n = {side: H * int(lut.groups(side).tiles_per_head.sum() // lut.heads) for side in "kq"}
    assert calls == [(fwd, (n["q"], 16) if fwd in fa.GROUP_KERNELS else None),
                     ("flash_bwd_dkdv_lut_sm90", (n["k"], 16)),
                     ("flash_bwd_dq_lut_sm90", (n["q"], 16))]


@pytest.mark.parametrize("dtype,d,match", [(torch.float32, 64, "dtype"),
                                           (torch.bfloat16, 96, "head dim"),
                                           (torch.bfloat16, 128, "head dim")])
def test_sm90_wrapper_refuses_what_it_was_not_built_for(dtype, d, match):
    lut = fa.layout_luts(_layout("tutorial16", 128, 2), 128, 2, False)
    q = torch.empty((2, 128, 2, d), dtype=dtype, device="meta")
    lse = torch.empty((2, 2, 128), device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_dkdv_lut_sm90(q, q, q, q, lse, lse, lut)
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="key_padding_bias"):
        fa.flash_bwd_dkdv_lut_sm90(q, q, q, q, lse, lse, lut,
                                   torch.empty((2, 128), dtype=torch.bfloat16, device="meta"))
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_sm90_route_without_nvcc_raises(monkeypatch):
    """With no nvcc the route raises and counts no launch: nothing falls
    back to the template or the plain version."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    lut = fa.layout_luts(_layout("tutorial16", 128, 2), 128, 2, False)
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((2, 2, 128), device="meta")
    for call in (fa.flash_bwd_dkdv_lut, fa.flash_bwd_dkdv_lut_sm90):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call(q, q, q, q, lse, lse, lut)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_dkdv_matches_its_plain_version_on_the_card():
    """flash_bwd_dkdv_lut_sm90 against the plain version on a CUDA card,
    through the route (``chip_smoke.py`` phase 7 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, T, causal in (("tutorial16", 1024, False), ("longformer16", 1008, True),
                            ("longformer128", 1024, True)):
        H = 4
        lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
        q, k, v, do = (torch.randn((2, T, H, 64), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        kb = torch.where(torch.rand((2, T), generator=gen, device="cuda") < 0.8, 0.0, -1e4)
        o, lse = fa.flash_fwd_lut(q, k, v, lut, kb)
        delta = fa.attention_delta(o, do)
        before = fa.launches["flash_bwd_dkdv_lut_sm90"]
        got = fa.flash_bwd_dkdv_lut(q, k, v, do, lse, delta, lut, kb)
        assert fa.launches["flash_bwd_dkdv_lut_sm90"] == before + 1
        want = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut,
                                                     key_padding_bias=kb)
        for a, r in zip(got, want):
            r = r.float()
            limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
            assert ((a.float() - r).abs() <= limit).all()
