"""The block-sparse forward for Hopper, ``flash_fwd_lut_sm90``
(deepspeed_tpu_torch/csrc/flash_attention_sparse_fwd_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 7, 8 and 9, and
the ``cuda``-marked test below).  Here:

- its schedule, ``flash_fwd_lut_sm90_schedule`` over ``GroupLut(side="q")``:
  under the kernel's mask rule (every pair of an unflagged visit; in a
  flagged one the filled key slots and, when causal, k <= q) each query row
  meets each of its live keys exactly once and no other key, every query row
  lies in exactly one output tile, and the work items are dealt once over
  the pipes, longest first;
- the kernel's arithmetic: a torch emulation over that schedule (Q gathered
  once per output tile, rows from T on read as zeros, per visit the slots'
  K, V and key bias, S in fp32, the online softmax in log2 units with the
  per-visit mask, P rounded where the kernel rounds it, O = acc / l and lse
  = m ln 2 + log l, dead rows and tiles with no visit O = 0 and lse =
  NEG_INF) against the plain ``flash_attention_reference_fwd`` and against
  JAX's LUT forward (``_fwd`` over ``_layout_luts``, Pallas in interpret
  mode);
- the route ``sparse_fwd_kernel`` through ``sparse_flash_attention``, on
  meta tensors standing for CUDA ones, with ``_run`` replaced; the
  refusals; with no nvcc the call raises and counts no launch.

Tolerances: 2e-5 against the plain version and against JAX in fp32 (the
same formula in log2 units, the softmax taken visit by visit against a
running maximum, sums in another order); with P rounded to bf16, 2^-5 of
the rms plus 2^-7 of each element (the limits ``chip_smoke.py`` holds the
kernel to: the kernel rounds P against its running maximum, the plain
version against the row's final one)."""

import importlib
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from test_torch_sparse_bwd_sm90 import BF16_TOL, FP32_TOL, _layout, _live, _rows

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

NAME = "flash_fwd_lut_sm90"
LN2 = math.log(2.0)
LOG2E = 1.0 / LN2


# ------------------------------------------------------------- schedule
SCHEDULE_CASES = [("tutorial16", 256, False, 2, 2, 3), ("tutorial16", 1008, False, 1, 2, 5),
                  ("longformer16", 1008, True, 2, 2, 7), ("fixed32", 512, True, 2, 2, 4),
                  ("fixed32", 512, False, 1, 2, 264), ("bigbird64", 512, False, 2, 2, 6),
                  ("longformer128", 1024, True, 1, 2, 2), ("empty-rows", 256, False, 3, 1, 4),
                  ("empty-rows", 256, True, 1, 1, 2)]


@pytest.mark.parametrize("name,T,causal,B,H,n_pipes", SCHEDULE_CASES)
def test_schedule_meets_every_live_pair_once(name, T, causal, B, H, n_pipes):
    """Over the pipes of ``flash_fwd_lut_sm90_schedule``, the kernel's mask
    rule leaves, for each (b, h), exactly the layout's live pairs, each
    once; every query row lies in exactly one output tile; every work item
    is dealt once, each pipe's in non-increasing visit count."""
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    g = lut.groups("q")
    U = g.unit
    live = _live(lut)
    sched = fa.flash_fwd_lut_sm90_schedule(lut, B, H, n_pipes)
    assert len(sched) == min(n_pipes, len(g.order(B, H)))
    seen = np.zeros((B, H, T, T), np.int32)
    owned = np.zeros((B, H, T), np.int32)
    items = 0
    for pipe in sched:
        counts = [len(visits) for *_, visits in pipe]
        assert counts == sorted(counts, reverse=True)
        for b, h, out, visits in pipe:
            items += 1
            qrows = _rows(out, U)
            owned[b, h, qrows] += 1
            for slots, masked in visits:
                krows = _rows(slots, U)
                rule = np.ones((len(qrows), len(krows)), bool)
                if masked and causal:
                    rule = qrows[:, None] >= krows[None, :]
                if not masked:
                    assert -1 not in slots
                np.add.at(seen[b, h], np.ix_(qrows, krows), rule.astype(np.int32))
    assert items == len(g.order(B, H))
    assert (owned == 1).all()
    for h in range(H):
        want = live[h if lut.heads > 1 else 0].astype(np.int32)
        assert all(np.array_equal(seen[b, h], want) for b in range(B))


def test_schedule_is_the_dq_schedule():
    """The forward and dQ visit the same pairs: one schedule."""
    lut = fa.layout_luts(_layout("tutorial16", 512, 4), 512, 4, False)
    assert fa.flash_fwd_lut_sm90_schedule(lut, 2, 4, 9) == \
        fa.flash_bwd_dq_lut_sm90_schedule(lut, 2, 4, 9)


# ------------------------------------------------ the kernel's arithmetic
def emulate_fwd(q, k, v, lut, kbias=None, sm_scale=None, round_to=None, n_pipes=5):
    """``flash_fwd_lut_sm90`` in torch, over its schedule as the kernel runs
    it: per output tile its slots' Q rows (an empty slot reads rows from T
    on: zeros), per visit the slots' K, V and key bias (zeros for an empty
    slot), S = Q K^T in fp32, x = S scale log2e + kbias log2e, -inf where a
    flagged visit masks (an empty key slot; when causal, a key after the
    query), the running maximum m (from NEG_INF), alpha = 2^(m_old - m_new),
    P = 2^(x - m_new) summed unrounded into l and rounded to ``round_to``
    before acc += P V; then O = acc / l and lse = m ln 2 + log l, or O = 0
    and lse = NEG_INF where m stayed at or below NEG_INF / 2; rows of empty
    slots dropped.  Returns (o (B, T, H, d), lse (B, H, T)) in fp32."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    U = lut.groups("q").unit
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    f = lambda x: torch.cat([x.float(), torch.zeros_like(x[:, :U].float())], 1)  # noqa: E731
    q, k, v = f(q), f(k), f(v)                                 # row T.. reads zeros
    kb = None if kbias is None else torch.cat([kbias.float(), torch.zeros_like(
        kbias[:, :U])], 1)
    o = torch.full((B, T + U, H, d), float("nan"))
    lse = torch.full((B, H, T + U), float("nan"))
    rows = lambda slots: torch.cat([torch.arange(U) + (u * U if u >= 0 else T)   # noqa: E731
                                    for u in slots])
    for pipe in fa.flash_fwd_lut_sm90_schedule(lut, B, H, n_pipes):
        for b, h, out, visits in pipe:
            qr = rows(out)
            m = torch.full((64,), fa.NEG_INF)
            l = torch.zeros(64)
            acc = torch.zeros((64, d))
            for slots, masked in visits:
                kr = rows(slots)
                s = q[b, qr, h] @ k[b, kr, h].T                        # (query, key)
                kb2 = torch.zeros(64) if kb is None else kb[b, kr] * LOG2E
                x = s * (scale * LOG2E) + kb2[None, :]
                if masked:
                    filled = torch.tensor([u >= 0 for u in slots]).repeat_interleave(U)
                    valid = filled[None, :].expand(64, 64)
                    if lut.causal:
                        valid = valid & (qr[:, None] >= kr[None, :])
                    x = torch.where(valid, x, torch.full_like(x, -math.inf))
                mn = torch.maximum(m, x.amax(1))
                alpha = torch.exp2(m - mn)
                p = torch.exp2(x - mn[:, None])
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + rnd(p) @ v[b, kr, h]
                m = mn
            live = m > fa.NEG_INF * 0.5
            l_safe = torch.where(l == 0, torch.ones_like(l), l)
            keep = torch.tensor([u >= 0 for u in out]).repeat_interleave(U)
            o[b, qr[keep], h] = torch.where(live[:, None], acc / l_safe[:, None],
                                            torch.zeros_like(acc))[keep]
            lse[b, h, qr[keep]] = torch.where(live, m * LN2 + torch.log(l_safe),
                                              torch.full_like(m, fa.NEG_INF))[keep]
    return o[:, :T], lse[..., :T]


def _inputs(seed, B, T, H, d, bias, dtype=torch.float32):
    """q, k, v from numpy and the key bias of ``bias``: None, ``add``
    (-10000 past each row's length) or ``mul`` (0 / NEG_INF, batch row 1
    fully padded)."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(np.float32))
               .to(dtype) for _ in range(3))
    kb = None
    if bias is not None:
        keep = np.arange(T)[None, :] < rng.integers(T // 2, T + 1, B)[:, None]
        if bias == "mul":
            keep[1 % B] = False
        kb = torch.from_numpy(np.where(keep, 0.0, -10000.0 if bias == "add" else fa.NEG_INF)
                              .astype(np.float32))
    return q, k, v, kb


# blocks 16 (per-head layouts; a ragged T=1008), 32, 64, 128 and the
# empty-rows layout, causal and not, each with every key bias; the
# empty-rows layout not with ``add`` (a row whose every live key carries
# -10000: scores of magnitude 1e4, resolved to ~1e-3 in fp32 by the plain
# version and the kernels alike, as test_torch_sparse_bwd_sm90.py says)
EMULATION_CASES = [(name, T, causal, bias)
                   for name, T, causal in (("tutorial16", 256, False), ("tutorial16", 1008, True),
                                           ("longformer16", 1008, True), ("fixed32", 256, True),
                                           ("fixed32", 256, False), ("bigbird64", 256, False),
                                           ("bigbird64", 256, True),
                                           ("longformer128", 512, True),
                                           ("longformer128", 512, False),
                                           ("empty-rows", 256, False), ("empty-rows", 256, True))
                   for bias in (None, "add", "mul")
                   if not (name == "empty-rows" and bias == "add")]


@pytest.mark.parametrize("name,T,causal,bias", EMULATION_CASES)
def test_emulation_reproduces_the_plain_version(name, T, causal, bias):
    """fp32: the emulation over the schedule equals the plain version, O and
    lse (the fully padded ``mul`` row and the empty rows' queries exactly O =
    0 and lse = NEG_INF); the wrapper and the sparse path on CPU tensors are
    the plain version."""
    B, H, d = 2, 2, 16
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, kb = _inputs(T + 11 * len(name), B, T, H, d, bias)
    o, lse = emulate_fwd(q, k, v, lut, kb)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    wo, wlse = fa.flash_fwd_lut_sm90(q, k, v, lut, kb)
    assert torch.equal(wo, ro) and torch.equal(wlse, rlse)
    out = fa.sparse_flash_attention(q, k, v, _layout(name, T, H), causal=causal,
                                    key_padding_bias=kb)
    assert torch.equal(out, ro)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=0, atol=FP32_TOL)
    if bias == "mul":
        assert not o[1].any() and (lse[1] == fa.NEG_INF).all()
    if name == "empty-rows":
        assert not o[:, :64].any() and (lse[:, :, :64] == fa.NEG_INF).all()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("name,T,causal,bias", [("tutorial16", 256, False, "add"),
                                                ("longformer16", 496, True, None),
                                                ("fixed32", 512, True, "mul"),
                                                ("bigbird64", 512, False, "add")])
def test_emulation_with_bf16_rounding_matches_the_plain_version(name, T, causal, bias):
    """bf16 inputs, P rounded to bf16 as the kernel rounds it (against the
    running maximum), within the limits the kernel is held to on the card
    (T=496: a ragged 64-row tile; the fp32 cases cover T=1008); lse within
    2e-5 (fp32 on both sides)."""
    B, H, d = 2, 2, 64
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, kb = _inputs(7, B, T, H, d, bias, torch.bfloat16)
    o, lse = emulate_fwd(q, k, v, lut, kb, round_to=torch.bfloat16)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    ro = ro.float()
    limit = BF16_TOL[0] * ro.pow(2).mean().sqrt() + BF16_TOL[1] * ro.abs()
    assert ((o.to(torch.bfloat16).float() - ro).abs() <= limit).all()
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=0, atol=FP32_TOL)


def _jax_fwd(q, k, v, layout, causal, kb):
    """JAX ``_fwd`` over its LUTs (interpret mode) -> (o (B,T,H,d), lse (B,H,T))."""
    B, T, H, d = q.shape
    bq = T // layout.shape[1]
    luts = jfa._layout_luts(layout, T, H, causal, bq, bq)
    bhtd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, T, d)  # noqa: E731
    o, lse = jfa._fwd(bhtd(q), bhtd(k), bhtd(v), 1.0 / np.sqrt(d), causal, bq, bq,
                      n_heads=H, kmap=luts[0], klen=luts[1],
                      k_bias=None if kb is None else jnp.asarray(kb), attn_bias=None)
    return (np.asarray(o).reshape(B, H, T, d).transpose(0, 2, 1, 3),
            np.asarray(lse).reshape(B, H, T))


@pytest.mark.parametrize("block,causal,bias", [(16, False, "add"), (16, True, None),
                                               (32, True, "add"), (64, False, None)])
def test_emulation_matches_jax_lut_forward(block, causal, bias):
    """O and lse of the emulation against JAX's LUT forward (``_fwd`` with
    ``kmap``/``klen`` and the key bias, Pallas in interpret mode), fp32,
    from numpy-seeded inputs."""
    B, T, H, d = 2, 128, 2, 16
    layout = tsc.FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=2,
                                     num_global_blocks=1, different_layout_per_head=True,
                                     num_different_global_patterns=2).make_layout(T)
    layout = layout.astype(np.int32)
    q, k, v, kb = _inputs(block + 2 * causal, B, T, H, d, bias)
    jo, jlse = _jax_fwd(q.numpy(), k.numpy(), v.numpy(), layout, causal,
                        None if kb is None else kb.numpy())
    o, lse = emulate_fwd(q, k, v, fa.layout_luts(layout, T, H, causal), kb)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FP32_TOL)


# --------------------------------------------------------------- routes
def _recorded(monkeypatch):
    """Replace ``_run``: record (name, a group kernel's (n_work, unit, key
    bias handed)); the key bias as ``_group_sched`` is handed it (a meta
    tensor's address is 0)."""
    calls, biased = [], []
    group_sched = fa._group_sched

    def sched_of(name, q, lut, side, kbias):
        biased.append(kbias is not None)
        return group_sched(name, q, lut, side, kbias)

    def run(name, *args, device):
        sched = None
        if name in fa.GROUP_KERNELS:
            s = fa._GroupSchedule.from_address(args[-1])
            sched = (s.n_work, s.unit, biased.pop())
        calls.append((name, sched))
    monkeypatch.setattr(fa, "_group_sched", sched_of)
    monkeypatch.setattr(fa, "_run", run)
    return calls


@pytest.mark.parametrize("dtype,d,kbias,abias,want", [
    (torch.bfloat16, 64, False, False, NAME),
    (torch.bfloat16, 64, True, False, NAME),
    (torch.float32, 64, False, False, "flash_fwd_lut_ring"),
    (torch.float32, 64, True, False, "flash_fwd_lut"),
    (torch.bfloat16, 96, False, False, "flash_fwd_lut_ring"),
    (torch.bfloat16, 128, True, False, "flash_fwd_lut"),
    (torch.bfloat16, 64, True, True, "flash_fwd_lut"),
    (torch.bfloat16, 64, False, True, "flash_fwd_lut"),
])
def test_routes(monkeypatch, dtype, d, kbias, abias, want):
    """bf16 at head dim 64 with no (T, T) score bias takes the sm90 kernel,
    with or without the key bias, handed ``lut.groups("q")``'s work items,
    its slot rows and the bias; fp32, head dims 96 and 128 and a score bias
    keep the template they took before: the ring without a bias, the biased
    LUT kernel with one."""
    calls = _recorded(monkeypatch)
    B, T, H = 2, 256, 2
    layout = _layout("tutorial16", T, H)
    lut = fa.layout_luts(layout, T, H, False)
    q, k, v = (torch.empty((B, T, H, d), dtype=dtype, device="meta") for _ in range(3))
    kb = torch.empty((B, T), device="meta") if kbias else None
    ab = torch.empty((T, T), device="meta") if abias else None
    assert fa.sparse_fwd_kernel(dtype, d, abias, kbias) == want
    out = fa.sparse_flash_attention(q, k, v, layout, causal=False, key_padding_bias=kb,
                                    attn_bias=ab)
    assert out.shape == q.shape and out.dtype == dtype
    n_work = B * H * int(lut.groups("q").tiles_per_head.sum() // lut.heads)
    assert calls == [(want, (n_work, 16, kbias) if want == NAME else None)]
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("dtype,d,match", [(torch.float32, 64, "dtype"),
                                           (torch.bfloat16, 96, "head dim"),
                                           (torch.bfloat16, 128, "head dim")])
def test_wrapper_refuses_what_it_was_not_built_for(dtype, d, match):
    """The wrapper raises on a dtype or head dim it was not built for, on a
    key bias that is not fp32 or not (B, T), and takes no (T, T) score bias
    at all."""
    lut = fa.layout_luts(_layout("tutorial16", 128, 2), 128, 2, False)
    q = torch.empty((2, 128, 2, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd_lut_sm90(q, q, q, lut)
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    for bad in (torch.empty((2, 128), dtype=torch.bfloat16, device="meta"),
                torch.empty((2, 64), device="meta")):
        with pytest.raises(ValueError, match="key_padding_bias"):
            fa.flash_fwd_lut_sm90(q, q, q, lut, bad)
    with pytest.raises(TypeError, match="attn_bias"):
        fa.flash_fwd_lut_sm90(q, q, q, lut, attn_bias=torch.empty((128, 128), device="meta"))
    with pytest.raises(ValueError, match="LUT"):
        fa.flash_fwd_lut_sm90(torch.empty((2, 256, 2, 64), dtype=torch.bfloat16, device="meta"),
                              *(torch.empty((2, 256, 2, 64), dtype=torch.bfloat16,
                                            device="meta") for _ in range(2)), lut)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_route_without_nvcc_raises(monkeypatch):
    """With no nvcc the route raises and counts no launch: nothing falls
    back to the template or the plain version."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    layout = _layout("tutorial16", 128, 2)
    lut = fa.layout_luts(layout, 128, 2, False)
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    for call in (lambda: fa.flash_fwd_lut_sm90(q, q, q, lut),
                 lambda: fa.sparse_flash_attention(q, q, q, layout, causal=False)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_forward_matches_its_plain_version_on_the_card():
    """flash_fwd_lut_sm90 against the plain version on a CUDA card, O and
    lse, through the sparse path's route (``chip_smoke.py`` phase 7 runs the
    full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, T, causal, padded in (("tutorial16", 1024, False, True),
                                    ("longformer16", 1008, True, False),
                                    ("longformer128", 1024, True, True)):
        H = 4
        lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
        q, k, v = (torch.randn((2, T, H, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kb = torch.where(torch.rand((2, T), generator=gen, device="cuda") < 0.8, 0.0,
                         -1e4) if padded else None
        before = fa.launches[NAME]
        o, lse = fa.flash_fwd_lut_sm90(q, k, v, lut, kb)
        assert fa.launches[NAME] == before + 1
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
        ro = ro.float()
        limit = BF16_TOL[0] * ro.pow(2).mean().sqrt() + BF16_TOL[1] * ro.abs()
        assert ((o.float() - ro).abs() <= limit).all()
        assert ((lse - rlse).abs() <= 1e-4).all()
