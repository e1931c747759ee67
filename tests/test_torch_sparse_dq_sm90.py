"""The block-sparse dQ backward for Hopper, ``flash_bwd_dq_lut_sm90``
(deepspeed_tpu_torch/csrc/flash_attention_sparse_bwd_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 7, 8, 9 and 14,
and the ``cuda``-marked test below).  Here:

- its schedule: ``flash_bwd_dq_lut_sm90_schedule`` deals every work item of
  ``GroupLut(side="q")`` once over the kernel's pipes, longest first (the
  grouping itself is held against the layout, both sides, in
  ``test_torch_sparse_bwd_sm90.py``);
- the kernel's arithmetic: a torch emulation over its schedule (slots
  gathered, rows from T on read as zeros, the key bias per visit, fp32
  products per visit, dS rounded where the kernel rounds it, the mask rule
  of flagged visits, lse NEG_INF entering as +inf) against the plain
  ``flash_attention_reference_bwd_dq`` and against JAX's LUT backward
  (``jax.grad`` through the sparse path, Pallas in interpret mode);
- the route, on meta tensors standing for CUDA ones, with ``_run``
  replaced; the refusals; with no nvcc the call raises and counts no launch.

Tolerances, as for dK/dV: 2e-5 against the plain version in fp32 (the same
formula with exp2 for exp, summed per visit in another order); 1e-4 against
``jax.grad`` (fp32); with dS rounded to bf16 on both sides, 2^-5 of the rms
plus 2^-7 of each element (the limits ``chip_smoke.py`` holds the kernels
to)."""

import importlib
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from test_torch_sparse_bwd_sm90 import BF16_TOL, FP32_TOL, GRAD_TOL, _inputs, _layout

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

NAME = "flash_bwd_dq_lut_sm90"


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("name,T,causal,B,H,n_pipes", [
    ("tutorial16", 512, False, 2, 2, 2), ("tutorial16", 512, False, 2, 2, 7),
    ("tutorial16", 512, False, 8, 16, 264), ("longformer16", 1008, True, 1, 2, 3),
    ("longformer128", 1024, True, 2, 2, 5), ("empty-rows", 256, False, 3, 1, 4)])
def test_dq_schedule_deals_every_item_once_longest_first(name, T, causal, B, H, n_pipes):
    """``flash_bwd_dq_lut_sm90_schedule``: every output tile (query units)
    of every (b, h) exactly once over ``min(n_pipes, items)`` pipes, each
    pipe's items in non-increasing visit count, their visits and flags those
    of ``GroupLut(side="q")``."""
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    g = lut.groups("q")
    sched = fa.flash_bwd_dq_lut_sm90_schedule(lut, B, H, n_pipes)
    order = g.order(B, H)
    assert len(sched) == min(n_pipes, len(order))
    seen = {}
    for pipe in sched:
        counts = [len(visits) for *_, visits in pipe]
        assert counts == sorted(counts, reverse=True)
        for b, h, out, visits in pipe:
            seen[(b, h, out)] = seen.get((b, h, out), 0) + 1
            l = h if g.heads > 1 else 0
            t = next(t for t in range(g.tile_off[l], g.tile_off[l + 1])
                     if tuple(int(u) for u in g.out_slots[t]) == out)
            assert visits == [(tuple(int(u) for u in g.visit_slots[j]), bool(g.masked[j]))
                              for j in range(g.vbeg[t], g.vbeg[t + 1])]
    want = {(b, h, tuple(int(u) for u in g.out_slots[t]))
            for b in range(B) for h in range(H)
            for t in range(g.tile_off[h if g.heads > 1 else 0],
                           g.tile_off[(h if g.heads > 1 else 0) + 1])}
    assert set(seen) == want and set(seen.values()) == {1}
    assert (np.diff(np.diff(g.vbeg)[order[:, 1]]) <= 0).all()      # longest first


# ------------------------------------------------ the kernel's arithmetic
def emulate_dq(q, k, v, do, lse, delta, lut, kbias=None, sm_scale=None, round_to=None):
    """``flash_bwd_dq_lut_sm90`` in torch, over its schedule as the kernel
    runs it: per output tile its slots' Q and dO rows and their lse and delta
    (an empty slot reads rows from T on: zeros), per visit the slots' K, V
    and key bias (zeros for an empty slot), S = Q K^T and dP = dO V^T in
    fp32, P = 2^(S scale log2e + kbias log2e - l2) with l2 = lse log2e, or
    +inf where lse is NEG_INF, masked only in flagged visits (the key slot
    filled and, when causal, q >= k), dS = P (dP scale - delta scale)
    rounded to ``round_to`` before dQ += dS K; rows of empty slots dropped,
    rows of tiles with no visit zero."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    g = lut.groups("q")
    U = g.unit
    log2e = 1.0 / math.log(2.0)
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    f = lambda x: torch.cat([x.float(), torch.zeros_like(x[:, :U].float())], 1)  # noqa: E731
    q, k, v, do = f(q), f(k), f(v), f(do)                      # row T.. reads zeros
    lse = torch.cat([lse, torch.zeros_like(lse[..., :U])], -1)
    delta = torch.cat([delta, torch.zeros_like(delta[..., :U])], -1)
    kb = None if kbias is None else torch.cat([kbias.float(), torch.zeros_like(
        kbias[:, :U])], 1)
    dq = torch.zeros((B, T + U, H, d))
    rows = lambda slots: torch.cat([torch.arange(U) + (u * U if u >= 0 else T)   # noqa: E731
                                    for u in slots.tolist()])
    for b in range(B):
        for h in range(H):
            l = h if g.heads > 1 else 0
            for t in range(g.tile_off[l], g.tile_off[l + 1]):
                qr = rows(g.out_slots[t])
                ls = lse[b, h, qr]
                l2 = torch.where(ls > fa.NEG_INF * 0.5, ls * log2e,
                                 torch.full_like(ls, math.inf))
                dd = delta[b, h, qr] * scale
                acc = torch.zeros((64, d))
                for j in range(g.vbeg[t], g.vbeg[t + 1]):
                    slots = g.visit_slots[j]
                    kr = rows(slots)
                    s = q[b, qr, h] @ k[b, kr, h].T                    # (query, key)
                    dp = do[b, qr, h] @ v[b, kr, h].T
                    kb2 = torch.zeros(64) if kb is None else kb[b, kr] * log2e
                    p = torch.exp2(s * (scale * log2e) + (kb2[None, :] - l2[:, None]))
                    if g.masked[j]:
                        filled = torch.tensor([u >= 0 for u in slots.tolist()]
                                              ).repeat_interleave(U)
                        valid = filled[None, :].expand(64, 64)
                        if lut.causal:
                            valid = valid & (qr[:, None] >= kr[None, :])
                        p = torch.where(valid, p, torch.zeros_like(p))
                    ds = p * (dp * scale - dd[:, None])
                    acc += rnd(ds) @ k[b, kr, h]
                keep = torch.tensor([u >= 0 for u in g.out_slots[t].tolist()]
                                    ).repeat_interleave(U)
                dq[b, qr[keep], h] = acc[keep]
    return dq[:, :T]


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
def test_dq_emulation_reproduces_the_plain_version(name, T, causal, bias):
    """fp32: the emulation over the schedule equals the plain version (the
    fully padded ``mul`` row's dQ is exactly 0; so are the empty rows'
    queries); the wrapper on CPU tensors is the plain version."""
    B, H, d = 2, 2, 16
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, do, lse, delta, kb = _inputs(T + 7 * len(name), B, T, H, d, lut, bias)
    dq = emulate_dq(q, k, v, do, lse, delta, lut, kb)
    ref = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut,
                                              key_padding_bias=kb)
    for call in (fa.flash_bwd_dq_lut, fa.flash_bwd_dq_lut_sm90):
        assert torch.equal(call(q, k, v, do, lse, delta, lut, kb), ref)
    np.testing.assert_allclose(dq.numpy(), ref.numpy(), rtol=0, atol=FP32_TOL)
    if bias == "mul":
        assert not dq[1].any()
    if name == "empty-rows":
        assert not dq[:, :64].any()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("name,T,causal", [("tutorial16", 256, False),
                                           ("longformer16", 496, True),
                                           ("fixed32", 512, True), ("bigbird64", 512, False)])
def test_dq_emulation_with_bf16_rounding_matches_the_plain_version(name, T, causal):
    """bf16 inputs, dS rounded to bf16 as the kernel rounds it, within the
    limits the kernel is held to on the card (T=496: a ragged 64-row tile;
    the fp32 cases cover T=1008)."""
    B, H, d = 1, 2, 64
    lut = fa.layout_luts(_layout(name, T, H), T, H, causal)
    q, k, v, do, lse, delta, kb = _inputs(5, B, T, H, d, lut, "add", torch.bfloat16)
    got = emulate_dq(q, k, v, do, lse, delta, lut, kb, round_to=torch.bfloat16)
    ref = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut,
                                              key_padding_bias=kb).float()
    limit = BF16_TOL[0] * ref.pow(2).mean().sqrt() + BF16_TOL[1] * ref.abs()
    assert ((got.to(torch.bfloat16).float() - ref).abs() <= limit).all()


@pytest.mark.parametrize("block,causal", [(16, False), (16, True), (32, True), (64, False)])
def test_dq_emulation_matches_jax_lut_backward(block, causal):
    """dQ of the emulation, fed the port's forward, against ``jax.grad``
    through JAX's ``sparse_flash_attention`` (its LUT backward, Pallas in
    interpret mode), fp32."""
    B, T, H, d = 1, 256 if block == 64 else 128, 2, 16
    layout = tsc.FixedSparsityConfig(num_heads=H, block=block, num_local_blocks=2,
                                     num_global_blocks=1, different_layout_per_head=True,
                                     num_different_global_patterns=2).make_layout(T)
    rng = np.random.default_rng(block + causal)
    q, k, v, w = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jfa.sparse_flash_attention(q, k, v, jnp.asarray(layout),
                                                  causal=causal) * jnp.asarray(w))

    jdq = jax.grad(jloss)(*(jnp.asarray(x) for x in (q, k, v)))
    lut = fa.layout_luts(layout, T, H, causal)
    tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, lut=lut)
    dq = emulate_dq(tq, tk, tv, tw, lse, fa.attention_delta(o, tw), lut)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=0, atol=GRAD_TOL)


# --------------------------------------------------------------- routes
def _recorded(monkeypatch):
    """Replace ``_run``: record (name, a group kernel's (n_work, unit))."""
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
    (torch.bfloat16, 64, False, False, NAME),
    (torch.bfloat16, 64, True, False, NAME),
    (torch.bfloat16, 128, True, False, "flash_bwd_dq_lut"),
    (torch.float32, 64, True, False, "flash_bwd_dq_lut"),
    (torch.bfloat16, 96, False, False, "flash_bwd_dq_lut"),
    (torch.bfloat16, 64, True, True, "flash_bwd_dq_lut"),
])
def test_dq_routes(monkeypatch, dtype, d, kbias, abias, want):
    """bf16 at head dim 64 with no (T, T) score bias takes the sm90 kernel
    over ``lut.groups("q")`` (its work items and slot rows in the schedule
    it is handed); fp32, head dims 96 and 128 and a score bias the template
    kernel; ``flash_bwd_dq_lut_tiled`` always the template."""
    calls = _recorded(monkeypatch)
    B, T, H = 2, 256, 2
    lut = fa.layout_luts(_layout("tutorial16", T, H), T, H, False)
    q = torch.empty((B, T, H, d), dtype=dtype, device="meta")
    lse = torch.empty((B, H, T), device="meta")
    kb = torch.empty((B, T), device="meta") if kbias else None
    ab = torch.empty((T, T), device="meta") if abias else None
    assert fa.sparse_dq_kernel(dtype, d, abias) == want
    dq = fa.flash_bwd_dq_lut(q, q, q, q, lse, lse, lut, kb, ab)
    assert dq.shape == q.shape and dq.dtype == dtype
    fa.flash_bwd_dq_lut_tiled(q, q, q, q, lse, lse, lut, kb, ab)
    sched = (B * H * int(lut.groups("q").tiles_per_head.sum() // lut.heads), 16)
    assert calls == [(want, sched if want == NAME else None), ("flash_bwd_dq_lut", None)]
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("dtype,d,match", [(torch.float32, 64, "dtype"),
                                           (torch.bfloat16, 96, "head dim"),
                                           (torch.bfloat16, 128, "head dim")])
def test_dq_wrapper_refuses_what_it_was_not_built_for(dtype, d, match):
    """The sm90 wrapper raises on a dtype or head dim it was not built for,
    on a key bias that is not fp32, and takes no (T, T) score bias at all."""
    lut = fa.layout_luts(_layout("tutorial16", 128, 2), 128, 2, False)
    q = torch.empty((2, 128, 2, d), dtype=dtype, device="meta")
    lse = torch.empty((2, 2, 128), device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_dq_lut_sm90(q, q, q, q, lse, lse, lut)
    q = torch.empty((2, 128, 2, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="key_padding_bias"):
        fa.flash_bwd_dq_lut_sm90(q, q, q, q, lse, lse, lut,
                                 torch.empty((2, 128), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(TypeError, match="attn_bias"):
        fa.flash_bwd_dq_lut_sm90(q, q, q, q, lse, lse, lut,
                                 attn_bias=torch.empty((128, 128), device="meta"))
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_dq_route_without_nvcc_raises(monkeypatch):
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
    for call in (fa.flash_bwd_dq_lut, fa.flash_bwd_dq_lut_sm90):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call(q, q, q, q, lse, lse, lut)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_dq_matches_its_plain_version_on_the_card():
    """flash_bwd_dq_lut_sm90 against the plain version on a CUDA card,
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
        before = fa.launches[NAME]
        got = fa.flash_bwd_dq_lut(q, k, v, do, lse, delta, lut, kb).float()
        assert fa.launches[NAME] == before + 1
        ref = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut,
                                                  key_padding_bias=kb).float()
        limit = BF16_TOL[0] * ref.pow(2).mean().sqrt() + BF16_TOL[1] * ref.abs()
        assert ((got - ref).abs() <= limit).all()
