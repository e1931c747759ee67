"""The dense bf16 flash backward for Hopper, ``flash_bwd_dkdv_sm90`` and
``flash_bwd_dq_sm90`` (deepspeed_tpu_torch/csrc/flash_attention_sparse_bwd_sm90.cu),
on the CPU.

The kernels run only on a card (``chip_smoke.py`` phases 2, 5, 6 and 13,
and the ``cuda``-marked test below).  Here:

- their schedules, ``flash_bwd_dkdv_sm90_schedule`` and
  ``flash_bwd_dq_sm90_schedule`` (the kernels' own arithmetic in Python),
  against the live set at T from 1 to 8192, causal and not: every live
  (q, k) pair in exactly one visit, no visit without a live pair, the mask
  flag exactly on the causal diagonal and on the tile crossing T, every
  work item dealt once, longest first;
- the kernels' arithmetic: a torch emulation over those schedules (64-row
  tiles, rows of q, k, v, dO, lse and delta past T read as zeros, the
  mask of flagged visits, P and dS rounded where the kernels round them,
  output rows past T dropped) against the plain
  ``flash_attention_reference_bwd_*`` and against ``jax.grad`` of the JAX
  ``flash_attention`` (Pallas in interpret mode, as its own tests run it),
  once through ``flash_attention_with_lse`` (``delta - dlse``);
- the route ``dense_bwd_kernel`` and the wrappers, on meta tensors
  standing for CUDA ones, with ``_run`` replaced; the refusals; with no nvcc
  the route raises and counts no launch.

Tolerances: 2e-5 against the plain version in fp32 (the same formula with
exp2 for exp, summed per visit in another order); 1e-4 against
``jax.grad`` (fp32, as ``test_torch_flash_attention.py``); with P and dS
rounded to bf16 on both sides, 2^-5 of the rms plus 2^-7 of each element
(the limits ``chip_smoke.py`` holds the kernels to)."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer.flash_attention import (
    flash_attention as jax_flash, flash_attention_with_lse as jax_flash_lse)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

FP32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = (2 ** -5, 2 ** -7)
TILE = fa.TILE
SM90 = ["flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"]
TEMPLATES = ["flash_bwd_dkdv", "flash_bwd_dq"]


# ------------------------------------------------------------- schedule
def _schedule(side, B, T, H, causal, n_pipes):
    call = fa.flash_bwd_dkdv_sm90_schedule if side == "k" else fa.flash_bwd_dq_sm90_schedule
    return call(B, T, H, causal, n_pipes)


@pytest.mark.parametrize("side", ["k", "q"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 96, 1000, 1024, 1088, 8192])
def test_schedule_covers_the_live_set_once(T, causal, side):
    """Every live (q, k) pair (q, k < T; q >= k when causal) lies in exactly
    one visit of one output tile; every visit holds a live pair; a visit is
    masked exactly when it is the causal diagonal or crosses T, and an
    unmasked visit is wholly live over its 64 visited rows and the output
    tile's rows under T (rows past T are not stored)."""
    nt = -(-T // TILE)
    sched = _schedule(side, 1, T, 1, causal, 7)
    pos = np.arange(nt * TILE)
    live = (pos[:, None] < T) & (pos[None, :] < T)                     # [q, k]
    if causal:
        live &= pos[:, None] >= pos[None, :]
    tiles = live.reshape(nt, TILE, nt, TILE)                          # [qt, q, kt, k]
    seen = np.zeros((nt, nt), np.int32)                               # [qt, kt]
    out_tiles = []
    for pipe in sched:
        for b, h, out, visits in pipe:
            assert (b, h) == (0, 0)
            out_tiles.append(out)
            for u, masked in visits:
                qt, kt = (u, out) if side == "k" else (out, u)
                seen[qt, kt] += 1
                block = tiles[qt, :, kt, :]
                assert block.any(), (out, u)
                assert masked == ((causal and u == out) or (T % TILE != 0 and u == nt - 1))
                stored = pos[out * TILE:(out + 1) * TILE] < T
                rows = block[:, stored] if side == "k" else block[stored, :]
                if not masked:
                    assert rows.all(), (out, u)
    assert sorted(out_tiles) == list(range(nt))                       # each output tile once
    want = tiles.any(axis=(1, 3)).astype(np.int32)
    assert np.array_equal(seen, want)


@pytest.mark.parametrize("side", ["k", "q"])
@pytest.mark.parametrize("B,T,H,causal,n_pipes", [
    (8, 1024, 16, True, 264), (8, 1024, 16, False, 264), (2, 200, 3, True, 5),
    (1, 65, 2, True, 264), (3, 1000, 1, False, 7)])
def test_items_are_dealt_once_longest_first(side, B, T, H, causal, n_pipes):
    """Every (b, h, output tile) is dealt to exactly one pipe, over
    ``min(n_pipes, items)`` pipes; the item order is longest first (the
    key tiles of dK/dV ascending, the query tiles of dQ descending), each
    pipe takes its items in that order, and its visits ascend."""
    nt = -(-T // TILE)
    sched = _schedule(side, B, T, H, causal, n_pipes)
    assert len(sched) == min(n_pipes, nt * B * H)
    seen = []
    for pipe in sched:
        counts = [len(visits) for *_, visits in pipe]
        assert counts == sorted(counts, reverse=True)
        for b, h, out, visits in pipe:
            seen.append((b, h, out))
            us = [u for u, _ in visits]
            assert us == sorted(us) and len(us) == len(set(us))
            if causal:
                assert us == (list(range(out, nt)) if side == "k" else list(range(out + 1)))
            else:
                assert us == list(range(nt))
    assert sorted(seen) == [(b, h, t) for b in range(B) for h in range(H) for t in range(nt)]
    # the items in dealing order: pipe x takes r G + x, or r G + G - 1 - x in odd rounds
    blocks = fa.flash_fwd_sm90_blocks(nt * B * H, n_pipes)
    order = sorted((w, item) for items, pipe in zip(blocks, sched)
                   for w, item in zip(items, pipe))
    lengths = [len(item[3]) for _, item in order]
    assert lengths == sorted(lengths, reverse=True)


# ------------------------------------------------ the kernels' arithmetic
def _rows_zero_past_t(x, nt):
    """(B, nt * 64, H, d) fp32: rows from T on read as zeros (TMA's fill)."""
    B, T, H, d = x.shape
    return torch.cat([x.float(), torch.zeros((B, nt * TILE - T, H, d))], 1)


def _stats_zero_past_t(x, nt):
    """(B, H, nt * 64) fp32: lse or delta with zeros from T on (the producer
    lanes' zero-filled copies)."""
    B, H, T = x.shape
    return torch.cat([x.float(), torch.zeros((B, H, nt * TILE - T))], 2)


def emulate(q, k, v, do, lse, delta, causal, sm_scale=None, round_to=None, n_pipes=5):
    """``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90`` in torch, over their
    schedules as the kernels run them: per output tile the other side's
    visits, S and dP of the 64 x 64 visit in fp32, P = 2^(S scale log2e -
    l2) with l2 = lse log2e (+inf where lse is NEG_INF), lse and delta of
    the visit's (dK/dV) or the tile's (dQ) query rows, zeros past T (as q,
    k, v and dO); a flagged visit masks q >= T (dK/dV) or k >= T (dQ) and,
    when causal, q < k; dS = P (dP scale - delta scale);
    P and dS rounded to ``round_to`` before dV += P^T dO, dK += dS^T Q, dQ
    += dS K; rows of an output tile past T dropped.  Returns (dq, dk, dv)
    in fp32."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    log2e = 1.0 / math.log(2.0)
    nt = -(-T // TILE)
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    q, k, v, do = (_rows_zero_past_t(x, nt) for x in (q, k, v, do))
    lse, delta = _stats_zero_past_t(lse, nt), _stats_zero_past_t(delta, nt)
    rows = lambda t: torch.arange(TILE) + t * TILE                # noqa: E731

    def stats(b, h, r):
        ls = lse[b, h, r]
        l2 = torch.where(ls > fa.NEG_INF * 0.5, ls * log2e, torch.full_like(ls, math.inf))
        return l2, delta[b, h, r] * scale

    dk, dv, dq = (torch.zeros((B, nt * TILE, H, d)) for _ in range(3))
    for pipe in fa.flash_bwd_dkdv_sm90_schedule(B, T, H, causal, n_pipes):
        for b, h, kt, visits in pipe:
            kr = rows(kt)
            acc_k, acc_v = torch.zeros((TILE, d)), torch.zeros((TILE, d))
            for qt, masked in visits:
                qr = rows(qt)
                st = k[b, kr, h] @ q[b, qr, h].T                           # (key, query)
                dpt = v[b, kr, h] @ do[b, qr, h].T
                l2, dd = stats(b, h, qr)
                p = torch.exp2(st * (scale * log2e) - l2[None, :])
                if masked:
                    valid = (qr < T)[None, :] & ((qr[None, :] >= kr[:, None]) | (not causal))
                    p = torch.where(valid, p, torch.zeros_like(p))
                ds = p * (dpt * scale - dd[None, :])
                acc_v += rnd(p) @ do[b, qr, h]
                acc_k += rnd(ds) @ q[b, qr, h]
            dk[b, kr, h], dv[b, kr, h] = acc_k, acc_v
    for pipe in fa.flash_bwd_dq_sm90_schedule(B, T, H, causal, n_pipes):
        for b, h, qt, visits in pipe:
            qr = rows(qt)
            l2, dd = stats(b, h, qr)
            acc = torch.zeros((TILE, d))
            for kt, masked in visits:
                kr = rows(kt)
                s = q[b, qr, h] @ k[b, kr, h].T                            # (query, key)
                dp = do[b, qr, h] @ v[b, kr, h].T
                p = torch.exp2(s * (scale * log2e) - l2[:, None])
                if masked:
                    valid = (kr < T)[None, :] & ((qr[:, None] >= kr[None, :]) | (not causal))
                    p = torch.where(valid, p, torch.zeros_like(p))
                ds = p * (dp * scale - dd[:, None])
                acc += rnd(ds) @ k[b, kr, h]
            dq[b, qr, h] = acc
    return dq[:, :T], dk[:, :T], dv[:, :T]


def _inputs(seed, B, T, H, d, causal, dtype=torch.float32):
    """q, k, v, dO from numpy, the plain forward's (O, lse) and delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    o, lse = fa.flash_attention_reference_fwd(q, k, v, causal)
    return q, k, v, do, lse, fa.attention_delta(o, do)


def _plain(q, k, v, do, lse, delta, causal):
    dk, dv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal)
    return fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal), dk, dv


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 40, 63, 64, 65, 130, 200])
def test_emulation_reproduces_the_plain_version(T, causal):
    """fp32: the emulation over the schedules equals the plain versions at
    T under, at and past one 64-row tile and ragged; the wrappers on CPU
    tensors are the plain versions."""
    B, H, d = 3, 2, 16
    q, k, v, do, lse, delta = _inputs(T + causal, B, T, H, d, causal)
    got = emulate(q, k, v, do, lse, delta, causal)
    want = _plain(q, k, v, do, lse, delta, causal)
    for call in (fa.flash_bwd_dkdv, fa.flash_bwd_dkdv_sm90, fa.flash_bwd_dkdv_template):
        assert all(torch.equal(a, b) for a, b in zip(call(q, k, v, do, lse, delta, causal),
                                                     want[1:]))
    for call in (fa.flash_bwd_dq, fa.flash_bwd_dq_sm90, fa.flash_bwd_dq_template):
        assert torch.equal(call(q, k, v, do, lse, delta, causal), want[0])
    for label, a, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=FP32_TOL, err_msg=label)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [65, 200])
def test_emulation_with_bf16_rounding_matches_the_plain_version(T, causal):
    """bf16 inputs, P and dS rounded to bf16 as the kernels round them, at
    head dim 64, within the limits the kernels are held to on the card."""
    B, H, d = 2, 2, 64
    q, k, v, do, lse, delta = _inputs(3 + T, B, T, H, d, causal, torch.bfloat16)
    got = emulate(q, k, v, do, lse, delta, causal, round_to=torch.bfloat16)
    want = _plain(q, k, v, do, lse, delta, causal)
    for label, a, r in zip(("dq", "dk", "dv"), got, want):
        r = r.float()
        limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
        assert ((a.to(torch.bfloat16).float() - r).abs() <= limit).all(), label


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [96, 200])
def test_emulation_matches_jax_grad(T, causal):
    """dQ, dK and dV of the emulation, fed the port's forward, against
    ``jax.grad`` through JAX's ``flash_attention`` (Pallas in interpret
    mode), fp32, B=2 H=2 d=64."""
    B, H, d = 2, 2, 64
    rng = np.random.default_rng(T + 10 * causal)
    q, k, v, w = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=64, block_k=64)
                       * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, causal)
    got = emulate(tq, tk, tv, tw, lse, fa.attention_delta(o, tw), causal)
    for label, a, jg in zip(("dq", "dk", "dv"), got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(jg), rtol=0, atol=GRAD_TOL,
                                   err_msg=label)


def test_emulation_with_the_lse_cotangent_matches_jax_grad():
    """``flash_attention_with_lse`` under a loss on both outputs: the
    emulation fed ``delta - dlse`` against ``jax.grad`` through JAX's
    ``flash_attention_with_lse``, fp32, B=2 T=200 H=2 d=64, causal."""
    B, T, H, d = 2, 200, 2, 64
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))
    u = rng.standard_normal((B, H, T)).astype(np.float32)

    def jloss(q, k, v):
        o, lse = jax_flash_lse(q, k, v, causal=True, block_q=64, block_k=64)
        return jnp.sum(o * jnp.asarray(w)) + jnp.sum(lse * jnp.asarray(u))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tw, tu = map(torch.from_numpy, (q, k, v, w, u))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, True)
    delta = (fa.attention_delta(o, tw) - tu).contiguous()
    got = emulate(tq, tk, tv, tw, lse, delta, True)
    for label, a, jg in zip(("dq", "dk", "dv"), got, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(jg), rtol=0, atol=GRAD_TOL,
                                   err_msg=label)


# --------------------------------------------------------------- routes
def _names(monkeypatch):
    names = []
    monkeypatch.setattr(fa, "_run", lambda name, *a, device: names.append(name))
    return names


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 96, 128])
def test_dense_backward_routes_by_dtype_and_head_dim(monkeypatch, dtype, d):
    """bf16 at head dim 64 takes the sm90 pair, fp32 and head dims 96 and
    128 the templates, through ``flash_bwd_dkdv`` / ``flash_bwd_dq`` and the
    ``flash_attention`` autograd function; the ``_template`` wrappers always
    take the templates."""
    names = _names(monkeypatch)
    want = SM90 if (dtype, d) == (torch.bfloat16, 64) else TEMPLATES
    assert list(fa.dense_bwd_kernel(dtype, d)) == want
    B, T, H = 2, 200, 4
    q = torch.empty((B, T, H, d), dtype=dtype, device="meta")
    lse = torch.empty((B, H, T), device="meta")
    dk, dv = fa.flash_bwd_dkdv(q, q, q, q, lse, lse, True)
    dq = fa.flash_bwd_dq(q, q, q, q, lse, lse, True)
    assert dk.shape == dv.shape == dq.shape == q.shape and dq.dtype == dtype
    fa.flash_bwd_dkdv_template(q, q, q, q, lse, lse, False)
    fa.flash_bwd_dq_template(q, q, q, q, lse, lse, False)
    assert names == want + TEMPLATES
    names.clear()
    leaves = [torch.empty((B, T, H, d), dtype=dtype, device="meta", requires_grad=True)
              for _ in range(3)]
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert names == [fa.dense_fwd_kernel(dtype, d)] + want
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("dtype,d,match", [(torch.float32, 64, "dtype"),
                                           (torch.bfloat16, 96, "head dim"),
                                           (torch.bfloat16, 128, "head dim")])
def test_sm90_wrappers_refuse_what_they_were_not_built_for(dtype, d, match):
    q = torch.empty((2, 128, 2, d), dtype=dtype, device="meta")
    lse = torch.empty((2, 2, 128), device="meta")
    for call in (fa.flash_bwd_dkdv_sm90, fa.flash_bwd_dq_sm90):
        with pytest.raises(ValueError, match=match):
            call(q, q, q, q, lse, lse)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("operand", [0, 1, 2, 3])
def test_sm90_wrappers_refuse_unaligned_views(operand):
    """TMA needs 16-byte aligned rows: q, k, v or dO as a view whose t
    stride is 8 bytes off is refused, never copied (lse and delta, read with
    4-byte copies, need no more than their fp32 alignment)."""
    B, T, H, d = 2, 64, 4, 64
    row = H * d + 4                                  # 8 bytes past a 16-byte multiple
    bad = torch.empty(B * T * row, dtype=torch.bfloat16, device="meta").as_strided(
        (B, T, H, d), (T * row, row, d, 1))
    q = torch.empty((B, T, H, d), dtype=torch.bfloat16, device="meta")
    args = [q, q, q, q]
    args[operand] = bad
    lse = torch.empty((B, H, T), device="meta")
    for call in (fa.flash_bwd_dkdv, fa.flash_bwd_dq, fa.flash_bwd_dkdv_sm90, fa.flash_bwd_dq_sm90):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(*args, lse, lse)
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
    q = torch.empty((2, 64, 4, 64), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((2, 4, 64), device="meta")
    for call in (fa.flash_bwd_dkdv, fa.flash_bwd_dkdv_sm90, fa.flash_bwd_dq,
                 fa.flash_bwd_dq_sm90):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call(q, q, q, q, lse, lse)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_backward_matches_its_plain_versions_on_the_card():
    """flash_bwd_dkdv_sm90 and flash_bwd_dq_sm90 against the plain versions
    on a CUDA card, through the route, q/k/v as views of one qkv tensor
    (``chip_smoke.py`` phase 2 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, d = 2, 4, 64
    for T, causal in ((33, True), (65, True), (200, False), (1024, True)):
        qkv = torch.randn((B, T, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
        do = torch.randn((B, T, H, d), generator=gen, device="cuda").to(torch.bfloat16)
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = fa.attention_delta(o, do)
        before = [fa.launches[n] for n in SM90]
        got = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
               *fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal))
        assert [fa.launches[n] for n in SM90] == [x + 1 for x in before]
        for a, r in zip(got, _plain(q, k, v, do, lse, delta, causal)):
            r = r.float()
            limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
            assert ((a.float() - r).abs() <= limit).all()
