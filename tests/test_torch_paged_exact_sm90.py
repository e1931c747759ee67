"""The exact paged-attention kernel for Hopper, ``paged_attention_exact_sm90``
(deepspeed_tpu_torch/csrc/paged_attention.cu, ``exact_split_kernel``), on
the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 2-4 and the
``cuda``-marked test below).  Here:

- the split: :func:`exact_sm90_plan` (ranks, rows a rank may take, rows it
  stages at once) and :func:`exact_sm90_split` (each rank's contiguous rows)
  cover every live row of every slot exactly once, with slots of length 0,
  slots whose window reaches S and ranks that take no row;
- the kernel's split arithmetic in torch: scores rounded to the compute
  dtype, scaled and masked; each rank's row max, then the cluster's; each
  rank's sum of ``exp(score - max)``, summed in rank order; P rounded to the
  compute dtype after the division by the full row sum; each rank's AV in
  fp32, summed in rank order.  Held against ``paged_attention_reference``
  and against JAX ``paged_attention(mode="exact")`` (its Pallas kernel in
  interpret mode, as the JAX package's own tests run it), fp32 and bf16,
  16-bit and int8 pools, windows 1, 3 and 8;
- the route: ``mode="exact"`` names ``paged_attention_exact_sm90``, CPU
  tensors take the plain version with no launch, tensors standing for CUDA
  ones (meta, the C entry replaced) count one launch of the entry the mode
  names and none of the first design unless it is called by name, and
  with no nvcc the route raises.

Tolerances: 1e-5 in fp32 (the same formula, the sums in another order, as
``test_torch_paged_attention.py``); in bf16 2e-2, ``chip_smoke.py``'s
limit for the kernel (one bf16 ulp at 1 is 7.8e-3: a score or a P rounded
to the other bf16 neighbour after a sum in another order)."""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import paged_kv as jpk
from deepspeed_tpu.ops.transformer.paged_attention import (
    paged_attention as jax_paged_attention)
from deepspeed_tpu_torch.inference import paged_kv as tpk
from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.transformer import paged_attention as tpa

SM90, TEMPLATE = "paged_attention_exact_sm90", "paged_attention_exact"
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BS, NB_MAX, H, HD = 16, 24, 2, 64          # S = 384: three ranks a (slot, head)
S = BS * NB_MAX
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("S_", [16, 64, 128, 129, 256, 384, 1000, 1024, 4096, 65536])
@pytest.mark.parametrize("hd,itemsize,n_scales", [(64, 2, 0), (128, 4, 0), (64, 1, 1),
                                                  (128, 1, 4)])
def test_plan_sizes_the_cluster_and_the_staging(S_, hd, itemsize, n_scales):
    """One rank per 128 rows of S, 2 to 8 of them past 128, every row of S
    within some rank's ``cap``, and the staged rows within the budget."""
    C, cap, R = tpa.exact_sm90_plan(S_, hd, itemsize, n_scales)
    assert C == min(8, max(1, -(-S_ // 128)))
    assert C * cap >= S_ and (C - 1) * cap < S_
    assert 1 <= R <= cap
    assert R == cap or 2 * R * (hd * itemsize + 4 * n_scales) <= tpa.SPLIT_STAGE_BYTES


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("S_", [16, 100, 384, 1024])
def test_split_covers_every_live_row_once(W, S_):
    """Each rank's rows are contiguous, in rank order, and together the
    ``min(len + W, S)`` rows the window reaches, each exactly once: at
    length 0, on the chunk edges, at ``len + W = S`` and past it; a rank
    past the live rows takes none."""
    C, cap, _ = tpa.exact_sm90_plan(S_, 64, 2)
    lengths = sorted({0, 1, S_ - W, max(S_ - W - 1, 0), S_, S_ + 5}
                     | {max(C * m - W, 0) for m in range(1, S_ // C + 1, max(S_ // (4 * C), 1))})
    empty = 0
    for length in lengths:
        ranks = tpa.exact_sm90_split(length, W, S_, C)
        n = min(length + W, S_)
        rows = [r for r0, r1 in ranks for r in range(r0, r1)]
        assert rows == list(range(n)), (length, ranks)
        assert all(r1 - r0 <= cap for r0, r1 in ranks)
        assert all(a[1] == b[0] for a, b in zip(ranks, ranks[1:]))
        empty += sum(r0 == r1 for r0, r1 in ranks)
    if C > W:
        assert empty > 0                      # a slot of length 0 leaves ranks with no row


# ------------------------------------------------- the kernel's arithmetic
def emulate(q, pool, tables, lengths, layer, scale_attn=True):
    """``exact_split_kernel`` in torch, rank by rank over
    :func:`exact_sm90_split`: (B, W, H * hd) in ``q.dtype``."""
    B, W, Hq, hd = q.shape
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    keys, vals = tpk.gather_kv(pool, layer, tables, dt)
    S_ = keys.shape[1]
    C, _, _ = tpa.exact_sm90_plan(S_, hd, pool["k"].element_size(),
                                  pool["k_scale"].shape[-1] if tpk.is_quantized_pool(pool) else 0)
    out = torch.zeros((B, W, Hq, hd))
    for b in range(B):
        length = int(lengths[b])
        ranks = tpa.exact_sm90_split(length, W, S_, C)
        for h in range(Hq):
            qf = q[b, :, h].float()                                  # (W, hd)
            parts = []
            for r0, r1 in ranks:
                kf, vf = keys[b, r0:r1, h].float(), vals[b, r0:r1, h].float()
                s = rnd(qf @ kf.T)                                    # (W, rows)
                if scale_attn:
                    s = s / float(np.sqrt(hd))
                pos = torch.arange(r0, r1)[None, :]
                live = pos <= length + torch.arange(W)[:, None]
                parts.append((torch.where(live, s, torch.tensor(tpa.NEG_INF)), vf))
            row_max = torch.full((W,), -float("inf"))
            for s, _ in parts:                                        # in rank order
                if s.shape[1]:
                    row_max = torch.maximum(row_max, s.max(1).values)
            es = [torch.exp(s - row_max[:, None]) for s, _ in parts]
            row_sum = torch.zeros(W)
            for e in es:
                row_sum = row_sum + e.sum(1)
            o = torch.zeros((W, hd))
            for e, (_, vf) in zip(es, parts):
                o = o + rnd(e / row_sum[:, None]) @ vf               # each rank's AV in fp32
            out[b, :, h] = o
    return out.to(dt).reshape(B, W, Hq * hd)


def _pools(seed, dtype, kv_bits, B):
    """The same pool built by each package's ``write_prefill``; tables of
    distinct blocks, lengths on the chunk edges, at 0 and at ``S - W``."""
    nb = 1 + B * NB_MAX
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, nb * BS, H, HD)).astype(np.float32)
    v = rng.standard_normal((2, nb * BS, H, HD)).astype(np.float32)
    jpool = jpk.write_prefill(
        jpk.init_pool(2, nb, BS, H, HD, JNP[dtype], kv_bits=kv_bits, quant_block=32),
        jnp.arange(nb, dtype=jnp.int32), jnp.asarray(k).astype(JNP[dtype]),
        jnp.asarray(v).astype(JNP[dtype]))
    tpool = tpk.write_prefill(
        tpk.init_pool(2, nb, BS, H, HD, dtype, kv_bits=kv_bits, quant_block=32, device="cpu"),
        torch.arange(nb), torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype))
    tables = (rng.permutation(B * NB_MAX) + 1).reshape(B, NB_MAX).astype(np.int32)
    return jpool, tpool, tables


def _lengths(W, B):
    C = tpa.exact_sm90_plan(S, HD, 2)[0]
    edges = [0, S - W, C * 40 - W, C * 40 + 1 - W, 37, 2]   # rows a multiple of C, one past
    return np.asarray(edges[:B], np.int32)


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_matches_the_plain_version_and_jax_exact(dtype, kv_bits, W):
    B = 6
    jpool, tpool, tables = _pools(W + kv_bits, dtype, kv_bits, B)
    lengths = _lengths(W, B)
    rng = np.random.default_rng(100 + W)
    q = rng.standard_normal((B, W, H, HD)).astype(np.float32)
    tq = torch.from_numpy(q).to(dtype)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = emulate(tq, tpool, tt, tl, 1)
    plain = tpa.paged_attention_reference(tq, tpool, tt, tl, 1)
    exact = jax.jit(lambda q, p: jax_paged_attention(q, p, tables, lengths, 1, mode="exact"))(
        jnp.asarray(q).astype(JNP[dtype]), jpool)
    exact = torch.from_numpy(np.array(exact.astype(jnp.float32)))
    assert got.shape == plain.shape == (B, W, H * HD)
    for label, ref in (("plain", plain.float()), ("jax exact", exact)):
        err = (got.float() - ref).abs().max().item()
        assert err <= TOL[dtype], (label, err)
    for mode in ("exact", "auto"):               # CPU tensors: the plain version
        assert torch.equal(tpa.paged_attention(tq, tpool, tt, tl, 1, mode=mode), plain)
    assert torch.equal(tpa.paged_attention_exact_template(tq, tpool, tt, tl, 1), plain)
    assert all(n == 0 for n in tpa.launches.values())


# ------------------------------------------------------------------ the route
def _fake_entry(monkeypatch):
    """Replace the C entries and the stream: record (name, arguments)."""
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(tpa, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _meta_operands(B=3, W=2, dtype=torch.bfloat16, kv_bits=16):
    q = torch.empty((B, W, H, HD), dtype=dtype, device="meta")
    pool = {"k": torch.empty((2, 9, BS, H, HD), dtype=torch.int8 if kv_bits == 8 else dtype,
                             device="meta")}
    pool["v"] = torch.empty_like(pool["k"])
    if kv_bits == 8:
        pool["k_scale"] = torch.empty((2, 9, BS, H, 2), device="meta")
        pool["v_scale"] = torch.empty_like(pool["k_scale"])
    tables = torch.empty((B, 4), dtype=torch.int32, device="meta")
    lengths = torch.empty((B,), dtype=torch.int32, device="meta")
    return q, pool, tables, lengths


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_exact_mode_routes_to_the_cluster_kernel(monkeypatch, kv_bits):
    """``mode="exact"`` launches ``paged_attention_exact_sm90`` and counts
    it; ``auto`` stays on the online kernel; the first design launches only
    by name; every call hands the C entry its 20 arguments and the stream."""
    assert tpa.KERNELS["exact"] == SM90 and tpa.resolve_mode("auto") == "online"
    assert tpa.TEMPLATES["exact"] == TEMPLATE
    online, online_first = tpa.KERNELS["online"], tpa.TEMPLATES["online"]
    assert set(tpa.launches) == {SM90, TEMPLATE, online, online_first}
    calls = _fake_entry(monkeypatch)
    q, pool, tables, lengths = _meta_operands(kv_bits=kv_bits)
    tpa.reset_launches()
    out = tpa.paged_attention(q, pool, tables, lengths, 1, mode="exact")
    assert out.shape == (3, 2, H * HD) and out.dtype == q.dtype
    tpa.paged_attention(q, pool, tables, lengths, 1)
    tpa.paged_attention_exact_template(q, pool, tables, lengths, 0)
    assert [n for n, _ in calls] == [SM90, online, TEMPLATE]
    assert tpa.launches == {SM90: 1, online: 1, TEMPLATE: 1, online_first: 0}
    for _, args in calls:
        assert len(args) == 21
        assert args[:3] == (1, int(kv_bits == 8), HD)
        assert args[11:18] == (3, 2, H, BS, 4, 9, 2 if kv_bits == 8 else 1)
    tpa.reset_launches()


def test_the_cluster_kernel_refuses_what_it_does_not_take(monkeypatch):
    """The operand checks run before any launch, on the new entry too: a
    window past 8, a head dim without a kernel, a view that does not start
    16-byte aligned."""
    _fake_entry(monkeypatch)
    q, pool, tables, lengths = _meta_operands(W=9)
    with pytest.raises(ValueError, match="window"):
        tpa.paged_attention(q, pool, tables, lengths, 0, mode="exact")
    q = torch.zeros((3, 1, H, 32))
    pool32 = {n: torch.zeros((2, 9, BS, H, 32)) for n in ("k", "v")}
    with pytest.raises(ValueError, match="head_dim"):
        tpa._launch(SM90, q, pool32, torch.zeros((3, 4), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32), 0, True)
    flat = torch.zeros(3 * H * HD + 2)[2:]               # 8 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte"):
        tpa._launch(SM90, flat.view(3, 1, H, HD), {n: torch.zeros((2, 9, BS, H, HD))
                                                   for n in ("k", "v")},
                    torch.zeros((3, 4), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                    0, True)
    assert all(n == 0 for n in tpa.launches.values())


def test_exact_route_without_nvcc_raises(monkeypatch):
    """With no nvcc the exact route raises and counts no launch: nothing
    falls back to the first design or to the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    q, pool, tables, lengths = _meta_operands()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tpa.paged_attention(q, pool, tables, lengths, 0, mode="exact")
    assert all(n == 0 for n in tpa.launches.values())


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_cluster_kernel_matches_its_plain_version_on_the_card():
    """``paged_attention_exact_sm90`` against the plain version on a CUDA
    card, bf16 and int8 pools, windows 1 and 8, head dims 64 and 128
    (``chip_smoke.py`` phase 2 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, nb_max = 4, 64
    lengths = torch.tensor([0, 1016, 255, 1023], dtype=torch.int32, device="cuda")
    for hd in (64, 128):
        for kv_bits in (16, 8):
            pool = tpk.init_pool(2, 1 + B * nb_max, 16, H, hd, torch.bfloat16, kv_bits=kv_bits,
                                 quant_block=32, device="cuda")
            k = torch.randn((2, (1 + B * nb_max) * 16, H, hd), generator=gen, device="cuda")
            pool = tpk.write_prefill(pool, torch.arange(1 + B * nb_max, device="cuda"),
                                     k.bfloat16(), (-k).bfloat16())
            tables = (torch.randperm(B * nb_max, generator=gen, device="cuda") + 1).view(
                B, nb_max).int()
            for W in (1, 8):
                q = torch.randn((B, W, H, hd), generator=gen, device="cuda").bfloat16()
                before = tpa.launches[SM90]
                out = tpa.paged_attention(q, pool, tables, lengths.clamp(max=1024 - W), 1,
                                          mode="exact")
                assert tpa.launches[SM90] == before + 1
                ref = tpa.paged_attention_reference(q, pool, tables, lengths.clamp(max=1024 - W),
                                                    1)
                assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
