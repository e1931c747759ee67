"""The online paged-attention kernel for Hopper, ``paged_attention_online_sm90``
(deepspeed_tpu_torch/csrc/paged_attention.cu, ``online_split_kernel``), on
the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 2-4 and the
``cuda``-marked test below).  Here:

- the plan: :func:`online_sm90_plan` (ranks, rows a rank may take, rows it
  stages at once), :func:`exact_sm90_split` (each rank's contiguous rows,
  the same split as the exact kernel's), :func:`online_sm90_pieces` (how a
  rank's rows go through the staging buffer) and :func:`deal` (a piece's
  rows to the FMA path's row groups or the tensor-core path's warps) cover
  every live row of every slot exactly once, with slots of length 0, slots
  whose window reaches S, ranks that take no row and chunks one row past
  the buffer;
- the kernel's arithmetic in torch, rank by rank, piece by piece and row
  group (or warp) by row group: fp32 scores x sm_scale, each group's max
  over its rows of a piece, p = exp(s - max) rounded to the compute dtype
  for AV only, l summed from the unrounded p, the running state rescaled
  between pieces, the groups merged, then the ranks in rank order, each
  scaled by exp(m_r - m).  Held against ``paged_attention_reference`` and against
  JAX ``paged_attention(mode="online")`` (its Pallas kernel in interpret
  mode, as the JAX package's own tests run it), fp32 and bf16, 16-bit and
  int8 pools, windows 1, 3 and 8, head dims 64 and 128;
- the route: ``mode="auto"`` and ``mode="online"`` name
  ``paged_attention_online_sm90``, CPU tensors take the plain version with
  no launch, tensors standing for CUDA ones (meta, the C entry replaced)
  count one launch of the entry the mode names and none of the first
  design ``paged_attention_online`` unless it is called by name, the
  operand checks run before any build, and with no nvcc the route raises.

Tolerances: 1e-5 in fp32 (the same formula, the max each p is taken
against and the sums in another order); 2e-2 in bf16, ``chip_smoke.py``'s
limit for the kernel (one bf16 ulp at 1 is 7.8e-3: the plain version
rounds each probability after the division by the row sum, the online
softmax rounds p = exp(s - m) before it)."""

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

SM90, TEMPLATE = "paged_attention_online_sm90", "paged_attention_online"
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BS, NB_MAX, H = 16, 24, 2                   # S = 384: three ranks a (slot, head)
S = BS * NB_MAX
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def online_mma(dtype):
    """Whether the kernel takes its tensor-core path (16-bit compute, over
    a 16-bit pool or an int8 one dequantized into 16-bit tiles) or its FMA
    path (fp32 compute)."""
    return dtype in (torch.bfloat16, torch.float16)


def deal(n, hd, mma):
    """The rows ``0 .. n - 1`` of a piece as the kernel deals them, one list
    a group with its own running max: on the FMA path to its
    ``128 // (hd // 8)`` row groups in turn (group g: rows g, g + groups,
    ...), on the tensor-core path to its 4 warps by 16-row tiles (warp w:
    rows 16 w .. 16 w + 15)."""
    if mma:
        return [list(range(16 * w, min(16 * w + 16, n))) for w in range(tpa.ONLINE_WARPS)]
    groups = 128 // (hd // 8)
    return [list(range(g, n, groups)) for g in range(groups)]


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("S_", [16, 64, 128, 129, 256, 384, 1000, 1024, 4096, 65536])
@pytest.mark.parametrize("hd,itemsize,n_scales", [(64, 2, 0), (128, 2, 0), (128, 4, 0),
                                                  (64, 1, 1), (128, 1, 2)])
def test_plan_sizes_the_cluster_and_the_staging(S_, hd, itemsize, n_scales):
    """The exact kernel's ranks (one per 128 rows of S, at most 8), every
    row of S within some rank's ``cap``, and the staged rows what the 16 KB
    budget holds, but 32 to 64 (a 16-row tile a warp) unless ``cap`` is
    fewer."""
    C, cap, R = tpa.online_sm90_plan(S_, hd, itemsize, n_scales)
    assert (C, cap) == tpa.exact_sm90_plan(S_, hd, itemsize, n_scales)[:2]
    assert C * cap >= S_ and (C - 1) * cap < S_
    assert R == cap <= 64 or 32 <= R <= 64
    per_row = 2 * (hd * itemsize + 4 * n_scales)
    assert R * per_row <= tpa.ONLINE_STAGE_BYTES or R == min(cap, 32)
    if (S_, hd, itemsize) == (1024, 64, 2):
        # phase 4's state: its longest slot (499 rows, 63 a rank) in one piece
        assert (C, cap, R) == (8, 128, 64)
    assert online_mma(torch.bfloat16) and online_mma(torch.float16)
    assert not online_mma(torch.float32)


@pytest.mark.parametrize("R,mma", [(2, False), (3, False), (32, False), (64, False),
                                   (32, True), (64, True), (5, True), (17, True)])
def test_pieces_cover_each_chunk_once(R, mma):
    """A rank's rows go through the buffer once each, in order: all at once
    when they fit (R below 32 only when it is the whole chunk, ``cap``),
    else in pieces of R // 2 rows (whole 16-row tiles on the tensor-core
    path) alternating between the buffer's halves, never past R rows; each
    piece's rows are dealt once, to the FMA path's row groups (rows g, g +
    groups, ...) or the tensor-core path's warps (a 16-row tile each, every
    tile row within the buffer's 16-row-rounded rows)."""
    sizes = {0, 1, R - 1, R} if mma and R < 32 else {0, 1, R - 1, R, R + 1, 2 * R, 3 * R + 5}
    for rows in sorted(sizes):
        pieces = tpa.online_sm90_pieces(rows, R, mma)
        staged = [s0 + i for s0, n, _ in pieces for i in range(n)]
        assert staged == list(range(rows)), (rows, pieces)
        assert all(slot + n <= R and n >= 1 for _, n, slot in pieces)
        if rows <= R:
            assert len(pieces) == (rows > 0) and all(slot == 0 for *_, slot in pieces)
        else:
            half = (R // 2) & ~15 if mma else R // 2
            assert [slot for *_, slot in pieces] == [(k % 2) * half for k in range(len(pieces))]
            assert len(pieces) == -(-rows // half)
        for hd in (64, 128):
            for _, n, slot in pieces:
                groups = deal(n, hd, mma)
                assert sorted(i for rows_ in groups for i in rows_) == list(range(n))
                if mma:
                    assert len(groups) == 4
                    assert all(r // 16 == w for w, rows_ in enumerate(groups) for r in rows_)
                    assert slot + 16 * -(-n // 16) <= 16 * -(-R // 16)


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("S_,hd,itemsize", [(16, 64, 2), (100, 64, 2), (384, 128, 2),
                                            (1024, 64, 2), (1024, 128, 4)])
def test_split_and_pieces_cover_every_live_row_once(W, S_, hd, itemsize):
    """Over the ranks and their pieces, each of the ``min(len + W, S)`` rows
    the window reaches is staged exactly once: at length 0, at ``len + W =
    S`` and past it, with a rank's chunk filling the buffer and one row
    past it; a rank past the live rows takes none."""
    C, cap, R = tpa.online_sm90_plan(S_, hd, itemsize)
    mma = itemsize == 2                       # a 16-bit pool has 16-bit compute
    lengths = sorted({0, 1, S_ - W, max(S_ - W - 1, 0), S_, S_ + 5, max(C * R - W, 0),
                      max(C * (R + 1) - W, 0), max(C * R + 1 - W, 0)})
    empty = 0
    for length in lengths:
        ranks = tpa.exact_sm90_split(length, W, S_, C)
        rows = [r0 + s0 + i for r0, r1 in ranks
                for s0, n, _ in tpa.online_sm90_pieces(r1 - r0, R, mma)
                for dealt in deal(n, hd, mma) for i in dealt]
        rows.sort()
        assert rows == list(range(min(length + W, S_))), (length, ranks)
        assert all(r1 - r0 <= cap for r0, r1 in ranks)
        empty += sum(r0 == r1 for r0, r1 in ranks)
    if C > W:
        assert empty > 0                      # a slot of length 0 leaves ranks with no row


# ------------------------------------------------- the kernel's arithmetic
def _merge(parts):
    """Partial (m, l, O) states, (W,), (W,), (W, hd), merged in order, each
    scaled by exp(m_i - m); a state that saw no row has m = -inf."""
    m = torch.stack([p[0] for p in parts]).max(0).values
    l = torch.zeros_like(m)
    o = torch.zeros_like(parts[0][2])
    for mi, li, oi in parts:
        f = torch.where(mi == -float("inf"), torch.zeros_like(mi), torch.exp(mi - m))
        l = l + f * li
        o = o + f[:, None] * oi
    return m, l, o


def emulate(q, pool, tables, lengths, layer, scale_attn=True):
    """``online_split_kernel`` in torch, rank by rank over
    :func:`exact_sm90_split`, piece by piece over :func:`online_sm90_pieces`
    and row group by row group: (B, W, H * hd) in ``q.dtype``."""
    B, W, Hq, hd = q.shape
    dt = q.dtype
    rnd = lambda x: x.to(dt).float()
    neg = -float("inf")
    keys, vals = tpk.gather_kv(pool, layer, tables, dt)
    S_ = keys.shape[1]
    quant = tpk.is_quantized_pool(pool)
    C, _, R = tpa.online_sm90_plan(S_, hd, pool["k"].element_size(),
                                   pool["k_scale"].shape[-1] if quant else 0)
    mma = online_mma(dt)
    sm_scale = 1.0 / float(np.sqrt(hd)) if scale_attn else 1.0
    out = torch.zeros((B, W, Hq, hd))
    for b in range(B):
        length = int(lengths[b])
        for h in range(Hq):
            qf = q[b, :, h].float()                                  # (W, hd)
            ranks = []
            for r0, r1 in tpa.exact_sm90_split(length, W, S_, C):
                state = None
                for s0, n, _ in tpa.online_sm90_pieces(r1 - r0, R, mma):
                    groups = deal(n, hd, mma)
                    if state is None:
                        state = [(torch.full((W,), neg), torch.zeros(W), torch.zeros((W, hd)))
                                 for _ in groups]
                    for g, dealt in enumerate(groups):
                        if not dealt:
                            continue                                 # the group has no row
                        rows = r0 + s0 + torch.tensor(dealt)
                        m, l, acc = state[g]
                        kf, vf = keys[b, rows, h].float(), vals[b, rows, h].float()
                        s = (qf @ kf.T) * sm_scale                    # (W, rows) fp32
                        live = rows[None, :] <= length + torch.arange(W)[:, None]
                        pm = torch.where(live, s, torch.tensor(neg)).max(1).values
                        m_new = torch.maximum(m, pm)                 # the piece's max
                        alpha = torch.where(m == neg, torch.zeros(W), torch.exp(m - m_new))
                        p = torch.where(live, torch.exp(s - m_new[:, None]), torch.zeros(()))
                        state[g] = (m_new, l * alpha + p.sum(1),
                                    acc * alpha[:, None] + rnd(p) @ vf)   # p rounded for AV
                if state is None:                                    # a rank with no row
                    state = [(torch.full((W,), neg), torch.zeros(W), torch.zeros((W, hd)))]
                ranks.append(_merge(state))                          # the rank's partial
            _, l, o = _merge(ranks)                                  # in rank order
            out[b, :, h] = o / torch.where(l == 0, torch.ones(()), l)[:, None]
    return out.to(dt).reshape(B, W, Hq * hd)


def _pools(seed, dtype, kv_bits, B, hd):
    """The same pool built by each package's ``write_prefill``; tables of
    distinct blocks."""
    nb = 1 + B * NB_MAX
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((2, nb * BS, H, hd)).astype(np.float32)
    v = rng.standard_normal((2, nb * BS, H, hd)).astype(np.float32)
    jpool = jpk.write_prefill(
        jpk.init_pool(2, nb, BS, H, hd, JNP[dtype], kv_bits=kv_bits, quant_block=32),
        jnp.arange(nb, dtype=jnp.int32), jnp.asarray(k).astype(JNP[dtype]),
        jnp.asarray(v).astype(JNP[dtype]))
    tpool = tpk.write_prefill(
        tpk.init_pool(2, nb, BS, H, hd, dtype, kv_bits=kv_bits, quant_block=32, device="cpu"),
        torch.arange(nb), torch.from_numpy(k).to(dtype), torch.from_numpy(v).to(dtype))
    tables = (rng.permutation(B * NB_MAX) + 1).reshape(B, NB_MAX).astype(np.int32)
    return jpool, tpool, tables


def _lengths(W, pool, hd):
    """Lengths at 0 and at ``S - W``, with rows a multiple of the ranks and
    one past, a rank's chunk filling the staging buffer and one row past
    it, and two between."""
    quant = tpk.is_quantized_pool(pool)
    C, _, R = tpa.online_sm90_plan(S, hd, pool["k"].element_size(),
                                   pool["k_scale"].shape[-1] if quant else 0)
    edges = [0, S - W, C * 40 - W, C * 40 + 1 - W, C * R - W, C * R + 1 - W, 37, 2]
    return np.asarray([min(max(n, 0), S - W) for n in edges], np.int32)


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_matches_the_plain_version_and_jax_online(dtype, kv_bits, hd, W):
    B = 8
    jpool, tpool, tables = _pools(W + kv_bits + hd, dtype, kv_bits, B, hd)
    lengths = _lengths(W, tpool, hd)
    rng = np.random.default_rng(200 + W)
    q = rng.standard_normal((B, W, H, hd)).astype(np.float32)
    tq = torch.from_numpy(q).to(dtype)
    tt, tl = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = emulate(tq, tpool, tt, tl, 1)
    plain = tpa.paged_attention_reference(tq, tpool, tt, tl, 1)
    online = jax.jit(lambda q, p: jax_paged_attention(q, p, tables, lengths, 1, mode="online"))(
        jnp.asarray(q).astype(JNP[dtype]), jpool)
    online = torch.from_numpy(np.array(online.astype(jnp.float32)))
    assert got.shape == plain.shape == (B, W, H * hd)
    for label, ref in (("plain", plain.float()), ("jax online", online)):
        err = (got.float() - ref).abs().max().item()
        assert err <= TOL[dtype], (label, err)
    for mode in ("online", "auto"):              # CPU tensors: the plain version
        assert torch.equal(tpa.paged_attention(tq, tpool, tt, tl, 1, mode=mode), plain)
    assert torch.equal(tpa.paged_attention_online_template(tq, tpool, tt, tl, 1), plain)
    assert all(n == 0 for n in tpa.launches.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulation_streams_and_unscaled(dtype):
    """A plan of 32 rows at once, so every chunk past it streams (pieces in
    both halves, the running state rescaled between them; on the
    tensor-core path tiles of 16), and ``scale_attn=False`` in fp32: the
    emulation still meets the plain version."""
    hd, W, B = 64, 2, 8
    _, tpool, tables = _pools(7, dtype, 16, B, hd)
    tt = torch.from_numpy(tables)
    q = torch.from_numpy(np.random.default_rng(8).standard_normal((B, W, H, hd)).astype(
        np.float32)).to(dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpa, "ONLINE_MAX_ROWS", 32)
        assert tpa.online_sm90_plan(S, hd, tpool["k"].element_size())[2] == 32
        tl = torch.from_numpy(_lengths(W, tpool, hd))
        # unscaled in fp32 only: the plain version rounds the score to bf16 before its softmax,
        # and unscaled scores reach ~30 (a bf16 ulp of 0.125 there moves p by 12%)
        for scale_attn in (True, False) if dtype == torch.float32 else (True,):
            got = emulate(q, tpool, tt, tl, 0, scale_attn=scale_attn)
            ref = tpa.paged_attention_reference(q, tpool, tt, tl, 0, scale_attn=scale_attn)
            assert (got.float() - ref.float()).abs().max().item() <= TOL[dtype]


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


def _meta_operands(B=3, W=2, dtype=torch.bfloat16, kv_bits=16, hd=64):
    q = torch.empty((B, W, H, hd), dtype=dtype, device="meta")
    pool = {"k": torch.empty((2, 9, BS, H, hd), dtype=torch.int8 if kv_bits == 8 else dtype,
                             device="meta")}
    pool["v"] = torch.empty_like(pool["k"])
    if kv_bits == 8:
        pool["k_scale"] = torch.empty((2, 9, BS, H, 2), device="meta")
        pool["v_scale"] = torch.empty_like(pool["k_scale"])
    tables = torch.empty((B, 4), dtype=torch.int32, device="meta")
    lengths = torch.empty((B,), dtype=torch.int32, device="meta")
    return q, pool, tables, lengths


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_auto_and_online_route_to_the_cluster_kernel(monkeypatch, kv_bits, hd):
    """``auto`` and ``online`` launch ``paged_attention_online_sm90`` and
    count one launch each; the first design launches only by name; every
    call hands the C entry its 20 arguments and the stream."""
    assert tpa.KERNELS["online"] == SM90 and tpa.TEMPLATES["online"] == TEMPLATE
    assert tpa.resolve_mode("auto") == "online"
    assert set(tpa.launches) == {SM90, TEMPLATE, *tpa.KERNELS.values(), *tpa.TEMPLATES.values()}
    calls = _fake_entry(monkeypatch)
    q, pool, tables, lengths = _meta_operands(kv_bits=kv_bits, hd=hd)
    tpa.reset_launches()
    out = tpa.paged_attention(q, pool, tables, lengths, 1)
    assert out.shape == (3, 2, H * hd) and out.dtype == q.dtype
    tpa.paged_attention(q, pool, tables, lengths, 1, mode="online")
    tpa.paged_attention_online_template(q, pool, tables, lengths, 0)
    assert [n for n, _ in calls] == [SM90, SM90, TEMPLATE]
    assert tpa.launches == {SM90: 2, TEMPLATE: 1, tpa.KERNELS["exact"]: 0,
                            tpa.TEMPLATES["exact"]: 0}
    for _, args in calls:
        assert len(args) == 21
        assert args[:3] == (1, int(kv_bits == 8), hd)
        assert args[11:18] == (3, 2, H, BS, 4, 9, 2 if kv_bits == 8 else 1)
        assert args[19] == pytest.approx(1 / np.sqrt(hd))
    tpa.reset_launches()


def test_the_cluster_kernel_refuses_what_it_does_not_take(monkeypatch):
    """The operand checks run before any launch: a window past 8, a head
    dim without a kernel, a view that does not start 16-byte aligned, a
    16-bit pool in another dtype."""
    _fake_entry(monkeypatch)
    q, pool, tables, lengths = _meta_operands(W=9)
    with pytest.raises(ValueError, match="window"):
        tpa.paged_attention(q, pool, tables, lengths, 0)
    q = torch.zeros((3, 1, H, 32))
    pool32 = {n: torch.zeros((2, 9, BS, H, 32)) for n in ("k", "v")}
    with pytest.raises(ValueError, match="head_dim"):
        tpa._launch(SM90, q, pool32, torch.zeros((3, 4), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32), 0, True)
    flat = torch.zeros(3 * H * 64 + 2)[2:]               # 8 bytes past an aligned start
    pool64 = {n: torch.zeros((2, 9, BS, H, 64)) for n in ("k", "v")}
    with pytest.raises(ValueError, match="16-byte"):
        tpa._launch(SM90, flat.view(3, 1, H, 64), pool64, torch.zeros((3, 4), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32), 0, True)
    with pytest.raises(ValueError, match="16-bit pool"):
        tpa._launch(SM90, torch.zeros((3, 1, H, 64), dtype=torch.bfloat16), pool64,
                    torch.zeros((3, 4), dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                    0, True)
    assert all(n == 0 for n in tpa.launches.values())


@pytest.mark.parametrize("mode", ["auto", "online"])
def test_online_route_without_nvcc_raises(monkeypatch, mode):
    """With no nvcc the online route raises and counts no launch: nothing
    falls back to the first design or to the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    q, pool, tables, lengths = _meta_operands()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tpa.paged_attention(q, pool, tables, lengths, 0, mode=mode)
    assert all(n == 0 for n in tpa.launches.values())


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
def test_cluster_kernel_matches_its_plain_version_on_the_card():
    """``paged_attention_online_sm90`` against the plain version on a CUDA
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
                lens = lengths.clamp(max=1024 - W)
                before = tpa.launches[SM90]
                out = tpa.paged_attention(q, pool, tables, lens, 1)
                assert tpa.launches[SM90] == before + 1
                ref = tpa.paged_attention_reference(q, pool, tables, lens, 1)
                assert (out.float() - ref.float()).abs().max().item() <= TOL[torch.bfloat16]
