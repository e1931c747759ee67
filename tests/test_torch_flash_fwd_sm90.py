"""The dense bf16 flash forward for Hopper, ``flash_fwd_sm90``
(deepspeed_tpu_torch/csrc/flash_attention_fwd_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 2, 5, 6, 13 and
14, and the ``cuda``-marked test below).  Here: its schedule, emulated in
Python by ``flash_fwd_sm90_schedule`` exactly as the kernel computes it,
held against the causal (or full) live set; the route that sends bf16
tensors at head dims 64 and 128 to it, on meta tensors standing for CUDA
ones; and the plain version it is held against on the card, against the
JAX package's ``flash_attention`` (Pallas in interpret mode, fp32) at the
new tile edges.  Tolerance there: 2e-5 (O and lse of magnitude ~1, the same
fp32 formula summed in another order)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer.flash_attention import (
    flash_attention as jax_flash, flash_attention_with_lse as jax_flash_lse)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

FWD_TOL = 2e-5


# ------------------------------------------------------------- schedule
def _tile_stats(T, causal, block_n):
    """Per (64-row half of a 128-row q tile, k tile): whether any and
    whether all of its (q, k) pairs with q < T are live."""
    nq, nk = -(-T // fa.SM90_BLOCK_Q), -(-T // block_n)
    rows, cols = nq * fa.SM90_BLOCK_Q, nk * block_n
    q = np.arange(rows)[:, None]
    k = np.arange(cols)[None, :]
    live = (k < T) & ((q >= k) if causal else (q >= 0))
    real = np.broadcast_to(q < T, live.shape)
    halves = lambda x: x.reshape(rows // 64, 64, nk, block_n)
    any_live = halves(live & real).any(axis=(1, 3))
    all_live = halves(live | ~real).all(axis=(1, 3))
    return any_live, all_live


@pytest.mark.parametrize("block_n", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [64, 100, 127, 128, 129, 1000, 1024, 1088, 8192])
def test_schedule_covers_the_live_set(T, causal, block_n):
    """The kernel's schedule: q tiles of 128 rows, longest causal rows
    first; each visits k tiles from its last down to 0; a skipped tile is
    wholly dead for both halves, an unmasked tile wholly live for its half,
    and a masked one is not wholly live (so the mask is taken only where it
    changes something)."""
    sched = fa.flash_fwd_sm90_schedule(T, causal, block_n)
    any_live, all_live = _tile_stats(T, causal, block_n)
    nq, nk = -(-T // 128), -(-T // block_n)
    assert [q0 for q0, _ in sched] == [128 * (nq - 1 - y) for y in range(nq)]
    visits = [len(tiles) for _, tiles in sched]
    assert visits == sorted(visits, reverse=True)            # longest first
    if not causal:
        assert visits == [nk] * nq
    for q0, tiles in sched:
        ks = [k0 for k0, _ in tiles]
        assert ks == [block_n * j for j in range(len(ks) - 1, -1, -1)]   # last tile first
        for half in range(2):
            hq = q0 // 64 + half
            for j in range(nk):
                if block_n * j not in ks:
                    assert not any_live[hq, j], (q0, half, j)
            for k0, masked in tiles:
                j = k0 // block_n
                if hq * 64 >= T:
                    continue                                  # rows past T: not stored
                assert masked[half] != all_live[hq, j], (q0, half, k0, masked)


@pytest.mark.parametrize("B,H,T", [(8, 16, 1024), (1, 8, 8192), (1, 16, 8192), (2, 4, 300),
                                   (1, 1, 64)])
def test_persistent_blocks_take_every_item_once_and_balance(B, H, T):
    """The persistent grid (one block per SM of an H100) takes every work
    item exactly once, each block in rising item order; where every block
    takes two items or more, the snake order keeps each block's causal k
    tiles within a quarter of the longest item of the mean (round-robin
    leaves block 0 ahead at every round: 32 tiles over the mean at T=8192,
    where a quarter of the longest item is 16)."""
    nq = -(-T // 128)
    n_work = nq * B * H
    blocks = fa.flash_fwd_sm90_blocks(n_work, 132)
    assert len(blocks) == min(132, n_work)
    assert sorted(w for items in blocks for w in items) == list(range(n_work))
    assert all(items == sorted(items) for items in blocks)
    visits = {q0: len(tiles) for q0, tiles in fa.flash_fwd_sm90_schedule(T, True)}
    tiles = [sum(visits[(nq - 1 - w // (B * H)) * 128] for w in items) for items in blocks]
    if n_work >= 2 * 132:
        assert max(tiles) - sum(tiles) / len(tiles) <= nq / 4


# ------------------------------------------------------------- routing
def _names(monkeypatch):
    names = []
    monkeypatch.setattr(fa, "_run", lambda name, *a, device: names.append(name))
    return names


@pytest.mark.parametrize("dtype,d,fwd", [
    (torch.bfloat16, 64, "flash_fwd_sm90"),
    (torch.bfloat16, 128, "flash_fwd_sm90"),
    (torch.bfloat16, 96, "flash_fwd"),
    (torch.float32, 64, "flash_fwd"),
    (torch.float32, 96, "flash_fwd"),
    (torch.float32, 128, "flash_fwd"),
])
def test_dense_forward_routes_by_dtype_and_head_dim(monkeypatch, dtype, d, fwd):
    """bf16 at head dims 64 and 128 takes flash_fwd_sm90, everything else
    the template flash_fwd; flash_attention(...).sum().backward() and
    flash_attention_with_lse still reach both backward kernels (bf16 at head
    dim 64 the sm90 ones, the rest the templates)."""
    names = _names(monkeypatch)
    assert fa.dense_fwd_kernel(dtype, d) == fwd
    bwd = (["flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"] if (dtype, d) == (torch.bfloat16, 64)
           else ["flash_bwd_dkdv", "flash_bwd_dq"])
    q, k, v = (torch.empty((2, 256, 4, d), dtype=dtype, device="meta", requires_grad=True)
               for _ in range(3))
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert names == [fwd, *bwd]
    names.clear()
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=False)
    (o.sum() + lse.sum()).backward()
    assert names == [fwd, *bwd]
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.parametrize("d", [64, 128])
def test_new_route_builds_the_kernel_or_raises(monkeypatch, d):
    """With no nvcc the flash_fwd_sm90 route raises and counts no launch:
    nothing falls back to the template or the plain version."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    q = torch.empty((2, 64, 4, d), dtype=torch.bfloat16, device="meta")
    for call in (fa.flash_fwd, fa.flash_fwd_sm90):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call(q, q, q)
    assert fa.launches == {name: 0 for name in fa.KERNELS}


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 96),
                                     (torch.float16, 96)])
def test_sm90_wrapper_refuses_what_it_was_not_built_for(dtype, d):
    q = torch.empty((2, 64, 4, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="dtype|head dim"):
        fa.flash_fwd_sm90(q, q, q)


def test_sm90_wrapper_raises_on_unaligned_rows():
    """TMA needs 16-byte aligned rows: a view whose t stride is 8 bytes off
    is refused, never copied."""
    B, T, H, d = 2, 64, 4, 64
    row = H * d + 4                                  # 8 bytes past a 16-byte multiple
    q = torch.empty(B * T * row, dtype=torch.bfloat16, device="meta").as_strided(
        (B, T, H, d), (T * row, row, d, 1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(q, q, q)


# ------------------------------------------------------------- JAX parity
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T", [127, 129, 1088])
def test_forward_and_lse_match_jax_at_the_new_tile_edges(T, d, causal):
    """The plain version the kernel is held against, through both dense
    wrappers, against the Pallas kernels (interpret mode, fp32) at T one
    short of, one past and a ragged multiple of 64 beyond the 128-row
    tiles."""
    rng = np.random.default_rng(T + d)
    q, k, v = (rng.standard_normal((1, T, 2, d)).astype(np.float32) for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jo, jlse = jax_flash_lse(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    jo_plain = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for call in (fa.flash_fwd, fa.flash_fwd_sm90):
        o, lse = call(tq, tk, tv, causal)
        assert o.shape == (1, T, 2, d) and lse.shape == (1, 2, T)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=FWD_TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo_plain), rtol=0, atol=FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0, atol=FWD_TOL)
    assert fa.launches == {name: 0 for name in fa.KERNELS}   # no kernel on the CPU


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_sm90_kernel_matches_its_plain_version_on_the_card():
    """flash_fwd_sm90 (O and lse) against the plain version on a CUDA card,
    through the route (``chip_smoke.py`` phase 2 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (64, 128):
        for T, causal in ((64, True), (200, True), (1088, False)):
            qkv = torch.randn((2, T, 3 * 4 * d), generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = (t.view(2, T, 4, d) for t in qkv.split(4 * d, dim=-1))
            before = fa.launches["flash_fwd_sm90"]
            o, lse = fa.flash_fwd(q, k, v, causal)
            assert fa.launches["flash_fwd_sm90"] == before + 1
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal)
            err = (o.float() - ro.float()).abs()
            assert (err <= 2 ** -5 * ro.float().pow(2).mean().sqrt()
                    + 2 ** -7 * ro.float().abs()).all()
            assert (lse - rlse).abs().max().item() <= 1e-4
