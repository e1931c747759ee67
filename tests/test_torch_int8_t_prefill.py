"""The tied head's int8 product at prefill for Hopper, ``int8_mm_t_prefill``
(deepspeed_tpu_torch/csrc/int8_matmul_prefill_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 10-12,
``examples/int8_prefill_check.py --layout t`` and the ``cuda``-marked test
below).  Here:

- its schedule (``int8_t_prefill_plan`` and ``int8_t_prefill_blocks``, the
  kernel's tiles, splits and block order in Python) covers every (output
  tile, k box) exactly once, each tile's splits in k order, at GPT-2 125M's
  and 1.3B's head (N = 50257: an 81-row tail at 128), a K that is a
  multiple of 16 but not of the 64-wide box, M 17/64/256/272/333/512 and
  every built token tile;
- a numpy emulation of the kernel, lane by lane as the source computes it
  (the q box under TMA's 64-byte swizzle and the x box under the 128-byte
  one, each lane's four 16-bit reads of its rows g and g + 8, the byte
  permute and the bf16x2 widening, the
  register-A fragments of warpgroup T's m64 product over weight rows
  64 T .. 64 T + 63, x read through the K-major B descriptor (one
  m64n136 or m64n256 product a k step), the accumulator layout, split partials summed in
  split order by whichever block counts in last, the epilogue's
  per-channel scale and one-element stores on rows of odd length),
  reproduces ``(x @ q.T) * scale`` exactly on small integers, every int8
  value included;
- ``int8_t_kernel`` routes through ``int8_matmul`` on meta tensors
  (standing for CUDA ones) with the launch replaced by a recorder, and the
  host side hands the kernel the arguments its C entry takes;
- with no nvcc the route raises and counts nothing;
- the plain version it is held against on the card agrees with JAX's
  ``int8_matmul(w_transposed=True)`` (XLA branch) and with ``_kernel_t``
  through ``pl.pallas_call(interpret=True)`` at M 17/64/333, per-tensor and
  per-channel scales, fp32: within 1e-5 of the largest |value| + 1e-6
  (exact bf16 x int8 products summed in fp32 in another order).
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deepspeed_tpu.ops.transformer import int8_matmul as jim
from deepspeed_tpu_torch.ops.transformer import int8_matmul as tim
from int8_fragments import byte_perm, widen_permuted

BN, BK = tim.T_PREFILL_BN, tim.T_PREFILL_BK
HEAD_SHAPES = [(768, 50257), (2048, 50257)]          # (K, N) of GPT-2 125M's and 1.3B's wte
T_PREFILL_M = (17, 64, 256, 272, 333, 512)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("K,N", HEAD_SHAPES + [(784, 50257), (2048, 300), (16, 1), (4096, 1000)])
@pytest.mark.parametrize("M", T_PREFILL_M)
@pytest.mark.parametrize("tile", tim.T_PREFILL_TILES)
def test_plan_covers_every_tile_and_k_box_once(M, K, N, tile):
    sms = 132
    tm, mt, nt, kb, splits, per = tim.int8_t_prefill_plan(M, N, K, sms, tile)
    assert tm == tile and (mt, nt, kb) == (-(-M // tm), -(-N // BN), -(-K // BK))
    tiles = mt * nt
    # split-K only while the tiles number fewer than the SMs (one block an SM), 4 boxes a split
    assert splits == 1 or (tiles * splits <= sms and per >= tim.PREFILL_MIN_BOXES)
    assert (splits - 1) * per < kb <= splits * per       # none empty
    blocks = tim.int8_t_prefill_blocks(M, N, K, tm, splits, per)
    assert len(blocks) == tiles * splits
    hits = np.zeros((mt, nt, kb), np.int32)
    for b, (tile, mi, ni, split, k_lo, k_hi) in enumerate(blocks):
        assert (tile, split) == (b // splits, b % splits)
        assert tile == ni * mt + mi and 0 <= mi < mt and 0 <= ni < nt
        assert (k_lo, k_hi) == (split * per, min(kb, split * per + per)) and k_lo < k_hi
        hits[mi, ni, k_lo:k_hi] += 1
        if split:                                         # splits in k order, adjacent
            prev = blocks[b - 1]
            assert prev[0] == tile and prev[3] == split - 1 and prev[5] == k_lo
        if mi:                                            # token tiles of one weight tile adjacent
            assert blocks[b - splits][1:3] == (mi - 1, ni)
    assert (hits == 1).all()


def test_token_tile_pads_the_least():
    """The built tile that pads M the least, the wider on a tie; every head
    prefill of the serving traffic's M fills the card without a split."""
    for M in range(17, 1025):
        tm = tim.int8_t_tile(M)
        padded = -(-M // tm) * tm
        assert all(padded < -(-M // o) * o or (padded == -(-M // o) * o and tm >= o)
                   for o in tim.T_PREFILL_TILES)
    assert [tim.int8_t_tile(M) for M in (17, 136, 137, 256, 272, 333, 512)] == [
        136, 136, 256, 256, 136, 136, 256]
    for M in (32, 256, 272, 512):
        for K in (768, 2048):
            assert tim.int8_t_prefill_plan(M, 50257, K, 132)[4] == 1


# ------------------------------------------------- the kernel, emulated
def _q_box(q, n0, k0):
    """The int8 q box at (k0, row n0): 128 rows of 64 bytes, zero past N and
    K, under TMA's 64-byte swizzle (16-byte chunk c of row r at chunk
    c ^ ((r >> 1) % 4)); flat bytes."""
    box = np.zeros((BN, BK), np.uint8)
    part = q[n0:n0 + BN, k0:k0 + BK].view(np.uint8)
    box[:part.shape[0], :part.shape[1]] = part
    r = np.arange(BN)[:, None]
    e = np.arange(BK)[None, :]
    smem = np.zeros(BN * BK, np.uint8)
    smem[r * BK + (((e // 16) ^ ((r >> 1) & 3)) * 16) + e % 16] = box
    return smem


def _x_box(x, k0, m0, tm):
    """The x box at (k0, token m0): tm rows of 64 bf16 values, zero past M
    and K, under the 128-byte swizzle; flat, in bf16 elements."""
    box = np.zeros((tm, BK))
    part = x[m0:m0 + tm, k0:k0 + BK]
    box[:part.shape[0], :part.shape[1]] = part
    r = np.arange(tm)[:, None]
    e = np.arange(BK)[None, :]
    smem = np.zeros(tm * BK)
    smem[r * BK + (((e // 8) ^ (r & 7)) * 8) + e % 8] = box
    return smem


def _b_operand(xsmem, ks, tm):
    """wgmma's B (16 x tm tokens) as ``desc_sw128(xbox + 32 ks, 16, 1024)``
    reads it: element (k, j) at byte 32 ks + 1024 (j / 8) + 128 (j % 8) +
    2 k of a 1024-aligned box, the address's bits 4-6 XORed with its bits
    7-9."""
    k = np.arange(16)[:, None]
    j = np.arange(tm)[None, :]
    addr = 32 * ks + 1024 * (j // 8) + 128 * (j % 8) + 2 * k
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return xsmem[addr // 2]


def _emulate(x, q, scale, sms, tile, order_seed=0):
    """int8_mm_t_prefill as the source computes it, every block and lane,
    the blocks run one after another in a shuffled order (any block of a
    split tile may count in last).  Returns the (M, N) output, each element
    stored once."""
    M, K = x.shape
    N = q.shape[0]
    tm, mt, nt, kb, splits, per = tim.int8_t_prefill_plan(M, N, K, sms, tile)
    blocks = tim.int8_t_prefill_blocks(M, N, K, tm, splits, per)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    per_channel = scale.size > 1
    out = np.full((M, N), np.nan)
    ws, counts = {}, np.zeros(mt * nt, np.int64)

    def store(m0, n0, acc):                  # store_t_tile: acc[T][warp][lane][element]
        for T in range(2):
            for w in range(4):
                c = n0 + 64 * T + 16 * w + g
                for r in range(2):
                    live = c + 8 * r < N
                    sc = (np.where(live, scale[np.minimum(c + 8 * r, N - 1)], 0.0)
                          if per_channel else np.full(32, scale[0]))
                    for j in range(tm // 8):
                        for e in range(2):
                            m = m0 + 8 * j + 2 * t + e
                            for ln in np.nonzero((m < M) & live)[0]:
                                assert np.isnan(out[m[ln], c[ln] + 8 * r])   # stored once
                                out[m[ln], c[ln] + 8 * r] = acc[T, w, ln, 4 * j + 2 * r + e] * sc[ln]

    order = np.random.default_rng(order_seed).permutation(len(blocks))
    for b in order:
        tile, mi, ni, split, k_lo, k_hi = blocks[b]
        m0, n0 = mi * tm, ni * BN
        D = np.zeros((2, 64, tm))           # warpgroup T's m64 x n tm product
        for kbox in range(k_lo, k_hi):
            qsmem = _q_box(q, n0, kbox * BK)
            xsmem = _x_box(x, kbox * BK, m0, tm)
            for ks in range(BK // 16):
                A = np.zeros((2, 64, 16))
                for T in range(2):
                    for w in range(4):
                        wbase = (64 * T + 16 * w + g) * BK + 2 * t
                        chunk = wbase + ((ks << 4) ^ ((g >> 1) << 4))
                        a = []
                        for off in (0, 8 * BK, 8, 8 * BK + 8):     # a[0] .. a[3]
                            pair = qsmem[(chunk + off)[:, None] + np.arange(2)].copy()
                            word = pair.view(np.uint16).reshape(32).astype(np.uint32)
                            a.append(widen_permuted(byte_perm(word, word, 0x0100)))
                        for e in range(2):   # the m16n8k16 A layout, warp w's rows
                            A[T, 16 * w + g, 2 * t + e] = a[0][e]
                            A[T, 16 * w + g + 8, 2 * t + e] = a[1][e]
                            A[T, 16 * w + g, 2 * t + 8 + e] = a[2][e]
                            A[T, 16 * w + g + 8, 2 * t + 8 + e] = a[3][e]
                D += A @ _b_operand(xsmem, ks, tm)
        # the accumulator layout: element 4 j + 2 r + e of warp w of warpgroup T, lane
        # 4 g + t is row 16 w + g + 8 r, token 8 j + 2 t + e of product T
        acc = np.zeros((2, 4, 32, tm // 2))
        for w in range(4):
            for j in range(tm // 8):
                for r in range(2):
                    for e in range(2):
                        acc[:, w, :, 4 * j + 2 * r + e] = D[:, 16 * w + g + 8 * r, 8 * j + 2 * t + e]
        if splits == 1:
            store(m0, n0, acc)
            continue
        ws[(tile, split)] = acc
        counts[tile] += 1                    # counted in
        if counts[tile] != splits:
            continue
        total = np.zeros_like(acc)           # counted last: the sum in split order
        for sp in range(splits):
            total = total + ws[(tile, sp)]
        store(m0, n0, total)
        counts[tile] = 0
    assert not counts.any()
    return out


@pytest.mark.parametrize("M,K,N,sms,tile,channel", [
    (17, 192, 257, 4, 136, True),        # one token tile, a 1-row tail past 256
    (17, 512, 300, 8, 136, False),       # split 2 ways, odd N
    (140, 64, 131, 1, 136, False),       # two token tiles, one k box
    (300, 1008, 128, 4, 256, True),      # split 2 ways, K % 64 = 48
])
def test_fragment_mapping_reproduces_the_product(M, K, N, sms, tile, channel):
    """Small integers (exact in bf16 and in the sums): the emulated kernel
    gives exactly (x @ q.T) * scale, each output stored once; the cases
    cover whole and split tiles, N, K and M tails, both built token tiles,
    both scale kinds and every int8 value."""
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.integers(-8, 9, (M, K)).astype(np.float64)
    q = rng.integers(-128, 128, (N, K)).astype(np.int8)
    q.flat[:256] = np.arange(-128, 128)
    scale = (rng.integers(1, 9, (N if channel else 1,)) / 8).astype(np.float64)
    splits = tim.int8_t_prefill_plan(M, N, K, sms, tile)[4]
    assert splits == {17: 1 if K == 192 else 2, 140: 1, 300: 2}[M]
    got = _emulate(x, q, scale, sms, tile, order_seed=M)
    np.testing.assert_array_equal(got, (x @ q.astype(np.float64).T) * scale[None, :])


# ------------------------------------------------------------- routes
class _Launched(Exception):
    pass


def _route(monkeypatch, M, N, K=256, misaligned=False, tiled=False):
    """The kernel ``int8_matmul`` (or ``int8_matmul_tiled``) would launch for
    an (N, K) weight on meta tensors (standing for CUDA ones): ``_entry``
    records the name and stops before the launch."""
    names = []

    def entry(name):
        names.append(name)
        raise _Launched

    monkeypatch.setattr(tim, "_entry", entry)
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    if misaligned:       # a view one byte into its storage
        q = torch.empty(K * N + 1, dtype=torch.int8, device="meta")[1:].view(N, K)
    else:
        q = torch.empty((N, K), dtype=torch.int8, device="meta")
    fn = tim.int8_matmul_tiled if tiled else tim.int8_matmul
    with pytest.raises(_Launched):
        fn(x, q, torch.ones(N, device="meta"), w_transposed=True, out_dtype=torch.float32)
    return names


@pytest.mark.parametrize("case,kwargs,want", [
    ("head M=8", dict(M=8, N=50257, K=2048), "int8_mm_t"),
    ("head M=16", dict(M=16, N=50257, K=768), "int8_mm_t"),
    ("head M=17", dict(M=17, N=50257, K=2048), "int8_mm_t_prefill"),
    ("head M=272", dict(M=272, N=50257, K=2048), "int8_mm_t_prefill"),
    ("head M=512", dict(M=512, N=50257, K=768), "int8_mm_t_prefill"),
    ("misaligned q", dict(M=512, N=50257, misaligned=True), "int8_mm_t"),
    ("K%16", dict(M=272, N=300, K=200), "int8_mm_t"),
    ("K=8", dict(M=272, N=300, K=8), "int8_mm_t"),
    ("tiled M=512", dict(M=512, N=50257, tiled=True), "int8_mm_t"),
])
def test_routes(monkeypatch, case, kwargs, want):
    tim.reset_launches()
    assert _route(monkeypatch, **kwargs) == [want]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


def test_route_function():
    assert tim.int8_t_kernel(17, 50257, 2048, True) == "int8_mm_t_prefill"
    assert tim.int8_t_kernel(16, 50257, 2048, True) == "int8_mm_t"
    assert tim.int8_t_kernel(512, 50257, 2048, False) == "int8_mm_t"
    assert tim.int8_t_kernel(512, 50257, 2040, True) == "int8_mm_t"
    assert tim.int8_t_kernel(512, 1, 16, True) == "int8_mm_t_prefill"
    assert tim.int8_t_kernel(512, 0, 16, True) == "int8_mm_t"
    # 2^31 (output tile, k box) pairs or more: past the kernel's 32-bit block index
    assert tim.int8_t_kernel(136 * 2 ** 10, 2 ** 18, 2 ** 16, True) == "int8_mm_t"
    assert tim.int8_t_kernel(136 * 2 ** 10, 2 ** 18, 2 ** 16 - 64, True) == "int8_mm_t_prefill"


@pytest.mark.parametrize("M,K,N,x_offset,channel", [(512, 2048, 50257, 0, True),
                                                    (272, 768, 50257, 0, False),
                                                    (33, 784, 300, 0, True),
                                                    (64, 2048, 300, 1, False)])
def test_launch_arguments(monkeypatch, M, K, N, x_offset, channel):
    """What ``_launch_t_prefill`` hands the C entry, on meta tensors with the
    entry replaced: x's rows padded to a multiple of 8 (or copied when not
    16-byte aligned), the scale kind, the plan's token tile and splits, a
    workspace and counters only for split tiles; one launch counted per
    call; a refused launch raises and counts nothing."""
    calls = []

    def fake(*args):
        calls.append(args)
        return rc[0]

    rc = [0]
    monkeypatch.setattr(tim, "_entry", lambda name: fake)
    monkeypatch.setattr(tim, "_sm_count", lambda device: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=7))
    tim.reset_launches()
    x = torch.empty(M * K + x_offset, dtype=torch.bfloat16, device="meta")[x_offset:].view(M, K)
    q = torch.empty((N, K), dtype=torch.int8, device="meta")
    scale = torch.ones(N if channel else 1, device="meta")
    out = tim.int8_matmul(x, q, scale, w_transposed=True, out_dtype=torch.float32)
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert tim.launches["int8_mm_t_prefill"] == 1 and sum(tim.launches.values()) == 1
    ((xp, qp, sp, per_channel, op, code, ws, counters, m, n, k, ldx, tm, splits, per,
      stream),) = calls
    want_tm, mt, nt, _, want_splits, want_per = tim.int8_t_prefill_plan(M, N, K, 132)
    assert (m, n, k, tm, splits, per, code, stream) == (M, N, K, want_tm, want_splits,
                                                        want_per, 0, 7)
    assert per_channel == int(channel) and tm in tim.T_PREFILL_TILES
    assert ldx == -(-K // 8) * 8 and xp % 16 == 0
    # a null pointer for whole tiles
    assert (splits == 1) == isinstance(ws, tim.ctypes.c_void_p) == isinstance(
        counters, tim.ctypes.c_void_p)
    rc[0] = -1
    with pytest.raises(RuntimeError, match="unsupported configuration"):
        tim.int8_matmul(x, q, scale, w_transposed=True)
    assert tim.launches["int8_mm_t_prefill"] == 1


def test_t_prefill_route_without_nvcc_raises(monkeypatch):
    """The route builds its library or raises: no fallback to ``int8_mm_t``
    or the plain version, and no launch counted."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    built = []
    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path",
                        lambda name: built.append(name) or builder.BUILD_DIR / "absent.so")
    tim.reset_launches()
    x = torch.empty((272, 2048), dtype=torch.bfloat16, device="meta")
    q = torch.empty((50257, 2048), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tim.int8_matmul(x, q, torch.ones(50257, device="meta"), w_transposed=True)
    assert built == ["int8_matmul_prefill_sm90"]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


# ------------------------------------------------- plain vs JAX at prefill
def _inputs(M, K, N, seed, channel):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (N, K)).astype(np.int8)
    scale = (rng.random(N if channel else 1) * 0.02 + 0.005).astype(np.float32)
    return x, q, scale


def _assert_close(got, want):
    """fp32: within 1e-5 of the largest |value| + 1e-6 (the same exact
    products summed in another order)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    limit = 1e-5 * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("M", [17, 64, 333])
@pytest.mark.parametrize("channel", [False, True])
def test_plain_matches_jax_xla_branch(M, channel):
    K, N = 256, 300
    x, q, scale = _inputs(M, K, N, seed=M, channel=channel)
    got = tim.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale),
                          w_transposed=True, out_dtype=torch.float32).numpy()
    want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                      w_transposed=True, out_dtype=jnp.float32))
    _assert_close(got, want)


@pytest.mark.parametrize("M", [17, 64, 333])
@pytest.mark.parametrize("channel", [False, True])
def test_plain_matches_pallas_kernel_t(M, channel):
    """``_kernel_t`` through ``pl.pallas_call(interpret=True)`` with
    ``_int8_mm_tpu``'s block specs (N a multiple of its 128-row blocks),
    scaled after it as ``int8_matmul`` does, against the plain version."""
    K, N, bn = 256, 384, 128
    x, q, scale = _inputs(M, K, N, seed=10 + M, channel=channel)
    acc = np.asarray(pl.pallas_call(
        jim._kernel_t, grid=(N // bn,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((bn, K), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((M, bn), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True,
    )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q)))
    got = tim.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(q),
                                    torch.from_numpy(scale), w_transposed=True).numpy()
    _assert_close(got, acc * scale[None, :])


@pytest.mark.cuda
def test_t_prefill_kernel_matches_its_plain_version_on_the_card():
    """``int8_mm_t_prefill`` against the plain version on a CUDA card, the
    head with per-channel scales, split tiles and tails included,
    bit-identical on a second call and launched once per call
    (``chip_smoke.py`` phase 10 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in ((272, 2048, 50257), (17, 784, 300), (512, 768, 50257), (333, 64, 131)):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randint(-128, 128, (N, K), generator=gen, device="cuda").to(torch.int8)
        scale = torch.rand((N,), generator=gen, device="cuda") * 1e-2
        for out_dtype in (torch.float32, torch.bfloat16):
            tim.reset_launches()
            got = tim.int8_matmul(x, q, scale, w_transposed=True, out_dtype=out_dtype)
            again = tim.int8_matmul(x, q, scale, w_transposed=True, out_dtype=out_dtype)
            assert tim.launches["int8_mm_t_prefill"] == 2
            ref = tim.int8_matmul_reference(x, q, scale, w_transposed=True, out_dtype=out_dtype)
            assert torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * max(1.0, ref.float().abs().max().item())
