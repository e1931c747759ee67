"""The prefill int8 product for Hopper, ``int8_mm_nt_prefill``
(deepspeed_tpu_torch/csrc/int8_matmul_prefill_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 10-12,
``examples/int8_prefill_check.py`` and the ``cuda``-marked test below).
Here:

- its schedule (``int8_prefill_plan`` and ``int8_prefill_blocks``, the
  kernel's tiles, splits and block order in Python) covers every (output
  tile, k box) exactly once, each tile's splits in k order, at GPT-2 125M's
  and 1.3B's block weight shapes, M 17/64/272/333/512, and N and K tails;
- a numpy emulation of the kernel, lane by lane as the source computes it
  (the TMA boxes under the 128-byte swizzle, each lane's four 32-bit words
  of the weight, read alike by both consumer warpgroups, the byte permutes
  and the bf16x2 widening, the register-A fragments of warpgroup T's m64
  product from column bytes 2T and 2T + 1, x read through the K-major B
  descriptor, the accumulator layout, split partials summed in split order
  by whichever block counts in last, the epilogue that undoes the column
  permutation), reproduces ``x @ q`` exactly on small integers, every int8
  value included;
- ``int8_nt_kernel`` routes through ``int8_matmul`` on meta tensors
  (standing for CUDA ones) with the launch replaced by a recorder, and the
  host side hands the kernel the arguments its C entry takes;
- with no nvcc the route raises and counts nothing;
- the plain version it is held against on the card agrees with JAX's
  ``int8_matmul`` (XLA branch) and with ``_kernel_nt`` through
  ``pl.pallas_call(interpret=True)`` at M 17/64/333, fp32: within 1e-5 of
  the largest |value| + 1e-6 (exact bf16 x int8 products summed in fp32 in
  another order).
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
from int8_fragments import widen2

BM, BN, BK = tim.PREFILL_BM, tim.PREFILL_BN, tim.PREFILL_BK
GPT2_SHAPES = [(K, N) for D in (768, 2048)
               for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D))]
PREFILL_M = (17, 64, 272, 333, 512)


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("K,N", GPT2_SHAPES + [(2050, 6160), (100, 208), (1, 16), (8192, 2064)])
@pytest.mark.parametrize("M", PREFILL_M)
def test_plan_covers_every_tile_and_k_box_once(M, K, N):
    sms = 132
    mt, nt, kb, splits, per = tim.int8_prefill_plan(M, N, K, sms)
    assert (mt, nt, kb) == (-(-M // BM), -(-N // BN), -(-K // BK))
    tiles = mt * nt
    # split-K only while the tiles fill fewer than two blocks an SM, at least 4 boxes a split
    assert splits == 1 or (tiles * splits <= tim.PREFILL_BLOCKS_PER_SM * sms
                           and per >= tim.PREFILL_MIN_BOXES)
    assert (splits - 1) * per < kb <= splits * per       # none empty
    blocks = tim.int8_prefill_blocks(M, N, K, splits, per)
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
    assert (hits == 1).all()


def test_plan_at_gpt2_1p3b():
    """The four 1.3B block shapes on an H100 (132 SMs): qkv and fc fill the
    card with whole tiles at M = 512; proj and fc_proj split 4 ways (5 at
    M = 272)."""
    want = {(512, 6144, 2048): (4, 48, 32, 1, 32), (512, 2048, 2048): (4, 16, 32, 4, 8),
            (512, 8192, 2048): (4, 64, 32, 1, 32), (512, 2048, 8192): (4, 16, 128, 4, 32),
            (272, 6144, 2048): (3, 48, 32, 1, 32), (272, 2048, 2048): (3, 16, 32, 5, 7),
            (272, 8192, 2048): (3, 64, 32, 1, 32), (272, 2048, 8192): (3, 16, 128, 5, 26)}
    for (M, N, K), plan in want.items():
        assert tim.int8_prefill_plan(M, N, K, 132) == plan


# ------------------------------------------------- the kernel, emulated
def _swizzle(rows, unit):
    """Where TMA's 128-byte swizzle puts a box of 128-byte rows (``unit``
    bytes an element): 16-byte chunk c of row r at chunk c ^ (r % 8).
    Returns the flat index, in elements, of (row, element)."""
    per_chunk = 16 // unit
    r = np.arange(rows)[:, None]
    e = np.arange(128 // unit)[None, :]
    return r * (128 // unit) + (((e // per_chunk) ^ (r & 7)) * per_chunk) + e % per_chunk


def _tma_q_box(q, c0, k0):
    """The int8 weight box at (column c0, row k0): 64 rows of 128 bytes,
    zero past K and N, swizzled; flat bytes."""
    box = np.zeros((BK, BN), np.uint8)
    part = q[k0:k0 + BK, c0:c0 + BN].view(np.uint8)
    box[:part.shape[0], :part.shape[1]] = part
    smem = np.zeros(BK * BN, np.uint8)
    smem[_swizzle(BK, 1)] = box
    return smem


def _tma_x_box(x, k0, m0):
    """The x box at (column k0, row m0): 128 token rows of 64 bf16 values,
    zero past M and K, swizzled; flat, in bf16 elements."""
    box = np.zeros((BM, BK))
    part = x[m0:m0 + BM, k0:k0 + BK]
    box[:part.shape[0], :part.shape[1]] = part
    smem = np.zeros(BM * BK)
    smem[_swizzle(BM, 2)] = box
    return smem


def _b_operand(xsmem, ks):
    """wgmma's B (16 x 128) as the K-major 128-byte-swizzled descriptor
    ``desc_sw128(xbox + 32 ks, 16, 1024)`` reads it: element (k, n) at byte
    32 ks + 1024 (n / 8) + 128 (n % 8) + 2 k of a 1024-aligned box, the
    address's bits 4-6 XORed with its bits 7-9."""
    k = np.arange(16)[:, None]
    n = np.arange(BM)[None, :]
    addr = 32 * ks + 1024 * (n // 8) + 128 * (n % 8) + 2 * k
    addr = addr ^ (((addr >> 7) & 7) << 4)
    return xsmem[addr // 2]


def _emulate(x, q, sms, order_seed=0):
    """int8_mm_nt_prefill as the source computes it, every block and lane,
    the blocks run one after another in a shuffled order (any block of a
    split tile may count in last).  Returns the (M, N) output, each element
    stored once."""
    M, K = x.shape
    N = q.shape[1]
    mt, nt, kb, splits, per = tim.int8_prefill_plan(M, N, K, sms)
    blocks = tim.int8_prefill_blocks(M, N, K, splits, per)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    out = np.full((M, N), np.nan)
    ws, counts = {}, np.zeros(mt * nt, np.int64)

    def store(m0, n0, acc):                 # store_tile: acc[T][warp][lane][element]
        for T in range(2):                   # warpgroup T: columns c0 and c0 + 1 per (n, e)
            for w in range(4):
                c0 = n0 + 32 * w + 4 * g + 2 * T
                for n in range(BM // 8):
                    for e in range(2):
                        m = m0 + 8 * n + 2 * t + e
                        vals = [acc[T, w, :, 4 * n + e], acc[T, w, :, 4 * n + 2 + e]]
                        for lane in np.nonzero((m < M) & (c0 < N))[0]:
                            for r in range(2):
                                assert np.isnan(out[m[lane], c0[lane] + r])   # stored once
                                out[m[lane], c0[lane] + r] = vals[r][lane]

    order = np.random.default_rng(order_seed).permutation(len(blocks))
    for b in order:
        tile, mi, ni, split, k_lo, k_hi = blocks[b]
        m0, n0 = mi * BM, ni * BN
        D = np.zeros((2, 64, BM))            # warpgroup T's m64 x n128 product
        for kbox in range(k_lo, k_hi):
            qsmem = _tma_q_box(q, n0, kbox * BK)
            xsmem = _tma_x_box(x, kbox * BK, m0)
            for ks in range(BK // 16):
                A = np.zeros((2, 64, 16))
                for w in range(4):           # warp w of each warpgroup: the same words
                    words = []
                    for j in range(4):
                        r = 2 * t + (j & 1) + 8 * (j >> 1)
                        woff = r * BN + (((2 * w + (g >> 2)) ^ (r & 7)) << 4) + 4 * (g & 3)
                        addr = woff + 16 * ks * BN
                        words.append(qsmem[addr[:, None] + np.arange(4)].copy()
                                     .view(np.uint32).reshape(32))
                    for T in range(2):       # warpgroup T: column bytes 2T and 2T + 1
                        a = [widen2(2 * T, *words[:2]), widen2(2 * T + 1, *words[:2]),
                             widen2(2 * T, *words[2:]), widen2(2 * T + 1, *words[2:])]
                        for e in range(2):   # the m16n8k16 A fragment, warp w's rows
                            A[T, 16 * w + g, 2 * t + e] = a[0][e]
                            A[T, 16 * w + g + 8, 2 * t + e] = a[1][e]
                            A[T, 16 * w + g, 2 * t + 8 + e] = a[2][e]
                            A[T, 16 * w + g + 8, 2 * t + 8 + e] = a[3][e]
                B = _b_operand(xsmem, ks)
                D[0] += A[0] @ B
                D[1] += A[1] @ B
        # the accumulator layout: element 4 n + 2 r + e of warp w of warpgroup T, lane
        # 4 g + t is row 16 w + g + 8 r, column 8 n + 2 t + e of product T
        acc = np.zeros((2, 4, 32, 64))
        for w in range(4):
            for n in range(BM // 8):
                for r in range(2):
                    for e in range(2):
                        acc[:, w, :, 4 * n + 2 * r + e] = D[:, 16 * w + g + 8 * r, 8 * n + 2 * t + e]
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


@pytest.mark.parametrize("M,K,N,sms", [(17, 192, 256, 4), (17, 512, 128, 4),
                                       (200, 600, 272, 6), (130, 64, 144, 1),
                                       (300, 1000, 128, 4)])
def test_fragment_mapping_reproduces_the_product(M, K, N, sms):
    """Small integers (exact in bf16 and in the sums): the emulated kernel
    gives exactly x @ q, each output stored once; the cases cover whole and
    split tiles (2, 4 and 2 ways), N, K and M tails, one and three token
    tiles, every int8 value."""
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.integers(-8, 9, (M, K)).astype(np.float64)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    q.flat[:256] = np.arange(-128, 128)
    *_, splits, _ = tim.int8_prefill_plan(M, N, K, sms)
    assert splits == {(17, 192): 1, (17, 512): 2, (200, 600): 2, (130, 64): 1,
                      (300, 1000): 2}[(M, K)]
    got = _emulate(x, q, sms, order_seed=M)
    np.testing.assert_array_equal(got, x @ q.astype(np.float64))


# ------------------------------------------------------------- routes
class _Launched(Exception):
    pass


def _route(monkeypatch, M, N, K=256, misaligned=False, tiled=False):
    """The kernel ``int8_matmul`` (or ``int8_matmul_tiled``) would launch for
    meta tensors (standing for CUDA ones): ``_entry`` records the name and
    stops before the launch."""
    names = []

    def entry(name):
        names.append(name)
        raise _Launched

    monkeypatch.setattr(tim, "_entry", entry)
    x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
    if misaligned:       # a view one byte into its storage
        q = torch.empty(K * N + 1, dtype=torch.int8, device="meta")[1:].view(K, N)
    else:
        q = torch.empty((K, N), dtype=torch.int8, device="meta")
    fn = tim.int8_matmul_tiled if tiled else tim.int8_matmul
    with pytest.raises(_Launched):
        fn(x, q, torch.ones(1, device="meta"))
    return names


@pytest.mark.parametrize("case,kwargs,want", [
    ("M=17", dict(M=17, N=2048), "int8_mm_nt_prefill"),
    ("M=64", dict(M=64, N=6144, K=2048), "int8_mm_nt_prefill"),
    ("M=512", dict(M=512, N=2048, K=8192), "int8_mm_nt_prefill"),
    ("K%8", dict(M=64, N=2048, K=100), "int8_mm_nt_prefill"),      # x padded for its map
    ("N%16", dict(M=64, N=200), "int8_mm_nt"),
    ("misaligned q", dict(M=512, N=2048, misaligned=True), "int8_mm_nt"),
    ("M=16", dict(M=16, N=2048), "int8_mm_nt_decode"),
    ("tiled M=512", dict(M=512, N=6144, tiled=True), "int8_mm_nt"),
])
def test_routes(monkeypatch, case, kwargs, want):
    tim.reset_launches()
    assert _route(monkeypatch, **kwargs) == [want]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


def test_route_function():
    assert tim.int8_nt_kernel(17, 6144, 2048, True) == "int8_mm_nt_prefill"
    assert tim.int8_nt_kernel(512, 2048, 8192, True) == "int8_mm_nt_prefill"
    assert tim.int8_nt_kernel(100000, 16, 1, True) == "int8_mm_nt_prefill"
    assert tim.int8_nt_kernel(512, 6144, 2048, False) == "int8_mm_nt"
    assert tim.int8_nt_kernel(512, 6152, 2048, True) == "int8_mm_nt"
    assert tim.int8_nt_kernel(512, 6144, 0, True) == "int8_mm_nt"
    # 2^31 (output tile, k box) pairs or more: past the kernel's 32-bit block index
    assert tim.int8_nt_kernel(2 ** 20, 2 ** 15, 2 ** 16, True) == "int8_mm_nt"
    assert tim.int8_nt_kernel(2 ** 20, 2 ** 15, 2 ** 16 - 64, True) == "int8_mm_nt_prefill"


@pytest.mark.parametrize("M,K,N,x_offset", [(512, 2048, 2048, 0), (64, 2048, 6144, 0),
                                            (33, 100, 2048, 0), (272, 2048, 2048, 1)])
def test_launch_arguments(monkeypatch, M, K, N, x_offset):
    """What ``_launch_prefill`` hands the C entry, on meta tensors with the
    entry replaced: x's rows padded to a multiple of 8 (or copied when not
    16-byte aligned), the plan's splits, a workspace and counters only for
    split tiles; one launch counted per call; a refused launch raises and
    counts nothing."""
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
    q = torch.empty((K, N), dtype=torch.int8, device="meta")
    out = tim.int8_matmul(x, q, torch.ones(1, device="meta"), out_dtype=torch.float32)
    assert out.shape == (M, N) and out.dtype == torch.float32
    assert tim.launches["int8_mm_nt_prefill"] == 1 and sum(tim.launches.values()) == 1
    (xp, qp, sp, op, code, ws, counters, m, n, k, ldx, splits, per, stream), = calls
    mt, nt, _, want_splits, want_per = tim.int8_prefill_plan(M, N, K, 132)
    assert (m, n, k, splits, per, code, stream) == (M, N, K, want_splits, want_per, 0, 7)
    assert ldx == -(-K // 8) * 8 and xp % 16 == 0
    # a null pointer for whole tiles
    assert (splits == 1) == isinstance(ws, tim.ctypes.c_void_p) == isinstance(
        counters, tim.ctypes.c_void_p)
    rc[0] = -1
    with pytest.raises(RuntimeError, match="unsupported configuration"):
        tim.int8_matmul(x, q, torch.ones(1, device="meta"))
    assert tim.launches["int8_mm_nt_prefill"] == 1


def test_prefill_route_without_nvcc_raises(monkeypatch):
    """The prefill route builds its own library or raises: no fallback to
    the tiled kernel or the plain version, and no launch counted."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    built = []
    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path",
                        lambda name: built.append(name) or builder.BUILD_DIR / "absent.so")
    tim.reset_launches()
    x = torch.empty((512, 2048), dtype=torch.bfloat16, device="meta")
    q = torch.empty((2048, 6144), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tim.int8_matmul(x, q, torch.ones(1, device="meta"))
    assert built == ["int8_matmul_prefill_sm90"]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


# ------------------------------------------------- plain vs JAX at prefill
def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    return x, q, np.asarray([0.0123], np.float32)


def _assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    limit = 1e-5 * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("M", [17, 64, 333])
@pytest.mark.parametrize("K,N", [(256, 384), (300, 208)])
def test_plain_matches_jax_xla_branch(M, K, N):
    x, q, scale = _inputs(M, K, N, seed=M)
    got = tim.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale),
                          out_dtype=torch.float32).numpy()
    want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                      out_dtype=jnp.float32))
    _assert_close(got, want)


@pytest.mark.parametrize("M", [17, 64, 333])
def test_plain_matches_pallas_kernel_nt(M):
    """``_kernel_nt`` through ``pl.pallas_call(interpret=True)`` with
    ``_int8_mm_tpu``'s block specs, scale 1, against the plain version."""
    K, N, bn = 256, 384, 128
    x, q, _ = _inputs(M, K, N, seed=10 + M)
    want = np.asarray(pl.pallas_call(
        jim._kernel_nt, grid=(N // bn,),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)),
                  pl.BlockSpec((K, bn), lambda i: (0, i))],
        out_specs=pl.BlockSpec((M, bn), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True,
    )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q)))
    got = tim.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(q),
                                    torch.ones(1)).numpy()
    _assert_close(got, want)


@pytest.mark.cuda
def test_prefill_kernel_matches_its_plain_version_on_the_card():
    """``int8_mm_nt_prefill`` against the plain version on a CUDA card, split
    tiles and tails included, bit-identical on a second call and launched
    once per call (``chip_smoke.py`` phase 10 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in ((512, 2048, 6144), (17, 300, 208), (272, 8192, 2048), (333, 70, 272)):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randint(-128, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        scale = torch.rand((1,), generator=gen, device="cuda") * 1e-2
        for out_dtype in (torch.float32, torch.bfloat16):
            tim.reset_launches()
            got = tim.int8_matmul(x, q, scale, out_dtype=out_dtype)
            again = tim.int8_matmul(x, q, scale, out_dtype=out_dtype)
            assert tim.launches["int8_mm_nt_prefill"] == 2
            ref = tim.int8_matmul_reference(x, q, scale, out_dtype=out_dtype)
            assert torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * max(1.0, ref.float().abs().max().item())
