"""The decode int8 product for Hopper, ``int8_mm_nt_decode``
(deepspeed_tpu_torch/csrc/int8_matmul_decode_sm90.cu), on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 10-12 and the
``cuda``-marked test below).  Here:

- its schedule (``int8_decode_blocks``, the kernel's box ranges, partial
  slots and reduction order in Python) covers every (n, k) of the product
  exactly once at GPT-2 125M's and 1.3B's block weight shapes and at N and
  K tails, with per-block ranges that differ by at most one box;
- a numpy emulation of the kernel, step by step as the source computes it
  (the TMA box under the 128-byte swizzle, each lane's four 32-bit words,
  the byte permutes and the bf16x2 widening, the mma.sync m16n8k16
  fragments as PTX defines them, split-tile partials summed in block order,
  the four-column store), reproduces ``x @ q`` exactly on small integers;
- ``int8_nt_kernel`` routes through ``int8_matmul`` on meta tensors
  (standing for CUDA ones) with the launch replaced by a recorder;
- with no nvcc the route raises and counts nothing;
- the plain version it is held against on the card agrees with JAX's
  ``int8_matmul`` (XLA branch) and with ``_kernel_nt`` through
  ``pl.pallas_call(interpret=True)`` at M 1/8/16, fp32: within 1e-5 of the
  largest |value| + 1e-6 (exact bf16 x int8 products summed in fp32 in
  another order).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deepspeed_tpu.ops.transformer import int8_matmul as jim
from deepspeed_tpu_torch.ops.transformer import int8_matmul as tim
from int8_fragments import widen2

BN, BK = tim.DECODE_BN, tim.DECODE_BK
BOX_N = BN                     # columns of one TMA box (its 128-byte rows)
GPT2_SHAPES = [(K, N) for D in (768, 2048)
               for K, N in ((D, 3 * D), (D, D), (D, 4 * D), (4 * D, D))]


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("K,N", GPT2_SHAPES + [(2048, 6160), (2050, 6144), (100, 208),
                                               (1, 16), (8192, 2064), (64, 128)])
@pytest.mark.parametrize("sms", [132, 7])
def test_schedule_covers_every_element_once_at_balance(K, N, sms):
    nt, kb, G = tim.int8_decode_plan(N, K, sms)
    assert G == min(nt * kb, sms)
    per_block, shared = tim.int8_decode_blocks(N, K, G)
    W = nt * kb
    # every (n, k) exactly once, tails masked as TMA masks them
    hits = np.zeros((nt * BN, kb * BK), np.int32)
    sizes, slots = [], set()
    for b, segs in enumerate(per_block):
        for tile, k_lo, k_hi, slot in segs:
            hits[tile * BN:(tile + 1) * BN, k_lo * BK:k_hi * BK] += 1
            assert 0 <= k_lo < k_hi <= kb
            if slot is None:                     # a whole tile, stored by this block
                assert (k_lo, k_hi) == (0, kb) and tile not in shared
            else:
                assert slot == 2 * b + (tile != segs[0][0]) and slot not in slots
                slots.add(slot)
        sizes.append(sum(h - l for _, l, h, _ in segs))
        assert sizes[-1] == (b + 1) * W // G - b * W // G
    assert (hits[:N, :K] == 1).all() and hits.sum() == W * BN * BK
    assert max(sizes) - min(sizes) <= 1
    # a shared tile: the blocks holding it, in block (and k) order, each once
    for tile, order in shared.items():
        holders = [b for b, segs in enumerate(per_block) for t, *_ in segs if t == tile]
        assert order == holders and len(order) >= 2
    # only a block's first and last tiles can be shared
    for segs in per_block:
        assert all(slot is None for *_, slot in segs[1:-1])
    # the kernel's block_of against a search of the ranges
    for i in sorted({0, W - 1, W // 2, W // 3, min(W - 1, kb)}):
        assert tim.int8_decode_block_of(i, W, G) == next(
            b for b in range(G) if b * W // G <= i < (b + 1) * W // G)


def test_decode_plan_at_gpt2_1p3b_qkv():
    """qkv of GPT-2 1.3B on an H100: 48 column tiles x 32 k boxes, 132
    blocks of 11 or 12 boxes (88-96 KB of weight each)."""
    nt, kb, G = tim.int8_decode_plan(6144, 2048, 132)
    assert (nt, kb, G) == (48, 32, 132)
    per_block, _ = tim.int8_decode_blocks(6144, 2048, G)
    assert {sum(h - l for _, l, h, _ in s) for s in per_block} == {11, 12}


# ------------------------------------------------- the kernel, emulated
def _tma_box(q, c0, k0, rows):
    """The box TMA writes at (column c0, row k0): ``rows`` rows of 128
    bytes, zero past K and N, chunk c of row r stored at chunk c ^ (r % 8)."""
    box = np.zeros((rows, BOX_N), np.uint8)
    part = q[k0:k0 + rows, c0:c0 + BOX_N].view(np.uint8)
    box[:part.shape[0], :part.shape[1]] = part
    smem = np.zeros(rows * BOX_N, np.uint8)
    for r in range(rows):
        for c in range(BOX_N // 16):
            base = r * BOX_N + ((c ^ (r & 7)) << 4)
            smem[base:base + 16] = box[r, 16 * c:16 * c + 16]
    return smem


def _tma_x_box(x, k0, rows):
    """The x box TMA writes at column k0: ``rows`` rows of 64 values (128
    bytes of bf16), zero past M and K, 16-byte chunk c of row r at chunk
    c ^ (r % 8); flat, in bf16 elements."""
    box = np.zeros((rows, 64))
    part = x[:rows, k0:k0 + 64]
    box[:part.shape[0], :part.shape[1]] = part
    smem = np.zeros(rows * 64)
    for r in range(rows):
        for c in range(64 // 8):
            base = r * 64 + ((c ^ (r & 7)) << 3)
            smem[base:base + 8] = box[r, 8 * c:8 * c + 8]
    return smem


def _mma(acc, a, b):
    """mma.sync m16n8k16 row.col as PTX lays out the fragments (lane 4 g + t):
    A[g][2t+e] = a[0], A[g+8][2t+e] = a[1], A[g][2t+8+e] = a[2],
    A[g+8][2t+8+e] = a[3]; B[2t+e][g] = b[0], B[2t+8+e][g] = b[1];
    C[g][2t+e] = c[e], C[g+8][2t+e] = c[2+e]."""
    g, t = np.arange(32) // 4, np.arange(32) % 4
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for e in range(2):
        A[g, 2 * t + e], A[g + 8, 2 * t + e] = a[0][e], a[1][e]
        A[g, 2 * t + 8 + e], A[g + 8, 2 * t + 8 + e] = a[2][e], a[3][e]
        B[2 * t + e, g], B[2 * t + 8 + e, g] = b[0][e], b[1][e]
    C = A @ B
    for e in range(2):
        acc[e] += C[g, 2 * t + e]
        acc[2 + e] += C[g + 8, 2 * t + e]


def _emulate(x, q, sms):
    """int8_mm_nt_decode as the source computes it, every block and lane: a
    warp per 32 columns, its fragments and products; at a tile's end a whole
    tile stored, or a split tile's partial written to the workspace; the
    block that counts a split tile in last sums the partials in block order
    and stores.  The blocks run here one after another, in order."""
    M, K = x.shape
    N = q.shape[1]
    warps = BN // 32
    nt, kb, G = tim.int8_decode_plan(N, K, sms)
    W = nt * kb
    NF = 1 if M <= 8 else 2
    g, t = np.arange(32) // 4, np.arange(32) % 4
    out = np.full((M, N), np.nan)
    ws, counts = {}, np.zeros(nt, np.int64)

    def store(tile, acc):                   # store_tile: acc[warp][T][f][e][lane]
        for w in range(warps):
            n0 = tile * BN + 32 * w + 4 * g
            for f in range(NF):
                for h in range(2):
                    m = 8 * f + 2 * t + h
                    vals = [acc[w, 0, f, h], acc[w, 0, f, 2 + h], acc[w, 1, f, h],
                            acc[w, 1, f, 2 + h]]
                    for lane in np.nonzero((m < M) & (n0 < N))[0]:
                        for c in range(4):
                            assert np.isnan(out[m[lane], n0[lane] + c])   # stored once
                            out[m[lane], n0[lane] + c] = vals[c][lane]

    for b in range(G):
        lo, hi = b * W // G, (b + 1) * W // G
        acc = np.zeros((warps, 2, NF, 4, 32))  # [warp][T][f][e][lane]
        for i in range(lo, hi):
            tile, kbox = i // kb, i % kb
            k0 = kbox * BK
            smem = _tma_box(q, tile * BN, k0, BK)
            xsmem = _tma_x_box(x, k0, 8 * NF)
            for w in range(warps):
                chunk, in_chunk = 2 * w + (g >> 2), 4 * (g & 3)
                for ks in range(BK // 16):
                    words = []
                    for j in range(4):
                        r = 16 * ks + 2 * t + (j & 1) + 8 * (j >> 1)
                        addr = r * BOX_N + ((chunk ^ (r & 7)) << 4) + in_chunk
                        words.append(smem[addr[:, None] + np.arange(4)].copy()
                                     .view(np.uint32).reshape(32))
                    a0 = [widen2(0, *words[:2]), widen2(1, *words[:2]),
                          widen2(0, *words[2:]), widen2(1, *words[2:])]
                    a1 = [widen2(2, *words[:2]), widen2(3, *words[:2]),
                          widen2(2, *words[2:]), widen2(3, *words[2:])]
                    for f in range(NF):
                        xb = []
                        for h in range(2):    # byte address / 2: the pair's first element
                            e0 = ((g + 8 * f) * 128 + (((2 * ks + h) ^ g) << 4) + 4 * t) // 2
                            xb.append([xsmem[e0], xsmem[e0 + 1]])
                        _mma(acc[w, 0, f], a0, xb)
                        _mma(acc[w, 1, f], a1, xb)
            if i + 1 != hi and (i + 1) % kb != 0:
                continue
            done, acc = acc, np.zeros_like(acc)
            bf = tim.int8_decode_block_of(tile * kb, W, G)
            bl = tim.int8_decode_block_of(tile * kb + kb - 1, W, G)
            if bf == bl:
                store(tile, done)
                continue
            ws[2 * b + (tile != lo // kb)] = done
            counts[tile] += 1                  # counted in
            if counts[tile] != bl - bf + 1:
                continue
            total = np.zeros_like(done)        # counted last: the sum in block order
            for bb in range(bf, bl + 1):
                total = total + ws[2 * bb + (tile != (bb * W // G) // kb)]
            store(tile, total)
            counts[tile] = 0
    assert not counts.any()
    return out


@pytest.mark.parametrize("M,K,N,sms", [(8, 192, 256, 3), (3, 150, 144, 4),
                                       (16, 128, 128, 1), (11, 70, 528, 5),
                                       (8, 128, 1040, 4)])
def test_fragment_mapping_reproduces_the_product(M, K, N, sms):
    """Small integers (exact in bf16 and in the sums): the emulated kernel
    gives exactly x @ q, each output stored once; the cases cover split and
    whole tiles (and a block with a whole tile between two split ones), N
    and K tails, M 3/8/11/16, every int8 value."""
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.integers(-8, 9, (M, K)).astype(np.float64)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    q.flat[:256] = np.arange(-128, 128)
    got = _emulate(x, q, sms)
    np.testing.assert_array_equal(got, x @ q.astype(np.float64))


# ------------------------------------------------------------- routes
class _Launched(Exception):
    pass


def _route(monkeypatch, M, N, K=256, transposed=False, misaligned=False, tiled=False,
           lead=None):
    """The kernel ``int8_matmul`` (or ``int8_matmul_tiled``) would launch for
    meta tensors (standing for CUDA ones): ``_entry`` records the name and
    stops before the launch."""
    names = []

    def entry(name):
        names.append(name)
        raise _Launched

    monkeypatch.setattr(tim, "_entry", entry)
    x = torch.empty((*(lead or (M,)), K), dtype=torch.bfloat16, device="meta")
    shape = (N, K) if transposed else (K, N)
    if misaligned:       # a view one byte into its storage
        q = torch.empty(K * N + 1, dtype=torch.int8, device="meta")[1:].view(shape)
    else:
        q = torch.empty(shape, dtype=torch.int8, device="meta")
    scale = torch.ones(1, device="meta")
    fn = tim.int8_matmul_tiled if tiled else tim.int8_matmul
    with pytest.raises(_Launched):
        fn(x, q, scale, w_transposed=transposed)
    return names


@pytest.mark.parametrize("case,kwargs,want", [
    ("M=1", dict(M=1, N=6144), "int8_mm_nt_decode"),
    ("M=8", dict(M=8, N=2048), "int8_mm_nt_decode"),
    ("M=16", dict(M=16, N=8192), "int8_mm_nt_decode"),
    ("M=2x4 leading", dict(M=8, N=2048, lead=(2, 4)), "int8_mm_nt_decode"),
    ("M=17", dict(M=17, N=2048), "int8_mm_nt_prefill"),
    ("M=512", dict(M=512, N=6144), "int8_mm_nt_prefill"),
    ("M=64 misaligned q", dict(M=64, N=2048, misaligned=True), "int8_mm_nt"),
    ("N%16", dict(M=8, N=200), "int8_mm_nt"),
    ("misaligned q", dict(M=8, N=2048, misaligned=True), "int8_mm_nt"),
    ("head", dict(M=8, N=50257, transposed=True), "int8_mm_t"),
    ("tiled M=8", dict(M=8, N=2048, tiled=True), "int8_mm_nt"),
    ("tiled head", dict(M=8, N=50257, transposed=True, tiled=True), "int8_mm_t"),
])
def test_routes(monkeypatch, case, kwargs, want):
    tim.reset_launches()
    assert _route(monkeypatch, **kwargs) == [want]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


def test_route_function():
    assert tim.int8_nt_kernel(8, 6144, 2048, True) == "int8_mm_nt_decode"
    assert tim.int8_nt_kernel(16, 16, 1, True) == "int8_mm_nt_decode"
    assert tim.int8_nt_kernel(8, 6144, 2048, False) == "int8_mm_nt"
    assert tim.int8_nt_kernel(17, 6144, 2048, True) == "int8_mm_nt_prefill"
    assert tim.int8_nt_kernel(8, 6152, 2048, True) == "int8_mm_nt"
    assert tim.int8_nt_kernel(8, 6144, 0, True) == "int8_mm_nt"
    assert tim.int8_nt_kernel(0, 6144, 2048, True) == "int8_mm_nt"


def test_decode_route_without_nvcc_raises(monkeypatch):
    """The decode route builds its own library or raises: no fallback to the
    tiled kernel or the plain version, and no launch counted."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    built = []
    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path",
                        lambda name: built.append(name) or builder.BUILD_DIR / "absent.so")
    tim.reset_launches()
    x = torch.empty((8, 2048), dtype=torch.bfloat16, device="meta")
    q = torch.empty((2048, 6144), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tim.int8_matmul(x, q, torch.ones(1, device="meta"))
    assert built == ["int8_matmul_decode_sm90"]
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


# ------------------------------------------------- plain vs JAX at decode
def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (K, N)).astype(np.int8)
    return x, q, np.asarray([0.0123], np.float32)


def _assert_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    limit = 1e-5 * np.abs(want).max() + 1e-6
    assert np.abs(got - want).max() <= limit


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("K,N", [(256, 384), (300, 208)])
def test_plain_matches_jax_xla_branch(M, K, N):
    x, q, scale = _inputs(M, K, N, seed=M)
    got = tim.int8_matmul(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale),
                          out_dtype=torch.float32).numpy()
    want = np.asarray(jim.int8_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale),
                                      out_dtype=jnp.float32))
    _assert_close(got, want)


@pytest.mark.parametrize("M", [1, 8, 16])
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
def test_decode_kernel_matches_its_plain_version_on_the_card():
    """``int8_mm_nt_decode`` against the plain version on a CUDA card, split
    tiles and tails included, bit-identical on a second call and launched
    once per call (``chip_smoke.py`` phase 10 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, K, N in ((8, 2048, 6144), (1, 300, 208), (16, 8192, 2048), (11, 70, 272)):
        x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randint(-128, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        scale = torch.rand((1,), generator=gen, device="cuda") * 1e-2
        for out_dtype in (torch.float32, torch.bfloat16):
            tim.reset_launches()
            got = tim.int8_matmul(x, q, scale, out_dtype=out_dtype)
            again = tim.int8_matmul(x, q, scale, out_dtype=out_dtype)
            assert tim.launches["int8_mm_nt_decode"] == 2
            ref = tim.int8_matmul_reference(x, q, scale, out_dtype=out_dtype)
            assert torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * max(1.0, ref.float().abs().max().item())
