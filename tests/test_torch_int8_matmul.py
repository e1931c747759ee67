"""The port's weight-int8 matmul against the JAX one on the CPU
(deepspeed_tpu_torch/ops/transformer/int8_matmul.py vs
deepspeed_tpu/ops/transformer/int8_matmul.py).

The same numpy-seeded x, int8 weights and scales go through the port's
``int8_matmul`` (its plain version on the CPU: the CUDA kernel runs only on
the card, ``chip_smoke.py`` phase 10) and through JAX's ``int8_matmul`` (the
XLA branch) and the Pallas kernel bodies ``_kernel_nt`` / ``_kernel_t`` in
interpret mode.  Both packages sum exact bf16 x int8 products in fp32, in
another order, so the limits are: fp32 outputs within d = 1e-5 of the
largest |value| + 1e-6; bf16 outputs within one bf16 ulp of the JAX value
plus d (both round an fp32 result that may differ by d; chip_smoke.py
phase 10 holds the kernel to the same limits)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from deepspeed_tpu.ops.transformer import int8_matmul as jim
from deepspeed_tpu_torch.ops.transformer import int8_matmul as tim

K = 256


def _inputs(M, N, transposed, scale_kind, in_dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-128, 128, (N, K) if transposed else (K, N)).astype(np.int8)
    if scale_kind == "tensor":
        scale = np.asarray([0.0123], np.float32)
    else:
        scale = (rng.random(N).astype(np.float32) + 0.5) * 1e-2
    if in_dtype == "bf16":        # values that are bf16 already
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, q, scale


def _port(x, q, scale, transposed, in_dtype, out_dtype):
    tdt = {"fp32": torch.float32, "bf16": torch.bfloat16}
    return tim.int8_matmul(torch.from_numpy(x).to(tdt[in_dtype]), torch.from_numpy(q),
                           torch.from_numpy(scale), w_transposed=transposed,
                           out_dtype=tdt[out_dtype]).float().numpy()


def _jax(x, q, scale, transposed, in_dtype, out_dtype):
    jdt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
    out = jim.int8_matmul(jnp.asarray(x, jdt[in_dtype]), jnp.asarray(q), jnp.asarray(scale),
                          w_transposed=transposed, out_dtype=jdt[out_dtype])
    return np.asarray(out.astype(jnp.float32))


def _assert_close(got, want, out_dtype):
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    limit = 1e-5 * np.abs(want).max() + 1e-6
    if out_dtype == "bf16":
        # plus one bf16 ulp of the JAX value: 2^(floor(log2 |v|) - 7)
        limit = limit + np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (err <= limit).all(), err.max()


CASES = [(M, N, t, s, i, o)
         for M in (1, 8, 17)
         for N in (200, 384)                  # 200: a tail past the 64/128-wide tiles
         for t, s in ((False, "tensor"), (True, "tensor"), (True, "channel"))
         for i, o in (("fp32", "fp32"), ("bf16", "bf16"), ("fp32", "bf16"),
                      ("bf16", "fp32"))]


@pytest.mark.parametrize("M,N,transposed,scale_kind,in_dtype,out_dtype", CASES)
def test_plain_matches_jax_int8_matmul(M, N, transposed, scale_kind, in_dtype, out_dtype):
    x, q, scale = _inputs(M, N, transposed, scale_kind, in_dtype)
    got = _port(x, q, scale, transposed, in_dtype, out_dtype)
    want = _jax(x, q, scale, transposed, in_dtype, out_dtype)
    _assert_close(got, want, out_dtype)


def _pallas_bodies(x, q, transposed, block_n=128):
    """``_kernel_nt`` / ``_kernel_t`` through ``_int8_mm_tpu``'s block specs,
    in interpret mode: the unscaled fp32 product of bf16 x and int8 q."""
    M = x.shape[0]
    N = q.shape[0] if transposed else q.shape[1]
    if transposed:
        q_spec, kernel = pl.BlockSpec((block_n, K), lambda i: (i, 0)), jim._kernel_t
    else:
        q_spec, kernel = pl.BlockSpec((K, block_n), lambda i: (0, i)), jim._kernel_nt
    return pl.pallas_call(
        kernel, grid=(pl.cdiv(N, block_n),),
        in_specs=[pl.BlockSpec((M, K), lambda i: (0, 0)), q_spec],
        out_specs=pl.BlockSpec((M, block_n), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32), interpret=True,
    )(jnp.asarray(x, jnp.bfloat16), jnp.asarray(q))


@pytest.mark.parametrize("transposed", [False, True], ids=["nt", "t"])
@pytest.mark.parametrize("M,N", [(16, 384), (16, 200), (32, 200)])
def test_plain_matches_pallas_kernel_bodies(M, N, transposed):
    """The plain version against the TPU kernels' own bodies (x padded to
    whole 16-row sublane tiles, as the JAX wrapper pads it), scale 1."""
    x, q, _ = _inputs(M, N, transposed, "tensor", "fp32", seed=1)
    want = np.asarray(_pallas_bodies(x, q, transposed))
    got = _port(x, q, np.ones((1,), np.float32), transposed, "fp32", "fp32")
    _assert_close(got, want, "fp32")


def test_fp32_x_is_rounded_to_bf16_first():
    """x is rounded to bf16 before the product even in an fp32 model (the
    JAX wrapper's ``astype(bfloat16)``, line 97)."""
    x, q, scale = _inputs(8, 64, False, "tensor", "fp32", seed=2)
    got = _port(x, q, scale, False, "fp32", "fp32")
    xb = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    exact = (xb @ q.astype(np.float64)) * scale[0]
    unrounded = (x.astype(np.float64) @ q.astype(np.float64)) * scale[0]
    assert np.abs(got - exact).max() <= 1e-5 * np.abs(exact).max()
    assert np.abs(got - unrounded).max() > 1e-3 * np.abs(exact).max()


def test_leading_dims_and_default_out_dtype():
    x, q, scale = _inputs(12, 96, True, "channel", "bf16", seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(3, 4, K)
    out = tim.int8_matmul(xt, torch.from_numpy(q), torch.from_numpy(scale),
                          w_transposed=True, block_n=7, use_pallas=True)
    assert out.shape == (3, 4, 96) and out.dtype == torch.bfloat16
    want = _jax(x, q, scale, True, "bf16", "bf16").reshape(3, 4, 96)
    _assert_close(out.float().numpy(), want, "bf16")


@pytest.mark.parametrize("transposed,size", [(False, 384), (False, 2), (True, 2),
                                             (True, 383)])
def test_bad_scale_size_raises_like_jax(transposed, size):
    x, q, _ = _inputs(4, 384, transposed, "tensor", "fp32")
    scale = np.ones((size,), np.float32)
    with pytest.raises(ValueError, match="does not map to per-tensor") as got:
        _port(x, q, scale, transposed, "fp32", "fp32")
    with pytest.raises(ValueError) as want:
        _jax(x, q, scale, transposed, "fp32", "fp32")
    assert str(got.value) == str(want.value)


def test_shape_and_dtype_validation():
    x = torch.zeros((2, K))
    with pytest.raises(ValueError, match="int8"):
        tim.int8_matmul(x, torch.zeros((K, 8)), torch.ones(1))
    with pytest.raises(ValueError, match="does not match"):
        tim.int8_matmul(x, torch.zeros((K + 1, 8), dtype=torch.int8), torch.ones(1))


@pytest.mark.parametrize("M,N,K_", [(8, 6144, 2048), (8, 2048, 2048), (8, 8192, 2048),
                                    (8, 2048, 8192), (8, 50257, 2048), (512, 6144, 2048),
                                    (512, 2048, 2048), (1, 2304, 768), (17, 200, 300),
                                    (4, 64, 0)])
def test_split_plan_covers_every_k_tile(M, N, K_):
    """Split-K plans: every K tile belongs to exactly one split, every split
    has at least one, and the grid never exceeds two blocks per SM through
    splitting (132 SMs, the H100)."""
    tile, splits, per = tim.plan(M, N, K_, 132)
    BM, BN, BK = tim.TILES[tile]
    assert tile == (0 if M <= 16 else 1)
    kt = -(-K_ // BK)
    assert splits >= 1 and (splits == 1 or (splits - 1) * per < kt <= splits * per)
    tiles = -(-M // BM) * -(-N // BN)
    if tiles >= 132:
        assert splits == 1
    assert (splits - 1) * tiles < 2 * 132


def test_cuda_tensor_without_nvcc_raises(monkeypatch):
    """A tensor off the CPU reaches the kernel or raises: with no nvcc the
    build raises instead of falling back, and nothing is counted."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    tim.reset_launches()
    x = torch.empty((8, K), dtype=torch.bfloat16, device="meta")
    q = torch.empty((K, 64), dtype=torch.int8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tim.int8_matmul(x, q, torch.ones(1, device="meta"))
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """Both entries against the plain version on a CUDA card, split-K and
    tails included, and bit-identical on a second call (``chip_smoke.py``
    phase 10 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for M, N, Kc, t in ((8, 2048, 2048, False), (17, 200, 300, True), (64, 384, 512, False)):
        x = torch.randn((M, Kc), generator=gen, device="cuda").to(torch.bfloat16)
        q = torch.randint(-128, 128, (N, Kc) if t else (Kc, N), generator=gen,
                          device="cuda").to(torch.int8)
        scale = torch.rand((N,) if t else (1,), generator=gen, device="cuda") * 1e-2
        for out_dtype in (torch.float32, torch.bfloat16):
            got = tim.int8_matmul(x, q, scale, w_transposed=t, out_dtype=out_dtype)
            again = tim.int8_matmul(x, q, scale, w_transposed=t, out_dtype=out_dtype)
            ref = tim.int8_matmul_reference(x, q, scale, w_transposed=t,
                                            out_dtype=out_dtype)
            assert torch.equal(got, again)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * max(1.0, ref.float().abs().max().item())
