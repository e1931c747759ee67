"""The port's flash attention against the JAX package's, in fp32 on the CPU
(deepspeed_tpu_torch/ops/transformer/flash_attention.py vs
deepspeed_tpu/ops/transformer/flash_attention.py).

On the CPU the port's wrappers take their plain versions (the CUDA
kernels are held against the same plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked test below).  The JAX side
runs its Pallas kernels in interpret mode at the block sizes its own
tests use.  Inputs are made with numpy from a seed.

Tolerances: 2e-5 on the forward (O and lse of magnitude ~1: the same
fp32 formula, sums in another order and one softmax pass against the
kernel's online one); 1e-4 on gradients (fp32, larger sums over T)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer.flash_attention import (
    flash_attention as jax_flash, flash_attention_with_lse as jax_flash_lse)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

FWD_TOL = 2e-5
GRAD_TOL = 1e-4


def _qkv(seed, B=2, T=64, H=2, d=32, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("block", [32, 64])
@pytest.mark.parametrize("T", [64, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_and_lse_match_jax(T, causal, block):
    q, k, v = _qkv(T, T=T)
    jo, jlse = jax_flash_lse(*map(jnp.asarray, (q, k, v)), causal=causal,
                             block_q=block, block_k=block)
    jo_plain = jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                         block_q=block, block_k=block)
    o, lse = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert o.shape == q.shape and lse.shape == (2, 2, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo_plain), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0, atol=FWD_TOL)
    assert fa.launches == {name: 0 for name in fa.KERNELS}   # no kernel on the CPU


@pytest.mark.parametrize("T", [64, 96])
@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax_grad(T, causal):
    q, k, v, w = _qkv(100 + T, B=1, T=T, d=16, n=4)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
                       * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=causal) * torch.from_numpy(w)).sum().backward()
    # the backward's plain version on its own, fed the forward's (o, lse)
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, causal)
    ref = fa.flash_attention_reference_bwd(tq, tk, tv, o, lse, tw, causal)
    for name, leaf, jg, r in zip("qkv", leaves, jgrads, ref):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), rtol=0,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(r.numpy(), np.asarray(jg), rtol=0, atol=GRAD_TOL,
                                   err_msg=f"reference d{name}")


def test_sm_scale_and_strided_views():
    """q, k, v as views of one fused qkv tensor (the model's layout) and an
    explicit sm_scale, against JAX on contiguous copies."""
    rng = np.random.default_rng(7)
    B, T, H, d = 2, 48, 2, 16
    qkv = rng.standard_normal((B, T, 3 * H * d)).astype(np.float32)
    tq, tk, tv = (x.view(B, T, H, d) for x in torch.from_numpy(qkv).split(H * d, -1))
    assert tq.stride() == (T * 3 * H * d, 3 * H * d, d, 1)
    out = fa.flash_attention(tq, tk, tv, causal=True, sm_scale=0.3)
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(x.numpy())) for x in (tq, tk, tv))
    ref = jax_flash(jq, jk, jv, causal=True, sm_scale=0.3, block_q=32, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)


def test_reference_backward_parts_compose():
    tq, tk, tv, tdo = map(torch.from_numpy, _qkv(3, T=40, n=4))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, True)
    delta = fa.attention_delta(o, tdo)
    assert delta.shape == (2, 2, 40) and delta.is_contiguous()
    dq, dk, dv = fa.flash_bwd(tq, tk, tv, o, lse, tdo, True)
    assert torch.equal(dq, fa.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, True))
    for a, b in zip((dk, dv), fa.flash_bwd_dkdv(tq, tk, tv, tdo, lse, delta, True)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float64, 96, "dtype"),           # no kernel has an fp64 instance
    (torch.bfloat16, 80, "head dim"),
    (torch.float32, 48, "head dim"),
])
def test_device_path_rejects_unsupported_configs(dtype, d, match):
    """Off the CPU the wrappers launch or raise; they never take the plain
    version.  (Meta tensors stand for device tensors here.)"""
    q = torch.empty((2, 64, 4, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd(q, q, q)


def test_device_path_rejects_strided_last_dim():
    q = torch.empty((2, 64, 4, 128), dtype=torch.bfloat16, device="meta")[..., ::2]
    with pytest.raises(ValueError, match="last dim contiguous"):
        fa.flash_fwd(q, q, q)


def test_device_path_builds_the_kernel_or_raises(monkeypatch):
    """A supported device tensor goes to the CUDA kernel: with no nvcc the
    build raises instead of falling back."""
    from deepspeed_tpu_torch.ops.op_builder import cuda as builder

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path",
                        lambda name: builder.BUILD_DIR / "absent.so")
    q = torch.empty((2, 64, 4, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_fwd(q, q, q)
    assert fa.launches["flash_fwd"] == 0


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    """The three kernels against their plain versions on a CUDA card
    (``chip_smoke.py`` phase 2 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        q, k, v, do = (torch.randn((2, 200, 4, 64), generator=gen, device="cuda").to(dt)
                       for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, True)
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True)
        got = fa.flash_bwd(q, k, v, o, lse, do, True)
        want = fa.flash_attention_reference_bwd(q, k, v, o, lse, do, True)
        for a, b in zip((o, lse) + got, (ro, rlse) + want):
            err = (a.float() - b.float()).abs().max().item()
            assert err <= tol * max(1.0, b.float().abs().max().item())
