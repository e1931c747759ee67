"""fp16 on every flash route of the port: the routes and the plain fp16
versions (the CPU path, and the card's oracle) against the JAX package's
Pallas kernels at fp16 in interpret mode, on the CPU.

The routes: an fp16 CUDA tensor (meta tensors stand for CUDA ones) takes
the kernel a bf16 one takes at every head dim and layout, now that every
kernel has an fp16 instance.  The plain versions: the LUT forward with and
without the key bias (JAX ``_fwd`` over ``_layout_luts``), the LUT
gradients (``jax.grad`` of JAX's ``sparse_flash_attention``), the dense
forward and gradients with a key bias (JAX ``flash_attention(
key_padding_bias=)``), the banded and merged forwards (JAX ``_fwd`` with
``banded=`` and ``sub01=``).  Inputs are N(0, 1) in fp16, made with numpy
from a seed.

Tolerances, as ``test_torch_fp16_train.py`` holds the dense fp16 path:
FP16_ATOL = 2^-8 absolute on O and the gradients (values up to ~4: two
fp16 ulps there; P rounded to fp16 against the running maximum in JAX's
kernel and against the row's final one in the plain version, each output
rounded once), 1e-4 on the fp32 lse."""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from test_torch_banded_merged import MERGE_LAYOUTS, _bhtd, _from_bhtd, _jax_merged_fwd, \
    _longformer
from test_torch_sparse_attention import _jax_fwd

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")
fa = importlib.import_module("deepspeed_tpu_torch.ops.transformer.flash_attention")

FP16_ATOL = 2.0 ** -8
LSE_ATOL = 1e-4
F16 = torch.float16


def _qkv16(seed, B=1, T=128, H=2, d=16, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float16) for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _layout(T, H):
    return jsc.FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=2,
                                   num_global_blocks=1, different_layout_per_head=True,
                                   num_different_global_patterns=2).make_layout(T).astype(np.int32)


def _kbias(seed, B, T):
    rng = np.random.default_rng(seed)
    kb = np.where(rng.random((B, T)) < 0.8, 0.0, -1e4).astype(np.float32)
    kb[:, 0] = 0.0
    return kb


def _close(got, want, atol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=atol,
                               err_msg=what)


# ------------------------------------------------------------------- routes
@pytest.mark.parametrize("d", [64, 96, 128])
def test_fp16_takes_the_bf16_route_at_every_head_dim(d):
    """Each route function names for fp16 what it names for bf16."""
    for has_ab, has_kb in ((False, False), (False, True), (True, False)):
        assert fa.sparse_fwd_kernel(F16, d, has_ab, has_kb) == \
            fa.sparse_fwd_kernel(torch.bfloat16, d, has_ab, has_kb)
        for route in (fa.sparse_dkdv_kernel, fa.sparse_dq_kernel, fa.biased_fwd_kernel,
                      fa.biased_bwd_kernel):
            assert route(F16, d, has_ab) == route(torch.bfloat16, d, has_ab)
    for route in (fa.dense_fwd_kernel, fa.dense_bwd_kernel, fa.banded_fwd_kernel,
                  fa.merged_fwd_kernel):
        assert route(F16, d) == route(torch.bfloat16, d)
    assert fa.sparse_fwd_kernel(F16, 64, False, True) == "flash_fwd_lut_sm90"
    assert fa.biased_bwd_kernel(F16, 64, False) == fa.DENSE_BWD_SM90


def test_fp16_sparse_path_launches_the_lut_instances(monkeypatch):
    """``sparse_flash_attention`` forward and backward on fp16 meta tensors
    with a key bias: the sm90 LUT forward, dK/dV and dQ, dtype code 2 each."""
    calls = []
    monkeypatch.setattr(fa, "_run", lambda name, dtype, *a, device: calls.append((name, dtype)))
    B, T, H = 2, 256, 2
    leaves = [torch.empty((B, T, H, 64), dtype=F16, device="meta", requires_grad=True)
              for _ in range(3)]
    kb = torch.zeros((B, T), device="meta")
    fa.sparse_flash_attention(*leaves, _layout(T, H), key_padding_bias=kb).sum().backward()
    assert calls == [("flash_fwd_lut_sm90", 2), ("flash_bwd_dkdv_lut_sm90", 2),
                     ("flash_bwd_dq_lut_sm90", 2)]
    assert fa.launches == {name: 0 for name in fa.KERNELS}


# --------------------------------------------------- plain fp16 versions vs JAX
@pytest.mark.parametrize("bias", ["none", "kb"])
@pytest.mark.parametrize("causal", [False, True])
def test_fp16_lut_forward_matches_jax_interpret(causal, bias):
    B, T, H = 2, 128, 2
    q, k, v = _qkv16(7 + causal, B=B, T=T, H=H)
    layout = _layout(T, H)
    kb = _kbias(8, B, T) if bias == "kb" else None
    jo, jlse = _jax_fwd(q, k, v, layout, causal, kb, None)
    lut = fa.layout_luts(layout, T, H, causal)
    o, lse = fa.flash_fwd_lut_sm90(*_t(q, k, v), lut,
                                   None if kb is None else torch.from_numpy(kb))
    assert o.dtype == F16 and jo.dtype == np.float16
    _close(o, jo, FP16_ATOL, "o")
    _close(lse, jlse, LSE_ATOL, "lse")


@pytest.mark.parametrize("causal", [False, True])
def test_fp16_lut_gradients_match_jax_grad(causal):
    """dQ, dK, dV through the LUT backward (``flash_bwd_dkdv_lut`` /
    ``flash_bwd_dq_lut``, whose CUDA tensors take the sm90 instances)
    against ``jax.grad`` of JAX's block-sparse path, block 16."""
    B, T, H = 1, 128, 2
    q, k, v, w = _qkv16(40 + causal, B=B, T=T, H=H, n=4)
    layout = _layout(T, H)

    def jloss(q, k, v):
        out = jfa.sparse_flash_attention(q, k, v, jnp.asarray(layout), causal=causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w, jnp.float32))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = fa.sparse_flash_attention(*leaves, layout, causal=causal)
    (out.float() * torch.from_numpy(w).float()).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == F16
        _close(leaf.grad, jg, FP16_ATOL, f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_fp16_key_bias_dense_forward_and_gradients_match_jax(causal):
    """The dense path with a (B, T) key bias (``flash_fwd_sm90``'s and the
    dense backward pair's key-bias instances on the card) against JAX
    ``flash_attention(key_padding_bias=)`` and its gradients in interpret
    mode, at fp16."""
    B, T, H = 2, 96, 2
    q, k, v, w = _qkv16(90 + causal, B=B, T=T, H=H, n=4)
    kb = _kbias(91, B, T)

    def jloss(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, key_padding_bias=jnp.asarray(kb),
                                  block_q=32, block_k=32)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w, jnp.float32)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [x.requires_grad_(True) for x in _t(q, k, v)]
    out = fa.flash_attention(*leaves, causal=causal, key_padding_bias=torch.from_numpy(kb))
    assert out.dtype == F16
    _close(out, jout, FP16_ATOL, "o")
    (out.float() * torch.from_numpy(w).float()).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        _close(leaf.grad, jg, FP16_ATOL, f"d{name}")


@pytest.mark.parametrize("block,T,window,globals_", [(16, 128, 3, [0]), (32, 256, 1, [0]),
                                                     (64, 512, 3, [0])])
def test_fp16_banded_forward_matches_jax_banded_kernel(block, T, window, globals_):
    B, H, d = 1, 2, 16
    q, k, v = _qkv16(block + window, B=B, T=T, H=H, d=d)
    layout = _longformer(block, T, window, globals_)
    W, gcols = fa.banded_structure(layout, True)
    luts = jfa._layout_luts(layout, T, H, True, block, block)
    jo, jlse = jfa._fwd(_bhtd(q), _bhtd(k), _bhtd(v), 1.0 / np.sqrt(d), True, block, block,
                        n_heads=H, kmap=luts[0], klen=luts[1], banded=(W, gcols, block, block))
    jo, jlse = _from_bhtd(jo, jlse, B, H)
    o, lse = fa.flash_fwd_banded(*_t(q, k, v), fa.band_lut(W, gcols, block, T))
    assert o.dtype == F16
    _close(o, jo, FP16_ATOL, "o")
    _close(lse, jlse, LSE_ATOL, "lse")


@pytest.mark.parametrize("name,T", [("longformer16", 128), ("fixed32-causal-per-head", 256),
                                    ("bigbird64-bidirectional", 256)])
def test_fp16_merged_forward_matches_jax_merged_kernel(name, T):
    B, H, d = 1, 2, 16
    q, k, v = _qkv16(T + len(name), B=B, T=T, H=H, d=d)
    causal = "bidirectional" not in name
    layout = MERGE_LAYOUTS[name](T, H)
    jo, jlse = _jax_merged_fwd(q, k, v, layout, causal)
    o, lse = fa.flash_fwd_merged(*_t(q, k, v), fa.layout_luts(layout, T, H, causal).merged)
    assert o.dtype == F16
    _close(o, jo, FP16_ATOL, "o")
    _close(lse, jlse, LSE_ATOL, "lse")
