"""The dense biased bf16 forward for Hopper: the key-bias instances of
``flash_fwd_sm90`` (deepspeed_tpu_torch/csrc/flash_attention_fwd_sm90.cu),
on the CPU.

The kernel runs only on a card (``chip_smoke.py`` phases 7, 8c and 9, and
the ``cuda``-marked test below).  Here:

- the kernel's arithmetic with a (B, T) key bias: a torch emulation over
  ``flash_fwd_sm90_schedule`` (128-row q tiles in two 64-row halves, 128-key
  tiles from the last down; keys past T read as zeros; every score scaled
  and biased in log2 units, S scale log2e + kbias log2e, before the row
  maximum; a flagged half masks k >= T and, when causal, q < k; the online
  softmax in exp2; P rounded where the kernel rounds it; a row whose maximum
  stays NEG_INF writing O = 0 and lse = NEG_INF) against the plain
  ``flash_attention_reference_fwd``, ``add`` and ``mul`` biases (``mul``
  with batch row 1 fully padded), causal and not, T from 1 to 300;
- the fully padded ``mul`` row: the port's O and lse against JAX
  ``flash_attention(key_padding_bias=)`` and its ``_fwd`` (Pallas in
  interpret mode, as its own tests run it);
- the route ``biased_fwd_kernel`` through ``flash_fwd_biased``,
  ``flash_attention(key_padding_bias=)`` and ``sparse_flash_attention`` with
  an all-ones layout, on meta tensors standing for CUDA ones with ``_run``
  replaced, and the argument list handed to the C entry (the key bias's
  pointer last before the stream, null without one); the refusals of a bias
  of the wrong shape, dtype, layout or device, and of a bias an entry does
  not take; with no nvcc the route raises and counts no launch.

Tolerances: 2e-5 against the plain version in fp32 (the same formula with
exp2 for exp and the bias in log2 units, summed per tile in another
order; O and lse of magnitude ~1), and against JAX (as
``test_torch_sparse_attention.py``); with P rounded to bf16, 2^-5 of the
rms plus 2^-7 of each element (the limits ``chip_smoke.py`` holds the
kernel to) and lse within 1e-4."""

import ctypes
import importlib
import math
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

jfa = importlib.import_module("deepspeed_tpu.ops.transformer.flash_attention")

FWD_TOL = 2e-5
BF16_TOL = (2 ** -5, 2 ** -7)
LSE_TOL = 1e-4
SM90, TEMPLATE = "flash_fwd_sm90", "flash_fwd_biased"


# ------------------------------------------------ the kernel's arithmetic
def emulate(q, k, v, kbias, causal, sm_scale=None, round_to=None):
    """The key-bias instance of ``flash_fwd_sm90`` in torch over
    :func:`flash_fwd_sm90_schedule`: ``(o (B, T, H, d) fp32, lse (B, H, T))``."""
    B, T, H, d = q.shape
    scale2 = (1.0 / math.sqrt(d) if sm_scale is None else sm_scale) / math.log(2.0)
    neg = fa.NEG_INF
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    bn = fa.SM90_BLOCK_N
    nk = -(-T // bn)
    pad = nk * bn - T
    kf = torch.cat([k.float(), torch.zeros(B, pad, H, d)], 1)       # TMA zero-fills past T
    vf = torch.cat([v.float(), torch.zeros(B, pad, H, d)], 1)
    kb2 = torch.cat([kbias.float(), torch.zeros(B, pad)], 1) / math.log(2.0)  # the bias ring
    o = torch.zeros(B, T, H, d)
    lse = torch.zeros(B, H, T)
    for q0, tiles in fa.flash_fwd_sm90_schedule(T, causal):
        for c in range(2):
            r0 = q0 + 64 * c
            if r0 >= T:                 # a half past T: its rows are clipped on the way out
                continue
            rows = torch.arange(r0, min(r0 + 64, T))
            qf = q[:, rows].float()
            m = torch.full((B, H, len(rows)), neg)
            l = torch.zeros(B, H, len(rows))
            acc = torch.zeros(B, H, len(rows), d)
            for k0, masked in tiles:
                cols = torch.arange(k0, k0 + bn)
                s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, cols])
                x = s * scale2 + kb2[:, None, None, cols]
                if masked[c]:
                    valid = (cols[None, :] < T) & (~torch.tensor(causal)
                                                   | (rows[:, None] >= cols[None, :]))
                    x = torch.where(valid, x, torch.tensor(neg))
                mn = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - mn)
                p = torch.exp2(x - mn[..., None])
                if masked[c]:
                    p = torch.where(x == neg, torch.zeros_like(p), p)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", rnd(p),
                                                            vf[:, cols])
                m = mn
            live = m > neg * 0.5
            l_safe = torch.where(l == 0, torch.ones_like(l), l)
            o[:, rows] = torch.where(live[..., None], acc / l_safe[..., None],
                                     torch.zeros_like(acc)).transpose(1, 2)
            lse[:, :, rows] = torch.where(live, m * math.log(2.0) + torch.log(l_safe),
                                          torch.full_like(m, neg))
    return o, lse


def key_bias(kind, rng, B, T):
    """A (B, T) fp32 key bias as the model builds it (``chip_smoke.py``'s
    ``bias_inputs``): ``add``, -10000 past each row's length (lengths
    uniform in [ceil(T/2), T]); ``mul``, 0 / NEG_INF the same way, with batch
    row 1 fully padded."""
    keep = np.arange(T)[None, :] < rng.integers(-(-T // 2), T + 1, B)[:, None]
    if kind == "mul":
        keep[1 % B] = False
        return torch.from_numpy(np.where(keep, 0.0, fa.NEG_INF).astype(np.float32))
    return torch.from_numpy(np.where(keep, 0.0, -10000.0).astype(np.float32))


def _inputs(seed, B, T, H, d, kind, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(np.float32))
               .to(dtype) for _ in range(3))
    return q, k, v, key_bias(kind, rng, B, T)


@pytest.mark.parametrize("kind", ["add", "mul"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 65, 127, 129, 300])
def test_emulation_reproduces_the_plain_version(T, causal, kind):
    """fp32: the emulation over the schedule equals the plain version at T
    under, at and past one 128-row tile, ragged; the ``mul`` bias's fully
    padded batch row writes O = 0 and lse = NEG_INF; the wrappers on CPU
    tensors are the plain version."""
    B, H, d = 2, 2, 16
    q, k, v, kb = _inputs(T + 3 * causal, B, T, H, d, kind)
    o, lse = emulate(q, k, v, kb, causal)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal, key_padding_bias=kb)
    for call in (lambda: fa.flash_fwd_biased(q, k, v, kb, None, causal),
                 lambda: fa.flash_fwd_biased_template(q, k, v, kb, None, causal),
                 lambda: fa.flash_fwd_sm90(q, k, v, causal, key_padding_bias=kb)):
        got = call()
        assert torch.equal(got[0], ro) and torch.equal(got[1], rlse)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=0, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=0, atol=FWD_TOL)
    if kind == "mul":
        for got_o, got_lse in ((o, lse), (ro, rlse)):
            assert not got_o[1].any()
            assert (got_lse[1] == fa.NEG_INF).all()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("kind", ["add", "mul"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("T", [65, 200])
def test_emulation_with_bf16_rounding_matches_the_plain_version(T, d, causal, kind):
    """bf16 inputs, P rounded to bf16 as the kernel rounds it, at head dims
    64 and 128, within the limits the kernel is held to on the card."""
    B, H = 2, 2
    q, k, v, kb = _inputs(17 + T + d, B, T, H, d, kind, torch.bfloat16)
    o, lse = emulate(q, k, v, kb, causal, round_to=torch.bfloat16)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal, key_padding_bias=kb)
    r = ro.float()
    limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
    assert ((o.to(torch.bfloat16).float() - r).abs() <= limit).all()
    assert (lse - rlse).abs().max().item() <= LSE_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_fully_padded_row_matches_jax(causal):
    """A ``mul`` key bias with batch row 1 fully padded, fp32, B=2 T=96 H=2
    d=64: the port's O and lse (the plain version and the emulation) against
    JAX ``flash_attention(key_padding_bias=)`` and ``_fwd`` (interpret
    mode): row 1 O = 0 and lse = NEG_INF on every side, row 0 within 2e-5."""
    B, T, H, d = 2, 96, 2, 64
    q, k, v, kb = _inputs(60 + causal, B, T, H, d, "mul")
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))
    jkb = jnp.asarray(kb.numpy())
    jo = np.asarray(jfa.flash_attention(jq, jk, jv, causal=causal, key_padding_bias=jkb,
                                        block_q=32, block_k=32))
    bhtd = lambda x: x.transpose(0, 2, 1, 3).reshape(B * H, T, d)
    _, jlse = jfa._fwd(bhtd(jq), bhtd(jk), bhtd(jv), 1.0 / np.sqrt(d), causal, 32, 32,
                       n_heads=H, k_bias=jkb)
    jlse = np.asarray(jlse).reshape(B, H, T)
    assert not jo[1].any() and (jlse[1] == fa.NEG_INF).all()
    for o, lse in (fa.flash_fwd_biased(q, k, v, kb, None, causal), emulate(q, k, v, kb, causal)):
        np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=FWD_TOL)
        np.testing.assert_allclose(lse.numpy(), jlse, rtol=0, atol=FWD_TOL)
        assert not o[1].any() and (lse[1] == fa.NEG_INF).all()


# --------------------------------------------------------------- routes
def _names(monkeypatch):
    """Replace ``_run``: record (name, arguments) instead of launching."""
    calls = []
    monkeypatch.setattr(fa, "_run", lambda name, *a, device: calls.append((name, a)))
    return calls


def _meta(shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("abias", [False, True])
def test_biased_forward_routes(monkeypatch, dtype, d, abias):
    """bf16 at head dims 64 and 128 with no (T, T) score bias takes the
    key-bias ``flash_fwd_sm90``, the rest the template ``flash_fwd_biased``,
    through ``flash_fwd_biased``, ``flash_attention(key_padding_bias=)`` and
    ``sparse_flash_attention`` with an all-ones layout; the ``_template``
    wrapper always takes the template."""
    calls = _names(monkeypatch)
    want = SM90 if (dtype, d in (64, 128), abias) == (torch.bfloat16, True, False) else TEMPLATE
    assert fa.biased_fwd_kernel(dtype, d, abias) == want
    B, T, H = 2, 256, 2
    q = _meta((B, T, H, d), dtype)
    kb = _meta((B, T), torch.float32)
    ab = _meta((T, T), torch.float32) if abias else None
    o, lse = fa.flash_fwd_biased(q, q, q, kb, ab, True)
    assert o.shape == q.shape and o.dtype == dtype and lse.shape == (B, H, T)
    fa.flash_fwd_biased_template(q, q, q, kb, ab, False)
    assert [n for n, _ in calls] == [want, TEMPLATE]
    for route in ("flash_attention", "sparse_flash_attention"):
        calls.clear()
        leaves = [_meta((B, T, H, d), dtype) for _ in range(3)]
        if route == "flash_attention":
            fa.flash_attention(*leaves, causal=False, key_padding_bias=kb, attn_bias=ab)
        else:
            fa.sparse_flash_attention(*leaves, np.ones((1, 16, 16), np.int32), causal=False,
                                      key_padding_bias=kb, attn_bias=ab)
        assert [n for n, _ in calls] == [want], route
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_flash_fwd_sm90_takes_the_key_bias_last(monkeypatch):
    """The argument lists the wrappers hand to ``flash_fwd_sm90`` match the
    ``argtypes`` ``_entry`` gives it (the stream after): the key bias's
    pointer just before the stream, null without a bias (the dense forward
    and ``flash_fwd_biased`` with no bias at all)."""
    calls = _names(monkeypatch)
    fake = types.SimpleNamespace(flash_fwd_sm90=types.SimpleNamespace(argtypes=None,
                                                                      restype=None))
    monkeypatch.setattr(builder, "load", lambda lib: fake)
    B, T, H, d = 2, 200, 4, 64
    q, kb = _meta((B, T, H, d)), _meta((B, T), torch.float32)
    fa.flash_fwd_biased(q, q, q, kb, None, True)
    fa.flash_fwd_sm90(q, q, q, False, key_padding_bias=kb)
    fa.flash_fwd(q, q, q, True)
    fa.flash_fwd_biased(q, q, q, None, None, False)
    assert [n for n, _ in calls] == [SM90] * 4
    argtypes = fa._entry(SM90).argtypes
    for (_, args), bias in zip(calls, (kb, kb, None, None)):
        assert len(args) + 1 == len(argtypes)
        assert argtypes[-2] is argtypes[-1] is ctypes.c_void_p     # key bias, stream
        assert args[-1] == (None if bias is None else bias.data_ptr())
        assert args[-6:-3] == (B, T, H) and args[-2] == pytest.approx(1 / 8)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided", "device"])
def test_wrappers_refuse_a_bad_key_bias(bad):
    """A key bias that is not a contiguous fp32 (B, T) tensor on q's device
    is refused before any launch, by the routed wrapper and the sm90 one."""
    B, T, H, d = 2, 128, 2, 64
    q = _meta((B, T, H, d))
    kb = {"shape": _meta((B, T + 1), torch.float32),
          "dtype": _meta((B, T), torch.bfloat16),
          "strided": _meta((T, B), torch.float32).t(),
          "device": torch.zeros((B, T))}[bad]
    for call in (lambda: fa.flash_fwd_biased(q, q, q, kb),
                 lambda: fa.flash_fwd_sm90(q, q, q, key_padding_bias=kb)):
        with pytest.raises(ValueError, match="key_padding_bias"):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_entries_refuse_a_bias_they_do_not_take():
    """The dense template takes no bias and ``flash_fwd_sm90`` no (T, T)
    score bias: a call that hands one over is refused, never launched
    without it."""
    B, T, H, d = 2, 128, 2, 64
    q = _meta((B, T, H, d))
    kb, ab = _meta((B, T), torch.float32), _meta((T, T), torch.float32)
    for call in (lambda: fa._fwd("flash_fwd", q, q, q, True, None, kbias=kb),
                 lambda: fa._fwd(SM90, q, q, q, True, None, abias=ab)):
        with pytest.raises(ValueError, match="takes no"):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_biased_forward_without_nvcc_raises(monkeypatch):
    """With no nvcc the route raises and counts no launch: nothing falls
    back to the template or the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    q, kb = _meta((2, 64, 4, 64)), _meta((2, 64), torch.float32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fa.flash_fwd_biased(q, q, q, kb)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_biased_sm90_forward_matches_its_plain_version_on_the_card():
    """The key-bias ``flash_fwd_sm90`` (O and lse) against the plain version
    on a CUDA card through the biased route, q/k/v as views of one qkv
    tensor, ``add`` and ``mul`` biases (``chip_smoke.py`` phase 7 runs the
    full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    B, H = 2, 4
    for d in (64, 128):
        for T, causal, kind in ((65, True, "add"), (200, False, "mul"), (1000, True, "mul")):
            qkv = torch.randn((B, T, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
            kb = key_bias(kind, rng, B, T).cuda()
            before = fa.launches[SM90]
            o, lse = fa.flash_fwd_biased(q, k, v, kb, None, causal)
            assert fa.launches[SM90] == before + 1
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal, key_padding_bias=kb)
            r = ro.float()
            limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
            assert ((o.float() - r).abs() <= limit).all()
            assert (lse - rlse).abs().max().item() <= LSE_TOL
            if kind == "mul":
                assert not o[1].any() and (lse[1] == fa.NEG_INF).all()
