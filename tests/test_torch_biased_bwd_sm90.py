"""The dense biased bf16 backward for Hopper: the key-bias instances of
``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``
(deepspeed_tpu_torch/csrc/flash_attention_sparse_bwd_sm90.cu), on the CPU.

The kernels run only on a card (``chip_smoke.py`` phases 7, 8c and 9, and
the ``cuda``-marked test below).  Here:

- the kernels' arithmetic with a (B, T) key bias: a torch emulation over
  ``flash_bwd_dkdv_sm90_schedule`` / ``flash_bwd_dq_sm90_schedule`` (64-row
  tiles; rows of q, k, v, dO, lse, delta and the key bias past T read as
  zeros; P = 2^(S scale log2e + kbias log2e - lse log2e), a row of lse
  NEG_INF entering as +inf; the mask of flagged visits; P and dS rounded
  where the kernels round them) against the plain
  ``flash_attention_reference_bwd_*``, ``add`` and ``mul`` biases (``mul``
  with batch row 1 fully padded), causal and not, T from 1 to 1000; and
  against ``jax.grad`` of JAX's biased ``flash_attention`` (Pallas in
  interpret mode, as its own tests run it);
- the route ``biased_bwd_kernel`` through ``flash_bwd_*_biased``,
  ``flash_attention(key_padding_bias=)`` and ``sparse_flash_attention``
  with an all-ones layout, on meta tensors standing for CUDA ones with
  ``_run`` replaced, and the argument list handed to the C entries; the
  refusals of a bias of the wrong shape, dtype, layout or device; with no
  nvcc the route raises and counts no launch.

Tolerances: 2e-5 against the plain version in fp32 (the same formula with
exp2 for exp and the bias in log2 units, summed per visit in another
order); 1e-4 against ``jax.grad`` (fp32, as
``test_flash_attention_with_biases_matches_jax``); with P and dS rounded to
bf16 on both sides, 2^-5 of the rms plus 2^-7 of each element (the limits
``chip_smoke.py`` holds the kernels to)."""

import ctypes
import math
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.transformer.flash_attention import flash_attention as jax_flash
from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

FP32_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = (2 ** -5, 2 ** -7)
TILE = fa.TILE
SM90 = ["flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90"]
TEMPLATES = ["flash_bwd_dkdv_biased", "flash_bwd_dq_biased"]


# ------------------------------------------------ the kernels' arithmetic
def _zero_past_t(x, nt, dim):
    """fp32 ``x`` padded with zeros along ``dim`` (its T axis) to ``nt`` 64-row
    tiles: what TMA and the producer lanes' zero-filled copies read past T."""
    pad = list(x.shape)
    pad[dim] = nt * TILE - x.shape[dim]
    return torch.cat([x.float(), torch.zeros(pad)], dim)


def emulate(q, k, v, do, lse, delta, kbias, causal, sm_scale=None, round_to=None, n_pipes=5):
    """The key-bias instances of ``flash_bwd_dkdv_sm90`` and
    ``flash_bwd_dq_sm90`` in torch, over their schedules as the kernels run
    them: per output tile the other side's visits, S and dP of the 64 x 64
    visit in fp32, P = 2^(S scale log2e + (kb2 - l2)) with kb2 = kbias
    log2e (dK/dV: the item's key rows, loaded once; dQ: the visit's) and l2
    = lse log2e (+inf where lse is NEG_INF), zeros past T; a flagged visit
    masks q >= T (dK/dV) or k >= T (dQ) and, when causal, q < k; dS = P
    (dP scale - delta scale); P and dS rounded to ``round_to`` before dV +=
    P^T dO, dK += dS^T Q, dQ += dS K; rows of an output tile past T
    dropped.  Returns (dq, dk, dv) in fp32."""
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    log2e = 1.0 / math.log(2.0)
    nt = -(-T // TILE)
    rnd = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    q, k, v, do = (_zero_past_t(x, nt, 1) for x in (q, k, v, do))
    lse, delta = _zero_past_t(lse, nt, 2), _zero_past_t(delta, nt, 2)
    kb2 = _zero_past_t(kbias, nt, 1) * log2e
    rows = lambda t: torch.arange(TILE) + t * TILE                # noqa: E731

    def stats(b, h, r):
        ls = lse[b, h, r]
        l2 = torch.where(ls > fa.NEG_INF * 0.5, ls * log2e, torch.full_like(ls, math.inf))
        return l2, delta[b, h, r] * scale

    dk, dv, dq = (torch.zeros((B, nt * TILE, H, d)) for _ in range(3))
    for pipe in fa.flash_bwd_dkdv_sm90_schedule(B, T, H, causal, n_pipes):
        for b, h, kt, visits in pipe:
            kr = rows(kt)
            acc_k, acc_v = torch.zeros((TILE, d)), torch.zeros((TILE, d))
            for qt, masked in visits:
                qr = rows(qt)
                st = k[b, kr, h] @ q[b, qr, h].T                           # (key, query)
                dpt = v[b, kr, h] @ do[b, qr, h].T
                l2, dd = stats(b, h, qr)
                p = torch.exp2(st * (scale * log2e) + (kb2[b, kr][:, None] - l2[None, :]))
                if masked:
                    valid = (qr < T)[None, :] & ((qr[None, :] >= kr[:, None]) | (not causal))
                    p = torch.where(valid, p, torch.zeros_like(p))
                ds = p * (dpt * scale - dd[None, :])
                acc_v += rnd(p) @ do[b, qr, h]
                acc_k += rnd(ds) @ q[b, qr, h]
            dk[b, kr, h], dv[b, kr, h] = acc_k, acc_v
    for pipe in fa.flash_bwd_dq_sm90_schedule(B, T, H, causal, n_pipes):
        for b, h, qt, visits in pipe:
            qr = rows(qt)
            l2, dd = stats(b, h, qr)
            acc = torch.zeros((TILE, d))
            for kt, masked in visits:
                kr = rows(kt)
                s = q[b, qr, h] @ k[b, kr, h].T                            # (query, key)
                dp = do[b, qr, h] @ v[b, kr, h].T
                p = torch.exp2(s * (scale * log2e) + (kb2[b, kr][None, :] - l2[:, None]))
                if masked:
                    valid = (kr < T)[None, :] & ((qr[:, None] >= kr[None, :]) | (not causal))
                    p = torch.where(valid, p, torch.zeros_like(p))
                ds = p * (dp * scale - dd[:, None])
                acc += rnd(ds) @ k[b, kr, h]
            dq[b, qr, h] = acc
    return dq[:, :T], dk[:, :T], dv[:, :T]


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


def _inputs(seed, B, T, H, d, causal, kind, dtype=torch.float32):
    """q, k, v, dO from numpy, the key bias, the plain forward's (O, lse)
    and delta."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, T, H, d)).astype(np.float32))
                   .to(dtype) for _ in range(4))
    kb = key_bias(kind, rng, B, T)
    o, lse = fa.flash_attention_reference_fwd(q, k, v, causal, key_padding_bias=kb)
    return q, k, v, do, lse, fa.attention_delta(o, do), kb


def _plain(q, k, v, do, lse, delta, kb, causal):
    dk, dv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal,
                                                   key_padding_bias=kb)
    dq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal,
                                             key_padding_bias=kb)
    return dq, dk, dv


@pytest.mark.parametrize("kind", ["add", "mul"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1, 63, 65, 200, 1000])
def test_emulation_reproduces_the_plain_version(T, causal, kind):
    """fp32: the emulation over the schedules equals the plain versions at
    T under, past and well past one 64-row tile, ragged; the ``mul`` bias's
    fully padded batch row gets no gradient; the wrappers on CPU tensors
    are the plain versions."""
    B, H, d = 2, 2, 16
    q, k, v, do, lse, delta, kb = _inputs(T + 7 * causal, B, T, H, d, causal, kind)
    got = emulate(q, k, v, do, lse, delta, kb, causal)
    want = _plain(q, k, v, do, lse, delta, kb, causal)
    for call in (fa.flash_bwd_dkdv_biased, fa.flash_bwd_dkdv_biased_template):
        assert all(torch.equal(a, b) for a, b in zip(
            call(q, k, v, do, lse, delta, kb, None, causal), want[1:]))
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, causal, key_padding_bias=kb), want[1:]))
    for dq in (fa.flash_bwd_dq_biased(q, k, v, do, lse, delta, kb, None, causal),
               fa.flash_bwd_dq_biased_template(q, k, v, do, lse, delta, kb, None, causal),
               fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta, causal, key_padding_bias=kb)):
        assert torch.equal(dq, want[0])
    for label, a, r in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=0, atol=FP32_TOL, err_msg=label)
        if kind == "mul":
            assert not a[1].any(), label               # batch row 1: no live key
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("kind", ["add", "mul"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [65, 200])
def test_emulation_with_bf16_rounding_matches_the_plain_version(T, causal, kind):
    """bf16 inputs, P and dS rounded to bf16 as the kernels round them, at
    head dim 64, within the limits the kernels are held to on the card."""
    B, H, d = 2, 2, 64
    q, k, v, do, lse, delta, kb = _inputs(11 + T, B, T, H, d, causal, kind, torch.bfloat16)
    got = emulate(q, k, v, do, lse, delta, kb, causal, round_to=torch.bfloat16)
    want = _plain(q, k, v, do, lse, delta, kb, causal)
    for label, a, r in zip(("dq", "dk", "dv"), got, want):
        r = r.float()
        limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
        assert ((a.to(torch.bfloat16).float() - r).abs() <= limit).all(), label


@pytest.mark.parametrize("kind", ["add", "mul"])
@pytest.mark.parametrize("causal", [True, False])
def test_emulation_matches_jax_grad(causal, kind):
    """dQ, dK and dV of the emulation, fed the port's biased forward,
    against ``jax.grad`` through JAX's ``flash_attention(key_padding_bias=)``
    (Pallas in interpret mode), fp32, B=2 T=96 H=2 d=64.  With ``mul``, batch
    row 1 has no live key: the port gives it no gradient, where JAX's
    backward computes ``exp(S - lse) = 1`` there (ROADMAP.md section C), so
    that row is held to zeros and the others to JAX."""
    B, T, H, d = 2, 96, 2, 64
    rng = np.random.default_rng(40 + 2 * causal + (kind == "mul"))
    q, k, v, w = (rng.standard_normal((B, T, H, d)).astype(np.float32) for _ in range(4))
    kb = key_bias(kind, rng, B, T)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, causal=causal, key_padding_bias=jnp.asarray(kb.numpy()),
                                 block_q=32, block_k=32) * jnp.asarray(w))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tw = map(torch.from_numpy, (q, k, v, w))
    o, lse = fa.flash_attention_reference_fwd(tq, tk, tv, causal, key_padding_bias=kb)
    got = emulate(tq, tk, tv, tw, lse, fa.attention_delta(o, tw), kb, causal)
    live = [0] if kind == "mul" else [0, 1]
    for label, a, jg in zip(("dq", "dk", "dv"), got, jgrads):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(jg)[live], rtol=0,
                                   atol=GRAD_TOL, err_msg=label)
        if kind == "mul":
            assert not a[1].any(), label


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
def test_biased_backward_routes(monkeypatch, dtype, d, abias):
    """bf16 at head dim 64 with no (T, T) score bias takes the sm90 pair,
    the rest the templates, through ``flash_bwd_*_biased``,
    ``flash_attention(key_padding_bias=)`` and ``sparse_flash_attention``
    with an all-ones layout; the forward takes the kernel
    ``biased_fwd_kernel`` names (the key-bias ``flash_fwd_sm90`` for bf16 at
    head dims 64 and 128 with no score bias); the ``_template`` wrappers
    always take the templates."""
    calls = _names(monkeypatch)
    want = SM90 if (dtype, d, abias) == (torch.bfloat16, 64, False) else TEMPLATES
    assert list(fa.biased_bwd_kernel(dtype, d, abias)) == want
    B, T, H = 2, 256, 2
    q = _meta((B, T, H, d), dtype)
    lse = _meta((B, H, T), torch.float32)
    kb = _meta((B, T), torch.float32)
    ab = _meta((T, T), torch.float32) if abias else None
    dk, dv = fa.flash_bwd_dkdv_biased(q, q, q, q, lse, lse, kb, ab, True)
    dq = fa.flash_bwd_dq_biased(q, q, q, q, lse, lse, kb, ab, True)
    assert dk.shape == dv.shape == dq.shape == q.shape and dq.dtype == dtype
    fa.flash_bwd_dkdv_biased_template(q, q, q, q, lse, lse, kb, ab, False)
    fa.flash_bwd_dq_biased_template(q, q, q, q, lse, lse, kb, ab, False)
    assert [n for n, _ in calls] == want + TEMPLATES
    for route in ("flash_attention", "sparse_flash_attention"):
        calls.clear()
        leaves = [_meta((B, T, H, d), dtype, grad=True) for _ in range(3)]
        if route == "flash_attention":
            out = fa.flash_attention(*leaves, causal=False, key_padding_bias=kb, attn_bias=ab)
        else:
            out = fa.sparse_flash_attention(*leaves, np.ones((1, 16, 16), np.int32),
                                            causal=False, key_padding_bias=kb, attn_bias=ab)
        out.sum().backward()                 # a cotangent of stride 0
        assert [n for n, _ in calls] == [fa.biased_fwd_kernel(dtype, d, abias)] + want, route
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_dense_sm90_entries_take_the_key_bias_last(monkeypatch):
    """The argument lists the wrappers hand to the C entries match the
    ``argtypes`` ``_entry`` gives them (the stream after): the key bias's
    pointer just before the stream, null without a bias."""
    calls = _names(monkeypatch)
    fake = types.SimpleNamespace(**{n: types.SimpleNamespace(argtypes=None, restype=None)
                                    for n in SM90})
    monkeypatch.setattr(builder, "load", lambda lib: fake)
    B, T, H, d = 2, 200, 4, 64
    q, lse, kb = _meta((B, T, H, d)), _meta((B, H, T), torch.float32), _meta((B, T),
                                                                              torch.float32)
    fa.flash_bwd_dkdv_biased(q, q, q, q, lse, lse, kb, None, True)
    fa.flash_bwd_dq_biased(q, q, q, q, lse, lse, kb, None, True)
    fa.flash_bwd_dkdv(q, q, q, q, lse, lse, True)
    fa.flash_bwd_dq(q, q, q, q, lse, lse, True)
    assert [n for n, _ in calls] == SM90 + SM90
    for (name, args), bias in zip(calls, (kb, kb, None, None)):
        argtypes = fa._entry(name).argtypes
        assert len(args) + 1 == len(argtypes), name
        assert argtypes[-2] is argtypes[-1] is ctypes.c_void_p, name    # key bias, stream
        assert args[-1] == (None if bias is None else bias.data_ptr()), name
        assert args[-6:-3] == (B, T, H) and args[-2] == pytest.approx(1 / 8)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


@pytest.mark.parametrize("bad,match", [
    ("shape", "key_padding_bias"), ("dtype", "key_padding_bias"),
    ("strided", "key_padding_bias"), ("device", "key_padding_bias")])
def test_wrappers_refuse_a_bad_key_bias(bad, match):
    """A key bias that is not a contiguous fp32 (B, T) tensor on q's device
    is refused before any launch, by the routed wrappers and the sm90 ones."""
    B, T, H, d = 2, 128, 2, 64
    q, lse = _meta((B, T, H, d)), _meta((B, H, T), torch.float32)
    kb = {"shape": _meta((B, T + 1), torch.float32),
          "dtype": _meta((B, T), torch.bfloat16),
          "strided": _meta((T, B), torch.float32).t(),
          "device": torch.zeros((B, T))}[bad]
    for call in (lambda: fa.flash_bwd_dkdv_biased(q, q, q, q, lse, lse, kb),
                 lambda: fa.flash_bwd_dq_biased(q, q, q, q, lse, lse, kb),
                 lambda: fa.flash_bwd_dkdv_sm90(q, q, q, q, lse, lse, key_padding_bias=kb),
                 lambda: fa.flash_bwd_dq_sm90(q, q, q, q, lse, lse, key_padding_bias=kb)):
        with pytest.raises(ValueError, match=match):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_entries_refuse_a_bias_they_do_not_take():
    """The dense templates take no bias and the sm90 pair no (T, T) score
    bias: a call that hands one over is refused, never launched without
    it."""
    B, T, H, d = 2, 128, 2, 64
    q, lse = _meta((B, T, H, d)), _meta((B, H, T), torch.float32)
    kb, ab = _meta((B, T), torch.float32), _meta((T, T), torch.float32)
    for call in (lambda: fa._bwd_dkdv("flash_bwd_dkdv", q, q, q, q, lse, lse, True, None,
                                      kbias=kb),
                 lambda: fa._bwd_dq("flash_bwd_dq_sm90", q, q, q, q, lse, lse, True, None,
                                    abias=ab)):
        with pytest.raises(ValueError, match="takes no"):
            call()
    assert fa.launches == {n: 0 for n in fa.KERNELS}


def test_biased_route_without_nvcc_raises(monkeypatch):
    """With no nvcc the route raises and counts no launch: nothing falls
    back to the template or the plain version."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(builder, "_loaded", {})
    monkeypatch.setattr(builder, "find_nvcc", no_nvcc)
    monkeypatch.setattr(builder, "_library_path", lambda name: builder.BUILD_DIR / "absent.so")
    q, lse, kb = _meta((2, 64, 4, 64)), _meta((2, 4, 64), torch.float32), _meta((2, 64),
                                                                                torch.float32)
    for call in (fa.flash_bwd_dkdv_biased, fa.flash_bwd_dq_biased):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call(q, q, q, q, lse, lse, kb)
    assert fa.launches == {n: 0 for n in fa.KERNELS}


# ------------------------------------------------------------- the card
@pytest.mark.cuda
def test_biased_sm90_backward_matches_its_plain_versions_on_the_card():
    """The key-bias instances of flash_bwd_dkdv_sm90 and flash_bwd_dq_sm90
    against the plain versions on a CUDA card, through the biased route, q/k/v
    as views of one qkv tensor, ``add`` and ``mul`` biases (``chip_smoke.py``
    phase 7 runs the full sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    B, H, d = 2, 4, 64
    for T, causal, kind in ((65, True, "add"), (200, False, "mul"), (1000, False, "add")):
        qkv = torch.randn((B, T, 3 * H * d), generator=gen, device="cuda").to(torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
        do = torch.randn((B, T, H, d), generator=gen, device="cuda").to(torch.bfloat16)
        kb = key_bias(kind, rng, B, T).cuda()
        o, lse = fa.flash_fwd_biased(q, k, v, kb, None, causal)
        delta = fa.attention_delta(o, do)
        before = [fa.launches[n] for n in SM90]
        got = (fa.flash_bwd_dq_biased(q, k, v, do, lse, delta, kb, None, causal),
               *fa.flash_bwd_dkdv_biased(q, k, v, do, lse, delta, kb, None, causal))
        assert [fa.launches[n] for n in SM90] == [x + 1 for x in before]
        for a, r in zip(got, _plain(q, k, v, do, lse, delta, kb, causal)):
            r = r.float()
            limit = BF16_TOL[0] * r.pow(2).mean().sqrt() + BF16_TOL[1] * r.abs()
            assert ((a.float() - r).abs() <= limit).all()
