"""The port's GPT-2 against the JAX model, in fp32 on the CPU
(deepspeed_tpu_torch/models/gpt2.py vs deepspeed_tpu/models/gpt2.py).

Weights come from the JAX ``GPT2.init_numpy`` and reach the port through
``params_from_jax``.  Tolerance 1e-4 on logits of magnitude ~1: the two
frameworks sum the same fp32 matmuls in different orders over 4 layers.
The JAX paged decode runs its Pallas kernel in interpret mode (the
``kernel`` impl) or the gather oracle; the port's runs its plain path."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import paged_kv as jpk
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import paged_kv as tpk
from deepspeed_tpu_torch.models import build
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax

TOL = 1e-4
BS = 8


@pytest.fixture(scope="module")
def tiny():
    jmodel = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, embd_pdrop=0.0,
                   attn_pdrop=0.0, resid_pdrop=0.0)
    np_params = jmodel.init_numpy(seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tmodel = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")
    tparams = params_from_jax(np_params, "cpu", torch.float32)
    return jmodel, jparams, tmodel, tparams, np_params


def test_params_from_jax_round_trip(tiny):
    _, _, tmodel, tparams, np_params = tiny
    flat_np = jax.tree_util.tree_leaves_with_path(np_params)
    flat_t = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in flat_np] == [p for p, _ in flat_t]
    for (path, a), (_, t) in zip(flat_np, flat_t):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))
    # the port's own init_numpy draws the JAX package's numbers
    own = tmodel.init_numpy(seed=0)
    for (_, a), (_, b) in zip(flat_np, jax.tree_util.tree_leaves_with_path(own)):
        np.testing.assert_array_equal(a, b)


def test_prefill_logits_and_cache_match_jax(tiny):
    jmodel, jparams, tmodel, tparams, _ = tiny
    toks = np.random.default_rng(1).integers(0, 1024, (2, 13))
    jlog, jcache = jmodel.apply_with_cache(jparams, jnp.asarray(toks, jnp.int32),
                                           jmodel.init_cache(2, 16))
    tlog, tcache = tmodel.apply_with_cache(tparams, torch.from_numpy(toks),
                                           tmodel.init_cache(2, 16))
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 13, 1024)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL)
    assert tcache["index"] == int(jcache["index"]) == 13
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0, atol=TOL)
    # a decode token on top of the prefill cache
    nxt = np.asarray([[5], [7]])
    jlog2, _ = jmodel.apply_with_cache(jparams, jnp.asarray(nxt, jnp.int32),
                                       jcache)
    tlog2, _ = tmodel.apply_with_cache(tparams, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), rtol=0,
                               atol=TOL)


def _decode_inputs(n_window, kv_bits, c):
    rng = np.random.default_rng(2 + n_window)
    nb_max, nb = 4, 16
    L, H, hd = c.n_layer, c.n_head, c.head_dim
    k = (rng.standard_normal((L, nb * BS, H, hd)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((L, nb * BS, H, hd)) * 0.5).astype(np.float32)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0],
                         [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([25, 9, 0, 0], np.int32)
    toks = rng.integers(0, c.vocab_size, (4, n_window))
    return k, v, tables, lengths, toks, nb


@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("n_window", [1, 3])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_decode_step_paged_matches_jax(tiny, impl, n_window, kv_bits):
    jmodel, jparams, tmodel, tparams, _ = tiny
    c = tmodel.config
    k, v, tables, lengths, toks, nb = _decode_inputs(n_window, kv_bits, c)
    jpool = jpk.write_prefill(
        jpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim, jnp.float32,
                      kv_bits=kv_bits, quant_block=16),
        jnp.arange(nb, dtype=jnp.int32), jnp.asarray(k), jnp.asarray(v))
    tpool = tpk.write_prefill(
        tpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim, torch.float32,
                      kv_bits=kv_bits, quant_block=16, device="cpu"),
        torch.arange(nb), torch.from_numpy(k), torch.from_numpy(v))
    jmodel.config.paged_attention_impl = impl
    tmodel.config.paged_attention_impl = impl
    jt = toks[:, 0] if n_window == 1 else toks
    jlog, jpool = jax.jit(jmodel.decode_step_paged)(
        jparams, jnp.asarray(jt, jnp.int32), jpool, jnp.asarray(tables),
        jnp.asarray(lengths))
    tlog, tpool = tmodel.decode_step_paged(
        tparams, torch.from_numpy(jt), tpool, torch.from_numpy(tables),
        torch.from_numpy(lengths))
    assert tlog.shape == tuple(jlog.shape)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL)
    for name in jpool:
        a, b = np.asarray(jpool[name])[:, 1:], tpool[name].numpy()[:, 1:]
        if name in ("k", "v") and kv_bits == 8:
            # a K/V value that lands on a rounding edge may quantize one
            # step apart after fp32 sums in another order
            assert np.abs(b.astype(np.int32) - a.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=name)


def test_decode_step_clamps_positions_past_max_seq(tiny):
    """A slot at length max_seq-1 decoding a 3-token window: positions
    past max_seq read the last wpe row, as JAX's clamped gather does."""
    jmodel, jparams, tmodel, tparams, _ = tiny
    c = tmodel.config
    nb = c.max_seq // BS + 1
    tables = np.arange(1, nb, dtype=np.int32)[None]
    lengths = np.asarray([c.max_seq - 1], np.int32)
    toks = np.asarray([[3, 4, 5]])
    jmodel.config.paged_attention_impl = "gather"
    tmodel.config.paged_attention_impl = "gather"
    jpool = jpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim, jnp.float32)
    tpool = tpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim,
                          torch.float32, device="cpu")
    jlog, _ = jax.jit(jmodel.decode_step_paged)(
        jparams, jnp.asarray(toks, jnp.int32), jpool, jnp.asarray(tables),
        jnp.asarray(lengths))
    tlog, _ = tmodel.decode_step_paged(
        tparams, torch.from_numpy(toks), tpool, torch.from_numpy(tables),
        torch.from_numpy(lengths))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL)


def test_tied_head_keeps_the_fp32_accumulator_in_bf16():
    """bf16 hidden states and wte through the port's ``_head`` and through
    JAX's ``einsum(..., preferred_element_type=float32)``: within 1e-5
    relative (fp32 sums in another order).  A result rounded to bf16
    before the fp32 cast — the port's head before this fix — is a bf16
    ulp (up to 2**-8 relative) away and fails the same bound."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    wte = (rng.standard_normal((96, 64)) * 0.5).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wte, jnp.bfloat16)
    want = np.asarray(jnp.einsum("btd,vd->btv", jx, jw,
                                 preferred_element_type=jnp.float32))
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, wte))
    model = GPT2(preset="gpt2-tiny", dtype=torch.bfloat16, device="cpu")
    got = model._head({"wte": tw}, tx)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 96)
    bound = 1e-5 * np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= bound
    rounded = (tx @ tw.t()).float().numpy()
    assert np.abs(rounded - want).max() > bound
    # its gradient: the cotangent rounded to bf16, then bf16 products
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    model._head({"wte": tw}, tx).sum().backward()
    ones = torch.ones((15, 96), dtype=torch.bfloat16)
    assert torch.equal(tx.grad.reshape(15, 64), ones @ tw.detach())
    assert torch.equal(tw.grad, ones.t() @ tx.detach().reshape(15, 64))


def test_entry_points_need_cuda_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2(preset="gpt2-tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build("gpt2-tiny")
    assert build("gpt2-tiny", device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build("bert-base")
    assert build("bert-base", device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="Unknown model preset"):
        build("gptj-6b", device="cpu")
