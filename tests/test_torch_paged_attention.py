"""The port's paged attention and pool writes against the JAX package,
in fp32 on the CPU (deepspeed_tpu_torch/ops/transformer/paged_attention.py
and inference/paged_kv.py vs their deepspeed_tpu counterparts).

On the CPU the port's ``paged_attention`` takes its plain version (the
CUDA kernels are compared with it on the card by ``chip_smoke.py``).  It
is held against two JAX references: the ``gather_kv`` +
``GPT2._attend_paged`` oracle, and the Pallas kernel in exact mode, run
in interpret mode as the JAX package's own tests run it.  Tolerance
1e-5 in fp32: both sides compute the same fp32 formula, and only the
order of the score and AV sums differs."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import paged_kv as jpk
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2, GPT2Config as JConfig
from deepspeed_tpu.ops.transformer.paged_attention import (
    paged_attention as jax_paged_attention)
from deepspeed_tpu_torch.inference import paged_kv as tpk
from deepspeed_tpu_torch.ops.transformer import paged_attention as tpa

BS, NB_MAX, NB, L, H, HD = 8, 4, 16, 2, 4, 16
TOL = 1e-5

# ragged lengths: partial last block, exact block multiple, first row of
# a block, a single token, and an inactive all-scratch slot
TABLES = np.asarray([[1, 2, 3, 4],
                     [5, 6, 7, 0],
                     [8, 9, 0, 0],
                     [10, 0, 0, 0],
                     [0, 0, 0, 0]], np.int32)
LENGTHS = np.asarray([28, 21, 8, 0, 0], np.int32)


def _jax_model():
    cfg = JConfig(vocab_size=64, max_seq=BS * NB_MAX, n_embd=H * HD,
                  n_layer=L, n_head=H, embd_pdrop=0.0, attn_pdrop=0.0,
                  resid_pdrop=0.0, attention_impl="jnp")
    return JGPT2(cfg, dtype=jnp.float32)


def _pools(seed, kv_bits):
    """The same pool built by each package's write_prefill."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, NB * BS, H, HD)).astype(np.float32)
    v = rng.standard_normal((L, NB * BS, H, HD)).astype(np.float32)
    jpool = jpk.write_prefill(
        jpk.init_pool(L, NB, BS, H, HD, jnp.float32, kv_bits=kv_bits,
                      quant_block=8),
        jnp.arange(NB, dtype=jnp.int32), jnp.asarray(k), jnp.asarray(v))
    tpool = tpk.write_prefill(
        tpk.init_pool(L, NB, BS, H, HD, torch.float32, kv_bits=kv_bits,
                      quant_block=8),
        torch.arange(NB), torch.from_numpy(k), torch.from_numpy(v))
    return jpool, tpool


def _assert_pools_equal(jpool, tpool, skip_scratch=False):
    assert sorted(jpool) == sorted(tpool)
    for name in jpool:
        a, b = np.asarray(jpool[name]), tpool[name].numpy()
        if skip_scratch:
            a, b = a[:, 1:], b[:, 1:]
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_write_prefill_matches_jax(kv_bits):
    jpool, tpool = _pools(0, kv_bits)
    _assert_pools_equal(jpool, tpool)


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("n_window", [1, 3])
@pytest.mark.parametrize("layer", [0, 1])
def test_paged_attention_matches_jax_oracle_and_exact_kernel(kv_bits,
                                                             n_window, layer):
    jpool, tpool = _pools(1, kv_bits)
    rng = np.random.default_rng(2)
    q = rng.standard_normal((TABLES.shape[0], n_window, H, HD)).astype(
        np.float32)
    keys, vals = jpk.gather_kv(jpool, layer, jnp.asarray(TABLES), jnp.float32)
    oracle = np.asarray(_jax_model()._attend_paged(
        jnp.asarray(q), keys, vals, jnp.asarray(LENGTHS)))
    exact = np.asarray(jax.jit(
        lambda q, p: jax_paged_attention(q, p, TABLES, LENGTHS, layer,
                                         mode="exact"))(jnp.asarray(q), jpool))
    for mode in ("auto", "exact", "online"):
        out = tpa.paged_attention(torch.from_numpy(q), tpool,
                                  torch.from_numpy(TABLES),
                                  torch.from_numpy(LENGTHS), layer, mode=mode)
        assert out.shape == (TABLES.shape[0], n_window, H * HD)
        np.testing.assert_allclose(out.numpy(), oracle, rtol=0, atol=TOL)
        np.testing.assert_allclose(out.numpy(), exact, rtol=0, atol=TOL)
    assert all(n == 0 for n in tpa.launches.values())   # no kernel on the CPU


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_gather_kv_matches_jax(kv_bits):
    jpool, tpool = _pools(3, kv_bits)
    jk, jv = jpk.gather_kv(jpool, 1, jnp.asarray(TABLES), jnp.float32)
    tk, tv = tpk.gather_kv(tpool, 1, torch.from_numpy(TABLES), torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("kv_bits", [16, 8])
@pytest.mark.parametrize("n_window", [1, 3])
def test_write_tokens_matches_jax_with_overflow_to_scratch(kv_bits, n_window):
    """Window positions past the table's end go to the scratch block,
    never to the table's last real block (slot 0 at length 30 with W=3
    overflows; inactive slots write scratch too)."""
    jpool, tpool = _pools(4, kv_bits)
    lengths = np.asarray([30, 21, 8, 0, 0], np.int32)
    rng = np.random.default_rng(5)
    shape = (TABLES.shape[0], n_window, H, HD)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    last_real = tpool["k"][1, 4].clone()
    jpool = jpk.write_tokens(jpool, 1, jnp.asarray(TABLES),
                             jnp.asarray(lengths), jnp.asarray(k),
                             jnp.asarray(v))
    tpk.write_tokens(tpool, 1, torch.from_numpy(TABLES),
                     torch.from_numpy(lengths), torch.from_numpy(k),
                     torch.from_numpy(v))
    # several slots write the scratch block: which write lands there is
    # unspecified in both frameworks, so scratch is left out
    _assert_pools_equal(jpool, tpool, skip_scratch=True)
    if n_window == 3:
        # position 30 → block 4 row 6, 31 → row 7, 32 → past the table
        assert not torch.equal(tpool["k"][1, 4], last_real)
        np.testing.assert_array_equal(tpool["k"][1, 4, :6].numpy(),
                                      last_real[:6].numpy())


def test_block_allocator_refcounts_and_recycling():
    a = tpk.BlockAllocator(6)
    assert a.free_blocks == 5
    got = a.alloc(3)
    assert tpk.SCRATCH_BLOCK not in got and a.alloc(3) is None
    a.incref(got[:1])
    assert a.free(got) == got[1:]            # shared block survives
    assert a.refcount(got[0]) == 1 and a.free([got[0]]) == [got[0]]
    assert a.free_blocks == 5
    with pytest.raises(ValueError, match="double free"):
        a.free([got[0]])
    with pytest.raises(ValueError, match="scratch"):
        a.free([tpk.SCRATCH_BLOCK])


def test_pool_helpers_match_jax():
    for kv_bits in (16, 8):
        j = jpk.init_pool(L, NB, BS, H, HD, jnp.float32, kv_bits=kv_bits,
                          quant_block=8)
        t = tpk.init_pool(L, NB, BS, H, HD, torch.float32, kv_bits=kv_bits,
                          quant_block=8)
        assert tpk.is_quantized_pool(t) == jpk.is_quantized_pool(j)
        assert tpk.pool_quant_block(t) == jpk.pool_quant_block(j)
        assert tpk.pool_bytes(t) == jpk.pool_bytes(j)
        assert tpk.capacity_tokens(t) == jpk.capacity_tokens(j)
    for n in (1, 7, 8, 9, 64):
        assert tpk.blocks_needed(n, 8) == jpk.blocks_needed(n, 8)


def test_wrapper_checks_shapes_and_modes():
    _, tpool = _pools(6, 16)
    q = torch.zeros(TABLES.shape[0], 1, H, HD)
    with pytest.raises(ValueError, match="mode"):
        tpa.paged_attention(q, tpool, torch.from_numpy(TABLES),
                            torch.from_numpy(LENGTHS), 0, mode="fast")
    with pytest.raises(ValueError, match="does not match"):
        tpa.paged_attention(torch.zeros(5, 1, H + 1, HD), tpool,
                            torch.from_numpy(TABLES),
                            torch.from_numpy(LENGTHS), 0)
    with pytest.raises(ValueError, match="layer"):
        tpa.paged_attention(q, tpool, torch.from_numpy(TABLES),
                            torch.from_numpy(LENGTHS), L)


def test_kernel_launcher_refuses_bad_operands_before_building():
    """The CUDA launcher's operand checks run before any build, so they
    are exercised here on CPU tensors."""
    tables, lengths = torch.from_numpy(TABLES), torch.from_numpy(LENGTHS)
    _, pool16 = _pools(7, 16)
    _, pool8 = _pools(7, 8)
    q = torch.zeros(TABLES.shape[0], 1, H, HD)
    launch = lambda *a: tpa._launch("paged_attention_online", *a, 0, True)
    with pytest.raises(ValueError, match="int32"):
        launch(q, pool16, tables.long(), lengths)
    with pytest.raises(ValueError, match="compute dtype"):
        launch(q.double(), pool16, tables, lengths)
    with pytest.raises(ValueError, match="16-bit pool"):
        launch(q.half(), pool16, tables, lengths)
    with pytest.raises(ValueError, match="scales"):
        launch(q, dict(pool8, v_scale=pool8["v_scale"][..., :1].contiguous()),
               tables, lengths)
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.zeros(H, HD, TABLES.shape[0], 1).permute(2, 3, 0, 1),
               pool16, tables, lengths)
    with pytest.raises(ValueError, match="window"):
        launch(torch.zeros(TABLES.shape[0], 9, H, HD), pool16, tables,
               lengths)
    with pytest.raises(ValueError, match="head_dim"):
        launch(q, pool16, tables, lengths)        # HD = 16 has no kernel
    assert all(n == 0 for n in tpa.launches.values())
