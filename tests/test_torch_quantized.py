"""The port's block quantizer against the JAX one, bit for bit
(deepspeed_tpu_torch/runtime/comm/quantized.py vs
deepspeed_tpu/runtime/comm/quantized.py): the int8 KV pool stores what it
produces and the CUDA kernels dequantize with the same formula."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu.runtime.comm import quantized as jq
from deepspeed_tpu_torch.runtime.comm import quantized as tq


def _cases():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal((3, 5, 64)).astype(np.float32)
    # ties at .5 after the divide: a block whose amax is 127 has scale
    # exactly 1, so x / scale keeps the halves
    ties = np.zeros((2, 64), np.float32)
    ties[:, 0] = 127.0
    ties[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    ties[1, 1:9] = [3.5, 4.5, -3.5, -4.5, 10.5, 11.5, 0.5, -0.5]
    zeros = np.zeros((4, 64), np.float32)                  # all-zero blocks
    mixed = rng.standard_normal((4, 64)).astype(np.float32)
    mixed[1] = 0.0
    nonfinite = rng.standard_normal((3, 64)).astype(np.float32) * 3
    nonfinite[0, 3] = np.nan
    nonfinite[1, 10] = np.inf
    nonfinite[2, 20] = -np.inf
    nonfinite[2, 40:48] = np.nan                       # a whole block NaN
    big = (rng.standard_normal((2, 7, 128)) * 1e4).astype(np.float32)
    return {"normal": normal, "ties": ties, "zeros": zeros, "mixed": mixed,
            "nonfinite": nonfinite, "big": big}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("block", [8, 16, 64])
def test_quantize_blockwise_bit_identical(name, block):
    x = CASES[name]
    jqv, jsv = jq.quantize_blockwise(jnp.asarray(x), block_size=block, bits=8)
    tqv, tsv = tq.quantize_blockwise(torch.from_numpy(x), block_size=block)
    assert tqv.dtype == torch.int8 and tsv.dtype == torch.float32
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    # scales compared as bits, not values
    np.testing.assert_array_equal(tsv.numpy().view(np.uint32),
                                  np.asarray(jsv).view(np.uint32))


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_dequantize_blockwise_bit_identical(name, out_dtype):
    x = CASES[name]
    jqv, jsv = jq.quantize_blockwise(jnp.asarray(x), block_size=16, bits=8)
    jd = jq.dequantize_blockwise(jqv, jsv, bits=8,
                                 out_dtype=getattr(jnp, out_dtype))
    td = tq.dequantize_blockwise(torch.from_numpy(np.array(jqv)),
                                 torch.from_numpy(np.array(jsv)),
                                 out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))


def test_pick_block_matches_jax():
    for n in range(0, 200):
        for b in (1, 3, 8, 16, 64, 1024):
            assert tq.pick_block(n, b) == jq.pick_block(n, b), (n, b)


def test_round_half_to_even_in_both_frameworks():
    x = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    want = np.asarray([0, 2, 2, -0, -2, -2, 4], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(jnp.round(jnp.asarray(x))), want)


def test_only_8_bit_is_ported():
    with pytest.raises(NotImplementedError):
        tq.quantize_blockwise(torch.zeros(4, 8), block_size=8, bits=4)
