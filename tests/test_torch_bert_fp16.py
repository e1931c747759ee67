"""BERT in fp16 through the port's engine against the JAX engine, on the CPU.

``bert-tiny`` (4 layers, 128 wide, 4 heads, T=64) in fp16 with the
``"fp16"`` block's dynamic loss scaler, AdamW, clip 1.0, gas 2, padded
batches, the same numpy parameters and batches in both packages, through
``initialize`` -> ``train_batch`` for five steps in each attention mode
BERT's recipe runs: the block-sparse layouts ``fixed``, ``bigbird`` and
``bslongformer`` (block 16) and ``"mode": "dense"`` with the padding's key
bias.  On the CPU the port's attention wrappers take their plain fp16
versions (P and dS rounded to fp16, as the kernels round them); the JAX
sparse path runs its Pallas kernels in interpret mode at fp16.

The loss scale starts at 2^16 with a window of 2, so the run grows it
within the five steps.  The scale, the hysteresis and the skipped steps
are equal at every step; the losses agree within LOSS_RTOL = 2^-11
relative, fp16's unit roundoff, as ``test_torch_fp16_train.py`` holds
GPT-2's (the loss is an fp32 mean over fp32 logits of fp16 activations,
which each package rounds after each op from sums in another order)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.bert import Bert as JBert
from deepspeed_tpu.ops.sparse_attention import replace_model_self_attention as j_replace
from deepspeed_tpu.ops.sparse_attention.sparsity_config import (
    build_sparsity_config as j_build)
from deepspeed_tpu.parallel.mesh import make_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import Bert
from deepspeed_tpu_torch.ops.sparse_attention import (build_sparsity_config,
                                                      replace_model_self_attention)
from test_torch_bert import NO_DROPOUT, _batch, _np_params

LOSS_RTOL = 2.0 ** -11
T = 64
STEPS = 5
MODES = {
    "fixed": dict(mode="fixed", block=16, num_local_blocks=2, num_global_blocks=1,
                  different_layout_per_head=True, num_different_global_patterns=2),
    "bigbird": dict(mode="bigbird", block=16, num_random_blocks=1,
                    num_sliding_window_blocks=3, num_global_blocks=1),
    "bslongformer": dict(mode="bslongformer", block=16, num_sliding_window_blocks=3,
                         global_block_indices=[0]),
    "dense": dict(mode="dense", block=16),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scaler(e):
    """(scale, hysteresis, last overflow, iter, skipped steps) of either engine."""
    st = e.state.scale if hasattr(e, "state") else e.scale
    return (float(st.cur_scale), int(st.cur_hysteresis), int(st.last_overflow_iter),
            int(st.iter_num), e.skipped_steps)


@pytest.mark.parametrize("mode", list(MODES))
def test_bert_fp16_engine_follows_the_jax_engine(mode):
    npp = _np_params(max_seq=T)
    batches = [_batch(20 + i, B=2, T=T) for i in range(2 * STEPS)]
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
                    "loss_scale_window": 2, "hysteresis": 2},
           "sparse_attention": dict(MODES[mode])}
    jm = JBert(preset="bert-tiny", dtype=jnp.float16, max_seq=T, **NO_DROPOUT)
    tm = Bert(preset="bert-tiny", dtype=torch.float16, device="cpu", max_seq=T, **NO_DROPOUT)
    je = jds.initialize(config=dict(cfg, compile_cache={"enabled": False}), model=jm,
                        params=npp, mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    te = tds.initialize(config=dict(cfg), model=tm, params=npp)[0]
    j_replace(jm, j_build(je.config.sparse_attention, num_heads=4))
    replace_model_self_attention(tm, build_sparsity_config(te.config.sparse_attention, 4))
    scales = []
    for step in range(STEPS):
        feed = batches[2 * step:2 * step + 2]
        jl, tl = float(je.train_batch(iter(feed))), float(te.train_batch(iter(feed)))
        assert _scaler(te) == _scaler(je), f"step {step + 1}"
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, err_msg=f"step {step + 1}")
        scales.append(_scaler(te)[0])
    assert te.compute_dtype == torch.float16 and te.params["word_embeddings"].dtype == torch.float16
    assert te.global_steps == STEPS and max(scales) > 2.0 ** 16
