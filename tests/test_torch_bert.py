"""The port's BERT masked-LM path against the JAX package's, in fp32 on the
CPU (deepspeed_tpu_torch/models/bert.py, ops/sparse_attention/ and the
engine vs deepspeed_tpu/models/bert.py, ops/sparse_attention/ and its
engine).

``bert-tiny`` (4 layers, 128 wide, 4 heads) at T <= 64, dropout 0, JAX's
own weights carried across with ``bert_params_from_jax``; inputs made with
numpy from a seed.  On the CPU the port's attention wrappers take their
plain versions; the JAX sparse path runs its Pallas kernels in interpret
mode.  Tolerance 1e-4 of the largest value: fp32 matmuls summed in
another order over 4 layers (the sparse path also through the online
softmax of the interpreted kernels)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.bert import Bert as JBert
from deepspeed_tpu.ops.sparse_attention import (
    FixedSparsityConfig as JFixed, extend_position_embedding as j_extend,
    pad_to_block_size as j_pad, replace_model_self_attention as j_replace,
    unpad_sequence_output as j_unpad)
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import Bert, build, bert_params_from_jax
from deepspeed_tpu_torch.ops.sparse_attention import (
    FixedSparsityConfig, extend_position_embedding, pad_to_block_size,
    replace_model_self_attention, unpad_sequence_output)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError

NO_DROPOUT = dict(hidden_dropout=0.0, attn_dropout=0.0)
TOL = 1e-4
SPARSE = dict(block=16, num_local_blocks=2, num_global_blocks=1,
              different_layout_per_head=True, num_different_global_patterns=2)


def _np_params(seed=0, **kw):
    jm = JBert(preset="bert-tiny", dtype=jnp.float32, **kw)
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))


def _batch(seed, B=2, T=64, vocab=1024, padded=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if padded:
        for b, n in enumerate(rng.integers(T // 2, T, B)):
            mask[b, n:] = 0
    labels = np.where((rng.random((B, T)) < 0.15) & (mask > 0), ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]                         # at least one label per row
    tt = (np.arange(T)[None] >= T // 2).astype(np.int32).repeat(B, 0)
    batch = {"input_ids": ids, "labels": labels, "token_type_ids": tt}
    if padded:
        batch["attention_mask"] = mask
    return batch


def _rel_close(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        f"{what}: {err} vs max {np.abs(want).max()}"


def _models(sparse, pre_ln, T):
    jm = JBert(preset="bert-tiny", dtype=jnp.float32, pre_layer_norm=pre_ln, remat=False,
               **NO_DROPOUT)
    tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", pre_layer_norm=pre_ln,
              remat=False, **NO_DROPOUT)
    if sparse:
        j_replace(jm, JFixed(num_heads=4, **SPARSE), max_seq_length=T)
        replace_model_self_attention(tm, FixedSparsityConfig(num_heads=4, **SPARSE),
                                     max_seq_length=T)
    return jm, tm


def test_bert_params_from_jax():
    npp = _np_params()
    tp = bert_params_from_jax(npp, "cpu")
    jl = jax.tree_util.tree_leaves_with_path(npp)
    tl = tutils.tree_leaves(tp)
    assert len(jl) == len(tl) == 22
    for (path, a), b in zip(jl, tl):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_array_equal(b.numpy(), a)
    assert tp["blocks"]["attn_qkvw"].shape == (4, 128, 384)
    bf = bert_params_from_jax(npp, "cpu", torch.bfloat16)
    assert bf["mlm_bias"].dtype == torch.bfloat16


def test_init_draws_jax_shapes_and_scales():
    """``init`` draws the JAX shapes, dtypes and standard deviations (not
    JAX's bits: a torch generator from the seed)."""
    npp = _np_params()
    tm = Bert(preset="bert-tiny", device="cpu")
    tp = tm.init(3)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(npp), tutils.tree_leaves(tp)):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
        if a.std() == 0:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
        else:
            np.testing.assert_allclose(b.std().item(), a.std(), rtol=0.2, err_msg=str(path))
    assert torch.equal(tm.init(3)["word_embeddings"], tp["word_embeddings"])
    assert not torch.equal(tm.init(4)["word_embeddings"], tp["word_embeddings"])


@pytest.mark.parametrize("padded", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("pre_ln", [False, True], ids=["postln", "preln"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_hidden_logits_loss_and_grads_match_jax(sparse, pre_ln, padded):
    T = 64
    jm, tm = _models(sparse, pre_ln, T)
    npp = _np_params(pre_layer_norm=pre_ln)
    jp = jax.tree_util.tree_map(jnp.asarray, npp)
    tp = bert_params_from_jax(npp, "cpu")
    batch = _batch(1 + 2 * int(padded), T=T, padded=padded)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jh = jm.apply(jp, jb["input_ids"], attention_mask=jb.get("attention_mask"),
                  token_type_ids=jb["token_type_ids"])
    th = tm.apply(tp, tb["input_ids"], attention_mask=tb.get("attention_mask"),
                  token_type_ids=tb["token_type_ids"])
    assert th.shape == (2, T, 128) and th.dtype == torch.float32
    _rel_close(th.numpy(), jh, TOL, "hidden")
    _rel_close(tm.mlm_logits(tp, th).detach().numpy(), jm.mlm_logits(jp, jh), TOL, "logits")
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb, jax.random.PRNGKey(0))
    for leaf in tutils.tree_leaves(tp):
        leaf.requires_grad_(True)
    tloss = tm.loss(tp, tb, 0)
    tloss.backward()
    _rel_close(tloss.item(), jloss, TOL, "loss")
    for (path, jg), tg in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                              tutils.tree_leaves(tp)):
        _rel_close(tg.grad.numpy(), jg, TOL, jax.tree_util.keystr(path))
    assert fa.launches == {name: 0 for name in fa.KERNELS}   # no kernel on the CPU


def test_remat_recomputes_the_same_dropout():
    """remat=True recomputes each block under torch.utils.checkpoint with
    the same dropout masks: loss and gradients equal the remat=False run's."""
    npp = _np_params()
    batch = {k: torch.from_numpy(v) for k, v in _batch(5).items()}
    out = []
    for remat in (False, True):
        tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", remat=remat)
        replace_model_self_attention(tm, FixedSparsityConfig(num_heads=4, **SPARSE))
        tp = bert_params_from_jax(npp, "cpu")
        for leaf in tutils.tree_leaves(tp):
            leaf.requires_grad_(True)
        loss = tm.loss(tp, batch, 1234)
        loss.backward()
        out.append((loss.item(), [l.grad.clone() for l in tutils.tree_leaves(tp)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_flop_counts_match_jax():
    for preset in ("bert-tiny", "bert-large"):
        j, t = JBert(preset=preset), build(preset, device="cpu")
        assert (t.num_params(), t.flops_per_token()) == (j.num_params(), j.flops_per_token())
    with pytest.raises(ValueError, match="Unknown preset"):
        build("bert-huge", device="cpu")


# --------------------------------------------------------- sparse helpers
def test_extend_position_embedding_matches_jax():
    npp = _np_params()
    jm = JBert(preset="bert-tiny", dtype=jnp.float32)
    tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu")
    jp, jm = j_extend(jax.tree_util.tree_map(jnp.asarray, npp), jm, 300)
    tp, tm = extend_position_embedding(bert_params_from_jax(npp, "cpu"), tm, 300)
    assert tm.config.max_seq == jm.config.max_seq == 300
    np.testing.assert_array_equal(tp["position_embeddings"].numpy(),
                                  np.asarray(jp["position_embeddings"]))
    assert tp["position_embeddings"].shape == (300, 128)
    with pytest.raises(ValueError):
        extend_position_embedding(tp, tm, 300)


@pytest.mark.parametrize("T", [40, 48])
def test_pad_and_unpad_match_jax(T):
    rng = np.random.default_rng(T)
    ids = rng.integers(0, 100, (3, T)).astype(np.int32)
    mask = np.ones((3, T), np.int32)
    tt = np.zeros((3, T), np.int32)
    want = j_pad(16, ids, mask, tt, pad_token_id=7)
    got = pad_to_block_size(16, ids, mask, tt, pad_token_id=7)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    hidden = rng.standard_normal((3, T + want[0], 8)).astype(np.float32)
    np.testing.assert_array_equal(unpad_sequence_output(want[0], torch.from_numpy(hidden)),
                                  np.asarray(j_unpad(want[0], jnp.asarray(hidden))))


def test_replace_needs_a_model_that_dispatches():
    from deepspeed_tpu_torch.models import GPT2
    with pytest.raises(TypeError, match="does not support sparse attention"):
        replace_model_self_attention(GPT2(preset="gpt2-tiny", device="cpu"),
                                     FixedSparsityConfig(num_heads=4))


# ----------------------------------------------------------------- config
SPARSE_SECTION = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                  "num_local_blocks": 4, "num_global_blocks": 1,
                  "attention": "bidirectional"}


def test_sparse_attention_config_key_is_ported():
    pd = {"train_batch_size": 8, "sparse_attention": SPARSE_SECTION}
    t, j = DeepSpeedConfig(dict(pd)), JConfig(dict(pd), world_size=1)
    assert t.sparse_attention == j.sparse_attention == SPARSE_SECTION
    assert DeepSpeedConfig({"train_batch_size": 8}).sparse_attention is None
    with pytest.raises(ValueError, match="Unknown sparse_attention mode"):
        DeepSpeedConfig({"train_batch_size": 8, "sparse_attention": {"mode": "diagonal"}})
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig({"train_batch_size": 8, "sparse_attention": {"no_such_key": 1}})
    with pytest.raises(ValueError, match="divisible"):
        DeepSpeedConfig({"train_batch_size": 8, "sparse_attention": {
            "mode": "fixed", "num_local_blocks": 3, "num_global_blocks": 2}})


# ----------------------------------------------------------------- engine
def test_initialize_without_params_uses_model_init():
    cfg = {"train_micro_batch_size_per_gpu": 2, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    model = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", **NO_DROPOUT)
    eng, _, _, _ = tds.initialize(config=cfg, model=model, rng_seed=7)
    want = model.init(7)
    assert torch.equal(eng.params["word_embeddings"], want["word_embeddings"])
    loss = eng.train_batch(iter([_batch(2)]))
    assert torch.isfinite(loss) and eng.global_steps == 1


def test_sparse_engine_loss_curve_matches_jax():
    """Five steps of sparse bert-tiny (block 16, per-head layouts, padded
    batches), AdamW + clip 1.0, gas 2, the same params= and batches:
    losses within 1e-4 relative, grad norms alike."""
    T = 64
    npp = _np_params(max_seq=T)
    batches = [_batch(10 + i, B=2, T=T) for i in range(10)]
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "sparse_attention": dict(SPARSE, mode="fixed")}
    jm = JBert(preset="bert-tiny", dtype=jnp.float32, max_seq=T, **NO_DROPOUT)
    tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", max_seq=T, **NO_DROPOUT)
    je, _, _, _ = jds.initialize(config=dict(cfg), model=jm, params=npp,
                                 mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    te, _, _, _ = tds.initialize(config=dict(cfg), model=tm, params=npp)
    from deepspeed_tpu.ops.sparse_attention.sparsity_config import (
        build_sparsity_config as j_build)
    from deepspeed_tpu_torch.ops.sparse_attention import build_sparsity_config
    j_replace(jm, j_build(je.config.sparse_attention, num_heads=4))
    replace_model_self_attention(tm, build_sparsity_config(te.config.sparse_attention, 4))
    for step in range(5):
        feed = batches[2 * step:2 * step + 2]
        jl, tl = float(je.train_batch(iter(feed))), float(te.train_batch(iter(feed)))
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(te.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=1e-4)
    assert (te.global_steps, te.skipped_steps) == (5, 0)
