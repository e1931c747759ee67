"""The engine's captured training step (``runtime/engine.py`` through
``runtime/step_graph.py``) on the CPU.

There is no CUDA graph here.  On the CPU the step body is called directly
(``step_impl`` "auto" / "graph" without a pool, and "eager").  Two stand-in
graph objects drive the capture path: :class:`FakeGraph` records the
calls and replays nothing, which holds the bookkeeping (the warm-up and
the capture train nothing; launches count warm-ups and replays, not the
capture; failures raise naming the step); :class:`ReplayGraph` computes on
``replay()`` what a CUDA replay computes: the captured body over the same
static buffers, its dropout draws taken from the generators registered
before the capture and re-seeded before the replay.  Through it the
engine curves of the reviewers' probe configurations, bf16 and
BERT-tiny's sparse modes are held against the JAX engine on a 1-device
mesh, within ``test_engine_loss_curve_matches_jax``'s 1e-4 relative (bf16
grad norms within two bf16 unit roundoffs, see ``BF16_GNORM_RTOL``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.bert import Bert as JBert
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.sparse_attention import replace_model_self_attention as j_replace
from deepspeed_tpu.ops.sparse_attention.sparsity_config import (
    build_sparsity_config as j_build)
from deepspeed_tpu.parallel.mesh import make_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.inference.engine import sample_seed
from deepspeed_tpu_torch.models import Bert
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.sparse_attention import (build_sparsity_config,
                                                      replace_model_self_attention)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.runtime import step_graph as sg
from deepspeed_tpu_torch.runtime.step_graph import FoldedSeed, GraphPool
from deepspeed_tpu_torch.runtime.utils import tree_leaves

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
RTOL = 1e-4                 # test_engine_loss_curve_matches_jax's tolerance
# bf16 grad norms: the gradients are bf16 products summed in another order
# and rounded to bf16 per element; the widest reading over the 5 steps was
# 2.1e-3 relative, one bf16 unit roundoff (2^-9); the limit is two.  bf16
# losses keep RTOL (widest reading 3.6e-5), as tests/test_torch_checkpoint.py's
BF16_GNORM_RTOL = 2 * 2.0 ** -9
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)
BASE = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
        "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                     "warmup_max_lr": 1e-3}}}



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models here run fastest on one thread: more threads spin on
    ops of a few thousand elements and, beside the other test workers,
    multiply the suite's CPU time.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records the calls, keeps
    the registered generators, replays nothing."""

    def __init__(self, fail_replay=False):
        self.calls, self.generators, self.fail_replay = [], [], fail_replay

    def register_generator_state(self, g):
        self.generators.append(g)

    def capture_begin(self, pool=None):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        if self.fail_replay:
            raise RuntimeError("replay refused")
        self.calls.append("replay")


class ReplayGraph(FakeGraph):
    """``replay()`` computes what a CUDA replay of the engine's step
    computes: the body over the static buffers, each dropout draw from the
    k-th registered generator (re-seeded by the StepGraph before the
    replay), results written into the static outputs."""

    def __init__(self, engine):
        super().__init__()
        self.engine = engine

    def replay(self):
        step = next(s for s in self.engine._steps.values() if s._graph is self)
        with step._drawing("capture"):
            out = step.body(**step._args())
        for k, v in out.items():
            step._outputs[k].copy_(v)
        self.calls.append("replay")


def _graph_path(engine, factory=None):
    """Give ``engine`` a pool of stand-in graphs (ReplayGraph by default)."""
    engine.step_impl = "graph"
    engine._graphs = GraphPool("cpu", graph_factory=factory or (lambda: ReplayGraph(engine)))
    return engine


def _gpt2(cfg, impl="auto", np_params=None, dtype=torch.float32, tokens=TOKENS, **model_kw):
    kw = dict(NO_DROPOUT, **model_kw)
    tm = GPT2(preset="gpt2-tiny", dtype=dtype, device="cpu", max_seq=32, **kw)
    np_params = np_params if np_params is not None else _np_params()
    te = tds.initialize(config=dict(cfg), model=tm, params=np_params,
                        training_data=(tokens,),
                        step_impl="eager" if impl == "eager" else "auto")[0]
    return _graph_path(te) if impl == "replay" else te


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _jax_gpt2(cfg, np_params=None, dtype=jnp.float32, tokens=TOKENS):
    jm = JGPT2(preset="gpt2-tiny", dtype=dtype, max_seq=32, **NO_DROPOUT)
    np_params = np_params if np_params is not None else _np_params()
    return jds.initialize(config=dict(cfg, compile_cache={"enabled": False}), model=jm,
                          params=np_params, training_data=(tokens,),
                          mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]


def _curves_match(je, te, steps=5, gnorm_rtol=RTOL):
    for _ in range(steps):
        jl, tl = float(je.train_batch()), float(te.train_batch())
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=gnorm_rtol)
        assert te.get_lr() == pytest.approx(je.get_lr(), rel=2.5e-7)
    assert (te.global_steps, te.skipped_steps) == (steps, 0)


def _state(te):
    """Every state tensor of the engine, by name."""
    out = {f"params/{i}": t for i, t in enumerate(tree_leaves(te.params))}
    if te.master is not None:
        out.update({f"master/{i}": t for i, t in enumerate(tree_leaves(te.master))})
    out.update({f"opt/{i}": t for i, t in enumerate(tree_leaves(te.opt_state))})
    out["optimizer_steps"], out["skipped_steps"] = te._optimizer_steps, te._skipped_steps
    if te.health is not None:
        out.update({f"health/{i}": t for i, t in enumerate(te.health)})
    return out


# ------------------------------------------------ (1) the body against JAX
@pytest.fixture(scope="module")
def jax_base_curve():
    """The JAX engine's losses, grad norms and lrs over 5 steps of BASE."""
    je = _jax_gpt2(BASE)
    out = []
    for _ in range(5):
        out.append((float(je.train_batch()), je.get_global_grad_norm(), je.get_lr()))
    return out


@pytest.mark.parametrize("impl", ["auto", "eager", "replay"])
def test_step_body_matches_the_jax_engine(impl, jax_base_curve):
    """The step body through each step_impl (the CPU's direct call, the
    eager path, the capture path with a computing stand-in graph) gives the
    JAX engine's losses, grad norms and lrs over 5 steps (AdamW, clip,
    WarmupLR, gas 2)."""
    te = _gpt2(BASE, impl)
    assert te.step_impl == ("eager" if impl == "eager" else "graph")
    for jl, jg, jlr in jax_base_curve:
        np.testing.assert_allclose(float(te.train_batch()), jl, rtol=RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(), jg, rtol=RTOL)
        assert te.get_lr() == pytest.approx(jlr, rel=2.5e-7)
    assert (te.global_steps, te.skipped_steps) == (5, 0)
    g = te.stats()["graphs"]
    assert (g["graphs"], g["captures"], g["warmups"], g["replays"]) == (
        (1, 1, 1, 5) if impl == "replay" else (0, 0, 0, 0))


# the reviewers' probe configurations and bf16 (Lamb's and SGD's curves:
# tests/test_torch_lamb_sgd.py)
PROBES = {
    "adam-wd-betas-zero2-warmupdecay": dict(
        BASE, gradient_accumulation_steps=1, gradient_clipping=0.0,
        optimizer={"type": "Adam", "params": {"lr": 1e-3, "weight_decay": 0.05,
                                              "betas": [0.8, 0.95]}},
        zero_optimization={"stage": 2},
        scheduler={"type": "WarmupDecayLR", "params": {
            "warmup_num_steps": 2, "total_num_steps": 6, "warmup_max_lr": 1e-3}}),
    "adamw-gas3-clip05-zero1-onecycle": dict(
        BASE, gradient_accumulation_steps=3, gradient_clipping=0.5,
        zero_optimization={"stage": 1},
        scheduler={"type": "OneCycle", "params": {
            "cycle_min_lr": 1e-4, "cycle_max_lr": 1e-3, "cycle_first_step_size": 2}}),
    "lrrangetest-batch8": dict(
        BASE, train_batch_size=8, train_micro_batch_size_per_gpu=None,
        gradient_accumulation_steps=None,
        scheduler={"type": "LRRangeTest", "params": {
            "lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 2,
            "lr_range_test_step_rate": 1.0}}),
    "bf16-adamw-warmuplr": dict(BASE, bf16={"enabled": True}),
}


@pytest.mark.parametrize("name", list(PROBES))
def test_probe_configs_match_the_jax_engine_through_the_graph_path(name):
    cfg = {k: v for k, v in PROBES[name].items() if v is not None}
    bf16 = "bf16" in cfg
    te = _gpt2(cfg, "replay", dtype=torch.bfloat16 if bf16 else torch.float32)
    _curves_match(_jax_gpt2(cfg, dtype=jnp.bfloat16 if bf16 else jnp.float32), te,
                  gnorm_rtol=BF16_GNORM_RTOL if bf16 else RTOL)
    assert te.stats()["graphs"]["replays"] == 5


BERT_SPARSE = {"dense": {"mode": "dense", "block": 16},
               "bigbird": {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
                           "num_sliding_window_blocks": 3, "num_global_blocks": 1},
               "bslongformer": {"mode": "bslongformer", "block": 16,
                                "num_sliding_window_blocks": 3,
                                "global_block_indices": [0]}}


def _bert_batch(seed, B=2, T=64, vocab=1024):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b, n in enumerate(rng.integers(T // 2, T, B)):
        mask[b, n:] = 0
    labels = np.where((rng.random((B, T)) < 0.15) & (mask > 0), ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "token_type_ids": np.zeros_like(ids)}


@pytest.mark.parametrize("mode", list(BERT_SPARSE))
def test_bert_sparse_modes_match_the_jax_engine_through_the_graph_path(mode):
    T = 64
    jm = JBert(preset="bert-tiny", dtype=jnp.float32, max_seq=T, hidden_dropout=0.0,
               attn_dropout=0.0)
    npp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "scheduler": {"type": "WarmupDecayLR", "params": {
               "warmup_num_steps": 2, "total_num_steps": 6, "warmup_max_lr": 1e-3}},
           "sparse_attention": BERT_SPARSE[mode]}
    tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", max_seq=T,
              hidden_dropout=0.0, attn_dropout=0.0)
    je = jds.initialize(config=dict(cfg, compile_cache={"enabled": False}), model=jm,
                        params=npp, mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    te = _graph_path(tds.initialize(config=dict(cfg), model=tm, params=npp)[0])
    j_replace(jm, j_build(je.config.sparse_attention, num_heads=4))
    replace_model_self_attention(tm, build_sparsity_config(te.config.sparse_attention, 4))
    batches = [_bert_batch(20 + i, T=T) for i in range(10)]
    for step in range(5):
        feed = batches[2 * step:2 * step + 2]
        jl, tl = float(je.train_batch(iter(feed))), float(te.train_batch(iter(feed)))
        np.testing.assert_allclose(tl, jl, rtol=RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=RTOL)
    assert te.stats()["graphs"]["replays"] == 5


# --------------------------------------------------- (2) the capture path
def _regression(params, batch, rng):
    fa.launches["flash_fwd_sm90"] += 1            # stands in for a kernel launch
    pred = batch["x"].to(params["w"].dtype) @ params["w"] + params["b"]
    return (pred.float() - batch["y"]).square().mean()


def _regression_engine(impl="auto", loss_fn=_regression, **cfg):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 2)).astype(np.float32),
              "b": np.zeros(2, np.float32)}
    config = dict({"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
                   "bf16": {"enabled": True}, "gradient_clipping": 1.0,
                   "health_check": {"enabled": True, "skip_on_spike": True,
                                    "spike_zmax": 6.0},
                   "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}}, **cfg)
    data = {"x": rng.standard_normal((64, 4)).astype(np.float32),
            "y": rng.standard_normal((64, 2)).astype(np.float32)}
    eng = tds.initialize(config=config, loss_fn=loss_fn, params=params, device="cpu",
                         training_data=data, step_impl=impl)[0]
    return eng


def test_warmup_and_capture_train_nothing():
    """With a graph that replays nothing, the first train_batch runs the
    warm-up and the capture only: params, master, moments, the health EMA
    and both counters stay bit-identical, the graph registered no
    generator (no dropout) and recorded begin, end, replay."""
    graphs = []
    eng = _graph_path(_regression_engine(), lambda: graphs.append(FakeGraph()) or graphs[-1])
    eng.health.ema_loss.fill_(0.5)                 # a warmed EMA, wide enough for no spike
    eng.health.ema_sq.fill_(100.0)
    eng.health.count.fill_(7)
    before = {k: t.clone() for k, t in _state(eng).items()}
    eng.train_batch()
    after = _state(eng)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(after[k], before[k]), k
    assert graphs[0].calls == ["begin", "end", "replay"] and graphs[0].generators == []
    g = eng.stats()["graphs"]
    assert (g["graphs"], g["captures"], g["warmups"], g["replays"]) == (1, 1, 1, 1)
    assert list(g["pool_bytes"]) == ["engine.train[x:2x4x4,y:2x4x2,gas2]"]
    # the same engine called directly trains: the gate is the commit flag alone
    eng.step_impl, eng._steps = "eager", {}
    eng.train_batch()
    assert not torch.equal(eng.master["w"], before["master/0"])
    assert (eng.optimizer_steps, eng.skipped_steps) == (1, 0)


def test_launches_count_warmups_and_replays_not_the_capture():
    fa.reset_launches()
    eng = _graph_path(_regression_engine(), FakeGraph)
    eng.train_batch()
    # gas 2: the warm-up's two, the capture's two taken back, the replay's two added
    assert fa.launches["flash_fwd_sm90"] == 2 * 2
    eng.train_batch()
    assert fa.launches["flash_fwd_sm90"] == 3 * 2
    assert eng.stats()["graphs"]["replays"] == 2
    fa.reset_launches()


def _host_reading(params, batch, rng):
    loss = _regression(params, batch, rng)
    if loss.item() > 1e9:                          # a host read inside the step
        raise AssertionError
    return loss


def test_capture_and_replay_failures_raise_naming_the_step():
    fa.reset_launches()
    eng = _graph_path(_regression_engine(loss_fn=_host_reading), FakeGraph)
    with pytest.raises(RuntimeError, match=r"step engine\.train\[x:2x4x4,y:2x4x2,gas2\]: "
                       r"CUDA graph capture failed: .*host read.*step_impl='eager'"):
        eng.train_batch()
    assert eng.stats()["graphs"]["graphs"] == 0
    # the same loss_fn trains eagerly
    eager = _regression_engine(impl="eager", loss_fn=_host_reading)
    assert np.isfinite(float(eager.train_batch())) and eager.optimizer_steps == 1
    eng = _graph_path(_regression_engine(), lambda: FakeGraph(fail_replay=True))
    with pytest.raises(RuntimeError, match=r"step engine\.train\[.*\]: CUDA graph replay "
                                           r"failed: replay refused"):
        eng.train_batch()
    fa.reset_launches()


def test_step_impl_resolves_and_refuses():
    assert _regression_engine().step_impl == "graph"
    assert _regression_engine(impl="graph").step_impl == "graph"
    assert _regression_engine(impl="eager").step_impl == "eager"
    with pytest.raises(ValueError, match="step_impl must be one of"):
        _regression_engine(impl="jit")
    assert _regression_engine()._graphs is None          # no pool without a card


@pytest.mark.parametrize("impl", ["eager", "replay"])
def test_state_keeps_its_addresses_across_steps_and_load(impl, tmp_path):
    """Every state tensor keeps its storage through steps, a save and a
    load; the graph stays valid across the load (the next losses equal a
    run that loaded into a fresh engine)."""
    cfg = dict(BASE, bf16={"enabled": True})
    te = _gpt2(cfg, impl, dtype=torch.bfloat16)
    ptrs = {k: t.data_ptr() for k, t in _state(te).items()}
    for _ in range(2):
        te.train_batch()
    te.save_checkpoint(str(tmp_path))
    after_save = [float(te.train_batch()) for _ in range(2)]
    te.load_checkpoint(str(tmp_path))
    assert {k: t.data_ptr() for k, t in _state(te).items()} == ptrs
    again = [float(te.train_batch()) for _ in range(2)]
    assert again == after_save
    fresh = _gpt2(cfg, impl, np_params=_np_params(1), dtype=torch.bfloat16)
    fresh.load_checkpoint(str(tmp_path))
    assert [float(fresh.train_batch()) for _ in range(2)] == after_save
    if impl == "replay":
        assert te.stats()["graphs"]["graphs"] == 1     # one capture, before the load


def test_returned_losses_stay_distinct():
    """Each train_batch returns its own loss tensor: a later replay does
    not overwrite an earlier step's loss or grad norm."""
    te = _gpt2(BASE, "replay")
    losses, norms = [], []
    for _ in range(3):
        losses.append(te.train_batch())
        norms.append(te.get_global_grad_norm())
    values = [float(x) for x in losses]
    assert len(set(values)) == 3 and len({id(x) for x in losses}) == 3
    ref = _gpt2(BASE, "eager")
    want = [float(ref.train_batch()) for _ in range(3)]
    assert values == want
    assert len(set(norms)) == 3


# ------------------------------------------------------ (3) dropout masks
def test_folded_seed_is_the_eager_fold():
    s = FoldedSeed(1234).fold(3).fold(17)
    assert s.value() == sample_seed(sample_seed(1234, 3), 17) == int(s)
    assert s.value(base=99) == sample_seed(sample_seed(99, 3), 17)
    assert sg.fold(5, 2) == sample_seed(5, 2) and sg.fold(s, 1).path == (3, 17, 1)
    assert sg.as_seed(None) == 0 and sg.as_seed(np.int64(7)) == 7 and sg.as_seed(s) is s
    a = sg.dropout_uniform((4, 5), s, "cpu")
    g = torch.Generator()
    g.manual_seed(s.value())
    assert torch.equal(a, torch.rand((4, 5), generator=g))


@pytest.mark.parametrize("model,remat", [("gpt2", False), ("gpt2", True),
                                         ("bert", True)])
def test_dropout_masks_equal_eager_and_through_the_graph(model, remat):
    """Dropout 0.1: the step drawn eagerly and through the capture path
    (each draw from a generator registered before the capture, re-seeded
    before every replay) gives bit-equal losses and params over 3 steps;
    under remat too, whose recompute draws from generators of its own.
    Each replay re-seeds every draw of the step."""
    def engine(impl):
        if model == "gpt2":
            return _gpt2(BASE, impl, embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1,
                         remat=remat, attention_impl="jnp")
        tm = Bert(preset="bert-tiny", dtype=torch.float32, device="cpu", max_seq=64,
                  hidden_dropout=0.1, attn_dropout=0.1, remat=remat)
        data = {k: np.concatenate([_bert_batch(s)[k] for s in range(4)])
                for k in _bert_batch(0)}
        te = tds.initialize(config=dict(BASE, train_micro_batch_size_per_gpu=2), model=tm,
                            training_data=data, step_impl="eager" if impl == "eager"
                            else "auto")[0]
        return _graph_path(te) if impl == "replay" else te

    eager, graph = engine("eager"), engine("replay")
    losses = []
    for _ in range(3):
        losses.append(float(graph.train_batch()))
        assert losses[-1] == float(eager.train_batch())
    for a, b in zip(tree_leaves(eager.params), tree_leaves(graph.params)):
        assert torch.equal(a, b)
    step = next(iter(graph._steps.values()))
    g = step._graph
    # every draw of the forward (and the recompute) of each micro-batch
    n_layer = 4                                    # gpt2-tiny's and bert-tiny's
    sites = 1 + 3 * n_layer                        # the embeddings', 3 a block
    per_micro = sites + (3 * n_layer if remat else 0)
    assert len(g.generators) == 2 * per_micro == graph.stats()["graphs"]["dropout_draws"]
    # the masks move with the seed: another seed, another loss
    other = engine("replay")
    other._rng_seed = 1
    assert float(other.train_batch()) != losses[0]


def test_a_seed_read_as_an_int_inside_a_capture_raises():
    """A loss_fn that turns the step's seed into an int would freeze its
    masks into the graph: the capture raises, naming the step (the same
    loss_fn trains eagerly)."""
    def loss_fn(params, batch, rng):
        g = torch.Generator()
        g.manual_seed(int(rng))
        keep = torch.rand(batch["x"].shape, generator=g) < 0.9
        return _regression(params, {"x": batch["x"] * keep, "y": batch["y"]}, rng)

    eng = _graph_path(_regression_engine(loss_fn=loss_fn), FakeGraph)
    with pytest.raises(RuntimeError, match=r"step engine\.train\[.*\]: CUDA graph capture "
                                           r"failed: a dropout seed read as an int"):
        eng.train_batch()
    assert _regression_engine(impl="eager", loss_fn=loss_fn).train_batch() is not None
    fa.reset_launches()

