"""The training loop's host modules of the port against the JAX package, on
the CPU: the imperative API (``forward`` / ``backward`` / ``step`` /
``is_gradient_accumulation_boundary``), curriculum learning
(``runtime/data_pipeline/curriculum_scheduler.py`` and the engine's crop)
and progressive layer drop (``runtime/progressive_layer_drop.py`` and its
engine hook), with their config blocks.

The twins of ``tests/test_engine.py``'s shim test and of
``tests/test_aux_runtime.py``'s curriculum and PLD tests.  JAX engines run
on a 1-device mesh.  The schedules are host arithmetic in both packages,
so they are held value for value; the shim's losses are held bit for bit
against the port's own ``train_batch`` (the same captured step) and within
the existing engine tests' 1e-4 relative against the JAX engine (fp32,
sums in another order); so are the curriculum run's losses."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.data_pipeline.curriculum_scheduler import (
    CurriculumScheduler as JCurriculum)
from deepspeed_tpu.runtime.dataloader import RepeatingLoader as JRepeating
from deepspeed_tpu.runtime.progressive_layer_drop import ProgressiveLayerDrop as JPLD
from simple_model import SimpleModel, random_dataset

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader
from deepspeed_tpu_torch.runtime.progressive_layer_drop import ProgressiveLayerDrop
from test_torch_train_graph import _graph_path

RTOL = 1e-4
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return make_mesh({"data": 1}, devices=jax.devices()[:1])


# ------------------------------------------------------------------ schedules
SCHEDULES = {
    "fixed_linear": {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}},
    "fixed_root": {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8,
                                       "root_degree": 2}},
    "fixed_discrete": {"curriculum_type": "seqlen", "min_difficulty": 1, "max_difficulty": 3,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [1, 2, 3], "max_step": [5, 10]}},
    "fixed_linear 128-1024": {
        "curriculum_type": "seqlen", "min_difficulty": 128, "max_difficulty": 1024,
        "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 14, "difficulty_step": 128}},
    "fixed_root odd step": {
        "curriculum_type": "seqlen", "min_difficulty": 5, "max_difficulty": 77,
        "schedule_type": "fixed_root",
        "schedule_config": {"total_curriculum_step": 37, "difficulty_step": 12,
                            "root_degree": 3}},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_curriculum_schedule_matches_jax_value_for_value(name):
    """``get_difficulty`` at every step 0..150 and ``update_difficulty`` over
    the same steps (the difficulty never falls back), equal; the state too."""
    cfg = SCHEDULES[name]
    port, ref = CurriculumScheduler(dict(cfg)), JCurriculum(dict(cfg))
    for step in range(151):
        assert port.get_difficulty(step) == ref.get_difficulty(step), step
    seen = []
    for step in range(151):
        got = port.update_difficulty(step)
        assert got == ref.update_difficulty(step), step
        seen.append(got)
    assert seen == sorted(seen) and seen[-1] == cfg["max_difficulty"]
    assert port.get_state() == ref.get_state()
    assert port.get_current_difficulty() == ref.get_current_difficulty()


@pytest.mark.parametrize("bad", [
    {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64},
    {"curriculum_type": "seqlen", "min_difficulty": 8, "max_difficulty": 64,
     "schedule_type": "fixed_linear", "schedule_config": {"total_curriculum_step": 10}},
    {"curriculum_type": "seqlen", "min_difficulty": 1, "max_difficulty": 3,
     "schedule_type": "fixed_discrete",
     "schedule_config": {"difficulty": [1, 2], "max_step": [5, 10]}},
])
def test_curriculum_refuses_what_jax_refuses(bad):
    with pytest.raises(AssertionError):
        JCurriculum(dict(bad))
    with pytest.raises(ValueError):
        CurriculumScheduler(dict(bad))
    unknown = dict(SCHEDULES["fixed_linear"], schedule_type="fixed_cubic")
    for cls in (JCurriculum, CurriculumScheduler):
        with pytest.raises(RuntimeError):
            cls(dict(unknown))


@pytest.mark.parametrize("pd", [
    {},
    {"curriculum_learning": {"enabled": False}},
    {"curriculum_learning": dict(SCHEDULES["fixed_linear"], enabled=True)},
    {"progressive_layer_drop": {"enabled": True}},
    {"progressive_layer_drop": {"enabled": True, "theta": 0.5, "gamma": 0.01}},
])
def test_curriculum_and_pld_config_match_jax(pd):
    pd = dict(pd, train_batch_size=8)
    t, j = DeepSpeedConfig(dict(pd)), JConfig(dict(pd), world_size=1)
    assert (t.curriculum.enabled, t.curriculum.params) == (j.curriculum.enabled,
                                                           j.curriculum.params)
    for key in ("enabled", "theta", "gamma"):
        assert getattr(t.pld, key) == getattr(j.pld, key), key
        assert getattr(t.progressive_layer_drop, key) == getattr(j.progressive_layer_drop, key)


def test_pld_schedule_matches_jax():
    """theta(t) = (1 - theta) e^(-gamma t) + theta, equal at every step, and
    the state dict."""
    port, ref = ProgressiveLayerDrop(theta=0.5, gamma=0.01), JPLD(theta=0.5, gamma=0.01)
    assert port.get_theta() == ref.get_theta() == 1.0
    for step in range(0, 2000, 7):
        assert port.update_state(step) == ref.update_state(step)
        assert port.get_state() == ref.get_state()
    assert abs(port.get_theta() - 0.5) < 1e-3 and port.get_state()["progressive_layer_drop"]


# --------------------------------------------------------- the MLP engines
def _mlp_loss(params, batch, rng):
    x, y = batch
    h = x.to(params["layer_0"]["w"].dtype)
    for i in range(2):
        p = params[f"layer_{i}"]
        h = h @ p["w"] + p["b"]
        if i == 0:
            h = torch.relu(h)
    return (h.float() - y.float()).square().mean()


def _mlp_params():
    return jax.tree_util.tree_map(np.asarray, SimpleModel().init(jax.random.PRNGKey(0)))


def _mlp_pair(over, gas=1):
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": gas,
           "steps_per_print": 1000, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           **over}
    params = _mlp_params()
    je, _, jloader, _ = jds.initialize(config=dict(cfg), model=SimpleModel(), params=params,
                                       training_data=random_dataset(), mesh=_mesh())
    te, _, tloader, _ = tds.initialize(config=dict(cfg), loss_fn=_mlp_loss, params=params,
                                       device="cpu", training_data=random_dataset())
    return je, jloader, te, tloader


def test_pld_engine_hook_matches_jax():
    """The engine updates theta after each step from its global step, as the
    JAX engine does (``_finish_step``); ``get_state`` reports it."""
    je, _, te, _ = _mlp_pair({"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                                         "gamma": 0.1}})
    assert te.progressive_layer_drop.get_theta() == 1.0
    for step in range(1, 4):
        je.train_batch()
        te.train_batch()
        want = (1.0 - 0.5) * math.exp(-0.1 * step) + 0.5
        assert te.progressive_layer_drop.get_theta() == je.progressive_layer_drop.get_theta()
        assert te.progressive_layer_drop.get_theta() == pytest.approx(want, rel=1e-15)
    assert te.progressive_layer_drop.get_state() == {"progressive_layer_drop": True,
                                                     "pld_theta": te.progressive_layer_drop
                                                     .get_theta()}
    plain = tds.initialize(config={"train_batch_size": 4}, loss_fn=_mlp_loss,
                           params=_mlp_params(), device="cpu")[0]
    assert plain.progressive_layer_drop is None and plain.curriculum_seqlen() is None


# ------------------------------------------------------ the imperative API
def _shim_losses(engine, loader, steps=3, it_cls=RepeatingLoader):
    it = iter(it_cls(loader))
    losses = []
    for _ in range(steps):
        for i in range(engine.gradient_accumulation_steps()):
            assert engine.step() is None if i else True
            mb = next(it)
            loss = engine.forward(mb)
            assert engine.backward(loss) is loss
        assert engine.is_gradient_accumulation_boundary()
        losses.append(float(engine.step()))
        assert not engine.is_gradient_accumulation_boundary()
    return losses


def test_forward_backward_step_shim_matches_train_batch_and_jax():
    """The twin of ``tests/test_engine.py``'s shim test (SimpleModel, micro
    4, gas 2, three optimizer steps): the port's shim equals its own
    ``train_batch`` bit for bit (losses, grad norms, params), and the JAX
    engine's shim within 1e-4."""
    je, jloader, te, tloader = _mlp_pair({}, gas=2)
    jl = _shim_losses(je, jloader, it_cls=JRepeating)
    tl = _shim_losses(te, tloader)
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert je.global_steps == te.global_steps == 3
    assert tl[-1] < tl[0] * 2
    ref = _mlp_pair({}, gas=2)[2]
    for want in tl:
        assert float(ref.train_batch()) == want
    assert ref.get_global_grad_norm() == te.get_global_grad_norm()
    for a, b in zip(jax.tree_util.tree_leaves(ref.params), jax.tree_util.tree_leaves(te.params)):
        assert torch.equal(a, b)
    assert (te.optimizer_steps, te.micro_steps) == (3, 6)


def test_shim_replays_the_train_batch_graph():
    """Stand-in graphs that recompute the step on replay: ``train_batch``
    then the shim on one engine take one graph (one capture), and the
    shim's step loss equals a twin engine's ``train_batch``."""
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 1000, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    make = lambda: _graph_path(tds.initialize(config=dict(cfg), loss_fn=_mlp_loss,
                                              params=_mlp_params(), device="cpu",
                                              training_data=random_dataset())[0])
    eng, twin = make(), make()
    x, y = random_dataset()
    batches = [(x[i:i + 4], y[i:i + 4]) for i in range(0, 32, 4)]
    for k in range(2):
        eng.train_batch(iter(batches[4 * k:4 * k + 2]))
        for mb in batches[4 * k + 2:4 * k + 4]:
            eng.backward(eng.forward(mb))
        got = float(eng.step())
        twin.train_batch(iter(batches[4 * k:4 * k + 2]))
        assert got == float(twin.train_batch(iter(batches[4 * k + 2:4 * k + 4])))
    g = eng.stats()["graphs"]
    assert (g["graphs"], g["captures"], g["replays"], g["released"]) == (1, 1, 4, 0)


def test_shim_refusals():
    te = _mlp_pair({}, gas=2)[2]
    with pytest.raises(RuntimeError, match="forward"):
        te.backward()
    assert te.step() is None and te.global_steps == 0


# ------------------------------------------------------ the curriculum crop
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 8,
              "max_difficulty": 32, "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 6, "difficulty_step": 8}}


def _gpt2_pair(cfg, tokens):
    np_params = JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=0)
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT)
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32, **NO_DROPOUT)
    je = jds.initialize(config=dict(cfg), model=jm, params=np_params, training_data=(tokens,),
                        mesh=_mesh())[0]
    te = tds.initialize(config=dict(cfg), model=tm, params=np_params,
                        training_data=(tokens,))[0]
    return je, te


def test_curriculum_loss_curve_and_crop_match_jax():
    """gpt2-tiny, micro 2, gas 2, a fixed_linear curriculum 8 -> 32 over 6
    steps: at every step the same difficulty in both engines, the port's
    graph fed (gas, 2, seqlen + 1) tokens (one graph a difficulty, the past
    ones released), and losses and grad norms within 1e-4 of the JAX
    engine's (which crops and retraces the same way)."""
    tokens = np.random.default_rng(0).integers(0, 1024, (64, 33)).astype(np.int32)
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 2,
           "steps_per_print": 1000, "gradient_clipping": 1.0,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "curriculum_learning": dict(CURRICULUM)}
    je, te = _gpt2_pair(cfg, tokens)
    _graph_path(te)
    seen = []
    for step in range(8):
        jl, tl = float(je.train_batch()), float(te.train_batch())
        assert te.curriculum_seqlen() == je.curriculum_seqlen()
        seen.append(te.curriculum_seqlen())
        live = list(te._steps.values())
        assert len(live) == 1 and live[0].static["batch/0"].shape == (2, 2, seen[-1] + 1)
        np.testing.assert_allclose(tl, jl, rtol=RTOL, err_msg=f"step {step + 1}")
        np.testing.assert_allclose(te.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=RTOL, err_msg=f"step {step + 1}")
    assert seen == [8, 16, 16, 24, 24, 32, 32, 32]
    g = te.stats()["graphs"]
    # one graph a difficulty; those of the shorter lengths released when it moved on
    assert (g["captures"], g["released"], g["graphs"], g["replays"]) == (4, 3, 1, 8)
    assert len(g["pool_bytes"]) == 4


def test_curriculum_crop_keeps_targets_and_float_leaves():
    """Integer leaves crop to ``seqlen + 1`` along axis 1, others to
    ``seqlen``; shorter leaves and 1-D leaves stay as they are."""
    te = tds.initialize(config={"train_batch_size": 2,
                                "curriculum_learning": dict(CURRICULUM)},
                        loss_fn=_mlp_loss, params=_mlp_params(), device="cpu")[0]
    mb = {"ids": np.zeros((2, 33), np.int32), "w": np.ones((2, 33), np.float32),
          "short": np.zeros((2, 4), np.int64), "flat": np.arange(40)}
    out = te._apply_curriculum(mb)
    assert te.curriculum_seqlen() == 8
    assert {k: v.shape for k, v in out.items()} == {"ids": (2, 9), "w": (2, 8),
                                                   "short": (2, 4), "flat": (40,)}
