"""``initialize``'s client surface in the port (``__init__.py``,
``runtime/engine.py``) against the JAX package's, on the CPU.

ROADMAP item 3's "done when": a client ``FusedAdam`` and a client
``WarmupLR`` train gpt2-tiny to the JAX engine's losses (the JAX engine
given its own ``FusedAdam`` and ``WarmupLR`` with the same arguments, on
a 1-device mesh) within the engine tests' 1e-4, through the captured step
(a stand-in graph that replays the body, ``test_torch_train_graph.py``'s
``ReplayGraph``) and eagerly; the two port runs are bit-equal.  Then the
surface JAX ``__init__.py:21-26`` defines: ``args.deepspeed_config``,
``config_params``, the accepted and the refused arguments (``mpu``,
``mesh``, ``apply_fn``, ``elastic``, ``monitor`` raise
``NotImplementedError``, never ``TypeError``), ``collate_fn`` reaching the
loader as in JAX, the optimizer objects the captured step runs and the
ones it refuses, naming themselves.
"""

import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.adam.fused_adam import FusedAdam as JFusedAdam
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JLoader
from deepspeed_tpu.runtime.lr_schedules import WarmupLR as JWarmupLR

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam, FusedAdamW
from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb
from deepspeed_tpu_torch.ops.sgd import SGD
from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR

from test_torch_train_graph import _graph_path

LOSS_RTOL = 1e-4
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)
CFG = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
       "gradient_clipping": 1.0, "steps_per_print": 10 ** 9}
ADAM = dict(lr=2e-3, weight_decay=0.05, betas=(0.9, 0.98))
WARMUP = dict(warmup_min_lr=1e-4, warmup_max_lr=2e-3, warmup_num_steps=4)
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _port(impl="auto", config=CFG, **kw):
    m = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32, **NO_DROPOUT)
    return tds.initialize(config=dict(config), model=m, params=_np_params(),
                          training_data=(TOKENS,), step_impl=impl, **kw)


@pytest.fixture(scope="module")
def jax_curve():
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT)
    opt = JFusedAdam(**ADAM)
    je, jopt, _, jsched = jds.initialize(
        config=dict(CFG, compile_cache={"enabled": False}), model=jm, params=_np_params(),
        optimizer=opt, lr_scheduler=JWarmupLR(opt, **WARMUP), training_data=(TOKENS,),
        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    assert jopt is opt
    return [float(je.train_batch()) for _ in range(STEPS)]


def test_client_optimizer_and_scheduler_match_jax(jax_curve):
    """Captured (stand-in graph) and eager: the JAX engine's losses within
    1e-4, each other's bit for bit; the engine returns the client objects,
    and each step's lr is the client scheduler's."""
    curves = {}
    for impl in ("replay", "eager"):
        opt = FusedAdam(**ADAM)
        sched = WarmupLR(opt, **WARMUP)
        eng, o, _, s = _port("eager" if impl == "eager" else "auto", optimizer=opt,
                             lr_scheduler=sched)
        assert o is opt and s is sched and eng.optimizer is opt
        if impl == "replay":
            _graph_path(eng)
        curve = []
        for step in range(STEPS):
            curve.append(float(eng.train_batch()))
            assert eng._last_metrics["lr"] == sched.lr_fn(step)
        if impl == "replay":
            g = eng.stats()["graphs"]
            assert g["graphs"] == 1 and g["replays"] == STEPS
        curves[impl] = curve
    assert curves["replay"] == curves["eager"]
    np.testing.assert_allclose(curves["eager"], jax_curve, rtol=LOSS_RTOL)


@pytest.mark.parametrize("make", [
    lambda: FusedAdamW(lr=1e-3), lambda: FusedLamb(lr=1e-3), lambda: SGD(lr=1e-2, momentum=0.9),
    lambda: DeepSpeedCPUAdagrad(lr=1e-2)], ids=["adamw", "lamb", "sgd", "adagrad"])
def test_client_optimizers_the_step_runs(make):
    """The port's optimizer objects train through the engine (no config
    optimizer block); the loss stays finite and the state is theirs."""
    opt = make()
    eng, o, _, _ = _port(optimizer=opt)
    losses = [float(eng.train_batch()) for _ in range(2)]
    assert o is opt and all(np.isfinite(losses)) and eng.optimizer_steps == 2


def test_foreign_objects_raise_naming_themselves():
    """A torch.optim optimizer or a scheduler without ``lr_fn`` cannot run
    in the captured step: TypeError naming the object, no fallback."""
    p = torch.nn.Parameter(torch.zeros(2))
    with pytest.raises(TypeError, match="torch.optim.adamw.AdamW"):
        _port(optimizer=torch.optim.AdamW([p]))
    with pytest.raises(TypeError, match="StepLR.*lr_fn"):
        _port(optimizer=FusedAdam(), lr_scheduler=torch.optim.lr_scheduler.StepLR(
            torch.optim.SGD([p], lr=0.1), 1))


def test_config_sources_and_accepted_arguments():
    """``config`` > ``config_params`` > ``args.deepspeed_config`` (JAX
    ``__init__.py:61-65``); ``model_parameters`` and ``dist_init_required``
    are accepted and unused."""
    args = types.SimpleNamespace(deepspeed_config=dict(CFG, train_micro_batch_size_per_gpu=2))
    m = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32)
    eng = tds.initialize(args=args, model=m, params=_np_params(),
                         model_parameters=[torch.zeros(1)], dist_init_required=False)[0]
    assert eng.train_micro_batch_size_per_gpu() == 2
    eng = tds.initialize(args=args, model=m, params=_np_params(),
                         config_params=dict(CFG, train_micro_batch_size_per_gpu=3))[0]
    assert eng.train_micro_batch_size_per_gpu() == 3
    with pytest.raises(ValueError, match="requires a config"):
        tds.initialize(model=m, params=_np_params())


@pytest.mark.parametrize("name", ["mpu", "mesh", "apply_fn", "elastic", "monitor"])
def test_unported_arguments_raise_not_implemented(name):
    with pytest.raises(NotImplementedError, match=name):
        _port(**{name: object()})


def test_collate_fn_reaches_the_loader():
    """A dataset of samples (not columnar) batched by the client's
    ``collate_fn``: the port's loader yields JAX's batches."""
    rng = np.random.default_rng(3)
    samples = [{"ids": rng.integers(0, 100, 5).astype(np.int32), "w": float(i)}
               for i in range(10)]

    def collate(batch):
        return {"ids": np.stack([s["ids"] for s in batch]),
                "w": np.asarray([s["w"] for s in batch], np.float32) * 2}

    eng = tds.initialize(config=dict(CFG, train_micro_batch_size_per_gpu=4),
                         loss_fn=lambda p, b, rng=None: (p["w"] * b["w"].sum()),
                         params={"w": np.ones((), np.float32)}, device="cpu",
                         training_data=samples, collate_fn=collate)[0]
    ref = JLoader(samples, batch_size=4, collate_fn=collate)
    for got, want in zip(eng.training_dataloader, ref):
        for k in ("ids", "w"):
            np.testing.assert_array_equal(got[k], want[k])


def test_checkpointing_exported():
    """``deepspeed_tpu_torch.checkpointing`` (JAX ``__init__.py:12``), at
    first use."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    assert tds.checkpointing is checkpointing
    assert "checkpointing" in tds.__all__


@pytest.fixture(scope="module")
def adagrad_jax_curve():
    cfg = dict(CFG, optimizer={"type": "Adagrad", "params": {"lr": 2e-2,
                                                             "weight_decay": 0.01}})
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT)
    je = jds.initialize(config=dict(cfg, compile_cache={"enabled": False}), model=jm,
                        params=_np_params(), training_data=(TOKENS,),
                        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    return cfg, [float(je.train_batch()) for _ in range(4)]


def test_config_adagrad_matches_jax(adagrad_jax_curve):
    """The config's ``"Adagrad"`` (JAX ``engine.py:554-555``) no longer
    raises: its device update trains to the JAX engine's losses within
    1e-4, its state JAX's ``AdagradState`` layout."""
    cfg, want = adagrad_jax_curve
    eng, opt, _, _ = _port(config=cfg)
    assert isinstance(opt, DeepSpeedCPUAdagrad) and eng.opt_state._fields == ("sum_sq",)
    np.testing.assert_allclose([float(eng.train_batch()) for _ in range(4)], want,
                               rtol=LOSS_RTOL)
