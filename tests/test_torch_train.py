"""The port's training slice against the JAX package, in fp32 on the CPU:
config resolution (runtime/config.py), Adam(W) (ops/adam/fused_adam.py),
clipping (runtime/utils.py), LR schedules, the data loader, the health
sentinels, GPT-2's training forward / loss / gradients (models/gpt2.py)
and a 5-step loss curve of the engine (runtime/engine.py, initialize).

Inputs come from numpy seeds; the same numpy parameters reach both
packages.  The JAX engine runs on a 1-device mesh, so both engines see
the same global batch.  Tolerances are stated where they are used."""

import itertools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.adam import fused_adam as jadam
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import health as jhealth
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.config import (DeepSpeedConfig as JConfig,
                                          DeepSpeedConfigError as JConfigError)

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models import build
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax
from deepspeed_tpu_torch.ops.adam import fused_adam as tadam
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import health as thealth
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


def _tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


# ------------------------------------------------------------------ config
# the batch dicts of tests/test_config.py, resolved at world size 1
BATCH_DICTS = [
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 4},
    {"train_batch_size": 32, "gradient_accumulation_steps": 2},
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2},
    {"train_batch_size": 32},
    {"train_batch_size": 33, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 2},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 4,
     "gradient_accumulation_steps": 2},
    {},
]


@pytest.mark.parametrize("pd", BATCH_DICTS, ids=lambda d: "-".join(
    f"{k.split('_')[1]}{v}" for k, v in d.items()) or "empty")
def test_batch_triple_matches_jax(pd):
    """The same (train_batch, micro_batch, gas), or both packages refuse
    the dict (JAX with an assert or its config error, the port with
    DeepSpeedConfigError)."""
    def triple(cfg):
        return (cfg.train_batch_size, cfg.train_micro_batch_size_per_gpu,
                cfg.gradient_accumulation_steps)

    try:
        want = triple(JConfig(dict(pd), world_size=1))
    except (AssertionError, JConfigError):
        want = None
    try:
        got = triple(DeepSpeedConfig(dict(pd)))
    except DeepSpeedConfigError:
        got = None
    assert got == want


@pytest.mark.parametrize("pd", [
    {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {
        "lr": 1e-3, "betas": [0.9, 0.999]}},
     "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}}},
    {"train_batch_size": 8, "bf16": {"enabled": True}},
    {"train_batch_size": 8, "bfloat16": {"enabled": True}},
    {"train_batch_size": 16, "zero_optimization": {"stage": 2}},
    {"train_batch_size": 8, "zero_optimization": True},
    {"train_batch_size": 8, "gradient_clipping": 1.0, "steps_per_print": 5,
     "prescale_gradients": True, "dataloader_drop_last": True},
    {"train_batch_size": 8, "health_check": {"spike_zmax": 4.0, "skip_on_spike": True,
                                             "spike_window": 20}},
    {"train_batch_size": 8, "data_types": {"grad_accum_dtype": "bf16"},
     "zero_optimization": {"stage": 1, "overlap_comm": True}},
])
def test_config_fields_match_jax(pd):
    j, t = JConfig(dict(pd), world_size=1), DeepSpeedConfig(dict(pd))
    assert (t.optimizer_name, t.optimizer_params, t.scheduler_name, t.scheduler_params) \
        == (j.optimizer_name, j.optimizer_params, j.scheduler_name, j.scheduler_params)
    assert t.precision_dtype == j.precision_dtype
    assert t.zero_optimization_stage == j.zero_optimization_stage
    assert (t.gradient_clipping, t.steps_per_print, t.dataloader_drop_last,
            t.grad_accum_dtype) == (j.gradient_clipping, j.steps_per_print,
                                    j.dataloader_drop_last, j.grad_accum_dtype)
    for key in ("enabled", "skip_nonfinite", "spike_window", "spike_zmax",
                "skip_on_spike", "consecutive_skip_budget", "rewind_limit", "on_exhausted",
                "check_interval", "history", "forensic_dir"):
        assert getattr(t.health_check, key) == getattr(j.health_check, key), key


@pytest.mark.parametrize("pd,world_size", [
    ({"train_batch_size": 32}, 4),
    ({"train_batch_size": 8, "comms_compression": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "offload_param": {"device": "cpu", "no_such_key": 1}}}, 1),
    ({"train_batch_size": 8, "zero_optimization": {"stage": 3, "offload_param": {
        "device": "cpu"}}, "comms_compression": {"enabled": True, "routes": ["param_stream"],
                                                 "weights_bits": 8}}, 1),
    ({"train_batch_size": 8, "eigenvalue": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "optimizer": {"type": "OneBitAdam", "params": {}}}, 1),
    ({"train_batch_size": 8, "monitor": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "checkpoint": {"tag_validation": "Fail"}}, 1),
    ({"train_batch_size": 8, "quantize_training": {"enabled": True}}, 1),
    ({"train_batch_size": 8, "wall_clock_breakdown": True}, 1),
    ({"train_batch_size": 8, "sparse_gradients": True}, 2),
    ({"train_batch_size": 8, "no_such_key": 1}, 1),
])
def test_unported_config_raises(pd, world_size, monkeypatch):
    """``world_size`` is that of an initialised process group (stood in
    for here: nothing is initialised)."""
    if world_size != 1:
        import torch.distributed as dist
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda group=None: world_size)
    with pytest.raises(NotImplementedError):
        DeepSpeedConfig(pd)


def test_off_blocks_are_accepted():
    cfg = DeepSpeedConfig({"train_batch_size": 8, "monitor": {"enabled": False},
                           "fp16": {"enabled": False}, "compile_cache": {},
                           "zero_optimization": {"stage": 1, "reduce_bucket_size": 5e8}})
    assert cfg.noop_keys_set == ["zero_optimization.reduce_bucket_size"]
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig({"train_batch_size": 8, "fp16": {"enabled": True},
                         "bf16": {"enabled": True}})


# ------------------------------------------------------- optimizer, clipping
@pytest.mark.parametrize("adam_w_mode,wd", [(True, 0.1), (False, 0.01), (True, 0.0)])
def test_adam_update_matches_jax_over_three_steps(adam_w_mode, wd):
    """Tolerance 1e-6: the same fp32 formula op for op."""
    shapes = {"w": (7, 5), "b": (5,)}
    p = _tree(0, shapes)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, p), tutils.tree_map(torch.from_numpy, p)
    js, ts = jadam.adam_init(jp), tadam.adam_init(tp)
    for step in (1, 2, 3):
        g = _tree(step, shapes)
        lr = 1e-2 * step
        jp, js = jadam.adam_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp,
                                   step=jnp.int32(step), lr=jnp.float32(lr),
                                   weight_decay=wd, adam_w_mode=adam_w_mode)
        tp, ts = tadam.adam_update(tutils.tree_map(torch.from_numpy, g), ts, tp,
                                   step=torch.tensor(step, dtype=torch.int32), lr=lr,
                                   weight_decay=wd, adam_w_mode=adam_w_mode)
    for a, b in ((jp, tp), (js.exp_avg, ts.exp_avg), (js.exp_avg_sq, ts.exp_avg_sq)):
        for k in shapes:
            np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]), rtol=0, atol=1e-6)


def test_fused_adamw_defaults_match_jax():
    j, t = jadam.FusedAdamW(lr=6e-4, weight_decay=0.1), tadam.FusedAdamW(lr=6e-4,
                                                                        weight_decay=0.1)
    assert (t.lr, t.betas, t.eps, t.weight_decay, t.adam_w_mode, t.bias_correction) == \
        (j.lr, j.betas, j.eps, j.weight_decay, j.adam_w_mode, j.bias_correction)
    with pytest.raises(RuntimeError, match="AMSGrad"):
        tadam.FusedAdam(amsgrad=True)


def test_clip_by_global_norm_exact_on_exact_sums():
    """Values on a 1/8 grid: every square and sum is exact in fp32, so the
    norm, the coefficient and the clipped tree must be bit-identical."""
    rng = np.random.default_rng(1)
    g = {k: (rng.integers(-40, 40, s) / 8.0).astype(np.float32)
         for k, s in (("a", (6, 4)), ("b", (9,)), ("c", (3, 3)))}
    for max_norm in (1.0, 1e3):
        jc, jn = jutils.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
        tc, tn = tutils.clip_by_global_norm(tutils.tree_map(torch.from_numpy, g), max_norm)
        assert float(tn) == float(jn)
        for k in g:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


def test_global_norm_random_matches_jax():
    """Random fp32 leaves: sums in another order, tolerance 1e-6 relative."""
    g = _tree(5, {"x": (33, 17), "y": (100,)})
    jn = jutils.global_norm(jax.tree_util.tree_map(jnp.asarray, g))
    tn = tutils.global_norm(tutils.tree_map(torch.from_numpy, g))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)


# ------------------------------------------------------------- lr schedules
SCHEDULES = [
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=6e-4, warmup_num_steps=100)),
    ("WarmupLR", dict(warmup_max_lr=1e-3, warmup_num_steps=50, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=300, warmup_min_lr=1e-5,
                           warmup_max_lr=6e-4, warmup_num_steps=100)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=30,
                      decay_lr_rate=0.1, decay_step_size=7)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2, cycle_first_step_size=30,
                      cycle_second_step_size=20, decay_lr_rate=0.01)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=13,
                         lr_range_test_step_rate=2.0, lr_range_test_staircase=True)),
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4, lr_range_test_step_size=13)),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=lambda x: str(x)[:24])
def test_lr_schedules_match_jax(name, params):
    """Exact in float32, except the log warmup: numpy's and XLA's float32
    log may round one ulp apart (rtol 2.5e-7 = two ulps)."""
    j, t = jlr.get_lr_scheduler(name, params), tlr.get_lr_scheduler(name, params)
    log_warmup = "warmup_type" not in params and name.startswith("Warmup")
    for s in range(300):
        want, got = float(j.lr_fn(s)), t.lr_fn(s)
        if log_warmup and s < params["warmup_num_steps"]:
            np.testing.assert_allclose(got, want, rtol=2.5e-7)
        else:
            assert got == want, (s, got, want)
    for _ in range(5):
        j.step(), t.step()
    assert t.get_lr() == pytest.approx(j.get_lr(), rel=2.5e-7)
    with pytest.raises(ValueError, match="Unknown LR schedule"):
        tlr.get_lr_scheduler("Cosine", {})


# --------------------------------------------------------------- data loader
@pytest.mark.parametrize("form", ["tuple", "dict", "list"])
@pytest.mark.parametrize("drop_last", [False, True])
def test_dataloader_batch_order_matches_jax(form, drop_last):
    x = np.arange(22 * 3).reshape(22, 3).astype(np.int32)
    y = np.arange(22).astype(np.float32)
    data = {"tuple": (x, y), "dict": {"x": x, "y": y},
            "list": [(x[i], y[i]) for i in range(22)]}[form]
    j = jdl.RepeatingLoader(jdl.DeepSpeedDataLoader(data, 4, drop_last=drop_last, seed=3))
    t = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data, 4, drop_last=drop_last, seed=3))
    assert len(t.loader) == len(j.loader)
    for a, b in itertools.islice(zip(j, t), 15):        # over two epochs
        for la, lb in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(la, lb)


# ------------------------------------------------------------------- health
def test_health_sentinels_match_jax():
    losses = [3.0, 2.9, 2.95, 2.8, 2.85, 2.7, 9.0, float("nan"), 2.6, 2.65]
    js, ts = jhealth.init_state(), thealth.init_state()
    for loss in losses:
        js, jz, jspike = jhealth.update_ema(js, jnp.float32(loss), window=8, zmax=3.0)
        ts, tz, tspike = thealth.update_ema(ts, torch.tensor(loss), window=8, zmax=3.0)
        np.testing.assert_allclose(float(tz), float(jz), rtol=1e-6)
        assert bool(tspike) == bool(jspike)
        np.testing.assert_allclose(float(ts.ema_loss), float(js.ema_loss), rtol=1e-6)
        np.testing.assert_allclose(float(ts.ema_sq), float(js.ema_sq), rtol=1e-6)
        assert int(ts.count) == int(js.count)
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, float("inf")])},
            "i": torch.arange(3)}
    assert bool(thealth.tree_nonfinite(tree))
    assert not bool(thealth.tree_nonfinite({"a": torch.ones(3), "i": torch.arange(3)}))
    assert not bool(thealth.tree_nonfinite({}))


# ---------------------------------------------------------------- GPT-2 fwd
@pytest.fixture(scope="module")
def tiny():
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=64, **NO_DROPOUT)
    np_params = jm.init_numpy(seed=0)
    toks = np.random.default_rng(4).integers(0, 1024, (2, 49)).astype(np.int32)
    return jm, np_params, toks


def _rel_close(got, want, tol, what):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), f"{what}: {err} vs max {np.abs(want).max()}"


@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_gpt2_logits_loss_and_grads_match_jax(tiny, impl):
    """Tolerance 1e-4 of the largest value: fp32 matmuls summed in another
    order over 4 layers.  The JAX flash path runs its Pallas kernels in
    interpret mode; the port's runs its plain versions."""
    jm, np_params, toks = tiny
    jm.config.attention_impl = impl
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
              attention_impl=impl, remat=False, **NO_DROPOUT)
    tp = params_from_jax(np_params, "cpu")
    jlogits = jm.apply(jp, jnp.asarray(toks[:, :-1]))
    tlogits = tm.apply(tp, torch.from_numpy(toks[:, :-1]))
    assert tlogits.dtype == torch.float32 and tlogits.shape == (2, 48, 1024)
    _rel_close(tlogits.numpy(), jlogits, 1e-4, "logits")
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jax.random.PRNGKey(0))
    for leaf in tutils.tree_leaves(tp):
        leaf.requires_grad_(True)
    tloss = tm.loss(tp, torch.from_numpy(toks), 0)
    tloss.backward()
    _rel_close(tloss.item(), jloss, 1e-4, "loss")
    for (path, jg), tg in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                              tutils.tree_leaves(tp)):
        _rel_close(tg.grad.numpy(), jg, 1e-4, jax.tree_util.keystr(path))


def test_unscaled_attention_runs_flash_and_matches_jax(tiny, monkeypatch):
    """``scale_attn=False`` with ``attention_impl="flash"`` goes through
    ``flash_attention`` with ``sm_scale=1`` (JAX takes its jnp path for
    it); logits, loss and gradients within 1e-4 of the largest value."""
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    calls = []
    flash = fa.flash_attention

    def counted(*args, **kwargs):
        calls.append(kwargs.get("sm_scale"))
        return flash(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", counted)
    _, np_params, toks = tiny
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=64, scale_attn=False,
               attention_impl="jnp", **NO_DROPOUT)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
              scale_attn=False, attention_impl="flash", remat=False, **NO_DROPOUT)
    tp = params_from_jax(np_params, "cpu")
    _rel_close(tm.apply(tp, torch.from_numpy(toks[:, :-1])).numpy(),
               jm.apply(jp, jnp.asarray(toks[:, :-1])), 1e-4, "logits")
    assert calls and set(calls) == {1.0}
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jnp.asarray(toks), jax.random.PRNGKey(0))
    for leaf in tutils.tree_leaves(tp):
        leaf.requires_grad_(True)
    tloss = tm.loss(tp, torch.from_numpy(toks), 0)
    tloss.backward()
    _rel_close(tloss.item(), jloss, 1e-4, "loss")
    for (path, jg), tg in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                              tutils.tree_leaves(tp)):
        _rel_close(tg.grad.numpy(), jg, 1e-4, jax.tree_util.keystr(path))


def test_remat_and_dropout_recompute_the_same_masks(tiny):
    """remat=True recomputes each block under torch.utils.checkpoint; the
    dropout generators are re-seeded inside the block, so the loss and
    gradients equal the remat=False run's exactly."""
    _, np_params, toks = tiny
    out = []
    for remat in (False, True):
        tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
                  remat=remat, embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1)
        tp = params_from_jax(np_params, "cpu")
        for leaf in tutils.tree_leaves(tp):
            leaf.requires_grad_(True)
        loss = tm.loss(tp, torch.from_numpy(toks), 1234)
        loss.backward()
        out.append((loss.item(), [l.grad.clone() for l in tutils.tree_leaves(tp)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    # dropout is active: another seed, another loss
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
              remat=False, embd_pdrop=0.1, attn_pdrop=0.1, resid_pdrop=0.1)
    assert tm.loss(params_from_jax(np_params, "cpu"), torch.from_numpy(toks), 1).item() \
        != out[0][0]


@pytest.mark.parametrize("overrides", [dict(attention_impl="ulysses"),
                                       dict(attention_impl="ring_flash"),
                                       dict(attention_impl="ring")])
def test_unported_model_options_raise(tiny, overrides):
    _, np_params, toks = tiny
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
              **overrides)
    with pytest.raises(NotImplementedError):
        tm.loss(params_from_jax(np_params, "cpu"), torch.from_numpy(toks), 0)


def test_flop_counts_match_jax():
    for preset in ("gpt2-tiny", "gpt2-350m"):
        j = JGPT2(preset=preset)
        t = build(preset, device="cpu", unroll_layers=True, remat=False)
        assert (t.num_params(), t.flops_per_token()) == (j.num_params(), j.flops_per_token())


# ------------------------------------------------------------------- engine
def _engine_pair(np_params, tokens, cfg, **model_kw):
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT, **model_kw)
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32,
              **NO_DROPOUT, **model_kw)
    je, _, _, _ = jds.initialize(config=dict(cfg), model=jm, params=np_params,
                                 training_data=(tokens,),
                                 mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))
    te, opt, loader, sched = tds.initialize(config=dict(cfg), model=tm, params=np_params,
                                            training_data=(tokens,))
    assert isinstance(opt, tadam.FusedAdamW) and isinstance(loader, tdl.DeepSpeedDataLoader)
    assert isinstance(sched, tlr.WarmupLR)
    return je, te


def test_engine_loss_curve_matches_jax():
    """Five steps of gpt2-tiny, AdamW + clip 1.0 + WarmupLR, gas 2, the
    same params= and training_data: losses within 1e-4 relative (fp32,
    sums in another order), grad norms and lrs alike."""
    np_params = JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=0)
    tokens = np.random.default_rng(0).integers(0, 1024, (24, 33)).astype(np.int32)
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                        "warmup_max_lr": 1e-3}}}
    je, te = _engine_pair(np_params, tokens, cfg)
    for _ in range(5):
        jl, tl = float(je.train_batch()), float(te.train_batch())
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(te.get_global_grad_norm(), je.get_global_grad_norm(),
                                   rtol=1e-4)
        assert te.get_lr() == pytest.approx(je.get_lr(), rel=2.5e-7)
    assert (te.global_steps, te.skipped_steps, te.optimizer_steps) == (5, 0, 5)
    assert (te.train_batch_size(), te.gradient_accumulation_steps(),
            te.zero_optimization_stage()) == (8, 2, 0)
    for name in ("wte", "lnf_scale"):
        np.testing.assert_allclose(te.params[name].numpy(),
                                   np.asarray(je.state.params[name]), rtol=0, atol=1e-4)
    batch = (tokens[:4],)
    np.testing.assert_allclose(float(te.eval_batch(batch)),
                               float(je.eval_batch(batch)), rtol=1e-4)


def _regression(params, batch, rng):
    pred = batch["x"].to(params["w"].dtype) @ params["w"] + params["b"]
    return (pred.float() - batch["y"]).square().mean()


def test_nan_batch_is_skipped_without_touching_state():
    """bf16 training: a batch that makes the loss NaN is a no-op on the
    fp32 master, the bf16 params and both moments; skipped_steps counts it
    and Adam's step counter does not advance."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 2)).astype(np.float32),
              "b": np.zeros(2, np.float32)}
    cfg = {"train_micro_batch_size_per_gpu": 8, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    eng, _, _, _ = tds.initialize(config=cfg, loss_fn=_regression, params=params,
                                  device="cpu")
    good = {"x": rng.standard_normal((8, 4)).astype(np.float32),
            "y": rng.standard_normal((8, 2)).astype(np.float32)}
    bad = dict(good, x=np.full((8, 4), np.nan, np.float32))
    eng.train_batch(iter([good]))
    snap = [t.clone() for t in tutils.tree_leaves((eng.master, eng.params, eng.opt_state))]
    loss = eng.train_batch(iter([bad]))
    assert not torch.isfinite(loss)
    assert (eng.skipped_steps, eng.optimizer_steps, eng.global_steps) == (1, 1, 2)
    for a, b in zip(snap, tutils.tree_leaves((eng.master, eng.params, eng.opt_state))):
        assert torch.equal(a, b)
    assert eng.params["w"].dtype == torch.bfloat16 and eng.master["w"].dtype == torch.float32
    eng.train_batch(iter([good]))
    assert (eng.skipped_steps, eng.optimizer_steps) == (1, 2)
    assert not torch.equal(snap[0], eng.master["b"])


def test_initialize_without_device_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {"train_batch_size": 2}
    params = {"w": np.zeros((4, 2), np.float32), "b": np.zeros(2, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.initialize(config=cfg, loss_fn=_regression, params=params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.initialize(config=cfg, model=build("gpt2-tiny"))
    eng, opt, loader, sched = tds.initialize(config=cfg, loss_fn=_regression,
                                             params=params, device="cpu")
    assert eng.device.type == "cpu" and loader is None and sched is None
    assert isinstance(opt, tutils.DummyOptim)
