"""ZeRO-Offload in the port (``runtime/zero/{config,wire,offload_engine}.py``
and the engine's offload step) against the JAX package's, on the CPU.

Twins of ``tests/test_offload.py:32-260`` on gpt2-tiny in fp32: graded
config 3's training config (stage 3, AdamW at lr 6e-4 and weight decay
0.1, clipping 1.0, gas 2, remat) with ``offload_optimizer: cpu``, with and
without the delayed parameter update (DPU), trains to the JAX engine's
losses on a 1-device mesh within 1e-4 (the engine tests' tolerance:
another order of fp32 sums in the gradients), and to the port's own
in-device engine's; checkpoints cross from the JAX offload engine to the
port and back with the host master and moments bit-equal (the same native
step on the same bytes).  The rest holds the port's own semantics: the bf16
payload, the fp16 overflow skip, DPU's warm-up and one-step lag, the flush
on save, the client-optimizer refusal, checkpoints crossing port offload
and port in-device state, ``zero_to_fp32``, and the NVMe tier's refusals.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.mesh import make_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.utils import tree_leaves
from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

from test_torch_train_graph import _graph_path

LOSS_RTOL = 1e-4
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models run fastest on one thread (and beside the suite's other
    workers); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(offload=True, dpu=None, stage=3, optimizer=None, **over):
    zero = {"stage": stage}
    if offload:
        zero["offload_optimizer"] = {"device": "cpu"}
        if dpu is not None:
            zero["offload_optimizer"].update(delayed_param_update=True,
                                             delayed_param_update_warmup=dpu)
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
           "steps_per_print": 10 ** 9, "gradient_clipping": 1.0,
           "optimizer": optimizer or {"type": "AdamW",
                                      "params": {"lr": 6e-4, "weight_decay": 0.1}},
           "zero_optimization": zero}
    cfg.update(over)
    return cfg


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _port(cfg, dtype=torch.float32, params=None, **kw):
    m = GPT2(preset="gpt2-tiny", dtype=dtype, device="cpu", max_seq=32, remat=True,
             **NO_DROPOUT)
    return tds.initialize(config=cfg, model=m, params=params or _np_params(0),
                          training_data=(TOKENS,), **kw)[0]


def _batches(n, seed=11):
    """``n`` steps' data: each the gas (2) micro-batches of one step."""
    rng = np.random.default_rng(seed)
    return [[(rng.integers(0, 1024, (4, 33)).astype(np.int32),) for _ in range(2)]
            for _ in range(n)]


def _curve(e, steps=STEPS):
    return [float(e.train_batch()) for _ in range(steps)]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engines on a 1-device mesh: sync offload (5 steps, then a
    checkpoint) and DPU with warm-up 2 (5 steps); their curves, the saved
    directory and the sync engine (the port's checkpoint loads into it)."""
    out = {}
    for name, dpu in (("sync", None), ("dpu", 2)):
        jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, remat=True,
                   **NO_DROPOUT)
        je = jds.initialize(config=dict(_cfg(dpu=dpu), compile_cache={"enabled": False}),
                            model=jm, params=_np_params(0), training_data=(TOKENS,),
                            mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
        assert je._offload is not None and je._dpu == (dpu is not None)
        out[name] = [float(je.train_batch()) for _ in range(STEPS)]
        if name == "sync":
            d = str(tmp_path_factory.mktemp("jax_offload"))
            je.save_checkpoint(d)
            out["dir"], out["engine"] = d, je
    return out


@pytest.mark.parametrize("dpu", [None, 2])
def test_offload_curve_matches_jax(jax_runs, dpu):
    """Graded config 3 at gpt2-tiny: the port's losses within 1e-4 of the
    JAX engine's, synchronous and with DPU (its lag from step 3 on)."""
    e = _port(_cfg(dpu=dpu))
    assert e._offload is not None and e.zero_optimization_stage() == 3
    np.testing.assert_allclose(_curve(e), jax_runs["sync" if dpu is None else "dpu"],
                               rtol=LOSS_RTOL)


def test_offload_matches_in_device_engine():
    """``test_cpu_offload_loss_matches_device`` / ``test_zero3_offload...``:
    stage 3 + offload against the port's in-device stage-1 engine; the
    device holds no fp32 master and no moments."""
    ref = _curve(_port(_cfg(offload=False, stage=1)))
    e = _port(_cfg())
    np.testing.assert_allclose(_curve(e), ref, rtol=LOSS_RTOL)
    assert e.master is None and e.opt_state is None
    assert e.optimizer_steps == STEPS and e.global_steps == STEPS


def test_offload_weight_decay_matches_device():
    """``test_cpu_offload_weight_decay_matches_device``: Adam with decay."""
    opt = {"type": "Adam", "params": {"lr": 1e-2, "weight_decay": 0.1}}
    ref = _curve(_port(_cfg(offload=False, optimizer=opt)))
    np.testing.assert_allclose(_curve(_port(_cfg(optimizer=opt))), ref, rtol=LOSS_RTOL)


def test_offload_bf16_payload():
    """``test_cpu_offload_bf16``: bf16 params on the device are the bf16
    image of the host fp32 master; the gradients cross in bf16."""
    e = _port(_cfg(bf16={"enabled": True}, data_types={"grad_accum_dtype": "bf16"}),
              dtype=torch.bfloat16)
    losses = _curve(e, 8)
    assert losses[-1] < losses[0]
    off = e._offload
    assert off.out_dtype == "bfloat16" and off.wire_dtype == torch.bfloat16
    for leaf, master in zip(tree_leaves(e.params), tree_leaves(off.master_tree())):
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf, master.to(torch.bfloat16))


def test_offload_fp16_overflow_skips_host_step():
    """``test_cpu_offload_fp16_overflow_skips_host_step``: at 2^32 the first
    steps overflow; a skipped step leaves the host master and moments
    bit-unchanged and advances the skip counter only."""
    e = _port(_cfg(optimizer={"type": "Adam", "params": {"lr": 1e10}},
                   fp16={"enabled": True, "initial_scale_power": 32}), dtype=torch.float16)
    st = e.offload_state()
    before = {k: v.copy() for k, v in st.items()}
    e.train_batch()
    assert e.skipped_steps == 1 and e.optimizer_steps == 0 and e.global_steps == 1
    for k, v in e.offload_state().items():
        np.testing.assert_array_equal(v, before[k])
    # the scaler ticked in the device half (hysteresis 2: the first overflow keeps the scale)
    assert e.loss_scale() == 2.0 ** 32 and int(e.scale.cur_hysteresis) == 1
    e.train_batch()
    assert e.skipped_steps > 0 and e.optimizer_steps < e.global_steps


def test_offload_nonfinite_loss_skips_host_step():
    """The health sentinels under offload (JAX ``_grad_only_step``,
    :1238-1249): a step whose loss is NaN is skipped on the host, master,
    moments and device params bit-unchanged; the updated-params sentinel
    is not computed there (the host updates the params)."""
    e = _port(_cfg())
    assert e._health_enabled and e._health_cfg.skip_nonfinite
    e.train_batch()
    before = {k: v.copy() for k, v in e.offload_state().items()}
    params = [t.clone() for t in tree_leaves(e.params)]
    loss_fn = e._loss_fn
    e._loss_fn = lambda p, mb, seed: loss_fn(p, mb, seed) * float("nan")
    e.train_batch()
    m = e._last_metrics
    assert bool(m["skip"]) and bool(m["nonfinite_loss"]) and "nonfinite_params" not in m
    assert e.skipped_steps == 1 and e.optimizer_steps == 1 and e.global_steps == 2
    for k, v in e.offload_state().items():
        np.testing.assert_array_equal(v, before[k])
    assert all(torch.equal(a, b) for a, b in zip(params, tree_leaves(e.params)))
    e._loss_fn = loss_fn
    e.train_batch()
    assert e.optimizer_steps == 2 and not np.array_equal(e.offload_state()["master"],
                                                         before["master"])


def test_dpu_within_warmup_bit_equal_to_sync():
    """``test_dpu_within_warmup_matches_sync``: before the warm-up boundary
    DPU is the synchronous path, bit for bit."""
    batches = _batches(3)
    sync, dpu = _port(_cfg()), _port(_cfg(dpu=100))
    assert dpu._dpu and not sync._dpu
    a = [float(sync.train_batch(iter(b))) for b in batches]
    b = [float(dpu.train_batch(iter(b))) for b in batches]
    assert a == b
    np.testing.assert_array_equal(sync._offload.master, dpu._offload.master)


def test_dpu_one_step_lag_and_flush():
    """``test_dpu_one_step_lag_semantics``: warm-up 0; after the first batch
    nothing is applied, after the second exactly the first's update (the
    synchronous engine after one batch, bit for bit); the flush applies the
    pending one."""
    batches = _batches(2)
    e = _port(_cfg(dpu=0))
    p0 = e._offload.master.copy()
    e.train_batch(iter(batches[0]))
    np.testing.assert_array_equal(e._offload.master, p0)
    assert e.optimizer_steps == 0 and e._pending_offload is not None
    e.train_batch(iter(batches[1]))
    ref = _port(_cfg())
    ref.train_batch(iter(batches[0]))
    np.testing.assert_array_equal(e._offload.master, ref._offload.master)
    assert e.optimizer_steps == 1
    e._flush_offload()
    assert e._pending_offload is None and e.optimizer_steps == 2
    assert not np.array_equal(e._offload.master, ref._offload.master)


def test_dpu_converges_and_save_flushes(tmp_path):
    """``test_dpu_converges_and_checkpoint_flushes``."""
    e = _port(_cfg(dpu=2, optimizer={"type": "Adam", "params": {"lr": 1e-2}}))
    fixed = _batches(1)[0]
    losses = [float(e.train_batch(iter(fixed))) for _ in range(10)]
    assert losses[-1] < losses[0]
    assert e._pending_offload is not None
    e.save_checkpoint(str(tmp_path))
    assert e._pending_offload is None and e.optimizer_steps == 10


def test_device_half_captured_equals_eager():
    """The device half through the stand-in graph (a replay re-runs the
    body into the static outputs, the flat gradients among them) and
    eagerly, with DPU from step 2: the losses, the grad norms and the host
    master bit-equal; one graph, replayed every step."""
    runs = {}
    for impl in ("replay", "eager"):
        e = _port(_cfg(dpu=1), step_impl="eager" if impl == "eager" else "auto")
        if impl == "replay":
            _graph_path(e)
        curve = [(float(e.train_batch()), e.get_global_grad_norm()) for _ in range(4)]
        runs[impl] = (curve, e.offload_state()["master"].copy())
        if impl == "replay":
            g = e.stats()["graphs"]
            assert g["graphs"] == 1 and g["replays"] == 4
    assert runs["replay"][0] == runs["eager"][0]
    np.testing.assert_array_equal(runs["replay"][1], runs["eager"][1])


def test_client_optimizer_with_offload_rejected():
    """``test_client_optimizer_with_offload_rejected``: JAX's ValueError."""
    with pytest.raises(ValueError, match="offload_optimizer"):
        _port(_cfg(), optimizer=FusedAdam(lr=1e-2))


def test_checkpoint_crosses_jax_and_port_offload(jax_runs, tmp_path):
    """The JAX offload engine's checkpoint loads into the port's with its
    host master and moments bit-equal; the port's, saved back, loads into
    the JAX engine bit-equal; the next losses agree within 1e-4."""
    je = jax_runs["engine"]
    e = _port(_cfg())
    e.load_checkpoint(jax_runs["dir"])
    jm, jv = je._offload.moments()
    np.testing.assert_array_equal(e._offload.master, je._offload.master)
    np.testing.assert_array_equal(e._offload.m, jm)
    np.testing.assert_array_equal(e._offload.v, jv)
    assert e.global_steps == STEPS and e.optimizer_steps == STEPS
    for leaf, jleaf in zip(tree_leaves(e.params), jax.tree_util.tree_leaves(je.state.params)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(jleaf))
    batches = _batches(2, seed=5)
    e.save_checkpoint(str(tmp_path))
    je.load_checkpoint(str(tmp_path))
    np.testing.assert_array_equal(je._offload.master, e._offload.master)
    np.testing.assert_array_equal(je._offload.moments()[1], e._offload.v)
    port = [float(e.train_batch(iter(b))) for b in batches]
    jax_ = [float(je.train_batch(iter(b))) for b in batches]
    np.testing.assert_allclose(port, jax_, rtol=LOSS_RTOL)


def test_checkpoint_crosses_port_offload_and_device(tmp_path):
    """``test_checkpoint_cross_compatible_offload_and_device``: the host
    moments in the in-device layout, both ways."""
    off = _port(_cfg())
    _curve(off, 3)
    off.save_checkpoint(str(tmp_path / "from_off"))
    dev = _port(_cfg(offload=False))
    dev.load_checkpoint(str(tmp_path / "from_off"))
    flat = torch.cat([t.reshape(-1) for t in tree_leaves(dev.opt_state.exp_avg)]).numpy()
    np.testing.assert_array_equal(flat, off._offload.m)
    dev.save_checkpoint(str(tmp_path / "from_dev"))
    off2 = _port(_cfg())
    off2.load_checkpoint(str(tmp_path / "from_dev"))
    np.testing.assert_array_equal(off2._offload.m, off._offload.m)
    np.testing.assert_array_equal(off2._offload.master, off._offload.master)
    batches = _batches(2, seed=6)
    a = [float(off.train_batch(iter(b))) for b in batches]
    b = [float(off2.train_batch(iter(b))) for b in batches]
    assert a == b


def test_zero_to_fp32_with_offload(tmp_path):
    """``test_zero_to_fp32_with_offload``: the consolidated fp32 weights
    are the host master."""
    e = _port(_cfg(bf16={"enabled": True}), dtype=torch.bfloat16)
    _curve(e, 2)
    e.save_checkpoint(str(tmp_path))
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path))
    masters = [t.numpy() for t in tree_leaves(e._offload.master_tree())]
    assert len(sd) == len(masters)
    for name, master in zip(sorted(sd), masters):
        np.testing.assert_array_equal(sd[name], master)


def test_sub_groups_bit_equal_to_one_group():
    """``sub_group_size`` splits the host step; the result is the same."""
    batches = _batches(2, seed=8)
    one = _port(_cfg())
    split_cfg = _cfg()
    split_cfg["zero_optimization"]["sub_group_size"] = 100000
    split = _port(split_cfg)
    assert len(split._offload.sub_groups) > 1 and len(one._offload.sub_groups) == 1
    for b in batches:
        one.train_batch(iter(b))
        split.train_batch(iter(b))
    np.testing.assert_array_equal(one._offload.master, split._offload.master)


STREAMED = {"stage": 3, "offload_optimizer": {"device": "cpu"}, "offload_param": {"device": "cpu"}}


@pytest.mark.parametrize("zero,top,err", [
    ({**STREAMED, "offload_param": {"device": "nvme"}}, {}, (ValueError, "needs nvme_path")),
    ({**STREAMED, "offload_param": {"device": "disk"}}, {}, (ValueError, "none|cpu|nvme")),
    ({**STREAMED, "offload_param": {"device": "cpu", "prefetch": 2}}, {},
     (NotImplementedError, "unknown")),
    (STREAMED, {"comms_compression": {"enabled": True, "routes": ["param_stream"]}},
     (NotImplementedError, "item 13")),
    ({**STREAMED, "stage": 2}, {"_engine": "auto"}, (ValueError, "requires stage 3")),
    (STREAMED, {"_engine": "graph"}, (ValueError, "step_impl='graph'")),
])
def test_nvme_tier_raises_naming_item_7b(zero, top, err):
    """The offload tier is whole (item 7b's NVMe tiers, item 7c's parameter
    streaming and sparse wire); what stays invalid or unported beside it
    raises: ``offload_param`` nvme without ``nvme_path``, an unknown device
    or key, the quantized layer wire of ``comms_compression`` (item 13),
    and at the engine JAX's stage-3 ``ValueError`` and a captured
    streamed step."""
    top = dict(top)
    impl = top.pop("_engine", None)
    cfg = dict({"train_batch_size": 8, "zero_optimization": zero,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}, **top)
    with pytest.raises(err[0], match=err[1]):
        if impl is None:
            DeepSpeedConfig(cfg)
        else:
            _port(cfg, step_impl=impl)


def test_offload_config_parses_jax_defaults():
    """The stage-3 and offload keys with JAX's defaults (``zero/config.py``)."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    pd = {"train_batch_size": 8, "zero_optimization": {
        "stage": 3, "cpu_offload": True, "stage3_param_persistence_threshold": 10,
        "stage3_gather_16bit_weights_on_model_save": True}}
    t, j = DeepSpeedConfig(pd).zero_config, JConfig(pd, world_size=1).zero_config
    for key in ("stage", "sub_group_size", "param_persistence_threshold",
                "gather_16bit_weights_on_model_save", "cpu_offload"):
        assert getattr(t, key) == getattr(j, key), key
    for key in ("device", "delayed_param_update", "delayed_param_update_warmup"):
        assert getattr(t.offload_optimizer, key) == getattr(j.offload_optimizer, key), key
    assert t.offload_optimizer.delayed_param_update_warmup == 20
    # the NVMe keys as JAX parses them; the key with no effect here is accepted and named
    pd["zero_optimization"]["offload_optimizer"] = {
        "device": "nvme", "nvme_path": "/tmp/x", "pin_memory": True, "buffer_count": 2,
        "pipeline_write": True, "fast_init": True}
    t, j = DeepSpeedConfig(pd), JConfig(pd, world_size=1)
    for key in ("device", "nvme_path", "buffer_count", "pin_memory", "pipeline_read",
                "pipeline_write", "pipeline"):
        assert (getattr(t.zero_config.offload_optimizer, key)
                == getattr(j.zero_config.offload_optimizer, key)), key
    assert t.noop_keys_set == ["zero_optimization.offload_optimizer.fast_init"]
