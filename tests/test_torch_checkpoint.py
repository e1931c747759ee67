"""Checkpoints of the port (``deepspeed_tpu_torch/checkpoint/``, the
engine's ``save_checkpoint`` / ``load_checkpoint``, ``initialize``'s
auto-resume, ``InferenceEngine(checkpoint=)``, ``utils/zero_to_fp32.py``)
against the JAX package, on the CPU.

The training parity runs gpt2-tiny in bf16 in both packages (AdamW,
clip 1.0, WarmupLR, gas 2; the JAX engine on a 1-device mesh): a
checkpoint saved by one engine loads into the other with every leaf
bit-identical (bf16 params, fp32 master and moments), the same counters,
lr and loader position, and the next three steps' losses within 1e-4
relative, the tolerance of ``test_engine_loss_curve_matches_jax`` (bf16
matmuls summed in another order; the widest reading here was 7e-5).
Greedy ``generate`` tokens from a JAX-saved checkpoint are compared
exactly, as the existing generate parity tests do."""

import json
import os
import zipfile

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint import serialization as jser
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu.runtime import lr_schedules as jlr
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.utils import zero_to_fp32 as jz2f

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import atomic, serialization as ser
from deepspeed_tpu_torch.checkpoint.constants import MODEL_FILE, OPTIM_FILE
from deepspeed_tpu_torch.inference import InferenceEngine
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.adam.fused_adam import AdamState
from deepspeed_tpu_torch.runtime import dataloader as tdl
from deepspeed_tpu_torch.runtime import lr_schedules as tlr
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.utils import tree_leaves
from deepspeed_tpu_torch.utils import zero_to_fp32 as tz2f

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
LOSS_RTOL = 1e-4
CFG = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
       "gradient_clipping": 1.0, "steps_per_print": 100, "bf16": {"enabled": True},
       "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
       "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                    "warmup_max_lr": 1e-3}}}
TOKENS = np.random.default_rng(0).integers(0, 1024, (24, 33)).astype(np.int32)


def _np_params(seed):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _jax_engine(np_params, cfg=CFG):
    """The JAX engine on a 1-device mesh.  Its persistent compile cache is
    off: a step executable deserialized from the session cache expects 8
    shards once ``load_checkpoint`` has placed the state on the 1-device
    mesh of the 8-device test host (a JAX-package fault); compiled cold,
    the same step runs."""
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.bfloat16, max_seq=32, **NO_DROPOUT)
    cfg = dict(cfg, compile_cache={"enabled": False})
    return jds.initialize(config=cfg, model=jm, params=np_params, training_data=(TOKENS,),
                          mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]


def _port_engine(np_params, cfg=CFG, **kw):
    tm = GPT2(preset="gpt2-tiny", dtype=torch.bfloat16, device="cpu", max_seq=32,
              **NO_DROPOUT)
    return tds.initialize(config=dict(cfg), model=tm, params=np_params,
                          training_data=(TOKENS,), **kw)[0]


def _raw(x):
    """(dtype name, shape, bytes) of a torch tensor or a (JAX / numpy) array."""
    if isinstance(x, torch.Tensor):
        return ser._host_record(x)
    a = np.asarray(x)
    return a.dtype.name, list(a.shape), np.ascontiguousarray(a).tobytes()


def _flat_jax(tree):
    flat, _ = jser._flatten_with_paths(tree)
    return flat


def _state_of_jax(je):
    tree = {"params": je.state.params, "master": je.state.master,
            "opt_state": je.state.opt_state}
    return {k: _raw(v) for k, v in _flat_jax(tree).items()}


def _state_of_port(te):
    tree = {"params": te.params, "master": te.master, "opt_state": te.opt_state}
    return {k: _raw(v) for k, v in ser._flatten_with_paths(tree).items()}


def _counters_of(e):
    return (e.global_steps, int(e.optimizer_steps if not hasattr(e, "state")
                                else e.state.optimizer_steps),
            e.skipped_steps, e.micro_steps, e.global_samples, e._stream_step,
            e.training_dataloader.state_dict(), e.lr_scheduler.state_dict())


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The JAX engine after 3 steps and its checkpoint; then 3 more steps'
    losses."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    je = _jax_engine(_np_params(0))
    for _ in range(3):
        je.train_batch()
    je.save_checkpoint(d, client_state={"note": "from jax"})
    state, counters, lr = _state_of_jax(je), _counters_of(je), je.get_lr()
    losses = [float(je.train_batch()) for _ in range(3)]
    return d, state, counters, lr, losses


@pytest.fixture(scope="module")
def port_saved(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    te = _port_engine(_np_params(0))
    for _ in range(3):
        te.train_batch()
    te.save_checkpoint(d, client_state={"note": "from port"})
    state, counters, lr = _state_of_port(te), _counters_of(te), te.get_lr()
    losses = [float(te.train_batch()) for _ in range(3)]
    return d, state, counters, lr, losses


# ------------------------------------------------------------ the handoffs
def test_jax_checkpoint_loads_into_the_port(jax_saved):
    """A port engine from other weights loads the JAX engine's step-3
    checkpoint: every leaf bit-identical (bf16 params included), counters,
    lr, loader position and the client state equal; the next three
    losses within 1e-4 of the JAX engine's own."""
    d, state, counters, lr, losses = jax_saved
    te = _port_engine(_np_params(1))
    ptrs = [t.data_ptr() for t in tree_leaves((te.params, te.master, te.opt_state))]
    path, client = te.load_checkpoint(d)
    assert path == os.path.join(d, "global_step3") and client == {"note": "from jax"}
    assert te.loaded_checkpoint_tag == "global_step3"
    got = _state_of_port(te)
    assert got.keys() == state.keys() and len(got) == 64
    for key in state:
        assert got[key] == state[key], key
    assert got["params/wte"][0] == "bfloat16" and got["master/wte"][0] == "float32"
    # loaded in place: the engine's tensors keep their storage
    assert ptrs == [t.data_ptr() for t in tree_leaves((te.params, te.master, te.opt_state))]
    assert _counters_of(te) == counters
    assert te.get_lr() == pytest.approx(lr, rel=2.5e-7)
    got_losses = [float(te.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL)


def test_port_checkpoint_loads_into_jax(port_saved):
    d, state, counters, lr, losses = port_saved
    je = _jax_engine(_np_params(1))
    path, client = je.load_checkpoint(d)
    assert path.endswith("global_step3") and client == {"note": "from port"}
    got = _state_of_jax(je)
    assert got.keys() == state.keys()
    for key in state:
        assert got[key] == state[key], key
    assert _counters_of(je) == counters
    assert je.get_lr() == pytest.approx(lr, rel=2.5e-7)
    got_losses = [float(je.train_batch()) for _ in range(3)]
    np.testing.assert_allclose(got_losses, losses, rtol=LOSS_RTOL)


def test_port_writes_the_jax_container(jax_saved, tmp_path):
    """The same state (the JAX checkpoint loaded into the port and saved
    again): the same zip member order, ``treedef.json`` index (keys in
    order, dtypes, shapes), array bytes and ``meta.json`` key set and
    values, and the same manifest file list."""
    d = jax_saved[0]
    te = _port_engine(_np_params(1))
    te.load_checkpoint(d)
    te.save_checkpoint(str(tmp_path), client_state={"note": "from jax"})
    for name in (MODEL_FILE, OPTIM_FILE):
        with zipfile.ZipFile(os.path.join(d, "global_step3", name)) as jz, \
                zipfile.ZipFile(os.path.join(tmp_path, "global_step3", name)) as tz:
            assert tz.namelist() == jz.namelist()
            jidx = json.loads(jz.read("treedef.json"))["index"]
            tidx = json.loads(tz.read("treedef.json"))["index"]
            assert list(tidx.items()) == list(jidx.items())
            for member in jz.namelist():
                if member.startswith("arrays/"):
                    assert tz.read(member) == jz.read(member), member
                    assert tz.getinfo(member).compress_type == zipfile.ZIP_STORED
            if "meta.json" in jz.namelist():
                jm, tm = json.loads(jz.read("meta.json")), json.loads(tz.read("meta.json"))
                assert list(tm) == list(jm) and tm == jm
    jman = atomic.read_manifest(os.path.join(d, "global_step3"))
    tman = atomic.read_manifest(os.path.join(tmp_path, "global_step3"))
    assert tman["files"].keys() == jman["files"].keys()
    assert tman["meta"] == jman["meta"]


def test_jax_reads_the_port_files_with_its_own_load_tree(port_saved):
    d = port_saved[0]
    tree, meta = jser.load_tree(os.path.join(d, "global_step3", MODEL_FILE), with_meta=True)
    assert meta["global_steps"] == 3 and str(tree["params"]["wte"].dtype) == "bfloat16"
    port_tree = ser.load_tree(os.path.join(d, "global_step3", MODEL_FILE))
    assert _raw(tree["params"]["wte"]) == _raw(port_tree["params"]["wte"])


# ----------------------------------------------------------------- serving
def _scaled_weights():
    """gpt2-tiny weights with the embeddings and the four block matrices
    scaled 10x: greedy streams that change token (the untouched random
    model repeats one token)."""
    w = _np_params(0)
    w["wte"], w["wpe"] = w["wte"] * 10, w["wpe"] * 10
    for k in ("qkv_w", "proj_w", "fc_w", "fc_proj_w"):
        w["blocks"][k] = w["blocks"][k] * 10
    return w


@pytest.fixture(scope="module")
def jax_serving_ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_serve"))
    je = _jax_engine(_scaled_weights())
    je.train_batch()
    je.save_checkpoint(d)
    return d


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-weights", "int8"])
def test_inference_from_a_jax_checkpoint_generates_jax_tokens(jax_serving_ckpt, int8):
    """``InferenceEngine(checkpoint=)`` on a JAX-saved directory: greedy
    tokens equal JAX's ``InferenceEngine(checkpoint=)``, from the bf16
    weights (fp32 compute in both) and with ``dtype=int8``."""
    d = jax_serving_ckpt
    ids = np.random.default_rng(3).integers(0, 1024, (2, 8))
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT)
    jeng = JInferenceEngine(model=jm, checkpoint=d, dtype=jnp.int8 if int8 else None)
    want = np.asarray(jeng.generate(jnp.asarray(ids, jnp.int32), max_new_tokens=12))
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32)
    eng = InferenceEngine(tm, checkpoint=d, dtype=torch.int8 if int8 else None)
    assert eng.quantized == int8
    got = eng.generate(ids, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 8:].ravel())) > 8


def test_inference_checkpoint_forms(jax_serving_ckpt):
    """A save directory (through ``latest``), a tag directory and a model
    file give the same params; ``ServingEngine`` passes ``checkpoint=``
    through."""
    from deepspeed_tpu_torch.inference import ServingEngine
    d = jax_serving_ckpt
    mk = lambda: GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32)
    forms = (d, os.path.join(d, "global_step1"),
             os.path.join(d, "global_step1", MODEL_FILE))
    engines = [InferenceEngine(mk(), checkpoint=f) for f in forms]
    for e in engines[1:]:
        for a, b in zip(tree_leaves(engines[0].params), tree_leaves(e.params)):
            assert torch.equal(a, b)
    srv = ServingEngine(model=mk(), checkpoint=d, config={"batch_slots": 2, "block_size": 8})
    for a, b in zip(tree_leaves(engines[0].params), tree_leaves(srv.engine.params)):
        assert torch.equal(a, b)


# -------------------------------------------------- the port's own round trip
def test_checkpoint_roundtrip(tmp_path):
    """Twin of ``tests/test_engine.py::test_checkpoint_roundtrip``: a bf16
    engine with WarmupLR saves after 4 steps; another from other weights
    loads it: the client state, step count, params and master equal, and
    training continues."""
    rng = np.random.default_rng(0)
    params = {"layer_0": {"w": rng.standard_normal((8, 32)).astype(np.float32),
                          "b": np.zeros(32, np.float32)},
              "layer_1": {"w": rng.standard_normal((32, 8)).astype(np.float32),
                          "b": np.zeros(8, np.float32)}}
    x = rng.normal(size=(256, 8)).astype(np.float32)
    data = (x, x @ (rng.normal(size=(8, 8)).astype(np.float32) * 0.5))

    def loss_fn(p, batch, seed):
        h = batch[0].to(p["layer_0"]["w"].dtype)
        h = torch.relu(h @ p["layer_0"]["w"] + p["layer_0"]["b"])
        out = h @ p["layer_1"]["w"] + p["layer_1"]["b"]
        return (out.float() - batch[1]).square().mean()

    cfg = {"train_micro_batch_size_per_gpu": 4, "bf16": {"enabled": True},
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10,
                                                        "warmup_max_lr": 1e-2}}}
    e1 = tds.initialize(config=cfg, loss_fn=loss_fn, params=params, training_data=data,
                        device="cpu")[0]
    for _ in range(4):
        e1.train_batch()
    e1.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    other = {k: {n: a + 1 for n, a in v.items()} for k, v in params.items()}
    e2 = tds.initialize(config=cfg, loss_fn=loss_fn, params=other, training_data=data,
                        device="cpu")[0]
    path, client = e2.load_checkpoint(str(tmp_path))
    assert client == {"note": "hi"} and e2.global_steps == 4
    for a, b in zip(tree_leaves((e1.params, e1.master)), tree_leaves((e2.params, e2.master))):
        assert torch.equal(a, b)
    assert e2.get_lr() == e1.get_lr()
    # the same state and the same next batch: the same step
    assert float(e2.train_batch()) == float(e1.train_batch())
    assert e2.global_steps == 5


def test_load_module_only_casts_the_master_from_the_params(port_saved):
    """``load_module_only``: the params load, the master follows them (cast
    to fp32, as JAX's reshard_put does) and the moments stay."""
    d = port_saved[0]
    te = _port_engine(_np_params(1))
    moments = [t.clone() for t in tree_leaves(te.opt_state)]
    te.load_checkpoint(d, load_module_only=True)
    for key in te.params:
        for a, b in zip(tree_leaves(te.params[key]), tree_leaves(te.master[key])):
            assert torch.equal(a.float(), b)
    for a, b in zip(moments, tree_leaves(te.opt_state)):
        assert torch.equal(a, b)
    assert _raw(te.params["wte"]) == port_saved[1]["params/wte"]


def test_unported_optimizer_trees_raise(port_saved, tmp_path):
    """An unknown optimizer tree raises NotImplementedError naming the
    key; a loss ``scale`` (fp16) is ignored by this bf16 engine, as JAX
    ignores it in an engine without a scaler, and ``comm_error`` as JAX
    ignores it in an engine without error feedback."""
    import shutil
    te = _port_engine(_np_params(1))
    for extra, match in (({"scale": {"cur_scale": torch.ones(())}}, None),
                         ({"moe_state": {"x": torch.ones(1)}}, "moe_state"),
                         ({"comm_error": {"x": torch.ones(1)}}, None)):
        d = str(tmp_path / f"c{len(os.listdir(tmp_path))}")
        shutil.copytree(port_saved[0], d)
        tag_dir = os.path.join(d, "global_step3")
        tree = ser.load_tree(os.path.join(tag_dir, OPTIM_FILE))
        tree.update(extra)
        ser.save_tree(os.path.join(tag_dir, OPTIM_FILE), tree)
        os.remove(os.path.join(tag_dir, atomic.MANIFEST_FILE))    # a legacy tag now
        if match is None:
            te.load_checkpoint(d)
            assert te.global_steps == 3
        else:
            with pytest.raises(NotImplementedError, match=match):
                te.load_checkpoint(d)


def test_a_larger_mesh_warns_and_loads(port_saved, tmp_path):
    """A checkpoint recorded on an 8-device mesh at another global batch
    takes JAX's warn-and-continue path; a record-less one warns too."""
    import logging
    import shutil
    from deepspeed_tpu_torch.utils.logging import logger

    class Recorder(logging.Handler):
        def __init__(self):
            super().__init__(level=logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    d = str(tmp_path / "c")
    shutil.copytree(port_saved[0], d)
    tag_dir = os.path.join(d, "global_step3")
    os.remove(os.path.join(tag_dir, atomic.MANIFEST_FILE))        # a legacy tag now
    tree, meta = ser.load_tree(os.path.join(tag_dir, MODEL_FILE), with_meta=True)
    eight = {"pipe": 1, "data": 8, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
    for mesh, tb, want in ((eight, 64, "global batch changes 64 -> 8"),
                           (None, 8, "pre-elastic checkpoint")):
        ser.save_tree(os.path.join(tag_dir, MODEL_FILE), tree,
                      meta=dict(meta, mesh=mesh, train_batch_size=tb))
        rec = Recorder()
        logger.addHandler(rec)
        try:
            te = _port_engine(_np_params(1))
            te.load_checkpoint(d)
        finally:
            logger.removeHandler(rec)
        assert any(want in m for m in rec.messages), rec.messages
        assert te.global_steps == 3


# --------------------------------------------------------- auto-resume, config
def test_initialize_auto_resume_kwarg_and_config(port_saved, tmp_path):
    d = port_saved[0]
    te = _port_engine(_np_params(1), auto_resume=True,
                      cfg=dict(CFG, checkpoint={"dir": d}))
    assert te.global_steps == 3 and te.loaded_checkpoint_tag == "global_step3"
    te = _port_engine(_np_params(1), cfg=dict(CFG, checkpoint={"dir": d, "auto_resume": True}))
    assert te.global_steps == 3
    te = _port_engine(_np_params(1), auto_resume=False,
                      cfg=dict(CFG, checkpoint={"dir": d, "auto_resume": True}))
    assert te.global_steps == 0
    with pytest.raises(DeepSpeedConfigError, match="checkpoint.dir"):
        _port_engine(_np_params(1), auto_resume=True)


CONFIG_DICTS = [
    {"train_batch_size": 8, "checkpoint": {"keep_n": 3, "verify": "size"}},
    {"train_batch_size": 8, "checkpoint": {"dir": "/ckpt", "auto_resume": True,
                                           "fsync": False, "keep_n": None}},
    {"train_batch_size": 8, "checkpoint": {"tag_validation": "Warn"}},
    {"train_batch_size": 8, "io_retry": {"max_attempts": 3, "base_delay_s": 0.01}},
    {"train_batch_size": 8, "io_retry": {"full_jitter": True, "max_elapsed_s": 30}},
    {"train_batch_size": 8, "checkpoint": {}, "io_retry": {}},
    {"train_batch_size": 8},
]


@pytest.mark.parametrize("pd", CONFIG_DICTS)
def test_checkpoint_config_fields_match_jax(pd):
    j, t = JConfig(dict(pd), world_size=1), DeepSpeedConfig(dict(pd))
    for key in ("tag_validation", "load_universal", "keep_n", "verify", "auto_resume",
                "dir", "fsync"):
        assert getattr(t.checkpoint_config, key) == getattr(j.checkpoint_config, key), key
    for key in ("max_attempts", "base_delay_s", "max_delay_s", "jitter", "full_jitter",
                "max_elapsed_s"):
        assert getattr(t.io_retry_config, key) == getattr(j.io_retry_config, key), key
    jp, tp = j.io_retry_config.policy(), t.io_retry_config.policy()
    assert (tp.jitter_mode, tp.max_elapsed_s, tp.max_attempts) == \
        (jp.jitter_mode, jp.max_elapsed_s, jp.max_attempts)


@pytest.mark.parametrize("block", [{"keep_n": -1}, {"verify": "paranoid"},
                                   {"tag_validation": "bogus"}])
def test_bad_checkpoint_blocks_raise_in_both(block):
    from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JConfigError
    pd = {"train_batch_size": 8, "checkpoint": block}
    with pytest.raises(JConfigError):
        JConfig(dict(pd), world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(dict(pd))


@pytest.mark.parametrize("block", [{"tag_validation": "Fail"}, {"tag_validation": "Ignore"},
                                   {"load_universal": True}])
def test_unrun_checkpoint_keys_raise(block):
    """The JAX package stores these and reads neither; the port refuses a
    value it would not act on."""
    JConfig({"train_batch_size": 8, "checkpoint": block}, world_size=1)
    with pytest.raises(NotImplementedError):
        DeepSpeedConfig({"train_batch_size": 8, "checkpoint": block})


# ---------------------------------------------- schedule and loader state
@pytest.mark.parametrize("name,params", [
    ("WarmupLR", {"warmup_num_steps": 5}),
    ("WarmupDecayLR", {"total_num_steps": 20, "warmup_num_steps": 5}),
    ("OneCycle", {"cycle_first_step_size": 4}),
    ("LRRangeTest", {"lr_range_test_step_size": 3}),
])
def test_lr_schedule_state_matches_jax(name, params):
    j = jlr.get_lr_scheduler(name, params)
    t = tlr.get_lr_scheduler(name, params)
    for _ in range(7):
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict() == {"last_batch_iteration": 6}
    t2 = tlr.get_lr_scheduler(name, params)
    t2.load_state_dict(j.state_dict())
    assert t2.get_lr() == pytest.approx(j.get_lr(), rel=2.5e-7)
    assert t2.step() == t.step()


@pytest.mark.parametrize("consumed", [0, 3, 5, 6, 7, 14])
def test_loader_state_resumes_the_jax_stream(consumed):
    """After ``consumed`` batches of 23 rows in batches of 4 (drop_last off:
    6 an epoch, the last padded), the port's state equals JAX's, and a
    loader restored from JAX's state yields JAX's next 8 batches."""
    data = (np.arange(23 * 3, dtype=np.float32).reshape(23, 3),)
    jit = jdl.RepeatingLoader(jdl.DeepSpeedDataLoader(data, 4, seed=5))
    tit = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data, 4, seed=5))
    for _ in range(consumed):
        np.testing.assert_array_equal(next(tit)[0], next(jit)[0])
    assert tit.state_dict() == jit.state_dict()
    fresh = tdl.RepeatingLoader(tdl.DeepSpeedDataLoader(data, 4, seed=0))
    assert fresh.load_state_dict(jit.state_dict()) is True
    for _ in range(8):
        np.testing.assert_array_equal(next(fresh)[0], next(jit)[0])


def test_loader_position_converts_through_rows():
    data = (np.arange(48, dtype=np.float32).reshape(48, 1),)
    for saved_bs, idx, new_bs in ((4, 6, 8), (4, 5, 8), (8, 3, 4)):
        state = {"seed": 0, "epoch": 1, "batch_index": idx, "batch_size": saved_bs}
        jl = jdl.DeepSpeedDataLoader(data, new_bs)
        tl = tdl.DeepSpeedDataLoader(data, new_bs)
        assert tl.load_state_dict(state) == jl.load_state_dict(state)
        assert (tl.batch_index, tl.epoch) == (jl.batch_index, jl.epoch)
        np.testing.assert_array_equal(next(iter(tl))[0], next(iter(jl))[0])


# ------------------------------------------------------------ serialization
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16,
                                   torch.int8, torch.int32, torch.bool,
                                   torch.float8_e4m3fn])
def test_save_tree_leaf_round_trip_and_jax_reads_it(dtype, tmp_path):
    """Every dtype round-trips bit for bit through the port, and JAX's
    ``load_tree`` (through ml_dtypes for bf16 / float8) reads the same
    bytes under the same dtype name."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(3, 5, generator=g) * 4).to(dtype)
    tree = {"b": x, "a": {"n": torch.arange(4)},
            "s": AdamState(exp_avg={"w": x[:1]}, exp_avg_sq={"w": x[1:]})}
    path = str(tmp_path / "t.msgpack")
    ser.save_tree(path, tree, meta={"k": 1})
    back, meta = ser.load_tree(path, with_meta=True)
    assert meta == {"k": 1}
    assert back["b"].dtype == dtype and _raw(back["b"]) == _raw(x)
    assert torch.equal(back["s"]["exp_avg_sq"]["w"].view(torch.uint8),
                       x[1:].contiguous().view(torch.uint8))
    jtree = jser.load_tree(path)
    assert _raw(jtree["b"]) == _raw(x)
    with zipfile.ZipFile(path) as zf:
        keys = list(json.loads(zf.read("treedef.json"))["index"])
    assert keys == ["a/n", "b", "s/exp_avg/w", "s/exp_avg_sq/w"]


def test_jax_bf16_leaf_reads_without_ml_dtypes(tmp_path):
    """A JAX-written bf16 / float32 tree reads into tensors with the same
    bits, and the port's reader never imports ml_dtypes."""
    import subprocess
    import sys
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)
    path = str(tmp_path / "j.msgpack")
    jser.save_tree(path, {"p": {"w": a, "v": np.arange(3.0, dtype=np.float32)}})
    back = ser.load_tree(path)
    assert back["p"]["w"].dtype == torch.bfloat16 and _raw(back["p"]["w"]) == _raw(a)
    code = ("import sys; from deepspeed_tpu_torch.checkpoint import load_tree; "
            f"t = load_tree({path!r}); print(t['p']['w'].dtype); "
            "sys.exit(1 if 'ml_dtypes' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=str(os.path.dirname(os.path.dirname(__file__))))
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and "bfloat16" in r.stdout, r.stdout + r.stderr


def test_restore_and_place_like():
    like = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "st": AdamState(exp_avg={"w": torch.zeros(2)}, exp_avg_sq={"w": torch.zeros(2)})}
    loaded = {"w": torch.ones(2, 3), "extra": torch.ones(1),
              "st": {"exp_avg": {"w": torch.full((2,), 2.0)},
                     "exp_avg_sq": {"w": torch.full((2,), 3.0)}}}
    r = ser.restore_like(like, loaded)
    assert isinstance(r["st"], AdamState) and r["w"].dtype == torch.float32
    p = ser.place_like(loaded, like)
    assert p["w"].dtype == torch.bfloat16 and float(p["st"].exp_avg_sq["w"][0]) == 3.0
    assert ser.place_like(loaded, like, cast=torch.float64)["w"].dtype == torch.float64
    with pytest.raises(ValueError, match="shape"):
        ser.place_like(dict(loaded, w=torch.ones(3, 2)), like)
    with pytest.raises(KeyError):
        ser.restore_like(like, {"w": torch.ones(2, 3)})


# -------------------------------------------------------------- zero_to_fp32
def test_zero_to_fp32_roundtrip(port_saved):
    """Twin of ``tests/test_checkpoint_tools.py::test_zero_to_fp32_roundtrip``:
    bf16 training saves an fp32 master, which consolidation prefers; the
    port's tool and JAX's read the same values from the same checkpoint."""
    d, state = port_saved[0], port_saved[1]
    sd = tz2f.get_fp32_state_dict_from_zero_checkpoint(d)
    assert all(v.dtype == np.float32 for v in sd.values()) and len(sd) == 16
    assert sd["wte"].tobytes() == state["master/wte"][2]
    jsd = jz2f.get_fp32_state_dict_from_zero_checkpoint(d)
    assert sd.keys() == jsd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])


def test_zero_to_fp32_npz_and_state_dict(port_saved, tmp_path):
    d = port_saved[0]
    out = str(tmp_path / "fp32.npz")
    sd = tz2f.convert_zero_checkpoint_to_fp32_state_dict(d, out)
    loaded = np.load(out)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k], v)
    target = GPT2(preset="gpt2-tiny", device="cpu", max_seq=32).init_params(0)
    restored = tz2f.load_state_dict_from_zero_checkpoint(target, d)
    assert restored.keys() == target.keys()
    np.testing.assert_array_equal(restored["blocks"]["qkv_w"].numpy(), sd["blocks/qkv_w"])
    # a tag directory works without the parent's `latest`
    sd2 = tz2f.get_fp32_state_dict_from_zero_checkpoint(os.path.join(d, "global_step3"))
    np.testing.assert_array_equal(sd2["wpe"], sd["wpe"])


def test_recovery_script_and_16bit_model(tmp_path):
    """The recovery script is copied beside each checkpoint and listed in
    its manifest; ``save_16bit_model`` writes the bf16 params with
    ``{"dtype": "bfloat16"}``, which JAX's ``load_tree`` reads."""
    te = _port_engine(_np_params(0))
    te.train_batch()
    te.save_checkpoint(str(tmp_path), tag="t")
    tag_dir = tmp_path / "t"
    assert (tag_dir / "zero_to_fp32.py").is_file()
    assert "zero_to_fp32.py" in atomic.read_manifest(str(tag_dir))["files"]
    te.save_16bit_model(str(tmp_path / "16bit"))
    tree, meta = jser.load_tree(str(tmp_path / "16bit" / "model_16bit.msgpack"),
                                with_meta=True)
    assert str(tree["params"]["wte"].dtype) == "bfloat16" and meta == {"dtype": "bfloat16"}
    assert _raw(tree["params"]["wte"]) == _raw(te.params["wte"])
