"""fp16 mixed-precision training of the port (``runtime/engine.py`` with
``runtime/fp16/loss_scaler.py``, the fp16 routes of
``ops/transformer/flash_attention.py``) against the JAX package, on the
CPU.

The engine: gpt2-tiny in fp16 through ``initialize`` -> ``train_batch``
beside the JAX fp16 engine on a 1-device mesh (``compile_cache`` off, as
in ``test_torch_checkpoint.py``), from the same numpy parameters and
tokens, with an initial scale of 2^24 (the first steps overflow) and a
``loss_scale_window`` of 3 (the scale grows again within the run).  The
scale, the hysteresis and the skipped steps are equal at every step.  No
step's largest |gradient x scale| lies within 1% of 65504 in either
package, so the overflow decisions cannot part on a rounding.  That
guard reads the final gradients only, so the draws here must also keep
every partial sum of an fp16 reduction below 65504: JAX's fp16 bias
gradients accumulate in fp16 and overflow where a partial sum passes it
while the final one does not (ROADMAP section C;
``test_fp16_bias_gradient_partial_sum_stays_finite`` holds the port's
sums there).  The
losses agree within LOSS_RTOL = 2^-11 relative, fp16's unit roundoff u:
the loss is an fp32 mean over fp32 logits of fp16 activations, which XLA
and PyTorch's CPU kernels round after each op from sums in another order,
and the updates of the steps before move both runs apart; the widest
reading over the 12 steps was 1.4e-5.  Then checkpoints cross both ways (fp16 params as ``<f2``
leaves bit for bit, the ``scale`` tree equal), the captured step's
scaler bookkeeping runs through ``test_torch_train_graph``'s stand-in
graphs, and the twins of ``tests/test_engine.py``'s fp16 tests run the
MLP of ``tests/simple_model.py``.

The kernels: the fp16 routes on meta tensors (the dense sm90 entries,
and every other route's fp16 instance), and the plain fp16 forward and
gradients against JAX's Pallas kernels in interpret mode within
FP16_ATOL = 2^-8 absolute on values of magnitude up to ~4 (two fp16 ulps
there, four at 1: P rounded to fp16 against the running maximum in JAX's
kernel and against the row's final one in the plain version, outputs
rounded once each; the widest reading was 9.8e-4, on dK of magnitude 2.05)."""

import functools
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint import serialization as jser
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.transformer.flash_attention import (
    flash_attention as jax_flash, flash_attention_with_lse as jax_flash_lse)
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfigError as JConfigError
from simple_model import SimpleModel, random_dataset

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import FixedSparsityConfig
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig, DeepSpeedConfigError
from deepspeed_tpu_torch.runtime.utils import tree_leaves
from test_torch_train_graph import FakeGraph, ReplayGraph, _graph_path

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
LOSS_RTOL = 2.0 ** -11
FP16_ATOL = 2.0 ** -8
FP16_MAX = 65504.0
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)
CFG16 = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
         "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
         "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
         "fp16": {"enabled": True, "initial_scale_power": 24, "loss_scale_window": 3,
                  "hysteresis": 2}}
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _port(cfg=CFG16, np_params=None, **kw):
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float16, device="cpu", max_seq=32, **NO_DROPOUT)
    return tds.initialize(config=dict(cfg), model=tm,
                          params=_np_params() if np_params is None else np_params,
                          training_data=(TOKENS,), **kw)[0]


def _scaler(e):
    """(scale, hysteresis, last overflow, iter, skipped steps) of either engine."""
    st = e.state.scale if hasattr(e, "state") else e.scale
    return (float(st.cur_scale), int(st.cur_hysteresis), int(st.last_overflow_iter),
            int(st.iter_num), e.skipped_steps)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("fp16", [
    {"enabled": True},
    {"enabled": True, "loss_scale": 128},
    {"enabled": True, "initial_scale_power": 12, "loss_scale_window": 50, "hysteresis": 4,
     "min_loss_scale": 0.5},
    {"enabled": False, "initial_scale_power": 8},
])
def test_fp16_config_matches_jax_field_by_field(fp16):
    pd = {"train_batch_size": 8, "fp16": fp16}
    j, t = JConfig(dict(pd), world_size=1), DeepSpeedConfig(dict(pd))
    for key in ("enabled", "loss_scale", "initial_scale_power", "loss_scale_window",
                "hysteresis", "min_loss_scale", "dynamic_loss_scale"):
        assert getattr(t.fp16, key) == getattr(j.fp16, key), key
    assert t.precision_dtype == j.precision_dtype


def test_fp16_config_refusals():
    pd = {"train_batch_size": 8, "fp16": {"enabled": True}, "bf16": {"enabled": True}}
    with pytest.raises(JConfigError):
        JConfig(dict(pd), world_size=1)
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedConfig(dict(pd))
    with pytest.raises(NotImplementedError, match="master_weights_and_grads"):
        DeepSpeedConfig({"train_batch_size": 8,
                         "fp16": {"enabled": True, "master_weights_and_grads": True}})


# ------------------------------------------------------ the engine vs JAX
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both engines over STEPS steps: per step the losses, the scaler
    states and each package's largest |gradient x scale| (the scaled fp32
    gradients before the unscale); then each saves a checkpoint."""
    np_params = _np_params()
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float16, max_seq=32, **NO_DROPOUT)
    je = jds.initialize(config=dict(CFG16, compile_cache={"enabled": False}), model=jm,
                        params=np_params, training_data=(TOKENS,),
                        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    te = _port(np_params=np_params)
    jmax, tmax = [], []
    j_grad_fn, t_grad_fn = je._grad_fn, te._grad_fn

    def j_spy(base, batch, rng, cur_scale):
        out = j_grad_fn(base, batch, rng, cur_scale)
        m = functools.reduce(jnp.maximum, [jnp.max(jnp.abs(g))
                                           for g in jax.tree_util.tree_leaves(out[0])])
        jax.debug.callback(lambda v: jmax.append(float(v)), m)
        return out

    def t_spy(base, batch, seed):
        grads, loss = t_grad_fn(base, batch, seed)
        tmax.append(max(float(torch.where(torch.isnan(g), np.inf, g.abs()).max())
                        for g in tree_leaves(grads)))
        return grads, loss

    je._grad_fn, te._grad_fn = j_spy, t_spy
    rows = []
    for _ in range(STEPS):
        jl, tl = float(je.train_batch()), float(te.train_batch())
        rows.append(((jl, _scaler(je)), (tl, _scaler(te))))
    jax.effects_barrier()
    dirs = {k: str(tmp_path_factory.mktemp(f"{k}_fp16")) for k in ("jax", "port")}
    je.save_checkpoint(dirs["jax"])
    te.save_checkpoint(dirs["port"])
    return {"rows": rows, "jmax": jmax, "tmax": tmax, "je": je, "te": te, "dirs": dirs}


def test_fp16_engine_follows_the_jax_engine(run):
    rows = run["rows"]
    for i, ((jl, js), (tl, ts)) in enumerate(rows):
        assert ts == js, f"step {i + 1}: scaler {ts} != JAX {js}"
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, err_msg=f"step {i + 1}")
    scales = [js[0] for _, (_, js) in rows]
    skipped = rows[-1][0][1][4]
    # the run takes overflow skips and a growth of the scale
    assert 0 < skipped < STEPS and any(b > a for a, b in zip(scales, scales[1:]))
    assert len(run["jmax"]) == len(run["tmax"]) == STEPS
    for i, (jm, tm) in enumerate(zip(run["jmax"], run["tmax"])):
        for who, m in (("jax", jm), ("port", tm)):
            assert not 0.99 * FP16_MAX <= m <= FP16_MAX, f"step {i + 1}: {who} max {m}"
        assert np.isfinite(jm) == np.isfinite(tm), f"step {i + 1}: {jm} vs {tm}"
    assert run["te"].compute_dtype == torch.float16


def _raw(x):
    if isinstance(x, torch.Tensor):
        return ser._host_record(x)
    a = np.asarray(x)
    return a.dtype.name, list(a.shape), np.ascontiguousarray(a).tobytes()


def test_fp16_checkpoints_cross_both_ways(run):
    """JAX's checkpoint into a fresh port engine and the port's into the
    JAX engine: the fp16 params ``<f2`` bit for bit, the ``scale`` tree
    equal, the counters equal."""
    je, te = run["je"], run["te"]
    fresh = _port(np_params=_np_params(1))
    fresh.load_checkpoint(run["dirs"]["jax"])
    jflat, _ = jser._flatten_with_paths(je.state.params)
    tflat = ser._flatten_with_paths(fresh.params)
    assert jflat.keys() == tflat.keys()
    for k in jflat:
        assert _raw(tflat[k]) == _raw(jflat[k]), k
        assert _raw(tflat[k])[0] == "float16"
    assert _scaler(fresh) == _scaler(je)
    assert (fresh.global_steps, fresh.skipped_steps) == (je.global_steps, je.skipped_steps)
    je.load_checkpoint(run["dirs"]["port"])
    jflat, _ = jser._flatten_with_paths(je.state.params)
    tflat = ser._flatten_with_paths(te.params)
    for k in jflat:
        assert _raw(jflat[k]) == _raw(tflat[k]), k
    assert _scaler(je) == _scaler(te)
    tree = ser.load_tree(os.path.join(run["dirs"]["port"], f"global_step{STEPS}",
                                      "optim_states.msgpack"))
    assert sorted(tree["scale"]) == ["cur_hysteresis", "cur_scale", "iter_num",
                                     "last_overflow_iter"]


# -------------------------------------------------- the captured step's scaler
def test_warmup_and_capture_leave_the_scaler_unticked():
    """With stand-in graphs that replay nothing, the first train_batch is
    the warm-up and the capture: the scaler is where it started."""
    eng = _graph_path(_port(), lambda: FakeGraph())
    before = _scaler(eng)
    eng.train_batch()
    assert _scaler(eng) == before and eng.stats()["graphs"]["replays"] == 1


def test_replays_use_the_scale_the_last_replay_left():
    """Captured (stand-in graphs that recompute the body on replay) and
    eager engines step by step: the same losses, grad norms and scaler
    states while the scale halves after overflows, grows after the window,
    and after it is set in place to 2^40 (a scale baked into the capture as
    a host float would overflow every replay or never)."""
    cfg = dict(CFG16, fp16=dict(CFG16["fp16"], hysteresis=1))
    graph, eager = _graph_path(_port(cfg)), _port(cfg, step_impl="eager")
    states = []
    for step in range(10):
        if step == 7:
            for e in (graph, eager):
                e.scale.cur_scale.fill_(2.0 ** 40)
        a, b = float(graph.train_batch()), float(eager.train_batch())
        assert (a, repr(graph.get_global_grad_norm()), _scaler(graph)) == (
            b, repr(eager.get_global_grad_norm()), _scaler(eager)), f"step {step + 1}"
        states.append(_scaler(graph))
    assert graph.stats()["graphs"]["replays"] == 10
    assert states[0][:2] == (2.0 ** 23, 1) and states[0][4] == 1     # the first step overflowed
    assert states[7][0] == 2.0 ** 39 and states[7][4] == states[6][4] + 1


# ----------------------------------------- twins of tests/test_engine.py's fp16 tests
def _mlp_loss(params, batch, rng):
    x, y = batch
    h = x.to(params["layer_0"]["w"].dtype)
    for i in range(2):
        p = params[f"layer_{i}"]
        h = h @ p["w"] + p["b"]
        if i == 0:
            h = torch.relu(h)
    return (h.float() - y.float()).square().mean()


def _mlp_engine(fp16):
    params = jax.tree_util.tree_map(np.asarray, SimpleModel().init(jax.random.PRNGKey(0)))
    cfg = {"train_micro_batch_size_per_gpu": 32, "gradient_accumulation_steps": 1,
           "steps_per_print": 1000, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
           "fp16": fp16}
    return tds.initialize(config=cfg, loss_fn=_mlp_loss, params=params, device="cpu",
                          training_data=random_dataset())[0]


def test_fp16_static_overflow_skips():
    """A loss scale of 2^120: inf gradients, the step skipped, the params,
    the master and the optimizer state bit-unchanged."""
    engine = _mlp_engine({"enabled": True, "loss_scale": 2.0 ** 120})
    state = (engine.params, engine.master, engine.opt_state)
    before = [t.clone() for t in tree_leaves(state)]
    engine.train_batch()
    after = tree_leaves(state)
    assert engine.skipped_steps == 1 and engine.global_steps == 1
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_fp16_dynamic_trains():
    engine = _mlp_engine({"enabled": True, "initial_scale_power": 8})
    losses = [float(engine.train_batch()) for _ in range(15)]
    assert engine.compute_dtype == torch.float16
    assert engine.loss_scale() >= 1.0
    assert losses[-1] < losses[0] * 0.6


# ----------------------------------------------------- the fp16 kernel routes
def _names(monkeypatch):
    names = []
    monkeypatch.setattr(fa, "_run", lambda name, *a, device: names.append(name))
    return names


def test_fp16_routes_to_the_dense_sm90_entries(monkeypatch):
    """fp16 at head dim 64: the sm90 forward and backward pair, through the
    wrappers and the ``flash_attention`` autograd function; at 128 the sm90
    forward."""
    names = _names(monkeypatch)
    B, T, H = 2, 200, 4
    for d in (64, 128):
        q = torch.empty((B, T, H, d), dtype=torch.float16, device="meta")
        o, lse = fa.flash_fwd(q, q, q, True)
        assert o.dtype == torch.float16 and names[-1] == "flash_fwd_sm90"
    q = torch.empty((B, T, H, 64), dtype=torch.float16, device="meta")
    lse = torch.empty((B, H, T), device="meta")
    names.clear()
    fa.flash_bwd_dkdv(q, q, q, q, lse, lse, True)
    fa.flash_bwd_dq(q, q, q, q, lse, lse, True)
    assert names == list(fa.DENSE_BWD_SM90)
    names.clear()
    leaves = [torch.empty((B, T, H, 64), dtype=torch.float16, device="meta",
                          requires_grad=True) for _ in range(3)]
    fa.flash_attention(*leaves, causal=True).sum().backward()
    assert names == ["flash_fwd_sm90", *fa.DENSE_BWD_SM90]
    assert fa._DTYPE_CODES[torch.float16] == 2


def _routes():
    """The eleven fp16 routes that raised while only the dense sm90 entries
    had fp16 instances, each with the entry it must launch now."""
    B, T, H = 1, 256, 2
    q = torch.empty((B, T, H, 64), dtype=torch.float16, device="meta")
    q96 = torch.empty((B, T, H, 96), dtype=torch.float16, device="meta")
    q128 = torch.empty((B, T, H, 128), dtype=torch.float16, device="meta")
    lse = torch.empty((B, H, T), device="meta")
    kb = torch.zeros((B, T), device="meta")
    layout = FixedSparsityConfig(num_heads=H, block=16).make_layout(T)
    band = fa.band_lut(2, (0,), 16, T)
    merged = fa.layout_luts(layout, T, H, True).merged
    return {
        "backward d=128": (lambda: fa.flash_bwd_dkdv(q128, q128, q128, q128, lse, lse, True),
                           "flash_bwd_dkdv"),
        "dq d=128": (lambda: fa.flash_bwd_dq(q128, q128, q128, q128, lse, lse, True),
                     "flash_bwd_dq"),
        "forward d=96": (lambda: fa.flash_fwd(q96, q96, q96, True), "flash_fwd"),
        "key bias forward": (lambda: fa.flash_fwd_biased(q, q, q, key_padding_bias=kb),
                             "flash_fwd_sm90"),
        "key bias sm90 forward": (lambda: fa.flash_fwd_sm90(q, q, q, key_padding_bias=kb),
                                  "flash_fwd_sm90"),
        "key bias dK/dV": (lambda: fa.flash_bwd_dkdv_biased(q, q, q, q, lse, lse,
                                                            key_padding_bias=kb),
                           "flash_bwd_dkdv_sm90"),
        "key bias sm90 dQ": (lambda: fa.flash_bwd_dq_sm90(q, q, q, q, lse, lse,
                                                          key_padding_bias=kb),
                             "flash_bwd_dq_sm90"),
        "LUT": (lambda: fa.sparse_flash_attention(q, q, q, layout), "flash_fwd_lut_sm90"),
        "banded": (lambda: fa.flash_fwd_banded(q, q, q, band), "flash_fwd_banded_sm90"),
        "merged": (lambda: fa.flash_fwd_merged(q, q, q, merged), "flash_fwd_merged_sm90"),
        "template": (lambda: fa.flash_fwd_template(q, q, q, True), "flash_fwd"),
    }


@pytest.mark.parametrize("route", list(_routes()))
def test_every_other_fp16_route_raises(route, monkeypatch):
    """Off the CPU (meta tensors stand for CUDA ones) each fp16 route that
    raised while only the dense sm90 entries had fp16 instances now launches
    its kernel's fp16 instance (dtype code 2), once, and falls back to no
    plain version: the LUT, key-bias, banded and merged sm90 kernels and
    the templates."""
    calls = []
    monkeypatch.setattr(fa, "_run", lambda name, dtype, *a, device: calls.append((name, dtype)))
    call, name = _routes()[route]
    out = call()
    assert calls == [(name, 2)]
    first = out[0] if isinstance(out, tuple) else out
    assert first.dtype == torch.float16 and first.device.type == "meta"


# ------------------------------------------- the plain fp16 versions vs JAX
def _qkv16(seed, B=1, T=96, H=2, d=32, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, d)).astype(np.float16) for _ in range(n)]


@pytest.mark.parametrize("causal", [True, False])
def test_plain_fp16_forward_and_gradients_match_jax_interpret(causal):
    q, k, v, w = _qkv16(11 + causal)
    jo, jlse = jax_flash_lse(*map(jnp.asarray, (q, k, v)), causal=causal, block_q=32,
                             block_k=32)
    o, lse = fa.flash_fwd(*map(torch.from_numpy, (q, k, v)), causal)
    assert o.dtype == torch.float16
    np.testing.assert_allclose(o.float().numpy(), np.asarray(jo, np.float32), rtol=0,
                               atol=FP16_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0, atol=1e-4)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w, jnp.float32))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (fa.flash_attention(*leaves, causal=causal).float()
     * torch.from_numpy(w).float()).sum().backward()
    for name, leaf, jg in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == torch.float16
        np.testing.assert_allclose(leaf.grad.float().numpy(), np.asarray(jg, np.float32),
                                   rtol=0, atol=FP16_ATOL, err_msg=f"d{name}")


def test_fp16_bias_gradient_partial_sum_stays_finite():
    """ROADMAP section C, item 1: the bias gradient of ``x + b`` with x fp16
    (8, 32, 4) and a cotangent of 128 rows of +1000, then 128 of -600.  The
    exact sum is 51200, and its partial sums pass 65504 on the way.  The
    port's torch reduction accumulates fp16 in fp32: 51200 exactly.  JAX's
    vjp of the same expression returns inf (its fp16 reduction overflows at
    the partial sum); the port does not mirror that fault."""
    x = torch.zeros(8, 32, 4, dtype=torch.float16, requires_grad=True)
    b = torch.zeros(4, dtype=torch.float16, requires_grad=True)
    ct = torch.cat([torch.full((128, 4), 1000.0), torch.full((128, 4), -600.0)])
    (x + b).backward(ct.to(torch.float16).reshape(8, 32, 4))
    assert torch.equal(b.grad, torch.full((4,), 51200.0, dtype=torch.float16))
