"""LAMB and SGD of the port (``ops/lamb/fused_lamb.py``, ``ops/sgd.py``)
against the JAX package's, on the CPU.

The updates are held over 3 steps on a tree with a stacked ``(L, ...)``
leaf, leaves whose trust ratio clamps at ``max_coeff`` and at
``min_coeff``, a zero parameter and a zero gradient (trust 1), with and
without weight decay and bias correction; SGD with no momentum, plain
momentum and Nesterov, with and without weight decay.  fp32 values summed
in another order (the per-leaf norms): within 1e-6 relative.  Then a
6-step gpt2-tiny engine curve of each against the JAX engine on a 1-device
mesh (1e-4, ``test_engine_loss_curve_matches_jax``'s tolerance), and a
checkpoint of each saved by one package and loaded by the other, both ways:
every leaf bit-identical, the next losses within 1e-4.  One JAX engine a
optimizer serves all three (``jax_run``): its compile is the cost here.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.checkpoint import serialization as jser
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.ops.lamb import fused_lamb as jlamb
from deepspeed_tpu.ops import sgd as jsgd
from deepspeed_tpu.parallel.mesh import make_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.checkpoint import serialization as ser
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.ops.lamb import fused_lamb as tlamb
from deepspeed_tpu_torch.ops import sgd as tsgd
from deepspeed_tpu_torch.runtime.utils import tree_leaves

UPDATE_RTOL = 1e-6
LOSS_RTOL = 1e-4
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOKENS = np.random.default_rng(0).integers(0, 1024, (48, 33)).astype(np.int32)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models here run fastest on one thread: more threads spin on
    ops of a few thousand elements and, beside the other test workers,
    multiply the suite's CPU time.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _tree(seed):
    """Params and three steps' grads: a stacked leaf, leaves whose trust
    clamps high (large weights) and low (tiny weights), a zero parameter
    and a leaf whose gradients are zero."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)   # noqa: E731
    params = {"blocks": {"w": n(3, 4, 5)}, "big": 100.0 * n(6), "small": 1e-4 * n(4, 2),
              "zero_p": np.zeros(5, np.float32), "zero_g": n(7)}
    grads = [{"blocks": {"w": n(3, 4, 5)}, "big": n(6), "small": n(4, 2), "zero_p": n(5),
              "zero_g": np.zeros(7, np.float32)} for _ in range(3)]
    return params, grads


def _run(init, update, params, grads, as_array):
    p = {k: v for k, v in _map(as_array, params).items()}
    state = init(p)
    for i, g in enumerate(grads):
        p, state = update(_map(as_array, g), state, p, step=i + 1)
    return p, state


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _close(port, ref):
    for a, b in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=UPDATE_RTOL, atol=1e-30)


@pytest.mark.parametrize("wd,bias_correction", [(0.0, True), (0.01, True), (0.1, False)])
def test_lamb_update_matches_jax_over_three_steps(wd, bias_correction):
    params, grads = _tree(1)
    kw = dict(lr=1e-2, weight_decay=wd, bias_correction=bias_correction)
    j = jlamb.FusedLamb(**kw)
    t = tlamb.FusedLamb(max_grad_norm=1.0, **kw)              # accepted and unused
    jp, js = _run(j.init, j.update, params, grads, jnp.asarray)
    tp, ts = _run(t.init, t.update, params, grads, torch.from_numpy)
    _close(tp, jp)
    _close(ts, js)
    assert isinstance(ts, tlamb.LambState) and ts._fields == js._fields


def test_lamb_trust_ratio_clamps_and_zero_norms():
    """One step, no decay: the large leaf moves by max_coeff x lr x the
    Adam direction, the tiny one by min_coeff x ..., the zero parameter and
    the zero-gradient leaf by 1 x ... (trust 1 where a norm is 0)."""
    params, grads = _tree(2)
    p = _map(torch.from_numpy, params)
    g = _map(torch.from_numpy, grads[0])
    opt = tlamb.FusedLamb(lr=1.0, max_coeff=10.0, min_coeff=0.01)
    new, state = opt.update(g, opt.init(p), p, step=1)
    one = torch.ones(())
    bc1, bc2 = 1.0 - 0.9 ** one, 1.0 - 0.999 ** one          # in fp32, as the update
    for name, trust in (("big", 10.0), ("small", 0.01), ("zero_p", 1.0), ("zero_g", 1.0)):
        direction = (state.exp_avg[name] / bc1) / (torch.sqrt(state.exp_avg_sq[name] / bc2)
                                                   + 1e-8)
        # p - new cancels: a few fp32 ulps of |p| (~100 on the large leaf)
        torch.testing.assert_close(p[name] - new[name], trust * direction, rtol=1e-5,
                                   atol=0.0)
    assert torch.equal(new["zero_g"], p["zero_g"])      # a zero update leaves it


def test_lamb_amsgrad_raises():
    with pytest.raises(RuntimeError, match="AMSGrad"):
        tlamb.FusedLamb(amsgrad=True)


@pytest.mark.parametrize("momentum,wd,nesterov", [(0.0, 0.0, False), (0.9, 0.0, False),
                                                  (0.9, 1e-3, True), (0.5, 1e-2, False)])
def test_sgd_update_matches_jax_over_three_steps(momentum, wd, nesterov):
    params, grads = _tree(3)
    kw = dict(lr=1e-2, momentum=momentum, weight_decay=wd, nesterov=nesterov)
    j, t = jsgd.SGD(**kw), tsgd.SGD(**kw)
    jp, js = _run(j.init, j.update, params, grads, jnp.asarray)
    tp, ts = _run(t.init, t.update, params, grads, torch.from_numpy)
    _close(tp, jp)
    _close(ts, js)
    assert ts._fields == js._fields == ("momentum_buf",)


def test_sgd_takes_a_device_lr():
    params, grads = _tree(4)
    p, g = _map(torch.from_numpy, params), _map(torch.from_numpy, grads[0])
    opt = tsgd.SGD(lr=5.0, momentum=0.9)
    a, _ = opt.update(g, opt.init(p), p, step=1, lr=1e-2)
    b, _ = opt.update(g, opt.init(p), p, step=torch.tensor(1),
                      lr=torch.tensor(1e-2, dtype=torch.float32))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ------------------------------------------------------------- the engines
OPTIMIZERS = {"lamb": {"type": "Lamb", "params": {"lr": 2e-3, "max_coeff": 5.0}},
              "sgd": {"type": "SGD", "params": {"lr": 5e-2, "momentum": 0.9}}}


def _cfg(name):
    return {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 10 ** 9,
            "optimizer": OPTIMIZERS[name],
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                         "warmup_max_lr": 1e-3}}}


def _np_params(seed=0):
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=seed)


def _port_engine(name, seed=0):
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=32,
              **NO_DROPOUT)
    te, opt, _, _ = tds.initialize(config=_cfg(name), model=tm, params=_np_params(seed),
                                   training_data=(TOKENS,))
    assert isinstance(opt, tlamb.FusedLamb if name == "lamb" else tsgd.SGD)
    return te


def _raw_port(te):
    tree = {"params": te.params, "opt_state": te.opt_state}
    return {k: ser._host_record(v) for k, v in ser._flatten_with_paths(tree).items()}


def _raw_jax(je):
    flat, _ = jser._flatten_with_paths({"params": je.state.params,
                                        "opt_state": je.state.opt_state})
    out = {}
    for k, v in flat.items():
        a = np.asarray(v)
        out[k] = (a.dtype.name, list(a.shape), np.ascontiguousarray(a).tobytes())
    return out


@pytest.fixture(scope="module", params=list(OPTIMIZERS))
def jax_run(request, tmp_path_factory):
    """One JAX engine per optimizer (1-device mesh, compile cache off):
    3 steps, a checkpoint, 3 more steps; its curve, the saved state and
    the directory.  ``test_port_checkpoint_loads_into_jax`` then loads a
    port checkpoint into the same engine (one compile per optimizer)."""
    name = request.param
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=32, **NO_DROPOUT)
    je = jds.initialize(config=dict(_cfg(name), compile_cache={"enabled": False}),
                        model=jm, params=_np_params(0), training_data=(TOKENS,),
                        mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]
    d = str(tmp_path_factory.mktemp(f"jax_{name}"))
    curve = []
    for step in range(6):
        curve.append((float(je.train_batch()), je.get_global_grad_norm(), je.get_lr()))
        if step == 2:
            je.save_checkpoint(d)
            state = _raw_jax(je)
    return name, je, d, state, curve


FIELDS = {"lamb": ("exp_avg", "exp_avg_sq"), "sgd": ("momentum_buf",)}


def test_engine_loss_curve_matches_jax(jax_run):
    """Six steps of gpt2-tiny (clip, WarmupLR, gas 2): losses, grad norms
    and lrs of the port's engine against the JAX engine's."""
    name, _, _, _, curve = jax_run
    te = _port_engine(name)
    for jl, jg, jlr in curve:
        np.testing.assert_allclose(float(te.train_batch()), jl, rtol=LOSS_RTOL)
        np.testing.assert_allclose(te.get_global_grad_norm(), jg, rtol=LOSS_RTOL)
        assert te.get_lr() == pytest.approx(jlr, rel=2.5e-7)
    assert (te.global_steps, te.skipped_steps, te.optimizer_steps) == (6, 0, 6)


def test_jax_checkpoint_loads_into_the_port(jax_run):
    """A port engine from other weights loads the JAX engine's step-3
    checkpoint: every leaf (params, the optimizer's NamedTuple fields by
    name) bit-identical, the counters equal, the next 3 losses within 1e-4
    of JAX's own."""
    name, _, d, state, curve = jax_run
    te = _port_engine(name, seed=1)
    te.load_checkpoint(d)
    got = _raw_port(te)
    assert {k.split("/")[1] for k in got if k.startswith("opt_state/")} == set(FIELDS[name])
    assert got.keys() == state.keys()
    for k in state:
        assert got[k] == state[k], k
    assert (te.global_steps, te.optimizer_steps) == (3, 3)
    np.testing.assert_allclose([float(te.train_batch()) for _ in range(3)],
                               [x for x, _, _ in curve[3:]], rtol=LOSS_RTOL)


def test_port_checkpoint_loads_into_jax(jax_run, tmp_path):
    """The port engine trains 3 steps and saves; the JAX engine loads it:
    every leaf bit-identical, the counters equal, its next 3 losses within
    1e-4 of the port's own."""
    name, je, _, _, _ = jax_run
    te = _port_engine(name, seed=1)
    for _ in range(3):
        te.train_batch()
    te.save_checkpoint(str(tmp_path))
    want = _raw_port(te)
    losses = [float(te.train_batch()) for _ in range(3)]
    je.load_checkpoint(str(tmp_path))
    got = _raw_jax(je)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert je.global_steps == 3 and int(je.state.optimizer_steps) == 3
    np.testing.assert_allclose([float(je.train_batch()) for _ in range(3)], losses,
                               rtol=LOSS_RTOL)
