"""The sparse-gradient offload wire, ``SparseTensor``, ``cpu_offload_params``
and ``cpu_checkpointing`` in the port, on the CPU.

Twins of ``tests/test_sparse_gradients.py:75-188`` at world size 1
against a JAX engine on a 1-device mesh (``compile_cache`` off): an
embedding-bag model (a lookup-only table, mean-pooled, a linear head)
declares its table in ``sparse_grad_paths()``; the captured grad step
emits the table's gradient as (indices, values) bounded by the batch's
id count, the head's dense, equal to JAX's wire; five offload steps with
the wire on train bit-equal to the dense wire in the port, and to JAX's
sparse engine within 1e-5; without a declaration both packages warn and
stay dense; an under-declared ``sparse_grad_row_bound`` raises at a
reporting step and, with no reporting step, at ``save_checkpoint`` (with
and without DPU).  ``SparseTensor`` against JAX's, ``sparse_allreduce``
at one rank and refusing more (item 9), ``cpu_offload_params`` accepted
with no effect as in JAX, and ``cpu_checkpointing`` on a GPT-2 block
whose attention output (after the projection) is marked ``ckpt``: the
gradients equal the plain checkpoint's bit for bit, the mark is kept on
the host, and the backward runs the plain checkpoint's ops less exactly
the three that only feed the mark (the projection's ``mm``, its
``_unsafe_view`` and the bias ``add``), counted under a dispatch mode (the
checkpoint machinery's own ``detach`` ops aside).  That count is the one
``chip_smoke.py`` phase 26 holds on the card."""

import collections

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime.sparse_tensor import SparseTensor as JSparseTensor

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch.models.gpt2 import GPT2, _layer_norm
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.sparse_tensor import SparseTensor, sparse_allreduce
from deepspeed_tpu_torch.runtime.utils import tree_leaves

V, D = 512, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JEmbedBag:
    """``tests/test_sparse_gradients.py``'s model."""

    def __init__(self, declare_sparse=True):
        self.declare_sparse = declare_sparse

    def loss(self, params, batch, rng=None):
        tokens, target = batch
        h = params["emb"]["table"][tokens].mean(axis=1)
        return jnp.mean(((h @ params["head"]["w"])[:, 0] - target.astype(jnp.float32)) ** 2)

    def sparse_grad_paths(self):
        return [("emb", "table")] if self.declare_sparse else []


class EmbedBag:
    """The port's twin (the same loss, the same declaration)."""

    def __init__(self, declare_sparse=True, device="cpu"):
        self.declare_sparse = declare_sparse
        self.device = torch.device(device)

    def loss(self, params, batch, rng=None):
        tokens, target = batch
        h = params["emb"]["table"][tokens.long()].mean(dim=1)
        return (((h @ params["head"]["w"])[:, 0] - target.float()) ** 2).mean()

    def sparse_grad_paths(self):
        return [("emb", "table")] if self.declare_sparse else []


def _params():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return {"emb": {"table": np.asarray(jax.random.normal(k1, (V, D)) * 0.1, np.float32)},
            "head": {"w": np.asarray(jax.random.normal(k2, (D, 1)) * 0.1, np.float32)}}


def _data(n=64, T=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, size=(n, T)).astype(np.int32),
            rng.normal(size=(n,)).astype(np.float32))


def _cfg(sparse, offload=True, dpu=False, spp=1000):
    off = {"device": "cpu"}
    if dpu:
        off.update(delayed_param_update=True, delayed_param_update_warmup=0)
    cfg = {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 1,
           "steps_per_print": spp, "sparse_gradients": sparse,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if offload:
        cfg["zero_optimization"] = {"stage": 1, "offload_optimizer": off}
    return cfg


def _port(cfg, model=None, data=None, **kw):
    return tds.initialize(config=cfg, model=model or EmbedBag(), params=_params(),
                          training_data=data or _data(), **kw)[0]


def _jax(cfg, model=None, data=None):
    return jds.initialize(config=dict(cfg, compile_cache={"enabled": False}),
                          model=model or JEmbedBag(), params=_params(),
                          training_data=data or _data(),
                          mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]


def test_sparse_wire_format():
    """The grad step's wire: (indices, values) for the declared table,
    bounded by the id count (32 x 8), one nonzero row (id 3); the head
    dense; indices and values equal to JAX's."""
    e = _port(_cfg(True))
    assert e._sparse_grad_paths == (("emb", "table"),)
    tokens, target = np.zeros((32, 8), np.int32) + 3, np.zeros((32,), np.float32)
    batch = (torch.from_numpy(tokens)[None], torch.from_numpy(target)[None])
    out = e._grad_only_step(batch, 0, torch.tensor(False))
    idx, vals = out["sparse/0/indices"], out["sparse/0/values"]
    assert idx.shape == (256,) and vals.shape == (256, D)
    nz = vals.abs().sum(dim=1) > 0
    assert int(nz.sum()) == 1 and int(idx[nz][0]) == 3
    assert out["grads"].numel() == D and int(out["sparse_rows_dropped"]) == 0
    je = _jax(_cfg(True))
    jg, *_ = je._jit_grad_step(je.state, (jnp.asarray(tokens)[None], jnp.asarray(target)[None]),
                               jax.random.PRNGKey(0))
    leaf = jg["emb"]["table"]
    assert np.array_equal(np.asarray(leaf["sparse_indices"]), idx.numpy())
    np.testing.assert_allclose(vals.numpy(), np.asarray(leaf["sparse_values"]), rtol=1e-6,
                               atol=1e-9)
    assert not isinstance(jg["head"]["w"], dict)


def test_sparse_matches_dense_training():
    """Five offload steps, the wire on and off: the host master, the
    moments and the params bit-equal (a lossless re-encoding); the losses
    within 1e-5 of JAX's sparse engine."""
    es, ed = _port(_cfg(True)), _port(_cfg(False))
    ls = [float(es.train_batch()) for _ in range(5)]
    ld = [float(ed.train_batch()) for _ in range(5)]
    assert ls == ld
    assert np.array_equal(es._offload.master, ed._offload.master)
    assert all(np.array_equal(a, b) for a, b in zip(es._offload.moments(), ed._offload.moments()))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(es.params), tree_leaves(ed.params)))
    je = _jax(_cfg(True))
    np.testing.assert_allclose(ls, [float(je.train_batch()) for _ in range(5)], rtol=1e-5)


def test_sparse_gradients_without_declaration_warns_and_stays_dense(monkeypatch):
    from deepspeed_tpu_torch.runtime import engine as engine_mod
    said = []
    monkeypatch.setattr(engine_mod, "log_dist", lambda msg, ranks=None: said.append(msg))
    cfg = _cfg(True, offload=False)
    e = _port(cfg, model=EmbedBag(declare_sparse=False))
    assert e._sparse_grad_paths == ()
    assert any("declares no sparse_grad_paths" in m for m in said)
    assert np.isfinite(float(e.train_batch()))
    je = _jax(cfg, model=JEmbedBag(declare_sparse=False))
    assert je._sparse_grad_paths == ()


def _lying(pkg, cfg):
    """32 distinct ids a micro-batch, a declared bound of 2."""
    rng = np.random.default_rng(7)
    tokens = np.tile(np.arange(32, dtype=np.int32).reshape(4, 8) % V, (8, 1))
    data = (tokens, rng.normal(size=(32,)).astype(np.float32))
    model = EmbedBag() if pkg == "port" else JEmbedBag()
    model.sparse_grad_row_bound = lambda batch: 2
    return (_port if pkg == "port" else _jax)(cfg, model=model, data=data)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_underdeclared_row_bound_raises(pkg):
    e = _lying(pkg, _cfg(True, spp=1))
    with pytest.raises(RuntimeError, match="under-declared"):
        e.train_batch()


@pytest.mark.parametrize("dpu", [False, True])
def test_underdeclared_row_bound_raises_on_checkpoint(tmp_path, dpu):
    """No reporting step ever fires; the save's flush reads the counts
    (under DPU after applying the pending step) and raises, in both
    packages."""
    for pkg in ("port", "jax"):
        e = _lying(pkg, _cfg(True, dpu=dpu, spp=10 ** 6))
        e.train_batch()
        with pytest.raises(RuntimeError, match="under-declared"):
            e.save_checkpoint(str(tmp_path / pkg))


def test_sparse_tensor_matches_jax():
    rng = np.random.default_rng(1)
    dense = rng.normal(size=(12, 3)).astype(np.float32)
    dense[[0, 4, 5, 9]] = 0.0
    for k in (3, 8, 10, 12):
        t, j = SparseTensor.from_dense(torch.from_numpy(dense), max_rows=k), \
            JSparseTensor.from_dense(jnp.asarray(dense), max_rows=k)
        assert np.array_equal(t.indices.numpy(), np.asarray(j.indices))
        assert np.array_equal(t.values.numpy(), np.asarray(j.values))
        assert np.array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
        assert t.sparse_size() == j.sparse_size() and t.dense_size == j.dense_size
    t2, j2 = t.add(t), j.add(j)
    assert np.array_equal(t2.to_dense().numpy(), np.asarray(j2.to_dense()))
    with pytest.raises(ValueError):
        t.add(SparseTensor.from_dense(torch.zeros(4, 3)))


def test_sparse_allreduce_one_rank_and_across_ranks_raises(monkeypatch):
    st = SparseTensor.from_dense(torch.eye(4), max_rows=2)
    out = sparse_allreduce(st)
    assert torch.equal(out.to_dense(), st.to_dense())
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="item 9"):
        sparse_allreduce(st)


def test_cpu_offload_params_accepted_with_no_effect():
    """JAX parses ``cpu_offload_params`` (``zero/config.py:132``) and reads
    it nowhere; the port accepts it, names it a no-op and trains as
    without it (it does not mean ``offload_param: cpu``)."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    pd = {"train_batch_size": 8, "zero_optimization": {"stage": 2, "cpu_offload_params": True}}
    t, j = DeepSpeedConfig(pd), JConfig(pd, world_size=1)
    assert t.zero_config.cpu_offload_params is j.zero_config.cpu_offload_params is True
    assert "zero_optimization.cpu_offload_params" in t.noop_keys_set
    assert t.zero_config.offload_param is None and j.zero_config.offload_param is None
    on, off = _cfg(False, offload=False), _cfg(False, offload=False)
    on["zero_optimization"] = {"stage": 2, "cpu_offload_params": True}
    a, b = _port(on), _port(off)
    assert a._offload is None and a._param_stream is None
    assert [float(a.train_batch()) for _ in range(2)] == [float(b.train_batch()) for _ in range(2)]


# ---------------------------------------------------------------------------
# cpu_checkpointing on a GPT-2 block (ROADMAP item 3's done criterion)
# ---------------------------------------------------------------------------
CKPT_PRUNED = ["aten.mm.default", "aten._unsafe_view.default", "aten.add.Tensor"]


class _Count(TorchDispatchMode):
    """Counts the ops dispatched, the checkpoint machinery's ``detach``s aside."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten.detach.default:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def marked_block(model, B, T):
    """A GPT-2 block whose attention output, after the projection, is
    marked ``ckpt`` (``fn(x, *leaves)``, leaves in sorted key order)."""
    c = model.config
    D, H, hd = c.n_embd, c.n_head, c.head_dim
    keys = sorted(("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_scale",
                   "ln2_bias", "fc_w", "fc_b", "fc_proj_w", "fc_proj_b"))

    def fn(x, *leaves):
        p = dict(zip(keys, leaves))
        h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
        qkv = h @ p["qkv_w"] + p["qkv_b"]
        q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(D, dim=-1))
        a = model._attend(q, k, v, None, 0, True).reshape(B, T, D)
        x = x + ckpt.checkpoint_name(a @ p["proj_w"] + p["proj_b"], ckpt.CKPT)
        h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"], c.layer_norm_eps)
        h = F.gelu(h @ p["fc_w"] + p["fc_b"], approximate="tanh")
        return x + h @ p["fc_proj_w"] + p["fc_proj_b"]
    return fn, keys


def _block_grads(cpu):
    m = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", attention_impl="flash")
    B, T = 2, 16
    fn, keys = marked_block(m, B, T)
    blocks = m.init_params(0)["blocks"]
    leaves = [blocks[k][0].clone().requires_grad_() for k in keys]
    x = torch.randn(B, T, m.config.n_embd, generator=torch.Generator().manual_seed(5),
                    requires_grad=True)
    ckpt.configure(None, checkpoint_in_cpu=cpu)
    try:
        y = ckpt.checkpoint(fn, x, *leaves)
        loss = (y ** 2).mean()
        with _Count() as count:
            grads = torch.autograd.grad(loss, [x, *leaves])
    finally:
        ckpt.configure(None)
    return grads, count.ops


def test_cpu_checkpointing_prunes_the_marks_producers():
    g_plain, plain = _block_grads(False)
    g_cpu, ops = _block_grads(True)
    assert all(torch.equal(a, b) for a, b in zip(g_plain, g_cpu))
    st = ckpt.last_stats
    assert st["pruned"] == CKPT_PRUNED and st["skipped"] == len(CKPT_PRUNED)
    (mark,) = st["marks"]
    assert mark.device.type == "cpu" and mark.shape == (2, 16, 128)
    assert plain - ops == collections.Counter(CKPT_PRUNED) and not ops - plain
    assert sum(plain.values()) - sum(ops.values()) == len(CKPT_PRUNED)
