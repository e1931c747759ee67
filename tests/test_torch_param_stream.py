"""ZeRO-3 parameter offload in the port (``runtime/zero/param_stream.py``,
``wire.LayerWire``, the host tier over the stream tree and the engine's
streamed path) against the port's own engines and the JAX package's, on
the CPU.

Twins of ``tests/test_param_stream.py`` on JAX's ``_model`` (n_embd 64, 3
layers, bf16, no remat, the plain attention): the streamed run against
the non-streamed offload run of the same config (stage 3, the optimizer
on the host; rtol 3e-4, 5e-4 at gas 2, JAX's own tolerances), with
dropout on the first step's loss bit for bit (the same masks) and the
curve within 3e-4; the NVMe parameter tier equal to the CPU tier bit for
bit; checkpoints crossing streamed and monolithic engines both ways, in
the port and across the packages (the host master bit-equal after a
load); eval and ``module_state_dict``; JAX's validation errors; the
``fast_init`` run; the three prefetch-pool tests on the port's swapper.
Against JAX's streamed engine (1-device mesh, ``compile_cache`` off: a
step executable read back from a test run's compile cache expects 8
shards on that mesh, the fault that fails JAX's own
``test_stream_fast_init_trains`` after a warm hit in its file): 3 steps
within 3e-4, and the health ladder's skip and rewind on the streamed path
with the same counters.  GPT-2's batches are integer tokens, which
``grad_nan`` leaves alone, so the ladder test trains a model whose
``stream_fns`` carry a gate (ones) beside the labels and multiply the
loss by its mean.  The overlapped loop (two layer buffers, the copy
streams, the land-add thread) equals the eager-sequential one
(``overlap = False``) bit for bit."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu import fault as jfault
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2, GPT2Config as JGPT2Config
from deepspeed_tpu.parallel.mesh import make_mesh

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import fault as tfault
from deepspeed_tpu_torch.models.gpt2 import GPT2, GPT2Config
from deepspeed_tpu_torch.runtime.zero.param_stream import (ParamStreamRunner, from_stream_tree,
                                                           to_stream_tree)
from deepspeed_tpu_torch.runtime.utils import tree_leaves

MODEL = dict(n_embd=64, n_layer=3, n_head=4, vocab_size=256, max_seq=32, attn_pdrop=0.0,
             remat=False, attention_impl="jnp")
TOKENS = np.random.default_rng(0).integers(0, 256, (16, 25)).astype(np.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def faults():
    jfault.reset()
    tfault.reset()
    yield
    jfault.reset()
    tfault.reset()


def _split_gated(split, b, cat):
    tokens, labels = split(b[0])
    return tokens, cat(labels, b[1])


def _gated(base):
    """A model class whose streamed batches are ``(tokens, gate)``: the
    labels travel with the gate as their last column, the loss is the
    model's times the gate's mean (a ``grad_nan`` window makes it NaN)."""
    is_port = base is GPT2

    class Gated(base):
        def stream_fns(self):
            sf = dict(super().stream_fns())
            split, head = sf["split_batch"], sf["head_loss"]
            if is_port:
                cat = lambda lab, g: torch.cat([lab.float(), g.float()[:, None]], 1)  # noqa: E731
            else:
                cat = lambda lab, g: np.concatenate(  # noqa: E731
                    [np.asarray(lab, np.float32), np.asarray(g, np.float32)[:, None]], 1)

            def head_loss(nb, x, lg):
                T = lg.shape[1] - 1
                if is_port:
                    return head(nb, x, lg[:, :T].long()) * lg[:, T].mean()
                return head(nb, x, lg[:, :T].astype(jnp.int32)) * jnp.mean(lg[:, T])
            sf.update(split_batch=lambda b: _split_gated(split, b, cat), head_loss=head_loss)
            return sf
    return Gated


def _model(dropout=0.0, cls=GPT2):
    return cls(GPT2Config(embd_pdrop=dropout, resid_pdrop=dropout, **MODEL),
               dtype=torch.bfloat16, device="cpu")


def _jmodel(dropout=0.0, cls=JGPT2):
    return cls(JGPT2Config(embd_pdrop=dropout, resid_pdrop=dropout, **MODEL),
               dtype=jnp.bfloat16)


def _np_params():
    return JGPT2(JGPT2Config(**MODEL)).init_numpy(seed=0)


def _config(micro=4, gas=1, offload_param=None, clip=1.0, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "steps_per_print": 10 ** 9, "gradient_clipping": clip, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": 3, "offload_optimizer": {"device": "cpu"}}}
    if offload_param is not None:
        cfg["zero_optimization"]["offload_param"] = offload_param
    cfg.update(over)
    return cfg


CPU = {"device": "cpu"}


def _port(cfg, dropout=0.0, model=None, data=(TOKENS,), **kw):
    return tds.initialize(config=cfg, model=model or _model(dropout), params=_np_params(),
                          training_data=data, **kw)[0]


def _jax(cfg, model=None, data=(TOKENS,)):
    return jds.initialize(config=dict(cfg, compile_cache={"enabled": False}),
                          model=model or _jmodel(), params=_np_params(), training_data=data,
                          mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]


def _curve(e, steps=3):
    return [float(e.train_batch()) for _ in range(steps)]


def _host(e):
    """The host tier's master and moments (copies)."""
    m, v = e._offload.moments()
    return [np.array(e._offload.master), np.array(m), np.array(v)]


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """JAX's streamed engine: 3 steps, then a checkpoint; the engine stays
    (the port's streamed checkpoint loads into it)."""
    je = _jax(_config(offload_param=CPU))
    assert je._param_stream is not None
    curve = _curve(je)
    d = str(tmp_path_factory.mktemp("jax_stream"))
    je.save_checkpoint(d, tag="t")
    return {"curve": curve, "dir": d, "engine": je}


def test_stream_loss_matches_nonstream():
    ref = _curve(_port(_config()))
    e = _port(_config(offload_param=CPU))
    got = _curve(e)
    assert e._param_stream is not None and e.params is None and e.master is None
    assert got[0] == ref[0]                     # the same forward on the same params
    np.testing.assert_allclose(got, ref, rtol=3e-4)
    assert e.optimizer_steps == 3 and e.step_impl == "eager"


def test_stream_gas_accumulation_matches():
    ref = _curve(_port(_config(micro=2, gas=2)))
    e = _port(_config(micro=2, gas=2, offload_param=CPU))
    np.testing.assert_allclose(_curve(e), ref, rtol=5e-4)
    assert e.offload_times["h2d_copies"] == 2 * 3 * 2 and e.offload_times["d2h_copies"] == 7


def test_stream_with_dropout_rng_parity():
    """Dropout on: the streamed step draws the monolithic step's masks
    (step 1 bit for bit), and the curve stays within 3e-4."""
    ref = _curve(_port(_config(), dropout=0.1))
    got = _curve(_port(_config(offload_param=CPU), dropout=0.1))
    assert got[0] == ref[0]
    np.testing.assert_allclose(got, ref, rtol=3e-4)
    assert _curve(_port(_config(offload_param=CPU), dropout=0.0))[0] != got[0]


def test_stream_nvme_param_tier_matches_cpu(tmp_path):
    cpu = _port(_config(offload_param=CPU))
    nvme = _port(_config(offload_param={"device": "nvme", "nvme_path": str(tmp_path)}))
    ps = nvme._param_stream
    assert ps.nvme and nvme._offload.payload is None      # no 16-bit RAM image
    assert _curve(nvme) == _curve(cpu)
    assert all(np.array_equal(a, b) for a, b in zip(_host(nvme), _host(cpu)))
    # the layer files hold the bf16 cast of the master
    ps.swapper.swap_in([1])
    lo, hi = ps.layer_bounds[1]
    want = torch.from_numpy(nvme._offload.master[lo:hi]).to(torch.bfloat16)
    assert torch.equal(ps.swapper.get_buffer(1), want)
    ps.swapper.release([1])
    sd_n, sd_c = nvme.module_state_dict(), cpu.module_state_dict()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sd_n), tree_leaves(sd_c)))


def test_stream_overlapped_equals_sequential():
    """The overlapped loop (two layer buffers, copy streams, the land-add
    worker) against the eager-sequential one: bit for bit in the loss, the
    host gradients and the master."""
    a, b = _port(_config(micro=2, gas=2, offload_param=CPU)), _port(
        _config(micro=2, gas=2, offload_param=CPU))
    b._param_stream.wire.overlap = False
    la, lb = _curve(a, 2), _curve(b, 2)
    assert la == lb and not b.offload_times["overlap"]
    assert torch.equal(a._offload.grad32, b._offload.grad32)
    assert all(np.array_equal(x, y) for x, y in zip(_host(a), _host(b)))


def test_stream_checkpoint_cross_compatible(tmp_path):
    """Streamed save -> monolithic and streamed loads continue alike, and
    the reverse: the layer-major layout never reaches a checkpoint."""
    s = _port(_config(offload_param=CPU))
    _curve(s, 2)
    s.save_checkpoint(str(tmp_path), tag="t")
    a = _port(_config())
    a.load_checkpoint(str(tmp_path), tag="t")
    b = _port(_config(offload_param=CPU))
    b.load_checkpoint(str(tmp_path), tag="t")
    assert np.array_equal(b._offload.master, s._offload.master)
    assert all(np.array_equal(x, y) for x, y in zip(_host(b), _host(s)))
    np.testing.assert_allclose(_curve(a, 2), _curve(b, 2), rtol=3e-4)
    a.save_checkpoint(str(tmp_path / "mono"), tag="m")
    c = _port(_config(offload_param=CPU))
    c.load_checkpoint(str(tmp_path / "mono"), tag="m")
    want, got = a._offload.master_tree(), from_stream_tree(c._offload.master_tree(), "blocks")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(want), tree_leaves(got)))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.module_state_dict()),
                                                 tree_leaves(c.module_state_dict())))


def test_stream_save_16bit_and_zero_to_fp32(tmp_path):
    """``save_16bit_model`` and ``zero_to_fp32`` work on a streamed engine
    unchanged: the 16-bit file holds the stacked bf16 params, the
    consolidated fp32 weights are the host master in the stacked layout."""
    from deepspeed_tpu_torch.checkpoint.serialization import load_tree
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint
    e = _port(_config(offload_param=CPU))
    _curve(e, 1)
    e.save_16bit_model(str(tmp_path / "m16"))
    got = load_tree(str(tmp_path / "m16" / "model_16bit.msgpack"))["params"]
    assert got["blocks"]["qkv_w"].shape[0] == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(e.module_state_dict())))
    e.save_checkpoint(str(tmp_path / "ck"))
    sd = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "ck"))
    master = tree_leaves(from_stream_tree(e._offload.master_tree(), "blocks"))
    assert len(sd) == len(master)
    for name, m in zip(sorted(sd), master):
        np.testing.assert_array_equal(sd[name], m.numpy())


def test_stream_checkpoints_cross_packages(jax_stream, tmp_path):
    """JAX's streamed checkpoint loads into the port's streamed and
    monolithic engines with the host master bit-equal; the port's streamed
    checkpoint loads into JAX's streamed and non-streamed engines alike."""
    je = jax_stream["engine"]
    jmaster = np.array(je._offload.master)
    s = _port(_config(offload_param=CPU))
    s.load_checkpoint(jax_stream["dir"], tag="t")
    assert np.array_equal(s._offload.master, jmaster)
    m = _port(_config())
    m.load_checkpoint(jax_stream["dir"], tag="t")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(m.module_state_dict()),
                                                 tree_leaves(s.module_state_dict())))
    _curve(s, 1)
    s.save_checkpoint(str(tmp_path), tag="p")
    je.load_checkpoint(str(tmp_path), tag="p")
    assert np.array_equal(np.asarray(je._offload.master), s._offload.master)
    jm = _jax(_config())
    jm.load_checkpoint(str(tmp_path), tag="p")
    want = from_stream_tree(s._offload.master_tree(), "blocks")
    got = jm._offload.master_tree()
    for k in ("wte", "wpe", "lnf_scale"):
        assert np.array_equal(np.asarray(got[k]), want[k].numpy()), k
    for k in want["blocks"]:
        assert np.array_equal(np.asarray(got["blocks"][k]), want["blocks"][k].numpy()), k


def test_stream_eval_and_state_dict():
    e = _port(_config(offload_param=CPU))
    _curve(e, 1)
    loss = float(e.eval_batch(np.random.default_rng(3).integers(0, 256, (4, 25))))
    assert np.isfinite(loss)
    sd = e.module_state_dict()
    assert "blocks" in sd and sd["blocks"]["qkv_w"].shape[0] == 3
    assert sd["blocks"]["qkv_w"].dtype == torch.bfloat16
    mono = _port(_config())                 # the tree a monolithic engine holds
    assert {k: tuple(v.shape) for k, v in mono.params["blocks"].items()} == \
        {k: tuple(v.shape) for k, v in sd["blocks"].items()}


class _NoStream:
    device = torch.device("cpu")

    def init(self, seed):
        return {"w": np.zeros((4,), np.float32)}

    def loss(self, params, batch, rng):
        return params["w"].sum()


def _bad(case):
    cfg = _config(offload_param=CPU)
    model = None
    kw = {}
    if case == "no_offload_optimizer":
        del cfg["zero_optimization"]["offload_optimizer"]
    elif case == "stage":
        cfg["zero_optimization"]["stage"] = 2
    elif case == "fp16":
        cfg["bf16"] = {"enabled": False}
        cfg["fp16"] = {"enabled": True}
    elif case == "stream_fns":
        model = _NoStream()
    elif case == "graph":
        kw["step_impl"] = "graph"
    return cfg, model, kw


@pytest.mark.parametrize("case,match", [
    ("no_offload_optimizer", "offload_optimizer"), ("stage", "stage 3"), ("fp16", "fp16"),
    ("stream_fns", "stream_fns"), ("graph", "step_impl='graph'")])
def test_stream_config_validation(case, match):
    """JAX's ``ValueError``s (and the port's refusal to capture the
    streamed step)."""
    cfg, model, kw = _bad(case)
    with pytest.raises(ValueError, match=match):
        if model is not None:
            tds.initialize(config=cfg, model=model, **kw)
        else:
            _port(cfg, **kw)
    if case in ("no_offload_optimizer", "stage", "fp16"):
        with pytest.raises(ValueError, match=match):
            jds.initialize(config=cfg, model=_jmodel(), params=_np_params(),
                           mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))


def test_stream_fast_init_trains():
    """``offload_param.fast_init`` takes the model's numpy init; without
    ``init_numpy`` it raises, as JAX's does."""
    cfg = _config(offload_param={"device": "cpu", "fast_init": True})
    m = _model()
    e = tds.initialize(config=cfg, model=m, training_data=(TOKENS,))[0]
    losses = _curve(e, 4)
    assert e._param_stream is not None and losses[-1] < losses[0]
    assert all(np.isfinite(losses))

    class NoNumpyInit(GPT2):
        init_numpy = None
    with pytest.raises(ValueError, match="init_numpy"):
        tds.initialize(config=cfg, model=NoNumpyInit(GPT2Config(**MODEL), device="cpu"))


def test_stream_matches_jax_stream(jax_stream):
    """The port's streamed engine against JAX's over 3 steps (3e-4)."""
    np.testing.assert_allclose(_curve(_port(_config(offload_param=CPU))), jax_stream["curve"],
                               rtol=3e-4)


def test_stream_trees_round_trip():
    p = _np_params()
    t = to_stream_tree(p, "blocks")
    assert len(t["layers"]) == 3 and set(t["nonblock"]) == {"wte", "wpe", "lnf_scale",
                                                              "lnf_bias"}
    back = from_stream_tree(t, "blocks")
    assert all(np.array_equal(back["blocks"][k], p["blocks"][k]) for k in p["blocks"])


def _ladder(make, d):
    """JAX's acceptance scenario on the streamed path: 3 steps, save
    "good", a grad_nan window over stream steps 3-7, 9 steps, 3 clean."""
    e = make(_config(micro=2, offload_param=CPU, checkpoint={"dir": d},
                     health_check={"consecutive_skip_budget": 2, "rewind_limit": 3}))
    losses = _curve(e)
    e.save_checkpoint(d, tag="good")
    good = np.array(e._offload.master)
    jfault.configure("grad_nan=3:8")
    tfault.configure("grad_nan=3:8")
    losses.append(float(e.train_batch()))
    skipped_same = np.array_equal(np.asarray(e._offload.master), good) and \
        int(e.skipped_steps if not hasattr(e, "state") else e.state.skipped_steps) == 1
    losses += _curve(e, 8)
    mon = e.health_monitor
    state = (mon.rewinds, e.loaded_checkpoint_tag, e._stream_step, int(e.global_steps),
             mon.counters())
    return {"losses": losses, "after": _curve(e), "state": state, "skipped": skipped_same}


def test_stream_grad_nan_skip_and_rewind_match_jax(tmp_path, faults):
    data = (TOKENS, np.ones((16,), np.float32))
    want = _ladder(lambda c: _jax(c, model=_jmodel(cls=_gated(JGPT2)), data=data),
                   str(tmp_path / "jax"))
    jfault.reset()
    tfault.reset()
    got = _ladder(lambda c: _port(c, model=_model(cls=_gated(GPT2)), data=data),
                  str(tmp_path / "port"))
    assert got["state"] == want["state"] and got["skipped"] and want["skipped"]
    assert got["state"][0] >= 1 and got["state"][1] == "good"
    np.testing.assert_allclose(got["after"], want["after"], rtol=3e-4)
    assert [np.isfinite(x) for x in got["losses"]] == [np.isfinite(x) for x in want["losses"]]


# ---------------------------------------------------------------------------
# prefetch vs pool exhaustion (``prefetch_layer_nvme``, test_param_stream.py:194-272)
# ---------------------------------------------------------------------------
def _swapper(tmp_path, buffer_count=2, numel=1024):
    from deepspeed_tpu_torch.runtime.swap_tensor.partitioned_param_swapper import (
        AsyncPartitionedParameterSwapper)
    return AsyncPartitionedParameterSwapper({}, str(tmp_path), dtype=torch.float32,
                                            buffer_count=buffer_count, buffer_numel=numel)


class _PrefetchHarness:
    """Just enough of ParamStreamRunner for prefetch_layer_nvme."""
    prefetch_layer_nvme = ParamStreamRunner.prefetch_layer_nvme

    def __init__(self, swapper, L):
        self.nvme, self.swapper, self.L = True, swapper, L


def test_prefetch_pool_exhausted_race_falls_back(tmp_path):
    sw = _swapper(tmp_path)
    for i in range(4):
        sw.swap_out(i, torch.full((64,), float(i)))
    h = _PrefetchHarness(sw, L=4)
    real = sw.available_swap_in_buffers

    def racy():
        n = real()
        if n >= 1:          # another path drains the pool between the check and the acquire
            for _ in range(n):
                sw._pool.get()
        return n
    sw.available_swap_in_buffers = racy
    h.prefetch_layer_nvme(1)                       # must not raise
    assert 1 not in sw._id_to_buffer
    sw.available_swap_in_buffers = real
    for b in sw._pool.buffers:
        sw._pool.release(b)
    sw.swap_in([1])
    assert torch.equal(sw.get_buffer(1), torch.full((64,), 1.0))


def test_prefetch_concurrent_exhaustion_threads(tmp_path):
    import threading
    sw = _swapper(tmp_path)
    L = 8
    for i in range(L):
        sw.swap_out(i, torch.full((64,), float(i)))
    h = _PrefetchHarness(sw, L=L)
    errors = []

    def worker(base):
        try:
            for i in range(L):
                h.prefetch_layer_nvme((base + i) % L)
        except Exception as e:  # noqa: BLE001 (the assertion's payload)
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    sw.synchronize_reads()
    for pid in list(sw._id_to_buffer):
        assert torch.equal(sw.get_buffer(pid), torch.full((64,), float(pid)))


def test_prefetch_genuine_errors_still_raise(tmp_path):
    sw = _swapper(tmp_path)
    sw.swap_out(0, torch.zeros(64))
    h = _PrefetchHarness(sw, L=1)

    def broken(ids, async_op=False):
        raise RuntimeError("aio submit failed: EIO")
    sw.swap_in = broken
    with pytest.raises(RuntimeError, match="EIO"):
        h.prefetch_layer_nvme(0)
