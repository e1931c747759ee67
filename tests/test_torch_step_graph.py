"""The port's captured serving and generate steps against the JAX package
on the CPU (deepspeed_tpu_torch/runtime/step_graph.py, the bucketed
prefill and the W=1 decode step of inference/serving.py, generate's token
step of inference/engine.py, GPT2.decode_impl; vs JAX's
``ServingEngine._prefill_fn`` / ``_build_decode``, ``InferenceEngine.
generate(max_len=)`` and ``GPT2.decode_impl``).

On the CPU there is no graph: the step bodies run directly, so the
streams and the pool blocks here are the bodies' own.  The graph
bookkeeping (launch counts under capture and replay) is held with a fake
graph object.  Greedy token streams must be identical to JAX's in fp32;
pool blocks agree within the GPT-2 parity tolerance (int8 pools within one
quantization step)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import (InferenceEngine as JInferenceEngine,
                                     Request as JRequest,
                                     ServingConfig as JServingConfig,
                                     ServingEngine as JServingEngine)
from deepspeed_tpu.inference import paged_kv as jpk
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request,
                                           ServingConfig, ServingEngine)
from deepspeed_tpu_torch.inference import paged_kv as pk
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax
from deepspeed_tpu_torch.ops.transformer import int8_matmul as im
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.runtime.step_graph import GraphPool, StepGraph

TOL = 1e-4          # fp32 parity, as tests/test_torch_gpt2.py
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)


def _weights(max_seq=256):
    return JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=max_seq).init_numpy(seed=0)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def _jax_server(weights, max_seq=256, **cfg):
    return JServingEngine(
        model=JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=max_seq, **NO_DROPOUT),
        params=jax.tree_util.tree_map(jnp.asarray, weights),
        config=JServingConfig(**cfg))


def _port_server(weights, max_seq=256, decode_impl="auto", **cfg):
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=max_seq,
                 decode_impl=decode_impl)
    return ServingEngine(model=model, params=params_from_jax(weights, "cpu", torch.float32),
                         config=ServingConfig(**cfg))


# ------------------------------------------------------ (1) greedy streams
@pytest.mark.parametrize("max_seq,lengths,new", [
    (256, (5, 13, 8, 16, 21, 3), 10),     # block 8: 8 and 16 exact multiples, the rest not
    (47, (41, 44, 9, 40), 3),             # max_seq 47: buckets of 48 run the forward at 47
])
def test_greedy_streams_token_identical_to_jax(max_seq, lengths, new):
    weights = _weights(max_seq)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 1024, (n,)) for n in lengths]
    cfg = dict(batch_slots=3, block_size=8, max_new_tokens=new)
    jsrv = _jax_server(weights, max_seq, **cfg)
    jres = jsrv.run([JRequest(tokens=p, uid=i) for i, p in enumerate(prompts)])
    jsrv.close()
    for impl in ("fused", "unroll"):
        srv = _port_server(weights, max_seq, decode_impl=impl, **cfg)
        res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
        for uid in range(len(prompts)):
            assert res[uid]["outcome"] == OK
            assert res[uid]["tokens"] == [int(t) for t in jres[uid]["tokens"]], (impl, uid)
        assert srv.allocator.free_blocks == srv.num_blocks - 1
        g = srv.stats()["graphs"]
        # no graph on the CPU: the bodies run directly, nothing is captured or replayed
        assert g["decode_impl"] == impl and g["graphs"] == g["captures"] == 0
        assert g["decode_warmups"] == g["prefill_warmups"] == 0
        assert g["decode_replays"] == g["prefill_replays"] == 0
        assert sorted(srv._prefills) == sorted({-(-n // 8) * 8 for n in lengths})


# ------------------------------------------------------ (2) one prefill bucket
@pytest.mark.parametrize("kv_bits,T,max_seq", [(16, 13, 256), (16, 16, 256), (8, 13, 256),
                                               (16, 44, 47)])
def test_prefill_bucket_matches_jax_prefill_fn(kv_bits, T, max_seq):
    """First token, bad flag and every pool block the bucket wrote (its pad
    rows included) against JAX's ``_prefill_fn(bucket)``."""
    weights = _weights(max_seq)
    cfg = dict(batch_slots=2, block_size=8, kv_bits=kv_bits, max_new_tokens=2)
    bs = 8
    bucket = pk.blocks_needed(T, bs) * bs
    fwd_len = min(bucket, max_seq)
    prompt = np.random.default_rng(3).integers(0, 1024, (T,))
    toks = np.zeros((1, fwd_len), np.int64)
    toks[0, :T] = prompt
    blocks = np.arange(3, 3 + bucket // bs, dtype=np.int64)

    jsrv = _jax_server(weights, max_seq, **cfg)
    fn = jsrv._prefill_fn(bucket)
    jfirst, jbad, jpool = fn(jsrv.engine.params, jnp.asarray(toks, jnp.int32), jsrv.pool,
                             jnp.asarray(blocks, jnp.int32), jnp.int32(T), jnp.int32(0),
                             jnp.float32(1.0), jnp.asarray(False))
    jpool = {k: np.asarray(v) for k, v in jpool.items()}
    jsrv.close()

    srv = _port_server(weights, max_seq, **cfg)
    row, first, bad = srv._prefill_step(bucket)(toks=toks, blocks=blocks, t_real=np.int64(T))
    assert row.shape == (1, 1024) and torch.isfinite(row).all()
    assert int(first[0]) == int(jfirst) and bool(bad[0]) == bool(jbad) is False
    assert set(jpool) == set(srv.pool)
    for name in srv.pool:
        got = srv.pool[name][:, blocks].numpy()
        want = jpool[name][:, blocks]
        if name in ("k", "v") and kv_bits == 8:
            # a value on a rounding edge quantizes one int8 step apart
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)
        # only the bucket's blocks were written
        others = np.setdiff1d(np.arange(1, srv.num_blocks), blocks)
        np.testing.assert_array_equal(srv.pool[name][:, others].numpy(),
                                      jpool[name][:, others], err_msg=name)


# ------------------------------------------------- (3) decode_impl resolution
@pytest.mark.parametrize("impl", ["auto", "fused", "unroll", "legacy_scan", "bogus"])
def test_decode_impl_resolves_as_jax(impl):
    jmodel = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, decode_impl=impl)
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", decode_impl=impl)
    if impl == "bogus":
        with pytest.raises(AssertionError):
            jmodel.decode_impl()
        with pytest.raises(ValueError, match="decode_impl must be"):
            model.decode_impl()
        return
    want = jmodel.decode_impl()
    assert want == {"auto": "fused"}.get(impl, impl)
    if impl == "legacy_scan":
        with pytest.raises(NotImplementedError, match="legacy_scan"):
            model.decode_impl()
        return
    assert model.decode_impl() == want


# --------------------------------------------- (4) generate with max_len
@pytest.mark.parametrize("max_len", [None, 30, 64])
def test_generate_with_max_len_matches_jax(weights, max_len):
    prompt = np.random.default_rng(5).integers(0, 1024, (2, 9))
    jeng = JInferenceEngine(
        JGPT2(preset="gpt2-tiny", dtype=jnp.float32, **NO_DROPOUT),
        params=jax.tree_util.tree_map(jnp.asarray, weights))
    want = np.asarray(jeng.generate(jnp.asarray(prompt, jnp.int32), max_new_tokens=7,
                                    max_len=max_len))
    for impl in ("fused", "unroll"):
        model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", decode_impl=impl)
        eng = InferenceEngine(model, params_from_jax(weights, "cpu", torch.float32))
        got = eng.generate(prompt, max_new_tokens=7, max_len=max_len)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=impl)
        # a second call reuses the step (and its cache) and gives the same tokens
        np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=7,
                                                   max_len=max_len).numpy(), want)


def test_generate_max_len_below_total_raises(weights):
    prompt = np.zeros((1, 9), np.int64)
    jeng = JInferenceEngine(JGPT2(preset="gpt2-tiny", dtype=jnp.float32, **NO_DROPOUT),
                            params=jax.tree_util.tree_map(jnp.asarray, weights))
    with pytest.raises(AssertionError, match="max_len"):
        jeng.generate(jnp.asarray(prompt, jnp.int32), max_new_tokens=7, max_len=15)
    eng = InferenceEngine(GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu"),
                          params_from_jax(weights, "cpu", torch.float32))
    with pytest.raises(ValueError, match="max_len 15 must cover"):
        eng.generate(prompt, max_new_tokens=7, max_len=15)


def test_sampled_generate_same_stream_fused_and_unroll(weights):
    """Sampling draws after each replay from the step's logits: the
    captured-path body and the eager loop give the same stream."""
    prompt = np.asarray([[1, 2, 3], [4, 5, 6]])
    out = {}
    for impl in ("fused", "unroll"):
        model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", decode_impl=impl)
        eng = InferenceEngine(model, params_from_jax(weights, "cpu", torch.float32))
        out[impl] = eng.generate(prompt, 6, do_sample=True, top_k=10, temperature=0.8, seed=3)
    assert torch.equal(out["fused"], out["unroll"])


# ------------------------------------------- (5) the graph's launch bookkeeping
class FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: records the calls."""

    def __init__(self, fail_replay=False):
        self.calls, self.fail_replay = [], fail_replay

    def capture_begin(self, pool=None):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        if self.fail_replay:
            raise RuntimeError("replay refused")
        self.calls.append("replay")


def _counting_body(ran):
    def body(x):
        ran.append(x.clone())
        pa.launches["paged_attention_online_sm90"] += 12
        im.launches["int8_mm_nt_decode"] += 96
        return x * 2
    return body


def test_step_graph_counts_warmups_and_replays_not_capture():
    pa.reset_launches()
    im.reset_launches()
    ran, graphs = [], []
    pool = GraphPool("cpu", graph_factory=lambda: graphs.append(FakeGraph()) or graphs[-1])
    step = StepGraph("fake", _counting_body(ran), {"x": torch.full((3,), 7.0)}, "cpu", pool)
    assert not step.captured
    out = step(x=np.ones(3, np.float32))
    # the warm-up and the capture ran the body, on the initial values; the capture's
    # launches were taken back and one replay added
    assert len(ran) == 2 and all(torch.equal(r, torch.full((3,), 7.0)) for r in ran)
    assert graphs[0].calls == ["begin", "end", "replay"] and step.captured
    assert (step.captures, step.warmups, step.replays) == (1, 1, 1)
    assert pa.launches["paged_attention_online_sm90"] == 2 * 12
    assert im.launches["int8_mm_nt_decode"] == 2 * 96
    assert torch.equal(step.static["x"], torch.ones(3))
    again = step(x=np.full(3, 2.0, np.float32))
    assert again is out and len(ran) == 2 and len(graphs) == 1
    assert step.replays == 2 and pa.launches["paged_attention_online_sm90"] == 3 * 12
    assert im.launches["int8_mm_nt_decode"] == 3 * 96
    assert torch.equal(step.static["x"], torch.full((3,), 2.0))
    assert all(n == 0 for k, n in pa.launches.items() if k != "paged_attention_online_sm90")
    pa.reset_launches()
    im.reset_launches()


def test_step_graph_without_pool_calls_the_body():
    pa.reset_launches()
    ran = []
    step = StepGraph("direct", _counting_body(ran), {"x": torch.zeros(2)}, "cpu")
    for v in (1.0, 2.0):
        assert torch.equal(step(x=np.full(2, v, np.float32)), torch.full((2,), 2 * v))
    assert (step.captures, step.warmups, step.replays, len(ran)) == (0, 0, 0, 2)
    assert pa.launches["paged_attention_online_sm90"] == 24
    with pytest.raises(ValueError, match="takes"):
        step(y=np.zeros(2))
    pa.reset_launches()
    im.reset_launches()


def test_step_graph_failures_raise_naming_the_step():
    pa.reset_launches()

    def failing(x):
        pa.launches["paged_attention_online_sm90"] += 5
        if failing.capturing:
            raise RuntimeError("operation not permitted when stream is capturing")
        failing.capturing = True
        return x

    failing.capturing = False
    step = StepGraph("serving.decode[test]", failing, {"x": torch.zeros(1)}, "cpu",
                     GraphPool("cpu", graph_factory=FakeGraph))
    with pytest.raises(RuntimeError, match=r"step serving.decode\[test\]: CUDA graph capture"):
        step(x=np.zeros(1, np.float32))
    assert not step.captured
    assert pa.launches["paged_attention_online_sm90"] == 5     # the warm-up's only
    step = StepGraph("generate.token[test]", lambda x: x, {"x": torch.zeros(1)}, "cpu",
                     GraphPool("cpu", graph_factory=lambda: FakeGraph(fail_replay=True)))
    with pytest.raises(RuntimeError, match=r"step generate.token\[test\]: CUDA graph replay"):
        step(x=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        GraphPool("cpu")
    pa.reset_launches()


# ------------------------------------------------------- (6) no host sync
class _NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError(f"host sync in a step body: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_step_bodies_make_no_host_read(weights, kv_bits):
    srv = _port_server(weights, batch_slots=2, block_size=8, kv_bits=kv_bits,
                       max_new_tokens=4)
    tables = torch.zeros((2, srv.nb_max), dtype=torch.int32)
    tables[0, :2], tables[1, :2] = torch.tensor([1, 2]), torch.tensor([3, 4])
    with torch.no_grad(), _NoHostSync():
        srv._prefill_body(16, torch.arange(1, 14)[None], torch.tensor([1, 2]),
                          torch.tensor(13))
        srv._decode_body(torch.tensor([5, 6]), tables, torch.tensor([13, 7], dtype=torch.int32))
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")
    eng = InferenceEngine(model, params_from_jax(weights, "cpu", torch.float32))
    with torch.no_grad():
        step, st = eng._token_step(model, lambda p: p, 2, 16, False)
        st["cache"]["index"].fill_(3)
        with _NoHostSync():
            step()
            step()
    assert int(st["cache"]["index"]) == 5
    # the mode catches a host read
    with pytest.raises(AssertionError, match="host sync"), _NoHostSync():
        int(torch.ones(()).sum())


# ------------------------------------------------------- (7) fixed addresses
def test_pool_keeps_its_addresses_through_a_serve(weights):
    srv = _port_server(weights, batch_slots=2, block_size=8, max_new_tokens=5)
    ptrs = {k: v.data_ptr() for k, v in srv.pool.items()}
    pool = srv.pool
    rng = np.random.default_rng(9)
    res = srv.run([Request(tokens=rng.integers(0, 1024, (n,)), uid=i)
                   for i, n in enumerate((7, 16, 11))])
    assert all(r["outcome"] == OK for r in res.values())
    assert srv.pool is pool and {k: v.data_ptr() for k, v in srv.pool.items()} == ptrs


def test_write_prefill_takes_device_block_ids():
    pool = pk.init_pool(2, 6, 4, 2, 8, torch.float32, device="cpu")
    k = torch.randn(2, 8, 2, 8)
    v = torch.randn(2, 8, 2, 8)
    pk.write_prefill(pool, torch.tensor([4, 2]), k, v)
    ref = pk.init_pool(2, 6, 4, 2, 8, torch.float32, device="cpu")
    pk.write_prefill(ref, [4, 2], k, v)
    assert all(torch.equal(pool[n], ref[n]) for n in pool)
    assert torch.equal(pool["k"][:, 4], k[:, :4]) and torch.equal(pool["v"][:, 2], v[:, 4:])
    with pytest.raises(ValueError, match="block ids must be integers"):
        pk.write_prefill(pool, torch.tensor([4.0, 2.0]), k, v)
    jp = jpk.init_pool(2, 6, 4, 2, 8, jnp.float32)
    jp = jpk.write_prefill(jp, jnp.asarray([4, 2]), jnp.asarray(k.numpy()),
                           jnp.asarray(v.numpy()))
    np.testing.assert_array_equal(np.asarray(jp["k"]), pool["k"].numpy())
