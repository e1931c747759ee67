"""The port's weight quantization and int8 serving path against the JAX
package on the CPU (deepspeed_tpu_torch/ops/quantizer/quantizer.py,
module_inject/module_quantize.py, the int8 decode of models/gpt2.py,
inference/engine.py and inference/serving.py vs their deepspeed_tpu
counterparts).

- ``quantize`` / ``dequantize``: bit-identical int8 values and fp32
  scales (symmetric and asymmetric, flat and stacked leaves);
- ``default_predicate``, ``quantize_param_tree``, ``q_gather``,
  ``q_matmul``: the same leaves, bytes and values;
- GPT-2 tiny with int8 params in an fp32 model: ``apply_with_cache``
  logits within 1e-4 (the int8 products sum exact bf16 x int8 terms in
  fp32 in another order; fp32 everywhere else), the tolerance of
  tests/test_torch_gpt2.py; ``decode_step_paged`` within ``EDGE_TOL``;
- ``InferenceEngine(dtype=int8)``: greedy tokens equal to JAX's, and the
  serving layer's streams equal to the port's own ``generate``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.inference import paged_kv as jpk
from deepspeed_tpu.inference.engine import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.module_inject import module_quantize as jmq
from deepspeed_tpu.ops.quantizer import quantizer as jqz
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request, ServingConfig,
                                           ServingEngine)
from deepspeed_tpu_torch.inference import paged_kv as tpk
from deepspeed_tpu_torch.inference.engine import _normalize_dtype, _to
from deepspeed_tpu_torch.models.gpt2 import GPT2, layer_slice, params_from_jax
from deepspeed_tpu_torch.module_inject import module_quantize as tmq
from deepspeed_tpu_torch.ops.quantizer import quantizer as tqz
from deepspeed_tpu_torch.ops.transformer import int8_matmul as tim

TOL = 1e-4
# decode windows over a prefilled pool: an fp32 activation that lies on a
# bf16 rounding edge can round the other way in the two packages (its fp32
# sums ran in another order) before int8_matmul rounds x to bf16; one such
# flip moves the logits (~0.3 here) by up to 1.6e-3, half of one bf16 ulp at 1
EDGE_TOL = 4e-3
BS = 8


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _weights(seed=0):
    """gpt2-tiny's ``init_numpy`` weights with the embedding, qkv and fc
    weights scaled 10x: the streams of the untouched random model collapse
    to one repeated token, these change token within a stream."""
    w = JGPT2(preset="gpt2-tiny", dtype=jnp.float32).init_numpy(seed=seed)
    w["wte"] = w["wte"] * 10
    for k in ("qkv_w", "fc_w"):
        w["blocks"][k] = w["blocks"][k] * 10
    return w


def _jmodel():
    return JGPT2(preset="gpt2-tiny", dtype=jnp.float32, embd_pdrop=0.0, attn_pdrop=0.0,
                 resid_pdrop=0.0)


def _tmodel():
    return GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# ------------------------------------------------------------ the quantizer
def _quant_cases():
    rng = np.random.default_rng(0)
    ties = np.zeros((2, 64), np.float32)      # amax 127: scale 1, halves kept
    ties[:, 0] = 127.0
    ties[0, 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    ties[1, 1:9] = [3.5, 4.5, -3.5, -4.5, 10.5, 11.5, 0.5, -0.5]
    mixed = (rng.standard_normal((4, 64)) * 0.02).astype(np.float32)
    mixed[1] = 0.0                            # an all-zero group: scale 1
    return {
        "2d-g1": ((rng.standard_normal((64, 128)) * 0.02).astype(np.float32), 1),
        "2d-g8": ((rng.standard_normal((64, 128)) * 0.02).astype(np.float32), 8),
        "3d-g4": ((rng.standard_normal((4, 128, 96)) * 0.02).astype(np.float32), 4),
        "3d-g12": ((rng.standard_normal((3, 32, 64)) * 3).astype(np.float32), 12),
        "flat-g3": (rng.standard_normal((300,)).astype(np.float32), 3),
        "ties": (ties, 2),
        "zero-group": (mixed, 4),
    }


@pytest.mark.parametrize("symmetric", [True, False], ids=["sym", "asym"])
@pytest.mark.parametrize("case", sorted(_quant_cases()))
def test_quantize_bit_identical_to_jax(case, symmetric):
    x, groups = _quant_cases()[case]
    jq, js, jz = jqz.quantize(jnp.asarray(x), groups=groups, symmetric=symmetric)
    tq, ts, tz = tqz.quantize(torch.from_numpy(x), groups=groups, symmetric=symmetric)
    assert tq.dtype == torch.int8 and tq.shape == x.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_array_equal(_bits(tz.numpy()), _bits(jz))
    jd = jqz.dequantize(jq, js, jz if not symmetric else None, groups=groups)
    td = tqz.dequantize(tq, ts, tz if not symmetric else None, groups=groups)
    np.testing.assert_array_equal(_bits(td.numpy()), _bits(jd))


def test_quantizer_facade_and_bits_match_jax():
    x = np.random.default_rng(2).standard_normal((256,)).astype(np.float32)
    jq, js, _ = jqz.Quantizer(q_groups=2, q_bits=4).quantize(jnp.asarray(x))
    tq, ts, _ = tqz.Quantizer(q_groups=2, q_bits=4).quantize(torch.from_numpy(x))
    assert int(tq.max()) <= 7 and int(tq.min()) >= -8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    back = tqz.Quantizer(q_groups=2, q_bits=4).dequantize(tq, ts)
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(ts.max()) * 0.5 + 1e-6


def test_stochastic_rounding_is_unbiased_and_needs_a_generator():
    x = torch.full((1, 1024), 0.3)
    vals = []
    for i in range(16):
        g = torch.Generator().manual_seed(i)
        q, s, _ = tqz.quantize(x, groups=1, stochastic=True, rng=g)
        vals.append(float(tqz.dequantize(q, s, groups=1).mean()))
    assert abs(np.mean(vals) - 0.3) < 0.005
    with pytest.raises(ValueError, match="Generator"):
        tqz.quantize(x, stochastic=True)


def test_indivisible_groups_raise():
    with pytest.raises(ValueError, match="not divisible"):
        tqz.quantize(torch.ones(10), groups=3)


# ---------------------------------------------------------- module_quantize
def _predicate_cases():
    rng = np.random.default_rng(0)
    L, D = 64, 256
    return [("['h']['c_attn_b']", rng.normal(size=(L, 3 * D)).astype(np.float32)),
            ("['h']['mlp_fc_b']", rng.normal(size=(L, 4 * D)).astype(np.float32)),
            ("['h']['b']", rng.normal(size=(L, D)).astype(np.float32)),
            ("['h']['c_attn_w']", rng.normal(size=(L, D, 3 * D)).astype(np.float32)),
            ("['head_w']", rng.normal(size=(D, D)).astype(np.float32)),
            ("['blocks']['ln1_scale']", np.ones((L, D), np.float32)),
            ("['blocks']['qkv_b']", np.zeros((4, 384), np.float32)),
            ("['wpe']", np.zeros((256, 128), np.float32)),
            ("['small']", np.zeros((32, 64), np.float32)),
            ("['final_norm']", np.zeros((128, 128), np.float32)),
            ("['vec']", np.zeros((8192,), np.float32))]


@pytest.mark.parametrize("i", range(len(_predicate_cases())))
def test_default_predicate_matches_jax(i):
    path, leaf = _predicate_cases()[i]
    want = jmq.default_predicate(path, leaf)
    assert tmq.default_predicate(path, leaf) == want
    assert tmq.default_predicate(path, torch.from_numpy(leaf)) == want


def test_paths_are_spelled_as_jax_keystr():
    tree = {"blocks": {"qkv_w": np.zeros(2)}, "lst": [np.zeros(1), (np.zeros(1),)]}
    seen = []
    tmq.quantize_param_tree(tree, predicate=lambda p, _: seen.append(p) or False)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert seen == [jax.tree_util.keystr(p) for p, _ in flat]


@pytest.mark.parametrize("groups", [1, 4])
def test_quantize_param_tree_matches_jax(groups):
    w = _weights()
    w["h"] = {k: v for k, v in _predicate_cases()[:4]}   # *_b stacks at L = 64
    jtree, jstats = jmq.quantize_param_tree(w, groups=groups)
    ttree, tstats = tmq.quantize_param_tree(params_from_jax(w, "cpu") | {
        "h": {k: torch.from_numpy(v) for k, v in w["h"].items()}}, groups=groups)
    assert tstats == jstats
    jflat = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=jmq.is_quantized_leaf)[0]
    tnp = _to_numpy(ttree)
    assert len(jflat) == 20
    for path, jleaf in jflat:
        tleaf = tnp
        for key in path:
            tleaf = tleaf[key.key]
        if jmq.is_quantized_leaf(jleaf):
            assert set(tleaf) == {"q", "scale"}, jax.tree_util.keystr(path)
            assert tleaf["q"].dtype == np.int8 and tleaf["scale"].shape == jleaf["scale"].shape
            np.testing.assert_array_equal(tleaf["q"], np.asarray(jleaf["q"]))
            np.testing.assert_array_equal(_bits(tleaf["scale"]), _bits(jleaf["scale"]))
        else:
            np.testing.assert_array_equal(tleaf, np.asarray(jleaf))
    jdeq = jmq.dequantize_tree(jtree, jnp.float32)
    tdeq = _to_numpy(tmq.dequantize_tree(ttree, torch.float32))
    for path, jleaf in jax.tree_util.tree_flatten_with_path(jdeq)[0]:
        tleaf = tdeq
        for key in path:
            tleaf = tleaf[key.key]
        np.testing.assert_array_equal(_bits(tleaf), _bits(jleaf))


def test_layer_slice_carves_payload_and_scale():
    tq, _ = tmq.quantize_param_tree(params_from_jax(_weights(), "cpu"), groups=2)
    blocks = tq["blocks"]
    lp = layer_slice(blocks, 3)
    assert torch.equal(lp["qkv_w"]["q"], blocks["qkv_w"]["q"][3])
    assert lp["qkv_w"]["scale"].shape == (2,)
    assert torch.equal(lp["ln1_scale"], blocks["ln1_scale"][3])


@pytest.mark.parametrize("groups", [1, 1024, 4], ids=["tensor", "row", "groups"])
def test_q_gather_matches_jax(groups):
    w = _weights()["wte"]
    jleaf = jmq.quantize_param_tree({"wte": w}, groups=groups)[0]["wte"]
    tleaf = tmq.quantize_param_tree({"wte": torch.from_numpy(w)}, groups=groups)[0]["wte"]
    idx = np.random.default_rng(1).integers(0, 1024, (3, 5))
    want = np.asarray(jmq.q_gather(jleaf, jnp.asarray(idx), jnp.float32))
    got = tmq.q_gather(tleaf, torch.from_numpy(idx), torch.float32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("route", ["tensor", "channel-t", "groups", "groups-t", "float",
                                   "float-t-bf16-to-fp32"])
def test_q_matmul_routes_and_values_match_jax(route, monkeypatch):
    """Per-tensor and per-output-channel (transposed) scales go to
    int8_matmul; any other scale dequantizes and takes the plain product;
    a float weight takes the plain product (bf16 operands summed in fp32
    when ``out_dtype`` is fp32, as the float tied head in JAX)."""
    rng = np.random.default_rng(4)
    transposed = "-t" in route
    w = (rng.standard_normal((96, 128) if transposed else (128, 96)) * 0.05).astype(np.float32)
    groups = {"tensor": 1, "channel-t": 96, "groups": 4, "groups-t": 4}.get(route)
    h = rng.standard_normal((2, 3, 128)).astype(np.float32)
    bf16 = route == "float-t-bf16-to-fp32"
    out = dict(out_dtype=torch.float32) if bf16 else {}
    jout = dict(out_dtype=jnp.float32) if bf16 else {}
    if groups is None:
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
    else:
        jw = jmq.quantize_param_tree({"w": w}, groups=groups)[0]["w"]
        tw = tmq.quantize_param_tree({"w": torch.from_numpy(w)}, groups=groups)[0]["w"]
    calls = []
    real = tim.int8_matmul
    monkeypatch.setattr(tim, "int8_matmul", lambda *a, **k: calls.append(1) or real(*a, **k))
    th, jh = torch.from_numpy(h), jnp.asarray(h)
    if bf16:
        th, jh = th.to(torch.bfloat16), jh.astype(jnp.bfloat16)
    got = tmq.q_matmul(th, tw, w_transposed=transposed, **out)
    want = np.asarray(jmq.q_matmul(jh, jw, w_transposed=transposed, **jout))
    assert got.dtype == torch.float32
    assert len(calls) == (1 if route in ("tensor", "channel-t") else 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantize_transformer_layer_wraps_the_model():
    model = _tmodel()
    qmodel, qparams = tmq.quantize_transformer_layer(model, params_from_jax(_weights(), "cpu"))
    assert isinstance(qmodel, tmq.QuantizedModel) and qmodel.config is model.config
    assert tmq.is_quantized_leaf(qparams["blocks"]["fc_w"])
    inner, deq = tmq.resolve_decode_params(qmodel)
    assert inner is model and deq(qparams) is qparams
    plain, same = tmq.resolve_decode_params(model)
    assert plain is model and same(qparams) is qparams


# ------------------------------------------------- GPT-2 with int8 params
@pytest.fixture(scope="module")
def qtiny():
    # the unscaled init_numpy weights: at 10x, activations of ~10 put more
    # fp32 values on bf16 rounding edges, where a last-bit difference in an
    # fp32 sum of another order moves x's bf16 rounding by one ulp (2e-2 on
    # the logits); here the two packages agree to 1.2e-7
    w = JGPT2(preset="gpt2-tiny", dtype=jnp.float32).init_numpy(seed=0)
    jq, _ = jmq.quantize_param_tree(jax.tree_util.tree_map(jnp.asarray, w))
    tq, _ = tmq.quantize_param_tree(params_from_jax(w, "cpu"))
    return jq, tq


def test_gpt2_int8_apply_with_cache_matches_jax(qtiny):
    jq, tq = qtiny
    jmodel, tmodel = _jmodel(), _tmodel()
    tokens = np.random.default_rng(1).integers(0, 1024, (2, 13))
    jlog, jcache = jmodel.apply_with_cache(jq, jnp.asarray(tokens, jnp.int32),
                                           jmodel.init_cache(2, 20))
    tlog, tcache = tmodel.apply_with_cache(tq, torch.from_numpy(tokens), tmodel.init_cache(2, 20))
    assert tlog.dtype == torch.float32 and tlog.shape == (2, 13, 1024)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), rtol=0,
                                   atol=TOL)
    nxt = np.asarray([[5], [7]])
    jlog2, _ = jmodel.apply_with_cache(jq, jnp.asarray(nxt, jnp.int32), jcache)
    tlog2, _ = tmodel.apply_with_cache(tq, torch.from_numpy(nxt), tcache)
    np.testing.assert_allclose(tlog2.numpy(), np.asarray(jlog2), rtol=0, atol=TOL)


@pytest.mark.parametrize("n_window", [1, 3])
def test_gpt2_int8_decode_step_paged_matches_jax(qtiny, n_window):
    jq, tq = qtiny
    jmodel, tmodel = _jmodel(), _tmodel()
    c = tmodel.config
    rng = np.random.default_rng(2 + n_window)
    nb = 16
    k, v = ((rng.standard_normal((c.n_layer, nb * BS, c.n_head, c.head_dim)) * 0.5
             ).astype(np.float32) for _ in range(2))
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lengths = np.asarray([25, 9, 0, 0], np.int32)
    toks = rng.integers(0, c.vocab_size, (4, n_window))
    jt = toks[:, 0] if n_window == 1 else toks
    jpool = jpk.write_prefill(jpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim,
                                            jnp.float32),
                              jnp.arange(nb, dtype=jnp.int32), jnp.asarray(k), jnp.asarray(v))
    tpool = tpk.write_prefill(tpk.init_pool(c.n_layer, nb, BS, c.n_head, c.head_dim,
                                            torch.float32, device="cpu"),
                              torch.arange(nb), torch.from_numpy(k), torch.from_numpy(v))
    jlog, jpool = jmodel.decode_step_paged(jq, jnp.asarray(jt, jnp.int32), jpool,
                                           jnp.asarray(tables), jnp.asarray(lengths))
    tim.reset_launches()
    tlog, tpool = tmodel.decode_step_paged(tq, torch.from_numpy(jt), tpool,
                                           torch.from_numpy(tables), torch.from_numpy(lengths))
    assert tlog.shape == tuple(jlog.shape)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=EDGE_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tpool[name].numpy()[:, 1:], np.asarray(jpool[name])[:, 1:],
                                   rtol=0, atol=EDGE_TOL)
    # the CPU runs the plain version
    assert tim.launches == {name: 0 for name in tim.KERNELS.values()}


# ------------------------------------------------------ engine and serving
def test_engine_dtype_int8_quantizes_not_casts():
    """``dtype=torch.int8`` quantizes (never an int8 cast of the weights);
    the engine's logits equal JAX's ``forward`` at ``dtype=jnp.int8``."""
    w = _weights()
    ids = np.random.default_rng(2).integers(0, 1024, (2, 12))
    model = _tmodel()
    eng = InferenceEngine(model, params=params_from_jax(w, "cpu"), dtype=torch.int8)
    assert eng.quantized and eng.dtype is None
    assert isinstance(eng.module, tmq.QuantizedModel)
    assert model.dtype == torch.bfloat16          # the compute dtype, never int8
    assert tmq.is_quantized_leaf(eng.params["blocks"]["qkv_w"])
    out = eng.forward(ids)
    eng_q = InferenceEngine(_tmodel(), params=params_from_jax(w, "cpu"), quantization_setting=1)
    torch.testing.assert_close(eng_q(ids), out, rtol=0, atol=0)
    jeng = JInferenceEngine(model=_jmodel(), params=jax.tree_util.tree_map(jnp.asarray, w),
                            dtype=jnp.int8)
    want = np.asarray(jeng.forward(jnp.asarray(ids, jnp.int32)))
    # bf16 activations on both sides: a few bf16 ulps at logits of ~10
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=0.15)
    assert (out.numpy().argmax(-1) == want.argmax(-1)).mean() > 0.9
    ref = InferenceEngine(_tmodel(), params=params_from_jax(w, "cpu")).forward(ids)
    assert (out.argmax(-1) == ref.argmax(-1)).float().mean() > 0.9


def test_engine_keeps_int8_payloads_and_scales():
    """The engine's move to its device casts floating leaves only: int8
    payloads and fp32 scales keep their dtypes (a bf16 engine too)."""
    w = params_from_jax(_weights(), "cpu")
    tq, _ = tmq.quantize_param_tree(w)
    moved = _to(tq, "cpu", torch.bfloat16)
    assert moved["blocks"]["qkv_w"]["q"].dtype == torch.int8
    assert moved["blocks"]["qkv_w"]["scale"].dtype == torch.float32
    assert moved["blocks"]["ln1_scale"].dtype == torch.bfloat16
    # pre-quantized params: detected, the raw model wrapped, nothing cast
    eng = InferenceEngine(_tmodel(), params=tq, dtype=torch.bfloat16)
    assert eng.quantized and isinstance(eng.module, tmq.QuantizedModel)
    assert eng.params["wte"]["q"].dtype == torch.int8
    assert eng.params["wte"]["scale"].dtype == torch.float32
    assert eng.params["blocks"]["ln1_scale"].dtype == torch.float32


def test_engine_quantization_settings():
    w = params_from_jax(_weights(), "cpu")
    eng = InferenceEngine(_tmodel(), params=w, quantization_setting=(True, 8))
    assert eng.quantized and eng.params["blocks"]["qkv_w"]["scale"].shape == (4, 8)
    eng = InferenceEngine(_tmodel(), params=w, quantization_setting=4)
    assert eng.params["wte"]["scale"].shape == (4,)
    with pytest.raises(ValueError, match="quantization_setting"):
        InferenceEngine(_tmodel(), params=w, quantization_setting="8bits")
    # the wrapped model of a pre-quantized tree keeps its own dtype
    qmodel = tmq.QuantizedModel(_tmodel(), torch.float32)
    eng = InferenceEngine(qmodel, params=eng.params)
    assert eng.module is qmodel and qmodel.dtype == torch.float32


@pytest.mark.parametrize("spelling,want", [
    (torch.int8, torch.int8), (np.int8, torch.int8), (np.float32, torch.float32),
    ("bf16", torch.bfloat16), ("float16", torch.float16), (None, None)])
def test_normalize_dtype_spellings(spelling, want):
    assert _normalize_dtype(spelling) is want


def test_greedy_int8_generate_tokens_equal_jax():
    w = _weights()
    ids = np.random.default_rng(3).integers(0, 1024, (4, 8))
    jeng = JInferenceEngine(model=_jmodel(), params=jax.tree_util.tree_map(jnp.asarray, w),
                            dtype=jnp.int8)
    want = np.asarray(jeng.generate(jnp.asarray(ids, jnp.int32), max_new_tokens=16))
    eng = deepspeed_tpu_torch.init_inference(_tmodel(), params=params_from_jax(w, "cpu"),
                                             dtype=torch.int8)
    got = eng.generate(ids, max_new_tokens=16).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got[:, 8:].ravel())) > 4


def test_int8_serving_streams_equal_generate():
    """``ServingEngine(engine=<int8 engine>)`` answers greedy requests with
    the engine's own ``generate`` tokens and recycles every block; the pool
    takes the inner model's compute dtype (the quantized engine's dtype is
    None)."""
    w = _weights()
    eng = InferenceEngine(_tmodel(), params=params_from_jax(w, "cpu"), dtype=torch.int8)
    srv = ServingEngine(engine=eng, config=ServingConfig(batch_slots=2, block_size=8,
                                                         max_new_tokens=6))
    assert srv.model is eng.module._model and srv.pool["k"].dtype == torch.bfloat16
    prompts = [np.random.default_rng(9).integers(0, 1024, (int(n),)) for n in (5, 11, 7)]
    res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
    for uid, p in enumerate(prompts):
        assert res[uid]["outcome"] == OK
        assert res[uid]["tokens"] == eng.generate(p[None], max_new_tokens=6)[0, len(p):].tolist()
    assert srv.allocator.free_blocks == srv.num_blocks - 1


def test_serving_pool_dtype_follows_the_inner_model():
    eng = InferenceEngine(_tmodel(), params=params_from_jax(_weights(), "cpu"),
                          quantization_setting=1, dtype=torch.float32)
    assert eng.dtype is None and eng.module.dtype == torch.float32
    srv = ServingEngine(engine=eng, config=ServingConfig(batch_slots=1, block_size=8,
                                                         kv_bits=16))
    assert srv.pool["k"].dtype == torch.float32
