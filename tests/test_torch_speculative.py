"""The port's speculative decoding against the JAX package on the CPU
(deepspeed_tpu_torch/inference/serving.py ``SpeculativeConfig``,
``ngram_draft``, the W=k+1 decode step and the scheduler's window branch;
vs deepspeed_tpu/inference/serving.py ``SpeculativeConfig``,
``ngram_draft``, ``spec_step`` and ``step``).

``gpt2-tiny`` in fp32 with numpy-seeded weights: greedy speculative
streams must equal JAX's speculative and plain streams token for token,
with kv16 and kv8 pools and k 1/3/7, including ``max_seq=47`` requests
whose last windows cross the table's end, and the proposed / accepted
counts must equal JAX's.  Sampled streams keep the port's own contract:
speculative equals plain under any arrival order (the bits differ from
JAX's by design).  On the CPU the steps' bodies run directly; the graph
bookkeeping is held with a stand-in graph that re-runs the body on
replay."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import (InferenceEngine as JInferenceEngine,
                                     Request as JRequest,
                                     ServingConfig as JServingConfig,
                                     ServingEngine as JServingEngine)
from deepspeed_tpu.inference import serving as jserving
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, POISONED, Request,
                                           ServingConfig, ServingEngine)
from deepspeed_tpu_torch.inference import serving
from deepspeed_tpu_torch.inference.serving import (DRAFT_WINDOW, SpeculativeConfig,
                                                   ngram_draft)
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.runtime.step_graph import GraphPool, launch_counters

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
VOCAB = 1024


def _weights(max_seq=256):
    return JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=max_seq).init_numpy(seed=0)


def _jax_server(weights, max_seq=256, engine_kw=None, **cfg):
    eng = JInferenceEngine(
        model=JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=max_seq, **NO_DROPOUT),
        params=jax.tree_util.tree_map(jnp.asarray, weights), **(engine_kw or {}))
    return JServingEngine(engine=eng, config=JServingConfig(**cfg))


def _port_server(weights, max_seq=256, engine_kw=None, decode_impl="auto", **cfg):
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=max_seq,
                 decode_impl=decode_impl)
    eng = InferenceEngine(model, params_from_jax(weights, "cpu", torch.float32),
                          **(engine_kw or {}))
    return ServingEngine(engine=eng, config=ServingConfig(**cfg))


# --------------------------------------------------------------- the config
def test_speculative_config_validation():
    """JAX's ``test_speculative_config_validation``, on the port."""
    from deepspeed_tpu_torch.inference import SpeculativeConfig as Exported
    assert Exported is SpeculativeConfig
    assert SpeculativeConfig.from_value(None) is None
    assert SpeculativeConfig.from_value(False) is None
    assert SpeculativeConfig.from_value(True).k == 4
    d = SpeculativeConfig.from_value(True)
    assert (d.k, d.draft, d.ngram) == (4, "ngram", 3)
    assert SpeculativeConfig.from_value({"k": 2, "ngram": 1}).k == 2
    spec = SpeculativeConfig(k=3)
    assert SpeculativeConfig.from_value(spec) is spec
    with pytest.raises(AssertionError, match="speculative.k"):
        SpeculativeConfig.from_value({"k": 0})
    with pytest.raises(AssertionError, match="speculative.draft"):
        SpeculativeConfig.from_value({"draft": "model"})
    with pytest.raises(AssertionError, match="speculative.ngram"):
        SpeculativeConfig.from_value({"ngram": 0})
    with pytest.raises(ValueError, match="unknown serving.speculative"):
        SpeculativeConfig.from_value({"tokens": 3})
    # the JAX package refuses the same values
    with pytest.raises(AssertionError, match="speculative.k"):
        jserving.SpeculativeConfig.from_value({"k": 0})
    with pytest.raises(ValueError, match="unknown serving.speculative"):
        jserving.SpeculativeConfig.from_value({"tokens": 3})
    # the config key is ported: from_dict takes it and the engine arms it
    cfg = ServingConfig.from_dict({"batch_slots": 2, "speculative": {"k": 3, "ngram": 2}})
    assert cfg.speculative == {"k": 3, "ngram": 2}
    assert "speculative" not in serving.UNPORTED_KEYS
    srv = _port_server(_weights(), batch_slots=2, block_size=8,
                       speculative={"k": 3, "ngram": 2})
    assert (srv.spec.k, srv.spec.ngram) == (3, 2)
    assert _port_server(_weights(), batch_slots=2, speculative=False).spec is None


@pytest.mark.parametrize("k", [7, 8, 12])
def test_window_past_max_window_raises(k):
    """k + 1 <= MAX_WINDOW (8) is taken; beyond it the port raises
    NotImplementedError naming MAX_WINDOW (JAX scores any window), from
    the config and from the engine, with no fallback."""
    if k + 1 <= pa.MAX_WINDOW:
        assert SpeculativeConfig(k=k).k == k
        return
    with pytest.raises(NotImplementedError, match="MAX_WINDOW"):
        SpeculativeConfig(k=k)
    with pytest.raises(NotImplementedError, match="MAX_WINDOW=8"):
        _port_server(_weights(), batch_slots=2, speculative={"k": k})


# -------------------------------------------------------------- the drafter
def _histories(kind, rng):
    for n in (0, 1, 2, 3, 5, 9, 31, 200, DRAFT_WINDOW - 1, DRAFT_WINDOW + 77):
        if kind == "loopy":
            period = int(rng.integers(1, 7))
            yield np.tile(rng.integers(0, 50, (period,)), n // period + 1)[:n]
        else:
            yield rng.integers(0, 50 if kind == "small" else VOCAB, (n,))


@pytest.mark.parametrize("kind", ["loopy", "small", "random"])
def test_ngram_draft_equals_jax(kind):
    """The drafter over seeded histories (length 0 to past DRAFT_WINDOW,
    cut as the scheduler cuts them), k 1-7, ngram 1-4, equals JAX's."""
    assert DRAFT_WINDOW == jserving.DRAFT_WINDOW
    rng = np.random.default_rng({"loopy": 1, "small": 2, "random": 3}[kind])
    for h in _histories(kind, rng):
        h = list(h)[-DRAFT_WINDOW:]
        for k in range(1, 8):
            for ngram in range(1, 5):
                got = ngram_draft(h, k, ngram)
                want = jserving.ngram_draft(h, k, ngram)
                assert got.dtype == want.dtype == np.int32
                np.testing.assert_array_equal(got, want, err_msg=f"{len(h)} {k} {ngram}")


def test_ngram_draft_continuations():
    """JAX's own cases: the continuation of the tail's last previous
    occurrence, last-token repeat with no match, a pure function."""
    h = [5, 6, 7, 9, 5, 6, 7]
    np.testing.assert_array_equal(ngram_draft(h, 3, 3), [9, 5, 6])
    np.testing.assert_array_equal(ngram_draft(h, 3, 3), ngram_draft(np.asarray(h), 3, 3))
    np.testing.assert_array_equal(ngram_draft([1, 2, 3], 2, 3), [3, 3])
    np.testing.assert_array_equal(ngram_draft([], 2, 3), [0, 0])
    np.testing.assert_array_equal(ngram_draft([4, 4], 3, 1), [4, 4, 4])


# ------------------------------------------------------- greedy vs the JAX engine
def _greedy_traffic(max_seq):
    """Loopy prompts the drafter can hit and random ones it mostly
    cannot; at max_seq 47, requests that end at max_seq (their windows
    cross the table's end, S = 48)."""
    rng = np.random.default_rng(13)
    reqs = []
    for i in range(6):
        n = int(rng.integers(4, 14))
        toks = (np.tile(rng.integers(0, VOCAB, (2 + i % 3,)), 8)[:n] if i % 2 == 0
                else rng.integers(0, VOCAB, (n,)))
        new = int(rng.integers(3, 12))
        if max_seq == 47 and i < 4:
            toks = np.tile(rng.integers(0, VOCAB, (3,)), 14)[:36 + i]
            new = 47 - len(toks)
        reqs.append((toks, new))
    return reqs


_JAX_PLAIN = {}


def _jax_plain(kv_bits, max_seq, traffic):
    key = (kv_bits, max_seq)
    if key not in _JAX_PLAIN:
        srv = _jax_server(_weights(max_seq), max_seq, batch_slots=3, block_size=8,
                          kv_bits=kv_bits)
        res = srv.run([JRequest(tokens=t, max_new_tokens=n, uid=i)
                       for i, (t, n) in enumerate(traffic)])
        srv.close()
        _JAX_PLAIN[key] = {u: [int(x) for x in r["tokens"]] for u, r in res.items()}
    return _JAX_PLAIN[key]


@pytest.mark.parametrize("kv_bits,k,max_seq", [(16, 1, 256), (16, 3, 47), (8, 3, 256),
                                               (8, 7, 47), (16, 7, 256)])
def test_greedy_spec_streams_and_counts_equal_jax(kv_bits, k, max_seq):
    traffic = _greedy_traffic(max_seq)
    weights = _weights(max_seq)
    cfg = dict(batch_slots=3, block_size=8, kv_bits=kv_bits, speculative={"k": k, "ngram": 3})
    jsrv = _jax_server(weights, max_seq, **cfg)
    jres = jsrv.run([JRequest(tokens=t, max_new_tokens=n, uid=i)
                     for i, (t, n) in enumerate(traffic)])
    jst = jsrv.stats()["speculative"]
    jsrv.close()
    plain = _jax_plain(kv_bits, max_seq, traffic)
    srv = _port_server(weights, max_seq, **cfg)
    res = srv.run([Request(tokens=t, max_new_tokens=n, uid=i)
                   for i, (t, n) in enumerate(traffic)])
    for uid, (toks, new) in enumerate(traffic):
        want = [int(x) for x in jres[uid]["tokens"]]
        assert want == plain[uid], uid                  # JAX spec = JAX plain
        assert res[uid]["outcome"] == OK
        assert res[uid]["tokens"] == want, uid          # port spec = JAX spec
        assert res[uid]["spec"] == {key: int(v) for key, v in jres[uid]["spec"].items()}, uid
        if max_seq == 47 and uid < 4:
            assert len(toks) + new == max_seq
    st = srv.stats()["speculative"]
    assert st == {key: jst[key] for key in st}
    assert set(st) == {"k", "proposed", "accepted", "accept_rate", "tokens_per_step"}
    assert st["k"] == k and st["accepted"] > 0
    assert srv.allocator.free_blocks == srv.num_blocks - 1
    g = srv.stats()["graphs"]
    assert list(g["pool_bytes"])[0] == f"serving.decode[3x{srv.nb_max}x8,kv{kv_bits},spec{k}]"


def test_greedy_spec_equals_plain_on_both_decode_impls():
    """The captured-path bodies and the eager "unroll" path give the same
    streams, speculative or not, and speculation takes fewer steps."""
    traffic = _greedy_traffic(256)
    out = {}
    for impl in ("fused", "unroll"):
        for spec in (None, {"k": 4}):
            srv = _port_server(_weights(), decode_impl=impl, batch_slots=3, block_size=8,
                               speculative=spec)
            res = srv.run([Request(tokens=t, max_new_tokens=n, uid=i)
                           for i, (t, n) in enumerate(traffic)])
            out[impl, spec is None] = ({u: r["tokens"] for u, r in res.items()},
                                       srv.stats()["decode_steps"])
    assert len({str(v[0]) for v in out.values()}) == 1
    assert out["fused", False][1] < out["fused", True][1]


# ---------------------------------------------------------------- sampling
def _spec_reqs():
    """JAX's ``_spec_reqs`` at the tiny preset's vocab: loopy and random
    prompts, greedy and sampled, lengths that finish mid-window, 4
    requests over 2 slots."""
    rng = np.random.default_rng(9)
    reqs = []
    for i in range(4):
        if i % 2 == 0:
            toks = np.tile(rng.integers(0, VOCAB, (3 + i,)), 3)
        else:
            toks = rng.integers(0, VOCAB, (5 + i,))
        reqs.append(Request(tokens=toks, max_new_tokens=3 + i, seed=40 + i, uid=i,
                            do_sample=(i % 2 == 1), temperature=0.7))
    return reqs


def test_sampled_spec_equals_plain_under_permuted_arrivals():
    """JAX's ``test_speculative_token_identity_permuted_arrivals``: a
    sampled window position i draws with the plain path's index ngen + i,
    so speculative streams equal plain ones whatever the arrival order."""
    w = _weights()

    def run(spec, order):
        srv = _port_server(w, batch_slots=2, block_size=8, max_new_tokens=8, top_k=8,
                           speculative=spec)
        reqs = _spec_reqs()
        res = srv.run([reqs[j] for j in order])
        return {u: r["tokens"] for u, r in res.items()}, srv.stats(), res

    plain, _, _ = run(None, [0, 1, 2, 3])
    spec_a, st, recs = run({"k": 3, "ngram": 3}, [0, 1, 2, 3])
    spec_b, _, _ = run({"k": 3, "ngram": 3}, [2, 0, 3, 1])
    assert spec_a == plain and spec_b == plain
    assert st["speculative"]["k"] == 3 and st["speculative"]["proposed"] > 0
    assert 0.0 <= st["speculative"]["accept_rate"] <= 1.0
    for rec in recs.values():
        assert rec["spec"]["proposed"] >= rec["spec"]["accepted"] >= 0
    assert st["speculative"]["accepted"] > 0
    # a longer all-sampled run: accepted drafts among sampled rows too
    out = {}
    for spec in (None, {"k": 4}):
        srv = _port_server(w, batch_slots=2, block_size=8, top_k=4, speculative=spec)
        res = srv.run([Request(tokens=np.tile([5, 9, 2], 4), max_new_tokens=12, seed=s,
                               uid=s, do_sample=True, temperature=0.05) for s in range(3)])
        out[spec is None] = {u: r["tokens"] for u, r in res.items()}
        if spec:
            assert srv.stats()["speculative"]["accepted"] > 0
    assert out[True] == out[False]


# --------------------------------------------- eos, short requests, quarantine
def test_speculative_eos_and_short_requests_mid_window():
    """JAX's twin: an eos anywhere in the accepted window truncates where
    plain decode stops, max_new_tokens=1 finishes at prefill without
    drafting, and freed slots and blocks churn to queued work."""
    w = _weights()
    r = Request(tokens=np.tile(np.arange(4), 3), max_new_tokens=8, seed=0)
    ref = _port_server(w, batch_slots=1, block_size=8, max_new_tokens=8).run([r])[r.uid]
    ref = ref["tokens"]
    eos = int(ref[2])

    def run(spec):
        srv = _port_server(w, batch_slots=1, block_size=8, max_new_tokens=8,
                           eos_token_id=eos, speculative=spec)
        reqs = [Request(tokens=np.tile(np.arange(4), 3), max_new_tokens=8, seed=0, uid=0),
                Request(tokens=np.arange(5), max_new_tokens=1, seed=1, uid=1),
                Request(tokens=np.arange(6), max_new_tokens=5, seed=2, uid=2)]
        out = srv.run(reqs)
        free = srv.allocator.free_blocks == srv.num_blocks - 1
        return {u: rec["tokens"] for u, rec in out.items()}, free, out

    plain, free_p, _ = run(None)
    spec, free_s, recs = run({"k": 3})
    assert spec == plain
    assert plain[0] == ref[:ref.index(eos) + 1]
    assert len(plain[1]) == 1 and recs[1]["spec"] == {"proposed": 0, "accepted": 0}
    assert free_p and free_s


@pytest.mark.parametrize("victim_new", [6, 3])
def test_speculative_quarantine_mid_window(victim_new):
    """Twin of ``test_serving_resilience.py::test_speculative_quarantine_mid_stream``
    with the port's poisoning (the victim's blocks made NaN after its
    prefill): the victim comes back POISONED with its prefill token only,
    its neighbours keep a clean plain run's tokens, every block returns
    and the pool is finite.  With max_new 3 the victim's first window
    (k=4) runs past its own blocks into the shared scratch block, whose
    rows every slot reads masked: the port writes zeros there (JAX
    writes the NaN rows, and its neighbours come back POISONED too)."""
    w = _weights()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, (n,)) for n in (9, 11, 13, 7)]
    news = [10, 8, victim_new, 9]

    def run(spec, victim):
        srv = _port_server(w, batch_slots=4, block_size=8, speculative=spec)
        for i, p in enumerate(prompts):
            srv.submit(Request(tokens=p, uid=i, max_new_tokens=news[i]))
        srv._admit()
        if victim is not None:
            slot = next(i for i, s in enumerate(srv._slots)
                        if s is not None and s.req.uid == victim)
            idx = torch.as_tensor(srv._slots[slot].blocks)
            srv.pool["k"][:, idx] = float("nan")
            srv.pool["v"][:, idx] = float("nan")
        return srv.run(), srv

    clean, _ = run(None, None)
    res, srv = run({"k": 4, "ngram": 2}, 2)
    assert res[2]["outcome"] == POISONED
    assert res[2]["tokens"] == clean[2]["tokens"][:1]
    for u in (0, 1, 3):
        assert res[u]["outcome"] == OK and res[u]["tokens"] == clean[u]["tokens"], u
    assert srv.allocator.free_blocks == srv.num_blocks - 1
    assert srv.stats()["outcomes"][POISONED] == 1
    assert torch.isfinite(srv.pool["k"]).all() and torch.isfinite(srv.pool["v"]).all()


# ------------------------------------------------------------- int8 weights
def test_int8_weights_spec_equals_plain_and_jax():
    """int8 weights (``InferenceEngine(dtype=int8)``): port spec = port
    plain, and greedy streams = JAX's int8 speculative serve."""
    w = _weights()
    traffic = _greedy_traffic(256)
    cfg = dict(batch_slots=3, block_size=8, speculative={"k": 3})
    jsrv = _jax_server(w, engine_kw={"dtype": jnp.int8}, **cfg)
    jres = jsrv.run([JRequest(tokens=t, max_new_tokens=n, uid=i)
                     for i, (t, n) in enumerate(traffic)])
    jsrv.close()
    out = {}
    for spec in (None, {"k": 3}):
        srv = _port_server(w, engine_kw={"dtype": torch.int8}, batch_slots=3, block_size=8,
                           speculative=spec)
        assert srv.engine.quantized
        res = srv.run([Request(tokens=t, max_new_tokens=n, uid=i)
                       for i, (t, n) in enumerate(traffic)])
        assert all(r["outcome"] == OK for r in res.values())
        out[spec is None] = {u: r["tokens"] for u, r in res.items()}
    assert out[False] == out[True]
    assert out[False] == {u: [int(x) for x in r["tokens"]] for u, r in jres.items()}


# ------------------------------------------------ the step body and its graph
class _NoHostSync(torch.utils._python_dispatch.TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError(f"host sync in a step body: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_spec_body_makes_no_host_read(kv_bits):
    srv = _port_server(_weights(), batch_slots=2, block_size=8, kv_bits=kv_bits,
                       speculative={"k": 3})
    tables = torch.zeros((2, srv.nb_max), dtype=torch.int32)
    tables[0, :2], tables[1, :2] = torch.tensor([1, 2]), torch.tensor([3, 4])
    toks = torch.tensor([[5, 6, 7, 8], [9, 9, 9, 9]])
    with torch.no_grad(), _NoHostSync():
        logits, out, nonfin, accept = srv._decode_body(
            toks, tables, torch.tensor([13, 7], dtype=torch.int32))
    assert logits.shape == (2, 4, VOCAB) and out.shape == nonfin.shape == (2, 4)
    want = 1 + torch.cumprod((toks[:, 1:] == out[:, :-1]).long(), 1).sum(1)
    assert torch.equal(accept, want) and not nonfin.any()
    assert torch.equal(out, logits.argmax(-1))


class _ReplayGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay computes what a
    CUDA replay computes, the step's body over its static buffers, into
    its static outputs; like a CUDA replay it runs no Python, so the
    launch counters the body bumps are put back (the StepGraph adds the
    captured launches)."""

    def __init__(self, srv):
        self.srv, self.calls = srv, []

    def capture_begin(self, pool=None):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        steps = [self.srv._decode_step, *self.srv._prefills.values()]
        step = next(s for s in steps if s is not None and s._graph is self)
        counters = launch_counters()
        saved = [dict(c) for c in counters]
        for o, v in zip(step._outputs, step.body(**step.static)):
            o.copy_(v)
        for c, snap in zip(counters, saved):
            c.update(snap)
        self.calls.append("replay")


def test_spec_graph_bookkeeping(monkeypatch):
    """One ``spec{k}`` decode graph in place of the W=1 one; each replay
    and the warm-up add one step's launches (the capture's are taken
    back); the streams equal the direct bodies'; the pool bytes are
    reported per graph by name."""
    w = _weights()
    traffic = _greedy_traffic(256)
    real = pa.paged_attention

    def counted(*a, **kw):
        pa.launches["paged_attention_online_sm90"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(pa, "paged_attention", counted)
    reqs = lambda: [Request(tokens=t, max_new_tokens=n, uid=i)
                    for i, (t, n) in enumerate(traffic)]
    direct = _port_server(w, batch_slots=3, block_size=8, speculative={"k": 3}).run(reqs())
    srv = _port_server(w, batch_slots=3, block_size=8, speculative={"k": 3})
    graphs = []
    srv._graphs = GraphPool("cpu", graph_factory=lambda: graphs.append(_ReplayGraph(srv))
                            or graphs[-1])
    pa.reset_launches()
    res = srv.run(reqs())
    launches = dict(pa.launches)
    pa.reset_launches()
    assert {u: r["tokens"] for u, r in res.items()} == {u: r["tokens"]
                                                       for u, r in direct.items()}
    st = srv.stats()
    g = st["graphs"]
    dec = srv._decode_step
    assert dec.name == f"serving.decode[3x{srv.nb_max}x8,kv16,spec3]"
    assert dec.static["toks"].shape == (3, 4)
    assert (dec.captures, dec.warmups, dec.replays) == (1, 1, st["decode_steps"])
    assert g["graphs"] == 1 + len(srv._prefills) == len(graphs)
    assert g["decode_replays"] == st["decode_steps"] and g["decode_warmups"] == 1
    n_layer = srv.model.config.n_layer
    assert launches["paged_attention_online_sm90"] == (dec.replays + dec.warmups) * n_layer
    assert all(n == 0 for k, n in launches.items() if k != "paged_attention_online_sm90")
    assert set(g["pool_bytes"]) == {dec.name, *(s.name for s in srv._prefills.values())}
    assert all(graph.calls[:2] == ["begin", "end"] for graph in graphs)


@pytest.mark.parametrize("stage", ["capture", "replay"])
def test_spec_step_failures_raise_naming_the_step(stage):
    """A capture or replay of the spec step that fails raises, naming the
    step; nothing falls back to eager execution."""
    srv = _port_server(_weights(), batch_slots=2, block_size=8, speculative={"k": 3})
    made = []

    class Failing(_ReplayGraph):
        def capture_begin(self, pool=None):
            if stage == "capture":
                raise RuntimeError("operation not permitted when stream is capturing")

        def replay(self):
            raise RuntimeError("replay refused")

    def factory():        # the first graph is the prefill bucket's, the second the decode's
        made.append(Failing(srv) if made else _ReplayGraph(srv))
        return made[-1]

    srv._graphs = GraphPool("cpu", graph_factory=factory)
    name = rf"step serving\.decode\[2x{srv.nb_max}x8,kv16,spec3\]: CUDA graph {stage}"
    with pytest.raises(RuntimeError, match=name):
        srv.run([Request(tokens=np.arange(5), max_new_tokens=6)])
    assert srv._decode_step.replays == 0
