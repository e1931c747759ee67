"""The captured serving remainders on the CPU: ``generate``'s prefill as a
step graph (inference/engine.py, vs JAX ``InferenceEngine.generate``,
which jits its prefill), the tied head padded once per engine weight
(models/gpt2.py ``PaddedHead``, ``tied_head(padded=)``) and the graph
pool per graph in ``ServingEngine.stats()``.

On the CPU there is no CUDA graph: a stand-in graph re-runs the step's
body on replay, as a CUDA replay computes it, and puts back the launch
counters the body bumps (a replay runs no Python)."""

import gc

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import InferenceEngine as JInferenceEngine
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request, ServingConfig,
                                           ServingEngine)
from deepspeed_tpu_torch.inference.engine import TOKEN_STEPS_CAP
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models.gpt2 import GPT2, PaddedHead, params_from_jax, tied_head
from deepspeed_tpu_torch.runtime.step_graph import GraphPool, StepGraph, launch_counters

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
ODD_VOCAB = 1001          # not a multiple of 8: the 16-bit head takes a pad


def _weights(**kw):
    return JGPT2(preset="gpt2-tiny", dtype=jnp.float32, **kw).init_numpy(seed=0)


class ReplayGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: ``replay()`` runs the
    step's body over its static buffers into its static outputs, with the
    launch counters put back."""

    def __init__(self, steps):
        self.steps, self.calls = steps, []

    def capture_begin(self, pool=None):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")

    def replay(self):
        step = next(s for s in self.steps() if s is not None and s._graph is self)
        counters = launch_counters()
        saved = [dict(c) for c in counters]
        out = step.body(**step.static)
        for o, v in (zip(step._outputs, out) if isinstance(out, tuple)
                     else [(step._outputs, out)]):
            o.copy_(v)
        for c, snap in zip(counters, saved):
            c.update(snap)
        self.calls.append("replay")


def _engine_steps(eng):
    return lambda: [s for s, st in eng._token_steps.values()
                    for s in (s, *st["prefills"].values())]


def _graphed(eng):
    eng._graphs = GraphPool("cpu", graph_factory=lambda: ReplayGraph(_engine_steps(eng)))
    return eng


def _port_engine(weights=None, dtype=torch.float32, decode_impl="auto", **model_kw):
    weights = _weights(**model_kw) if weights is None else weights
    model = GPT2(preset="gpt2-tiny", dtype=dtype, device="cpu", decode_impl=decode_impl,
                 **model_kw)
    return InferenceEngine(model, params_from_jax(weights, "cpu", dtype))


# ------------------------------------------------- generate's captured prefill
@pytest.mark.parametrize("max_len", [None, 30])
def test_generate_prefill_is_a_step_graph_and_matches_jax(max_len):
    """``generate`` runs its prefill through a StepGraph per (B, T,
    max_len, do_sample) beside the token step: warmed up and captured
    once, replayed each call; the tokens equal JAX's (greedy) and the
    direct bodies' (sampled, the first token drawn after the replay)."""
    w = _weights()
    prompt = np.random.default_rng(5).integers(0, 1024, (2, 9))
    jeng = JInferenceEngine(JGPT2(preset="gpt2-tiny", dtype=jnp.float32, **NO_DROPOUT),
                            params=jax.tree_util.tree_map(jnp.asarray, w))
    want = np.asarray(jeng.generate(jnp.asarray(prompt, jnp.int32), max_new_tokens=7,
                                    max_len=max_len))
    eng = _graphed(_port_engine(w))
    for _ in range(2):
        np.testing.assert_array_equal(
            eng.generate(prompt, max_new_tokens=7, max_len=max_len).numpy(), want)
    ml = max_len or 16
    tok, st = eng._token_steps[(2, ml, False)]
    pre = st["prefills"][9]
    assert pre.name == f"generate.prefill[2x9,{ml},greedy]"
    assert pre.static["tokens"].shape == (2, 9)
    assert (pre.captures, pre.warmups, pre.replays) == (1, 1, 2)
    assert (tok.captures, tok.warmups, tok.replays) == (1, 1, 12)
    sampled = {}
    for graphed in (True, False):
        e = _port_engine(w)
        e = _graphed(e) if graphed else e
        sampled[graphed] = e.generate(prompt, 6, do_sample=True, top_k=10, temperature=0.8,
                                      seed=3)
    assert torch.equal(sampled[True], sampled[False])
    # "unroll" keeps the eager path: no prefill step
    eager = _port_engine(w, decode_impl="unroll")
    np.testing.assert_array_equal(
        eager.generate(prompt, max_new_tokens=7, max_len=max_len).numpy(), want)
    assert not eager._token_steps


def test_generate_steps_share_one_lru_cap():
    """Token steps, and each token step's prefills, keep at most
    TOKEN_STEPS_CAP graphs, least recently used out; a token step's
    eviction drops its prefills, which write its cache; evicted shapes
    rebuild and still decode right."""
    eng = _graphed(_port_engine())
    rng = np.random.default_rng(2)
    ref = {}
    for T in range(3, 3 + TOKEN_STEPS_CAP + 2):            # 10 prompt lengths, one max_len
        p = rng.integers(0, 1024, (1, T))
        ref[T] = (p, eng.generate(p, max_new_tokens=3, max_len=20))
        assert len(eng._token_steps[(1, 20, False)][1]["prefills"]) <= TOKEN_STEPS_CAP
    assert sorted(eng._token_steps[(1, 20, False)][1]["prefills"]) == list(range(5, 13))
    for ml in range(21, 21 + TOKEN_STEPS_CAP):              # 8 more token steps
        eng.generate(ref[12][0], max_new_tokens=3, max_len=ml)
    assert len(eng._token_steps) == TOKEN_STEPS_CAP and (1, 20, False) not in eng._token_steps
    assert all(list(st["prefills"]) == [12] for _, st in eng._token_steps.values())
    for T in (3, 12):
        p, want = ref[T]
        assert torch.equal(eng.generate(p, max_new_tokens=3, max_len=20), want)


# --------------------------------------------------- the head padded once
def test_padded_head_rules():
    """A copy only where the 16-bit head pads: odd vocab in bf16; none in
    fp32, for a vocab that is a multiple of 8 or for an int8 ``wte``."""
    wte = torch.randn(ODD_VOCAB, 16).to(torch.bfloat16)
    h = PaddedHead(wte, torch.bfloat16)
    assert h.weight.shape == (1008, 16) and h.weight.data_ptr() != wte.data_ptr()
    assert torch.equal(h.weight[:ODD_VOCAB], wte) and not h.weight[ODD_VOCAB:].any()
    assert PaddedHead(wte.float(), torch.float32).weight is None
    assert PaddedHead(torch.randn(1024, 16), torch.bfloat16).weight is None
    q = {"q": torch.zeros(ODD_VOCAB, 16, dtype=torch.int8), "scale": torch.ones(ODD_VOCAB)}
    assert PaddedHead(q, torch.bfloat16).weight is None
    # the padded weight gives the per-call head's logits, bit for bit
    x = torch.randn(5, 16).to(torch.bfloat16)
    assert torch.equal(tied_head(x, wte, h.weight), tied_head(x, wte))
    # an in-place write to wte reaches the copy at its next sync, at the same address
    ptr = h.weight.data_ptr()
    wte[3] = 7.0
    h.sync()
    assert h.weight.data_ptr() == ptr and torch.equal(h.weight[:ODD_VOCAB], wte)


def test_decode_bodies_read_one_padded_head(monkeypatch):
    """Serving (prefill and decode, plain and speculative) and
    ``generate`` (prefill and token step) hand the tied head the engine's
    one padded copy: no pad in any step, the same ``data_ptr`` through
    the serve, and an in-place write to ``wte`` followed before the next
    step."""
    w = _weights(vocab_size=ODD_VOCAB)
    eng = _port_engine(w, dtype=torch.bfloat16, vocab_size=ODD_VOCAB)
    eng.decode_head(eng.module, eng.params)        # the copy, made once
    seen, pads = [], []
    real_head, real_pad = tgpt2.tied_head, tgpt2._pad_vocab
    monkeypatch.setattr(tgpt2, "tied_head",
                        lambda x, wte, padded=None: seen.append(padded) or
                        real_head(x, wte, padded))
    monkeypatch.setattr(tgpt2, "_pad_vocab", lambda *a: pads.append(1) or real_pad(*a))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, ODD_VOCAB, (n,)) for n in (5, 12, 9)]
    for spec in (None, {"k": 3}):
        srv = ServingEngine(engine=eng, config=ServingConfig(
            batch_slots=2, block_size=8, max_new_tokens=5, speculative=spec))
        head = srv._head
        assert head is eng.decode_head(srv.model, eng.params)      # one per engine weight
        ptr = head.weight.data_ptr()
        res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
        assert all(r["outcome"] == OK for r in res.values())
        assert head.weight.data_ptr() == ptr
    eng.generate(np.stack([prompts[0], prompts[0]]), max_new_tokens=4)
    assert seen and all(p is head.weight for p in seen) and not pads
    # an in-place write to the engine's wte reaches the copy before the next step
    with torch.no_grad():
        eng.params["wte"][7] = 0.5
    srv = ServingEngine(engine=eng, config=ServingConfig(batch_slots=2, block_size=8,
                                                         max_new_tokens=3))
    srv.run([Request(tokens=prompts[1])])
    assert torch.equal(head.weight[:ODD_VOCAB], eng.params["wte"])
    assert head.weight.data_ptr() == ptr


def test_greedy_streams_unchanged_by_the_padded_head(monkeypatch):
    """A bf16 model with an odd vocab serves and generates the same
    greedy tokens with the padded copy as with the per-call pad."""
    w = _weights(vocab_size=ODD_VOCAB)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, ODD_VOCAB, (n,)) for n in (7, 13, 4, 10)]

    def run():
        eng = _port_engine(w, dtype=torch.bfloat16, vocab_size=ODD_VOCAB)
        srv = ServingEngine(engine=eng, config=ServingConfig(batch_slots=3, block_size=8,
                                                             max_new_tokens=8))
        res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
        gen = eng.generate(np.stack([prompts[0], prompts[0][::-1]]), max_new_tokens=6)
        return {u: r["tokens"] for u, r in res.items()}, gen, srv._head.weight

    padded, gen_padded, weight = run()
    assert weight is not None
    monkeypatch.setattr(GPT2, "decode_head",
                        lambda self, params: PaddedHead(params["wte"], torch.float32))
    per_call, gen_per_call, weight = run()
    assert weight is None
    assert padded == per_call and torch.equal(gen_padded, gen_per_call)


# --------------------------------------------------- graph pool per graph
def test_serving_stats_report_pool_bytes_per_graph():
    """``stats()["graphs"]["pool_bytes"]``: the decode step and each
    prefill bucket by name (what its capture added to the pool; 0 for
    the stand-in graphs of the CPU)."""
    w = _weights()
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")
    srv = ServingEngine(model=model, params=params_from_jax(w, "cpu", torch.float32),
                        config=ServingConfig(batch_slots=2, block_size=8, max_new_tokens=4))
    srv._graphs = GraphPool("cpu", graph_factory=lambda: ReplayGraph(
        lambda: [srv._decode_step, *srv._prefills.values()]))
    rng = np.random.default_rng(8)
    direct = ServingEngine(model=model, params=params_from_jax(w, "cpu", torch.float32),
                           config=ServingConfig(batch_slots=2, block_size=8, max_new_tokens=4))
    prompts = [rng.integers(0, 1024, (n,)) for n in (5, 12, 17)]
    reqs = lambda: [Request(tokens=p, uid=i) for i, p in enumerate(prompts)]
    res, ref = srv.run(reqs()), direct.run(reqs())
    assert {u: r["tokens"] for u, r in res.items()} == {u: r["tokens"] for u, r in ref.items()}
    g = srv.stats()["graphs"]
    names = {srv._decode_step.name, *(s.name for s in srv._prefills.values())}
    assert set(g["pool_bytes"]) == names and len(names) == 4 == g["graphs"]
    assert "serving.decode[2x32x8,kv16]" in names and "serving.prefill[24,kv16]" in names
    assert all(isinstance(b, int) and b == 0 for b in g["pool_bytes"].values())
    assert direct.stats()["graphs"]["pool_bytes"] == {
        n: 0 for n in {direct._decode_step.name, *(s.name for s in direct._prefills.values())}}


# ------------------------------------------- no garbage collection in a capture
def test_no_garbage_collection_inside_a_capture():
    """No collection runs between ``capture_begin`` and ``capture_end``
    (on the card, an earlier engine's graph freed inside another's
    capture invalidates it), though the same body's warm-up collects;
    the collector's state is restored after."""
    state = {"capturing": False, "in_capture": 0, "outside": 0}

    def on_gc(phase, info):
        if phase == "start":
            state["in_capture" if state["capturing"] else "outside"] += 1

    class Probe:
        def capture_begin(self, pool=None):
            state["capturing"] = True

        def capture_end(self):
            state["capturing"] = False

        def replay(self):
            pass

    def body(x):
        for _ in range(2000):           # cyclic garbage: collections come due
            cell = []
            cell.append(cell)
        return x * 2

    threshold = gc.get_threshold()
    gc.callbacks.append(on_gc)
    gc.set_threshold(10)
    try:
        for enabled in (True, False):
            (gc.enable if enabled else gc.disable)()
            state.update(in_capture=0, outside=0)
            step = StepGraph("probe", body, {"x": torch.zeros(2)}, "cpu",
                             GraphPool("cpu", graph_factory=Probe))
            step(x=np.ones(2, np.float32))
            assert step.captured and state["in_capture"] == 0
            assert gc.isenabled() == enabled and (state["outside"] > 0) == enabled
    finally:
        gc.callbacks.remove(on_gc)
        gc.set_threshold(*threshold)
        gc.enable()
