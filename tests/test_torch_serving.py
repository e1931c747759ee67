"""The port's ServingEngine against the JAX one on the CPU
(deepspeed_tpu_torch/inference/serving.py vs deepspeed_tpu/inference/serving.py).

Greedy serving of ``gpt2-tiny`` in fp32 with the same weights must give
identical per-request token streams, and the port must recycle every
block.  Sampling keeps the JAX package's within-package contract (tokens
depend on the request alone, whatever the arrival order); the bits differ
from JAX's by design."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.inference import (ServingConfig as JServingConfig,
                                     ServingEngine as JServingEngine,
                                     Request as JRequest)
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, POISONED,
                                           QueueFullError, Request,
                                           ServingConfig, ServingEngine,
                                           ServingStalledError)
from deepspeed_tpu_torch.inference.serving import UNPORTED_KEYS
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax


@pytest.fixture(scope="module")
def weights():
    return JGPT2(preset="gpt2-tiny", dtype=jnp.float32).init_numpy(seed=0)


def _port_engine(weights, **cfg):
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")
    return ServingEngine(model=model,
                         params=params_from_jax(weights, "cpu", torch.float32),
                         config=ServingConfig(**cfg))


def _prompts():
    rng = np.random.default_rng(7)
    return [rng.integers(0, 1024, (int(n),)) for n in
            rng.integers(5, 15, (6,))]


def test_greedy_serving_token_identical_to_jax(weights, devices):
    prompts = _prompts()
    cfg = dict(batch_slots=4, block_size=8, max_new_tokens=12)
    jsrv = JServingEngine(
        model=JGPT2(preset="gpt2-tiny", dtype=jnp.float32, embd_pdrop=0.0,
                    attn_pdrop=0.0, resid_pdrop=0.0),
        params=jax.tree_util.tree_map(jnp.asarray, weights),
        config=JServingConfig(**cfg))
    jres = jsrv.run([JRequest(tokens=p, uid=i) for i, p in enumerate(prompts)])
    jsrv.close()
    srv = _port_engine(weights, **cfg)
    res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
    assert len(res) == len(prompts)
    for uid in range(len(prompts)):
        assert res[uid]["outcome"] == OK
        assert len(res[uid]["tokens"]) == 12
        assert res[uid]["tokens"] == [int(t) for t in jres[uid]["tokens"]], uid
    assert srv.allocator.free_blocks == srv.num_blocks - 1
    st = srv.stats()
    assert st["completed"] == 6 and st["pending"] == 0
    assert st["generated_tokens"] == 72
    assert st["step_ms"]["p50"] > 0 and st["ttft_ms"]["p99"] > 0


def test_serving_matches_sequential_generate(weights):
    """Greedy answers equal the sequential InferenceEngine.generate."""
    prompts = _prompts()[:3]
    srv = _port_engine(weights, batch_slots=2, block_size=8, max_new_tokens=6,
                       kv_bits=16)
    res = srv.run([Request(tokens=p) for p in prompts])
    eng = srv.engine
    for uid, p in enumerate(prompts):
        ref = eng.generate(p[None], max_new_tokens=6)[0, len(p):].tolist()
        assert res[uid]["tokens"] == ref


def test_int8_kv_serving_completes_and_recycles(weights):
    srv = _port_engine(weights, batch_slots=3, block_size=8, max_new_tokens=5,
                       kv_bits=8, num_blocks=9)
    res = srv.run([Request(tokens=p) for p in _prompts()])
    assert all(r["outcome"] == OK and len(r["tokens"]) == 5
               for r in res.values())
    assert srv.allocator.free_blocks == 8


def test_arrival_order_determinism(weights):
    """Sampled requests arriving in different orders give identical
    per-request tokens: each stream depends on (seed, index) alone."""
    def run_order(order):
        srv = _port_engine(weights, batch_slots=2, block_size=8,
                           max_new_tokens=5, top_k=8)
        reqs = [Request(tokens=np.arange(3 + i) % 100, max_new_tokens=5,
                        seed=100 + i, do_sample=True, temperature=0.7, uid=i)
                for i in range(4)]
        out = srv.run([reqs[j] for j in order])
        return {u: r["tokens"] for u, r in out.items()}

    a = run_order([0, 1, 2, 3])
    assert a == run_order([3, 1, 0, 2])
    assert len({tuple(t) for t in a.values()}) > 1


@pytest.mark.parametrize("key", sorted(UNPORTED_KEYS))
def test_unported_config_key_raises(key):
    with pytest.raises(NotImplementedError, match=key):
        ServingConfig.from_dict({"batch_slots": 2, key: None})


def test_unknown_config_key_raises():
    with pytest.raises(ValueError, match="unknown serving config keys"):
        ServingConfig.from_dict({"batch_slot": 2})
    assert ServingConfig.from_dict({"kv_bits": 8}).kv_bits == 8


def test_poisoned_decode_is_evicted_and_neighbours_unchanged(weights):
    """A slot whose own pool blocks turn non-finite after prefill comes
    back POISONED at its first decode step, its blocks scrubbed and
    returned, while every neighbour's tokens equal a clean run's."""
    prompts = _prompts()[:4]

    def run(victim):
        srv = _port_engine(weights, batch_slots=4, block_size=8,
                           max_new_tokens=6)
        for i, p in enumerate(prompts):
            srv.submit(Request(tokens=p, uid=i))
        srv._admit()
        if victim is not None:
            slot = next(i for i, s in enumerate(srv._slots)
                        if s is not None and s.req.uid == victim)
            idx = torch.as_tensor(srv._slots[slot].blocks)
            srv.pool["k"][:, idx] = float("nan")
            srv.pool["v"][:, idx] = float("nan")
        res = srv.run()
        assert srv.allocator.free_blocks == srv.num_blocks - 1
        assert not torch.isnan(srv.pool["k"]).any()
        return res

    clean, poisoned = run(None), run(2)
    assert poisoned[2]["outcome"] == POISONED
    assert poisoned[2]["tokens"] == clean[2]["tokens"][:1]   # prefill token
    for uid in (0, 1, 3):
        assert poisoned[uid]["outcome"] == OK
        assert poisoned[uid]["tokens"] == clean[uid]["tokens"]


def test_prompt_with_infinite_embedding_is_poisoned_neighbours_unchanged(
        weights):
    """A request whose prompt holds a token whose ``wte`` row is inf
    comes back POISONED from its prefill and never takes a slot, while
    the requests decoding beside it keep a clean run's tokens.  The head
    is tied to ``wte``, so the row is inf only while the victim's prefill
    runs (otherwise every slot's logits would hold it).  The request
    admitted next is handed the victim's scrubbed blocks (the free list
    is LIFO): the block the victim's prefill wrote becomes its decode
    block, whose masked tail it reads."""
    prompts = _prompts()[:3]
    late = np.asarray(_prompts()[3][:6])

    def run(with_victim):
        srv = _port_engine(weights, batch_slots=4, block_size=8,
                           max_new_tokens=6)
        for i, p in enumerate(prompts):
            srv.submit(Request(tokens=p, uid=i))
        srv.step()
        got, alloc = [], srv._alloc_blocks
        srv._alloc_blocks = lambda n: got.append(alloc(n)) or got[-1]
        if with_victim:
            wte = srv.engine.params["wte"]
            row = wte[17].clone()
            wte[17] = float("inf")
            srv.submit(Request(tokens=np.asarray([3, 17, 5]), uid=9))
            srv._admit()
            wte[17] = row
        srv.submit(Request(tokens=late, uid=3))
        srv._admit()
        if with_victim:
            assert got[1][1] == got[0][0]
        res = srv.run()
        assert srv.allocator.free_blocks == srv.num_blocks - 1
        assert torch.isfinite(srv.pool["k"]).all()
        return res, srv

    clean, _ = run(False)
    poisoned, srv = run(True)
    assert poisoned[9]["outcome"] == POISONED
    assert poisoned[9]["tokens"] is None
    assert srv.stats()["outcomes"][POISONED] == 1
    for uid in (0, 1, 2, 3):
        assert poisoned[uid]["outcome"] == OK
        assert poisoned[uid]["tokens"] == clean[uid]["tokens"]


def test_submit_validation_queue_and_pop(weights):
    srv = _port_engine(weights, batch_slots=1, block_size=8, max_new_tokens=4,
                       max_queue=2)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit(Request(tokens=[]))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        srv.submit(Request(tokens=np.zeros(250), max_new_tokens=10))
    a = srv.submit(Request(tokens=[1, 2, 3]))
    srv.submit(Request(tokens=[4, 5]))
    with pytest.raises(QueueFullError):
        srv.submit(Request(tokens=[6]))
    with pytest.raises(ValueError, match="already submitted"):
        srv.submit(Request(tokens=[6], uid=a))
    with pytest.raises(RuntimeError, match="in flight"):
        srv.pop_result(a)
    srv.run()
    assert srv.pop_result(a)["outcome"] == OK
    with pytest.raises(KeyError):
        srv.pop_result(a)


def test_stall_is_reported(weights):
    srv = _port_engine(weights, batch_slots=1, block_size=8, max_new_tokens=4,
                       num_blocks=3)
    srv.allocator.alloc(2)          # leak the pool: admission cannot proceed
    srv.submit(Request(tokens=[1, 2, 3]))
    with pytest.raises(ServingStalledError, match="needs 1 block"):
        srv.step()


def test_sampled_generate_is_seeded(weights):
    model = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu")
    eng = InferenceEngine(model, params_from_jax(weights, "cpu",
                                                 torch.float32))
    prompt = np.asarray([[1, 2, 3], [4, 5, 6]])
    a = eng.generate(prompt, 5, do_sample=True, top_k=10, seed=3)
    assert torch.equal(a, eng.generate(prompt, 5, do_sample=True, top_k=10,
                                       seed=3))
    assert not torch.equal(a, eng.generate(prompt, 5, do_sample=True,
                                           top_k=10, seed=4))
