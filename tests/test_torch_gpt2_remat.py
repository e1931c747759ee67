"""GPT-2's ``remat_policy`` and ``loss_chunk`` (``models/gpt2.py`` of the
port) against the JAX package's same configuration and against the
port's own run without them, in fp32 on the CPU.

``remat_policy`` "dots" and "names:attn_out,mlp_fc" and ``loss_chunk``
(a chunk that divides B*T and one that does not): the loss and the
gradients of every parameter, and the final-LN hidden states the chunked
loss reads.  Against JAX within ``test_torch_train.py``'s GPT-2
tolerances (1e-5 relative to the largest value: fp32 sums in another
order).  Against the port's own plain run (``remat=True`` with no
policy, ``loss_chunk=0``): a remat policy bit for bit, as JAX's own
comparison is (the same values recomputed or saved); the chunked loss,
which sums its chunks in another order than the plain mean in both
packages (bit-equal in neither in general), within the same 1e-5.  The "dots" policy is also run through the flash
attention function (its plain version here), which a selective policy
must recompute, and the number of ``aten.mm`` calls shows that it saves
the weight products."""

import collections

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2

from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax, resolve_remat_policy
from deepspeed_tpu_torch.runtime.utils import tree_leaves

NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOL = 1e-5
TOKENS = np.random.default_rng(4).integers(0, 1024, (2, 33)).astype(np.int32)   # B*T = 64
NP_PARAMS = JGPT2(preset="gpt2-tiny", max_seq=64).init_numpy(seed=0)
OPTIONS = {"dots": dict(remat=True, remat_policy="dots"),
           "names": dict(remat=True, remat_policy="names:attn_out,mlp_fc"),
           "chunk16": dict(loss_chunk=16),                  # divides B*T
           "chunk22": dict(loss_chunk=22)}                  # does not: two masked pad rows
PLAIN = dict(remat=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _port(count=False, **kw):
    """(loss, grads, hidden states, aten op counts) of the port's gpt2-tiny."""
    tm = GPT2(preset="gpt2-tiny", dtype=torch.float32, device="cpu", max_seq=64,
              **dict(NO_DROPOUT, **kw))
    tp = params_from_jax(NP_PARAMS, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_(True)
    toks = torch.from_numpy(TOKENS)
    mode = _CountOps()
    if count:
        with mode:
            loss = tm.loss(tp, toks, 0)
            loss.backward()
    else:
        loss = tm.loss(tp, toks, 0)
        loss.backward()
    with torch.no_grad():
        hidden = tm.apply(tp, toks[:, :-1], return_hidden=True)
    return (loss.detach().numpy(), [leaf.grad.numpy() for leaf in tree_leaves(tp)],
            hidden.numpy(), mode.counts)


def _jax(**kw):
    jm = JGPT2(preset="gpt2-tiny", dtype=jnp.float32, max_seq=64, **dict(NO_DROPOUT, **kw))
    toks = jnp.asarray(TOKENS)

    def f(p):
        return jm.loss(p, toks, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray, NP_PARAMS)
    loss, grads = jax.jit(jax.value_and_grad(f))(params)
    hidden = jax.jit(lambda p: jm.apply(p, toks[:, :-1], return_hidden=True))(params)
    return (np.asarray(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            np.asarray(hidden))


@pytest.fixture(scope="module")
def plains():
    return {"port": _port(count=True, **PLAIN), "jax": _jax(**PLAIN)}


def _close(got, want, what):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-30), f"{what}: {err}"


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax_and_the_plain_run(name, plains):
    kw = OPTIONS[name]
    port, jx = _port(**kw), _jax(**kw)
    _close(port[0], jx[0], "loss vs jax")
    _close(port[2], jx[2], "hidden vs jax")
    for i, (a, b) in enumerate(zip(port[1], jx[1])):
        _close(a, b, f"grad {i} vs jax")
    # against the plain runs: a remat policy changes no value in either package; the
    # chunked loss sums its chunks in another order than the mean (JAX's too)
    jp, pp = plains["jax"], plains["port"]
    remat = name in ("dots", "names")
    for what, got, base, jgot, jbase in (
            ("loss", [port[0]], [pp[0]], [jx[0]], [jp[0]]),
            ("hidden", [port[2]], [pp[2]], [jx[2]], [jp[2]]),
            ("grads", port[1], pp[1], jx[1], jp[1])):
        for i, (g, b, jg, jb) in enumerate(zip(got, base, jgot, jbase)):
            if remat:
                assert np.array_equal(jg, jb) and np.array_equal(g, b), \
                    f"{name}: {what} {i} not bit-equal to the plain run"
            else:
                _close(g, b, f"{name}: {what} {i} vs the plain run")
                _close(jg, jb, f"{name}: JAX's {what} {i} vs its plain run")


def test_dots_saves_the_weight_products_and_recomputes_flash_attention(plains):
    """"dots" runs the block's four weight products once (their outputs
    saved: the mm count of a run without remat), the plain recompute runs
    them again; through the flash attention function the gradients stay
    bit-equal to a run without remat."""
    mm = torch.ops.aten.mm.default
    no_remat = _port(count=True, remat=False)
    dots = _port(count=True, **OPTIONS["dots"])
    assert dots[3][mm] == no_remat[3][mm] < plains["port"][3][mm]
    flash = _port(remat=False, attention_impl="flash")
    flash_dots = _port(attention_impl="flash", **OPTIONS["dots"])
    assert np.array_equal(flash[0], flash_dots[0])
    assert all(np.array_equal(a, b) for a, b in zip(flash[1], flash_dots[1]))


def test_unknown_policy_raises_jax_error():
    with pytest.raises(ValueError, match="unknown remat_policy 'bogus'"):
        resolve_remat_policy("bogus")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        _port(remat=True, remat_policy="bogus")
    _port(remat=False, remat_policy="bogus")       # JAX resolves it only with remat
