"""Activation checkpointing in the port
(``runtime/activation_checkpointing/checkpointing.py``) against the JAX
package's, on the CPU.

Twins of ``tests/test_activation_checkpointing.py:36-121`` (all but
``test_partition_activations_under_mesh``, which needs world size > 1):
a checkpointed MLP's loss and gradients equal to the unwrapped one's and
to JAX's ``checkpoint`` (1e-6 / 1e-5: another order of fp32 sums), the
region saving no intermediate, the config block, the contiguous-buffer
assertion, the RNG tracker's streams and ``model_parallel_seed``.  Then
the port's own: ``cpu_checkpointing`` keeps the ``ckpt`` marks on the
host and prunes their producers from the recompute;
``partition_activations`` at world size 1 changes nothing;
``checkpoint_wrapper``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from deepspeed_tpu.runtime.activation_checkpointing import checkpointing as jckpt

from deepspeed_tpu_torch.models.gpt2 import checkpoint_name
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig


@pytest.fixture(autouse=True)
def _reset_config():
    ckpt.configure(None)
    yield
    ckpt.configure(None)


def _mlp(w1, w2, x):
    return torch.tanh(x @ w1) @ w2


def _marked_mlp(w1, w2, x):
    return checkpoint_name(torch.tanh(x @ w1), "ckpt") @ w2


def _setup(seed=0, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(d, 4 * d)).astype(np.float32),
            rng.normal(size=(4 * d, d)).astype(np.float32),
            rng.normal(size=(8, d)).astype(np.float32))


def _loss_and_grads(fn, arrays, wrap):
    w1, w2, x = (torch.tensor(a, requires_grad=i < 2) for i, a in enumerate(arrays))
    out = wrap(fn, w1, w2, x) if wrap else fn(w1, w2, x)
    loss = (out ** 2).sum()
    loss.backward()
    return loss.item(), w1.grad, w2.grad


def test_checkpoint_matches_plain_and_jax():
    arrays = _setup()
    lp, *gp = _loss_and_grads(_mlp, arrays, None)
    lc, *gc = _loss_and_grads(_mlp, arrays, ckpt.checkpoint)
    assert lp == lc
    for a, b in zip(gp, gc):
        assert torch.equal(a, b)

    def jloss(w1, w2, x):
        return jnp.sum(jckpt.checkpoint(lambda a, b, c: jnp.tanh(c @ a) @ b, w1, w2, x) ** 2)
    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1))(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(lc, float(jl), rtol=1e-6)
    for a, b in zip(gc, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-3)


def test_checkpoint_saves_no_intermediate():
    """The twin of ``test_checkpoint_reduces_saved_residuals``: outside the
    region autograd keeps only what the region's output needs; without the
    checkpoint it also keeps the region's intermediates (tanh's output,
    the matmul inputs)."""
    arrays = _setup(d=32)

    def saved(wrap):
        count = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: count.append(t) or t,
                                                      lambda t: t):
            _loss_and_grads(_mlp, arrays, wrap)
        return len(count)
    assert saved(ckpt.checkpoint) < saved(None)


def test_configure_from_json():
    ckpt.configure(None, deepspeed_config={
        "train_micro_batch_size_per_gpu": 1,
        "activation_checkpointing": {"partition_activations": True,
                                     "cpu_checkpointing": False, "profile": True}})
    assert ckpt.PARTITION_ACTIVATIONS is True and ckpt.CPU_CHECKPOINT is False
    assert ckpt.PROFILE_TIME is True and ckpt.is_configured()


def test_config_block_parsed_as_jax():
    """The block no longer raises; its fields are JAX's."""
    from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
    pd = {"train_batch_size": 8, "activation_checkpointing": {
        "partition_activations": True, "cpu_checkpointing": True, "number_checkpoints": 4,
        "contiguous_memory_optimization": True, "synchronize_checkpoint_boundary": True}}
    t, j = DeepSpeedConfig(pd).activation_checkpointing, JConfig(pd, world_size=1)
    j = j.activation_checkpointing
    for key in ("partition_activations", "contiguous_memory_optimization",
                "cpu_checkpointing", "number_checkpoints",
                "synchronize_checkpoint_boundary", "profile"):
        assert getattr(t, key) == getattr(j, key), key


def test_contiguous_requires_partition():
    with pytest.raises(AssertionError):
        ckpt.configure(None, contiguous_checkpointing=True, partition_activations=False,
                       num_checkpoints=2)


def test_rng_tracker_fork_streams():
    tr = ckpt.get_rng_tracker()
    tr.reset()
    tr.add("model-parallel-rng", 42)
    with tr.fork() as g1:
        d1 = torch.randn(4, generator=g1)
    with tr.fork() as g2:
        d2 = torch.randn(4, generator=g2)
    assert not torch.equal(d1, d2)
    tr.reset()
    tr.add("model-parallel-rng", 42)
    with tr.fork() as g1:
        assert torch.equal(torch.randn(4, generator=g1), d1)     # a pure function of (seed, count)
    with pytest.raises(Exception):
        tr.add("model-parallel-rng", 1)
    with pytest.raises(Exception):
        tr.add("other", 42)
    assert ckpt.get_cuda_rng_tracker() is tr


def test_model_parallel_seed_sets_streams():
    ckpt.model_parallel_seed(1234, tensor_axis_index=3)
    states = ckpt.get_rng_tracker().get_states()
    assert states["data-parallel-rng"][1] == 1234
    assert states["model-parallel-rng"][1] == 1234 + 2718 + 3


def test_cpu_checkpointing_offloads_marked_tensors():
    """``cpu_checkpointing`` (JAX ``save_and_offload_only_these_names(
    ["ckpt"])``) is on from the argument and from the config block; a
    region with a ``ckpt`` mark keeps the marked tensor on the host, its
    recompute prunes the ops that only feed the mark (the matmul and the
    tanh: the tanh's result is the mark's value, the matmul's output is
    saved by nothing), and its loss and gradients equal the plain run's."""
    for kwargs in ({"checkpoint_in_cpu": True},
                   {"deepspeed_config": {"train_micro_batch_size_per_gpu": 1,
                                         "activation_checkpointing": {
                                             "cpu_checkpointing": True}}}):
        ckpt.configure(None, **kwargs)
        assert ckpt.CPU_CHECKPOINT is True
        ckpt.configure(None)
        assert ckpt.CPU_CHECKPOINT is False
    arrays = _setup(1)
    lp, *gp = _loss_and_grads(_marked_mlp, arrays, None)
    ckpt.configure(None, checkpoint_in_cpu=True)
    lc, *gc = _loss_and_grads(_marked_mlp, arrays, ckpt.checkpoint)
    assert lp == lc and all(torch.equal(a, b) for a, b in zip(gp, gc))
    st = ckpt.last_stats
    assert st["pruned"] == ["aten.mm.default", "aten.tanh.default"] and st["skipped"] == 2
    (mark,) = st["marks"]
    assert mark.device.type == "cpu" and mark.shape == (8, 64)


def test_partition_activations_one_device_is_identity():
    arrays = _setup(2)
    base = _loss_and_grads(_mlp, arrays, ckpt.checkpoint)
    ckpt.partition_activations_in_checkpoint(True)
    part = _loss_and_grads(_mlp, arrays, ckpt.checkpoint)
    assert base[0] == part[0] and all(torch.equal(a, b) for a, b in zip(base[1:], part[1:]))


def test_checkpoint_wrapper_and_layers():
    arrays = _setup(3)
    wrapped = ckpt.checkpoint_wrapper(_mlp)
    a = _loss_and_grads(wrapped, arrays, None)
    b = _loss_and_grads(_mlp, arrays, None)
    assert a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))
    ckpt.set_num_layers(7)
    assert ckpt.num_layers == 7
    ckpt.reset()
