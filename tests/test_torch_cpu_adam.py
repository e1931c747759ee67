"""The port's host optimizers (``ops/adam/cpu_adam.py``,
``ops/adagrad/cpu_adagrad.py``, built by ``ops/op_builder/builder.py``)
against the JAX package's, on the CPU.

Twins of ``tests/test_native_ops.py:105-268``.  Both packages compile the
repo's ``csrc/adam/ds_cpu_adam.cpp`` with the same g++ and flags and call
it on the same numpy inputs, so the master, the moments, the bf16 and
fp16 copy-back and Adagrad's rows are held **bit-equal** to the JAX
package's; against ``torch.optim`` and the plain torch step, within the
JAX tests' tolerances (another order of fp32 operations).
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu.ops.adam.cpu_adam import DeepSpeedCPUAdam as JCPUAdam
from deepspeed_tpu.ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad as JCPUAdagrad
from deepspeed_tpu.ops.op_builder import CPUAdamBuilder as JCPUAdamBuilder

from deepspeed_tpu_torch.ops.adam.cpu_adam import (DeepSpeedCPUAdam, DeepSpeedCPUAdamW,
                                                   adam_step_plain, host_memcpy, widen_bf16)
from deepspeed_tpu_torch.ops.adagrad.cpu_adagrad import AdagradState, DeepSpeedCPUAdagrad
from deepspeed_tpu_torch.ops.op_builder import builder


def _adam_pair(seed, n):
    rng = np.random.RandomState(seed)
    p0 = rng.randn(n).astype(np.float32)
    grads = [rng.randn(n).astype(np.float32) for _ in range(5)]
    return p0, grads


@pytest.mark.parametrize("adamw", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cpu_adam_bit_equal_to_jax(adamw, wd):
    """``test_cpu_adam_matches_torch``'s run: master and moments bit-equal
    to JAX's native step over 5 steps, and torch.optim within 2e-5."""
    n = 4099                     # odd: the vector tails
    p0, grads = _adam_pair(0, n)
    ours = DeepSpeedCPUAdam(lr=1e-2, weight_decay=wd, adamw_mode=adamw)
    ref = JCPUAdam(lr=1e-2, weight_decay=wd, adamw_mode=adamw)
    assert ref.is_native
    p, (m, v) = p0.copy(), ours.init_buffers(n)
    jp, (jm, jv) = p0.copy(), ref.init_buffers(n)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = (torch.optim.AdamW if adamw else torch.optim.Adam)([tp], lr=1e-2, weight_decay=wd)
    for step, g in enumerate(grads, 1):
        ours.step_flat(p, g, m, v, step)
        ref.step_flat(jp, g, jm, jv, step)
        tp.grad = torch.from_numpy(g.copy())
        topt.step()
    for a, b in ((p, jp), (m, jm), (v, jv)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(p, tp.detach().numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("out_dtype", ["bfloat16", "float16"])
def test_cpu_adam_fused_copyback_bit_equal(out_dtype):
    """The 16-bit copy-back: the words JAX's step writes, and the cast of
    the updated master (RNE) as torch and numpy compute it."""
    n = 1025
    rng = np.random.RandomState(1)
    p0, g = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    ours, ref = DeepSpeedCPUAdam(lr=1e-2), JCPUAdam(lr=1e-2)
    p, jp = p0.copy(), p0.copy()
    (m, v), (jm, jv) = ours.init_buffers(n), ref.init_buffers(n)
    out, jout = np.zeros(n, np.uint16), np.zeros(n, np.uint16)
    ours.step_flat(p, g, m, v, 1, out16=out, out_dtype=out_dtype)
    ref.step_flat(jp, g, jm, jv, 1, out16=jout, out_dtype=out_dtype)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(p, jp)
    tdt = torch.bfloat16 if out_dtype == "bfloat16" else torch.float16
    cast = torch.from_numpy(p).to(tdt).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(out, cast)
    jdt = jnp.bfloat16 if out_dtype == "bfloat16" else jnp.float16
    np.testing.assert_array_equal(out, np.asarray(jnp.asarray(p).astype(jdt)).view(np.uint16))


def test_cpu_adam_takes_tensors_and_torch_16bit_out():
    """CPU tensors (fp32 buffers, a bf16 payload tensor) take the numpy
    arrays' place and give the same bytes."""
    n = 777
    p0, grads = _adam_pair(3, n)
    opt = DeepSpeedCPUAdamW(lr=3e-3, weight_decay=0.05)
    p, (m, v) = p0.copy(), opt.init_buffers(n)
    tp = torch.from_numpy(p0.copy())
    tm, tv = torch.zeros(n), torch.zeros(n)
    out, tout = np.zeros(n, np.uint16), torch.zeros(n, dtype=torch.bfloat16)
    for step, g in enumerate(grads[:3], 1):
        opt.step_flat(p, g, m, v, step, out16=out, out_dtype="bfloat16")
        opt.step_flat(tp, torch.from_numpy(g), tm, tv, step, out16=tout,
                      out_dtype="bfloat16")
    np.testing.assert_array_equal(tp.numpy(), p)
    np.testing.assert_array_equal(tm.numpy(), m)
    np.testing.assert_array_equal(tout.view(torch.int16).numpy().view(np.uint16), out)
    with pytest.raises(ValueError, match="contiguous"):
        opt.step_flat(tp[::2], tp[::2].clone(), tm[::2], tv[::2], 4)
    with pytest.raises(ValueError, match="sizes differ"):
        opt.step_flat(p, grads[0][:-1], m, v, 4)


def test_native_matches_plain_torch_step():
    """``test_native_matches_numpy_fallback``'s run against the plain torch
    version of the step (the tests' oracle; the port has no fallback)."""
    n = 777
    rng = np.random.RandomState(3)
    p0, g = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    nat = DeepSpeedCPUAdam(lr=3e-3, weight_decay=0.05, adamw_mode=True)
    p, (m, v) = p0.copy(), nat.init_buffers(n)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(n), torch.zeros(n)
    for step in range(1, 4):
        nat.step_flat(p, g, m, v, step)
        adam_step_plain(tp, torch.from_numpy(g), tm, tv, step, 3e-3, weight_decay=0.05)
    np.testing.assert_allclose(p, tp.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(v, tv.numpy(), rtol=1e-6, atol=1e-12)


def test_cpu_adagrad_bit_equal_to_jax_and_torch():
    """``test_cpu_adagrad_native`` / ``_matches_torch``: dense host Adagrad
    bit-equal to JAX's, torch.optim.Adagrad within 1e-5."""
    n = 513
    rng = np.random.RandomState(7)
    p0 = rng.randn(n).astype(np.float32)
    ours, ref = DeepSpeedCPUAdagrad(lr=0.05, eps=1e-10), JCPUAdagrad(lr=0.05, eps=1e-10)
    assert ref.is_native
    p, jp = p0.copy(), p0.copy()
    s, js = np.zeros(n, np.float32), np.zeros(n, np.float32)
    tp = torch.nn.Parameter(torch.tensor(p0.copy()))
    topt = torch.optim.Adagrad([tp], lr=0.05, eps=1e-10)
    for _ in range(3):
        g = rng.randn(n).astype(np.float32)
        ours.step_flat(p, g, s)
        ref.step_flat(jp, g, js)
        tp.grad = torch.tensor(g.copy())
        topt.step()
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_allclose(p, tp.detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_cpu_adagrad_sparse_rows_bit_equal(wd):
    """``test_cpu_adagrad_sparse_rows_exact``: the row-sparse step, a row
    repeated, bit-equal to JAX's native one; untouched rows do not move."""
    V, D = 64, 16
    rng = np.random.RandomState(11)
    table = rng.randn(V, D).astype(np.float32)
    rows = np.array([3, 17, 3, 60], np.int64)
    row_grads = rng.randn(len(rows), D).astype(np.float32)
    p, jp = table.copy(), table.copy()
    s, js = np.zeros((V, D), np.float32), np.zeros((V, D), np.float32)
    DeepSpeedCPUAdagrad(lr=0.1, weight_decay=wd).step_sparse(p, rows, row_grads, s)
    JCPUAdagrad(lr=0.1, weight_decay=wd).step_sparse(jp, rows, row_grads, js)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(s, js)
    untouched = np.setdiff1d(np.arange(V), rows)
    np.testing.assert_array_equal(p[untouched], table[untouched])
    with pytest.raises(IndexError):
        DeepSpeedCPUAdagrad().step_sparse(p, np.array([V]), row_grads[:1], s)


def test_adagrad_device_update_matches_jax():
    """The config's "Adagrad" in the captured step: the tree update, three
    steps, within 1e-6 of JAX's (another order of fp32 operations)."""
    rng = np.random.RandomState(5)
    params = {"w": rng.randn(4, 3).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    ours, ref = DeepSpeedCPUAdagrad(lr=0.05, weight_decay=0.01), JCPUAdagrad(
        lr=0.05, weight_decay=0.01)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = ours.init(tp), ref.init(jp)
    for step, g in enumerate(grads, 1):
        tp, ts = ours.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp, step=step)
        jp, js = ref.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp, step=step)
    assert isinstance(ts, AdagradState) and ts._fields == js._fields
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6)
        np.testing.assert_allclose(ts.sum_sq[k].numpy(), np.asarray(js.sum_sq[k]), rtol=1e-6)


def test_memcpy_and_bf16_sweeps():
    """``test_ds_memcpy_and_bf16_sweeps``: ``ds_memcpy`` copies bytes,
    ``ds_bf16_to_fp32`` widens exactly."""
    src = np.random.RandomState(2).rand(1 << 16).astype(np.float32)
    dst = np.zeros_like(src)
    host_memcpy(dst.ctypes.data, src.ctypes.data, src.nbytes)
    np.testing.assert_array_equal(src, dst)
    words = torch.from_numpy(src).to(torch.bfloat16)
    back = torch.zeros(src.size)
    widen_bf16(words, back)
    assert torch.equal(back, words.float())


def test_builders_registered_and_build_as_jax_does():
    """``test_builders_registered``: one library in ``.torch_build`` from
    the same source and flags as the JAX builder's, every entry the JAX
    package's three builders name typed in it."""
    b = builder.CPUAdamBuilder()
    assert b.lib_path().parent == builder.BUILD_DIR
    jb = JCPUAdamBuilder()
    assert b.cflags() == jb.cflags()
    assert [str(s) for s in b.sources()] == jb.sources()
    lib = builder.load_library()
    for entry in ("ds_adam_step", "ds_adagrad_step", "ds_adagrad_step_sparse", "ds_memcpy",
                  "ds_fp32_to_bf16", "ds_bf16_to_fp32"):
        assert getattr(lib, entry).restype is ctypes.c_int, entry


def test_missing_gxx_raises(monkeypatch):
    """No fallback: without g++ a build raises."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    b = builder.CPUAdamBuilder()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        b.jit_build()
