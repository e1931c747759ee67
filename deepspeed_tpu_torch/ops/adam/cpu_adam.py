"""DeepSpeedCPUAdam: the host Adam(W) of the optimizer offload tier.

Counterpart of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (lines 56-146):
the state lives in flat fp32 host buffers and each step is one call of
the repo's native ``ds_adam_step`` (``csrc/adam/ds_cpu_adam.cpp:71``,
OpenMP over the elements, auto-vectorized), built by
``ops/op_builder/builder.py``.  The fused copy-back (``out16``,
``out_dtype`` "bfloat16" / "float16") writes the updated parameters in
16 bits in the same pass, as the payload the engine uploads to the card.

Buffers are numpy arrays or contiguous CPU tensors (pinned ones too: a
tensor is read through ``.numpy()``, which shares its memory; a 16-bit
tensor through its 16-bit words).  ``ctypes`` releases the GIL for the
call, so the host step runs beside the Python that queues the card's
work.

Deliberate differences: no numpy fallback (JAX ``cpu_adam.py:37``): a
missing g++ raises when the optimizer is built.  The plain torch version
of the step, :func:`adam_step_plain`, serves the tests only.  The pytree
``init`` / ``update`` convenience of the JAX class is not ported: the
engine's in-device path keeps ``FusedAdam``.
"""

import ctypes

import numpy as np
import torch

from ..op_builder.builder import f32p, load_library, u16p

_OUT_KIND = {None: 0, "bfloat16": 1, "float16": 2}


def host_array(a, dtype=np.float32):
    """A contiguous host buffer as a numpy array sharing its memory: a
    numpy array of ``dtype``, or a CPU tensor (16-bit tensors as their
    ``uint16`` words)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu" or not a.is_contiguous():
            raise ValueError(f"a host buffer must be a contiguous CPU tensor, got "
                             f"{a.device} contiguous={a.is_contiguous()}")
        if a.dtype in (torch.bfloat16, torch.float16):
            a = a.view(torch.int16).numpy().view(np.uint16)
        else:
            a = a.numpy()
    if a.dtype != np.dtype(dtype) or not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"a host buffer must be contiguous {np.dtype(dtype)}, got "
                         f"{a.dtype} contiguous={a.flags['C_CONTIGUOUS']}")
    return a


def _ptr(a, ty):
    return a.ctypes.data_as(ty)


def adam_step_plain(params, grads, exp_avg, exp_avg_sq, step, lr, betas=(0.9, 0.999),
                    eps=1e-8, weight_decay=0.0, adamw_mode=True, bias_correction=True):
    """The step in plain torch fp32, in place on CPU tensors, with the
    native kernel's formula and its fp32 coefficients (for tests)."""
    f = np.float32
    b1, b2, one = f(betas[0]), f(betas[1]), f(1.0)
    bc1 = float(one - b1 ** f(step)) if bias_correction else 1.0
    bc2_sqrt = float(np.sqrt(one - b2 ** f(step))) if bias_correction else 1.0
    g = grads
    if weight_decay != 0.0 and not adamw_mode:
        g = g + weight_decay * params
    exp_avg.mul_(float(b1)).add_(float(one - b1) * g)
    exp_avg_sq.mul_(float(b2)).add_(float(one - b2) * g * g)
    update = (exp_avg / bc1) / (exp_avg_sq.sqrt() / bc2_sqrt + eps)
    if weight_decay != 0.0 and adamw_mode:
        update = update + weight_decay * params
    params.sub_(lr * update)


class DeepSpeedCPUAdam:
    """Fused host Adam over flat fp32 buffers, in place."""

    name = "cpu_adam"

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, amsgrad=False, adamw_mode=True,
                 fp32_optimizer_states=True):
        if amsgrad:
            raise RuntimeError("DeepSpeedCPUAdam does not support AMSGrad "
                               "(reference parity).")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self._lib = load_library()

    def init_buffers(self, numel):
        """(exp_avg, exp_avg_sq): zeroed flat fp32 numpy buffers of ``numel``."""
        return np.zeros(numel, np.float32), np.zeros(numel, np.float32)

    def step_flat(self, params, grads, exp_avg, exp_avg_sq, step, lr=None, out16=None,
                  out_dtype=None):
        """One in-place Adam step over flat fp32 buffers; with ``out_dtype``
        the updated params are also written into ``out16`` (the words of a
        bf16 / fp16 buffer) in the same pass."""
        lr = self.lr if lr is None else float(lr)
        p = host_array(params)
        g, m, v = host_array(grads), host_array(exp_avg), host_array(exp_avg_sq)
        if not p.size == g.size == m.size == v.size:
            raise ValueError(f"buffer sizes differ: {p.size}, {g.size}, {m.size}, {v.size}")
        kind = _OUT_KIND[out_dtype]
        out = u16p()
        if kind:
            o = host_array(out16, np.uint16)
            if o.size != p.size:
                raise ValueError(f"out16 holds {o.size} words for {p.size} params")
            out = _ptr(o, u16p)
        self._lib.ds_adam_step(_ptr(p, f32p), _ptr(g, f32p), _ptr(m, f32p), _ptr(v, f32p),
                               p.size, int(step), lr, self.betas[0], self.betas[1],
                               self.eps, self.weight_decay, int(self.adamw_mode),
                               int(self.bias_correction), out, kind)


class DeepSpeedCPUAdamW(DeepSpeedCPUAdam):
    name = "cpu_adamw"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01,
                 bias_correction=True, amsgrad=False):
        super().__init__(lr=lr, bias_correction=bias_correction, betas=betas, eps=eps,
                         weight_decay=weight_decay, amsgrad=amsgrad, adamw_mode=True)


def widen_bf16(src, dst):
    """bf16 words -> fp32 (``ds_bf16_to_fp32``, exact), host buffers."""
    s, d = host_array(src, np.uint16), host_array(dst)
    if s.size != d.size:
        raise ValueError(f"{s.size} bf16 words into {d.size} floats")
    load_library().ds_bf16_to_fp32(_ptr(s, u16p), _ptr(d, f32p), s.size)


def host_memcpy(dst, src, nbytes):
    """``ds_memcpy``: an OpenMP copy of ``nbytes`` between host addresses."""
    load_library().ds_memcpy(ctypes.c_void_p(dst), ctypes.c_void_p(src), int(nbytes))
