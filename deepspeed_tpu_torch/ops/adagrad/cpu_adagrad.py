"""Adagrad: the device tree path and the native host path.

Counterpart of ``deepspeed_tpu/ops/adagrad/cpu_adagrad.py`` (116 lines):
the same update, ``sum_sq += g^2; p -= lr * g / (sqrt(sum_sq) + eps)``
with ``g += wd * p`` first when ``weight_decay`` is set, on two tiers:

- device (the config's ``"Adagrad"``, JAX ``engine.py:554-555``):
  ``init`` / ``update`` over the parameter tree in plain torch, inside
  the engine's captured step; the state is ``AdagradState(sum_sq=...)``,
  JAX's layout, so checkpoints cross;
- host: ``step_flat`` and ``step_sparse`` call the repo's native
  ``ds_adagrad_step`` / ``ds_adagrad_step_sparse``
  (``csrc/adam/ds_cpu_adam.cpp``) over flat fp32 host buffers;
  ``step_sparse`` touches only the rows an (indices, values) embedding
  gradient names, duplicates applied in order.

Deliberate difference: no numpy fallback; a missing g++ raises when the
host path is first used (the device path needs no library).
"""

from typing import NamedTuple

import numpy as np
import torch

from ...runtime.utils import tree_map
from ..adam.cpu_adam import _ptr, host_array
from ..op_builder.builder import f32p, i64p, load_library, u16p


class AdagradState(NamedTuple):
    sum_sq: dict


class DeepSpeedCPUAdagrad:
    name = "adagrad"

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay

    @property
    def _lib(self):
        return load_library()

    # ------------------------------------------------------------ host tier
    def step_flat(self, params, grads, sq_sum, lr=None):
        """In-place dense Adagrad over flat fp32 host buffers."""
        lr = self.lr if lr is None else float(lr)
        p, g, s = host_array(params), host_array(grads), host_array(sq_sum)
        if not p.size == g.size == s.size:
            raise ValueError(f"buffer sizes differ: {p.size}, {g.size}, {s.size}")
        self._lib.ds_adagrad_step(_ptr(p, f32p), _ptr(g, f32p), _ptr(s, f32p), p.size, lr,
                                  self.eps, self.weight_decay, u16p(), 0)

    def step_sparse(self, params2d, rows, row_grads, sq_sum2d, lr=None):
        """Row-sparse Adagrad on a (rows, dim) fp32 host table: only the
        rows in ``rows`` move, by ``row_grads`` (n, dim)."""
        lr = self.lr if lr is None else float(lr)
        p, s = host_array(params2d), host_array(sq_sum2d)
        if p.ndim != 2 or s.shape != p.shape:
            raise ValueError(f"params2d {p.shape} and sq_sum2d {s.shape} must be one "
                             "(rows, dim) shape")
        rows = np.ascontiguousarray(rows, np.int64)
        g = np.ascontiguousarray(row_grads, np.float32)
        if g.shape != (rows.size, p.shape[1]):
            raise ValueError(f"row_grads {g.shape} != ({rows.size}, {p.shape[1]})")
        if rows.size and (rows.min() < 0 or rows.max() >= p.shape[0]):
            raise IndexError(f"row ids out of [0, {p.shape[0]})")
        self._lib.ds_adagrad_step_sparse(_ptr(p, f32p), _ptr(rows, i64p), _ptr(g, f32p),
                                         _ptr(s, f32p), rows.size, p.shape[1], lr, self.eps,
                                         self.weight_decay, u16p(), 0)

    # ---------------------------------------------------------- device tier
    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdagradState(sum_sq=tree_map(zeros, params))

    def update(self, grads, state, params, *, step, lr=None):
        lr = self.lr if lr is None else lr

        def upd(p, g, s):
            g = g.float()
            p32 = p.float()
            if self.weight_decay != 0.0:
                g = g + self.weight_decay * p32
            s_new = s + g.square()
            return (p32 - lr * g / (torch.sqrt(s_new) + self.eps)).to(p.dtype), s_new

        outs = tree_map(upd, params, grads, state.sum_sq)
        return _pick(outs, 0), AdagradState(sum_sq=_pick(outs, 1))


def _pick(tree, i):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    return tree[i]
