"""LAMB over the parameter tree, in plain torch.

Counterpart of ``deepspeed_tpu/ops/lamb/fused_lamb.py`` (an XLA update
there, not a Pallas kernel).  The formula is the JAX package's, op for op
(lines 27-57): fp32 moments, the Adam direction
``(m / bc1) / (sqrt(v / bc2) + eps)`` (eps outside the sqrt of the
bias-corrected second moment), ``+ wd * p``, and the per-leaf trust ratio
``||p|| / ||update||`` clamped to ``[min_coeff, max_coeff]``, 1 where
either norm is 0.  A stacked ``blocks`` leaf is one leaf, as in JAX: its
norms run over the whole stack.

``step`` and ``lr`` may be device tensors (the engine feeds both, so a
captured step takes a new lr and a skipped step needs no host sync).
``max_grad_norm`` is accepted and unused, as in JAX; AMSGrad raises.
Differences: the update is functional over a dict tree (new tensors, one
loop over the leaves); the engine commits them.
"""

from typing import NamedTuple

import torch

from ...runtime.utils import tree_leaves, tree_map
from ..adam.fused_adam import _pick


class LambState(NamedTuple):
    exp_avg: dict      # first moment tree (fp32)
    exp_avg_sq: dict   # second moment tree (fp32)


def lamb_init(params) -> LambState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return LambState(exp_avg=tree_map(zeros, params), exp_avg_sq=tree_map(zeros, params))


def lamb_update(grads, state: LambState, params, *, step, lr,
                betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                bias_correction=True, max_coeff=10.0, min_coeff=0.01):
    """One LAMB step over the whole tree; ``step`` is the 1-based step
    count (int or tensor).  Returns ``(new_params, new_state)``; all math
    in fp32."""
    b1, b2 = betas
    dev = tree_leaves(params)[0].device
    step = torch.as_tensor(step, device=dev).float()
    one = torch.ones((), device=dev)
    bc1, bc2 = ((1.0 - b1 ** step, 1.0 - b2 ** step) if bias_correction
                else (one, one))

    def upd(p, g, m, v):
        g = g.float()
        p32 = p.float()
        m_new = b1 * m + (1.0 - b1) * g
        v_new = b2 * v + (1.0 - b2) * g.square()
        update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        if weight_decay != 0.0:
            update = update + weight_decay * p32
        w_norm = torch.linalg.vector_norm(p32)
        u_norm = torch.linalg.vector_norm(update)
        trust = torch.where((w_norm > 0) & (u_norm > 0),
                            torch.clamp(w_norm / u_norm, min_coeff, max_coeff), one)
        return (p32 - lr * trust * update).to(p.dtype), m_new, v_new

    outs = tree_map(upd, params, grads, state.exp_avg, state.exp_avg_sq)
    return _pick(outs, 0), LambState(exp_avg=_pick(outs, 1), exp_avg_sq=_pick(outs, 2))


class FusedLamb:
    """Engine-facing LAMB (config-driven hyperparameters)."""

    name = "lamb"

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, max_grad_norm=0.0, max_coeff=10.0, min_coeff=0.01,
                 amsgrad=False):
        if amsgrad:
            raise RuntimeError("FusedLamb does not support the AMSGrad variant "
                               "(reference parity).")
        self.lr = lr
        self.bias_correction = bias_correction
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff

    def init(self, params):
        return lamb_init(params)

    def update(self, grads, state, params, *, step, lr=None):
        lr = self.lr if lr is None else lr
        return lamb_update(grads, state, params, step=step, lr=lr, betas=self.betas,
                           eps=self.eps, weight_decay=self.weight_decay,
                           bias_correction=self.bias_correction,
                           max_coeff=self.max_coeff, min_coeff=self.min_coeff)
