"""SGD with momentum, weight decay and Nesterov, over the parameter tree.

Counterpart of ``deepspeed_tpu/ops/sgd.py`` (17-48), op for op: the
decay added to the gradient (``g + wd * p``), the fp32 buffer
``b = momentum * b + g``, the direction ``g + momentum * b`` (Nesterov),
``b`` (momentum) or ``g`` (none), and ``p - lr * d``.  ``lr`` may be a
device tensor (the engine's captured step feeds one); ``step`` is taken
and unused.  The update is functional (new tensors); the engine commits
them.
"""

from typing import NamedTuple

import torch

from ..runtime.utils import tree_map
from .adam.fused_adam import _pick


class SGDState(NamedTuple):
    momentum_buf: dict   # fp32 momentum buffer tree


class SGD:
    name = "sgd"

    def __init__(self, lr=1e-3, momentum=0.0, weight_decay=0.0, nesterov=False):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.nesterov = nesterov

    def init(self, params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return SGDState(momentum_buf=tree_map(zeros, params))

    def update(self, grads, state, params, *, step, lr=None):
        lr = self.lr if lr is None else lr
        mom, wd, nesterov = self.momentum, self.weight_decay, self.nesterov

        def upd(p, g, b):
            g = g.float()
            p32 = p.float()
            if wd != 0.0:
                g = g + wd * p32
            b_new = mom * b + g
            d = g + mom * b_new if nesterov else (b_new if mom != 0.0 else g)
            return (p32 - lr * d).to(p.dtype), b_new

        outs = tree_map(upd, params, grads, state.momentum_buf)
        return _pick(outs, 0), SGDState(momentum_buf=_pick(outs, 1))
