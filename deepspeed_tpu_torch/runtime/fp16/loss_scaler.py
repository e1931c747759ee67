"""Static and dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/fp16/loss_scaler.py``: the same
knobs (``init_scale = 2**initial_scale_power``, ``scale_window``,
``scale_factor``, ``min_scale``, ``delayed_shift`` for the hysteresis,
``consecutive_hysteresis``), the same state and the same branchless tick.

:class:`LossScaleState` holds four 0-d device tensors with JAX's field
names and dtypes.  :func:`update_scale` and :func:`has_overflow` are
tensor code with no host read (``torch.where`` for JAX's ``jnp.where``),
so the engine runs them inside its captured training step; it copies the
new state into its own state tensors in place, gated by the step's
``commit`` flag, so a replay reads and writes the same storage and the
warm-up and the capture leave the scaler unticked.  The host facades
(:class:`LossScaler`, :class:`DynamicLossScaler`,
:func:`create_loss_scaler`) keep JAX's signatures; ``loss_scale`` is their
one host read, made outside the step.

Deliberate differences: the state tensors live on a ``device`` (the
engine's) rather than wherever JAX's default device is;
``LossScaler.backward`` raises, as in JAX, since the engine scales the
loss inside its step.
"""

from typing import NamedTuple

import torch

from ..utils import tree_leaves


class LossScaleState(NamedTuple):
    """Device-resident scaler state (0-d tensors)."""
    cur_scale: torch.Tensor           # f32
    cur_hysteresis: torch.Tensor      # i32: overflows still tolerated before a shrink
    last_overflow_iter: torch.Tensor  # i32
    iter_num: torch.Tensor            # i32


def _state(scale, hysteresis, device=None):
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return LossScaleState(cur_scale=torch.tensor(scale, dtype=torch.float32, device=device),
                          cur_hysteresis=i32(hysteresis), last_overflow_iter=i32(-1),
                          iter_num=i32(0))


def static_state(loss_scale: float, device=None) -> LossScaleState:
    return _state(loss_scale, 0, device)


def dynamic_state(initial_scale_power: int = 16, delayed_shift: int = 2,
                  device=None) -> LossScaleState:
    return _state(2.0 ** initial_scale_power, delayed_shift, device)


def update_scale(state: LossScaleState, overflow, *, dynamic: bool,
                 scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, delayed_shift: int = 2,
                 consecutive_hysteresis: bool = False) -> LossScaleState:
    """One tick (JAX ``update_scale``, term for term): on an overflow with
    hysteresis left, one credit is consumed; without, the scale becomes
    ``max(scale / scale_factor, min_scale)``; after ``scale_window`` clean
    iterations the scale grows by ``scale_factor`` and the hysteresis is
    restored (every clean iteration with ``consecutive_hysteresis``).
    ``overflow`` is a bool (0-d tensor or host value)."""
    if not dynamic:
        return state._replace(iter_num=state.iter_num + 1)
    overflow = torch.as_tensor(overflow, device=state.cur_scale.device)
    iter_num = state.iter_num + 1

    # the overflow branch
    hysteresis_left = state.cur_hysteresis > 1
    ovf_scale = torch.where(hysteresis_left, state.cur_scale,
                            torch.clamp(state.cur_scale / scale_factor, min=min_scale))
    ovf_hyst = torch.where(hysteresis_left, state.cur_hysteresis - 1, state.cur_hysteresis)
    ovf_last = state.iter_num

    # the clean branch: the window counted from the last overflow
    window_elapsed = torch.remainder(state.iter_num - state.last_overflow_iter,
                                     scale_window) == 0
    grow = window_elapsed & (state.iter_num > state.last_overflow_iter)
    clean_scale = torch.where(grow, state.cur_scale * scale_factor, state.cur_scale)
    full = torch.full_like(state.cur_hysteresis, delayed_shift)
    clean_hyst = full if consecutive_hysteresis else torch.where(grow, full,
                                                                 state.cur_hysteresis)
    return LossScaleState(
        cur_scale=torch.where(overflow, ovf_scale, clean_scale),
        cur_hysteresis=torch.where(overflow, ovf_hyst, clean_hyst).to(torch.int32),
        last_overflow_iter=torch.where(overflow, ovf_last,
                                       state.last_overflow_iter).to(torch.int32),
        iter_num=iter_num)


def has_overflow(grads) -> torch.Tensor:
    """Any inf or NaN in a gradient tree: one 0-d bool tensor, reduced once
    over the leaves' flags (JAX ``has_overflow``; False for an empty
    tree)."""
    leaves = tree_leaves(grads)
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([~torch.isfinite(g).all() for g in leaves]).any()


class LossScaler:
    """Host facade over a :class:`LossScaleState` (JAX ``LossScaler``): the
    engine hands ``.state`` to its step and keeps the updated state."""

    def __init__(self, scale=1.0, device=None):
        self.dynamic = False
        self.scale_factor = 2.0
        self.scale_window = 1000
        self.min_scale = 1.0
        self.delayed_shift = 1
        self.consecutive_hysteresis = False
        self.state = static_state(scale, device)

    @property
    def loss_scale(self):
        return float(self.state.cur_scale)

    def update_kwargs(self):
        """The keyword arguments of :func:`update_scale` for this scaler."""
        return dict(dynamic=self.dynamic, scale_factor=self.scale_factor,
                    scale_window=self.scale_window, min_scale=self.min_scale,
                    delayed_shift=self.delayed_shift,
                    consecutive_hysteresis=self.consecutive_hysteresis)

    def update_scale(self, overflow):
        self.state = update_scale(self.state, overflow, **self.update_kwargs())

    def backward(self, loss):
        raise RuntimeError("LossScaler.backward is not used by the port: the engine scales "
                           "the loss inside its train step.")


class DynamicLossScaler(LossScaler):
    def __init__(self, init_scale=2 ** 32, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False, device=None):
        super().__init__(init_scale, device)
        self.dynamic = True
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.state = _state(init_scale, delayed_shift, device)


def create_loss_scaler(fp16_config, device=None):
    """A scaler from the parsed ``fp16`` section (JAX ``create_loss_scaler``):
    ``loss_scale == 0`` is dynamic with ``2**initial_scale_power``."""
    if fp16_config.dynamic_loss_scale:
        return DynamicLossScaler(init_scale=2.0 ** fp16_config.initial_scale_power,
                                 scale_window=fp16_config.loss_scale_window,
                                 min_scale=fp16_config.min_loss_scale,
                                 delayed_shift=fp16_config.hysteresis, device=device)
    return LossScaler(scale=fp16_config.loss_scale, device=device)
