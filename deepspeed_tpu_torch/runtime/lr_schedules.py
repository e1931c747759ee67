"""LR schedules: LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py``: the same
names, parameters and curves.  Each schedule is a pure function
``lr_fn(step) -> float`` of the global step, computed in float32 as the
JAX package traces it, so the engine reads the step's lr on the host
with no device work.  The stateful wrapper keeps ``step()``,
``get_lr()`` and the checkpointed ``state_dict`` / ``load_state_dict``
(JAX :72-78, ``{"last_batch_iteration": n}``); ``OneCycle.momentum_fn``
and ``get_last_lr`` are not ported (no ported optimizer reads them).
"""

import math

import numpy as np

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]
WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"

f32 = np.float32


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, f32(lo)), f32(hi))


class _ScheduleBase:
    """Stateful wrapper over the pure ``lr_fn(step)``."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def lr_fn(self, step):
        raise NotImplementedError

    def get_lr(self):
        return [float(self.lr_fn(max(0, self.last_batch_iteration)))]

    def step(self):
        self.last_batch_iteration += 1
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class LRRangeTest(_ScheduleBase):
    """LR range-test sweep."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        if lr_range_test_step_size <= 0:
            raise ValueError(f"Step size {lr_range_test_step_size} must be positive")
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_fn(self, step):
        interval = f32(step) / f32(self.step_size)
        if self.staircase:
            interval = np.floor(interval)
        return float(f32(self.min_lr) * (f32(1.0) + interval * f32(self.step_rate)))


class OneCycle(_ScheduleBase):
    """1-cycle policy: up-phase, down-phase, then decay."""

    def __init__(self, optimizer=None, cycle_min_lr=0.0, cycle_max_lr=1e-2,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.8, cycle_max_mom=0.9,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        # the momentum arguments are accepted (reference configs set them)
        # and unused: no ported optimizer cycles momentum
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = cycle_first_step_size
        self.second_size = (cycle_second_step_size
                            if cycle_second_step_size is not None else cycle_first_step_size)
        self.decay_step_size = decay_step_size
        self.total_size = self.first_size + self.second_size

    def lr_fn(self, step):
        step = f32(step)
        if step <= f32(self.total_size):
            up = _clip(step / f32(self.first_size), 0.0, 1.0)
            down = _clip((step - f32(self.first_size)) / f32(self.second_size), 0.0, 1.0)
            return float(f32(self.cycle_min_lr)
                         + f32(self.cycle_max_lr - self.cycle_min_lr) * (up - down))
        intervals = step - f32(self.total_size)
        if self.decay_step_size > 0:
            intervals = np.floor(intervals / f32(self.decay_step_size))
        return float(f32(self.cycle_min_lr)
                     / (f32(1.0) + f32(self.decay_lr_rate) * intervals))


class WarmupLR(_ScheduleBase):
    """Warmup from min to max lr (log or linear), then hold."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE,
                 last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        if warmup_type not in (WARMUP_LOG_RATE, WARMUP_LINEAR_RATE):
            raise ValueError(f"warmup_type {warmup_type} must be 'log' or 'linear'")
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_gamma(self, step):
        step = f32(step)
        if self.warmup_type == WARMUP_LOG_RATE:
            gamma = f32(self.inverse_log_warm_up) * np.log(step + f32(1.0))
        else:
            gamma = step / f32(self.warmup_num_steps)
        return _clip(gamma, 0.0, 1.0)

    def lr_fn(self, step):
        return float(f32(self.min_lr)
                     + f32(self.max_lr - self.min_lr) * self._warmup_gamma(step))


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to ``warmup_min_lr`` at ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE, last_batch_iteration=-1):
        self.total_num_steps = total_num_steps
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)

    def lr_fn(self, step):
        if f32(step) < f32(self.warmup_num_steps):
            return super().lr_fn(step)
        decay = _clip((f32(self.total_num_steps) - f32(step))
                      / f32(max(1.0, self.total_num_steps - self.warmup_num_steps)),
                      0.0, 1.0)
        return float(f32(self.min_lr) + f32(self.max_lr - self.min_lr) * decay)


SCHEDULE_CLASSES = {
    LR_RANGE_TEST: LRRangeTest,
    ONE_CYCLE: OneCycle,
    WARMUP_LR: WarmupLR,
    WARMUP_DECAY_LR: WarmupDecayLR,
}


def get_lr_scheduler(name, params, optimizer=None):
    """Instantiate a scheduler from the config's ``scheduler`` section."""
    if name not in SCHEDULE_CLASSES:
        raise ValueError(f"Unknown LR schedule {name!r}; valid: {VALID_LR_SCHEDULES}")
    return SCHEDULE_CLASSES[name](optimizer=optimizer, **params)
