"""The port's loss scaler (``deepspeed_tpu_torch/runtime/fp16/loss_scaler.py``)
against the JAX package's, on the CPU.

``update_scale`` is held bit for bit over seeded overflow sequences
(dynamic and static scaling, ``consecutive_hysteresis`` both ways, a
``scale_window`` of 3, ``min_scale`` reached); ``has_overflow`` on trees
with and without inf or NaN; ``create_loss_scaler`` from the parsed
configs of both packages; and twins of ``tests/test_loss_scaler.py``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deepspeed_tpu.runtime.config import DeepSpeedConfig as JConfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jls

from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls


def _np(state):
    return tuple(np.asarray(x).item() for x in state)


def _port_state(j):
    """The port's state with a JAX state's values."""
    return ls.LossScaleState(*(torch.tensor(np.asarray(x).item(), dtype=t) for x, t in zip(
        j, (torch.float32, torch.int32, torch.int32, torch.int32))))


KNOBS = {
    "dynamic-window3-hyst2": dict(dynamic=True, scale_window=3, delayed_shift=2),
    "dynamic-window3-hyst2-consecutive": dict(dynamic=True, scale_window=3, delayed_shift=2,
                                              consecutive_hysteresis=True),
    "dynamic-window3-hyst1-floor4": dict(dynamic=True, scale_window=3, delayed_shift=1,
                                         min_scale=4.0),
    "dynamic-factor4-window5-hyst3": dict(dynamic=True, scale_factor=4.0, scale_window=5,
                                          delayed_shift=3),
    "static": dict(dynamic=False),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", list(KNOBS))
def test_update_scale_matches_jax_bit_for_bit(name, seed):
    """60 ticks over a seeded overflow sequence (runs of overflows long
    enough to reach ``min_scale``, clean runs long enough to grow), the
    port's state equal to JAX's after every tick, dtypes included."""
    kw = KNOBS[name]
    rng = np.random.default_rng(seed)
    flags = (rng.random(60) < [0.8] * 20 + [0.15] * 40).tolist()
    j = (jls.dynamic_state(initial_scale_power=6, delayed_shift=kw.get("delayed_shift", 2))
         if kw["dynamic"] else jls.static_state(128.0))
    t = _port_state(j)
    floor_seen = False
    for flag in flags:
        j = jls.update_scale(j, flag, **kw)
        t = ls.update_scale(t, torch.tensor(flag), **kw)
        assert _np(t) == _np(j)
        assert [x.dtype for x in t] == [torch.float32, torch.int32, torch.int32, torch.int32]
        floor_seen |= float(t.cur_scale) == kw.get("min_scale", 1.0)
    assert floor_seen or not kw["dynamic"]


@pytest.mark.parametrize("tree,want", [
    ({"a": np.ones(3), "b": np.zeros((2, 2))}, False),
    ({"a": np.array([1.0, np.inf]), "b": np.zeros(2)}, True),
    ({"a": np.zeros(2), "b": {"c": np.array([np.nan, 0.0])}}, True),
    ({"a": np.array([-np.inf])}, True),
    ({}, False),
])
def test_has_overflow_matches_jax(tree, want):
    def conv(t, f):
        return {k: conv(v, f) if isinstance(v, dict) else f(v) for k, v in t.items()}
    got = ls.has_overflow(conv(tree, lambda a: torch.tensor(a, dtype=torch.float32)))
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(jls.has_overflow(conv(tree, jnp.asarray))) == want


@pytest.mark.parametrize("fp16", [
    {"enabled": True},
    {"enabled": True, "initial_scale_power": 8, "loss_scale_window": 100, "hysteresis": 3,
     "min_loss_scale": 2},
    {"enabled": True, "loss_scale": 64},
])
def test_create_loss_scaler_from_the_parsed_config(fp16):
    pd = {"train_batch_size": 8, "fp16": fp16}
    t = ls.create_loss_scaler(DeepSpeedConfig(dict(pd)).fp16)
    j = jls.create_loss_scaler(JConfig(dict(pd), world_size=1).fp16)
    assert type(t).__name__ == type(j).__name__
    for key in ("dynamic", "scale_factor", "scale_window", "min_scale", "delayed_shift",
                "consecutive_hysteresis", "loss_scale"):
        assert getattr(t, key) == getattr(j, key), key
    assert _np(t.state) == _np(j.state)
    t.update_scale(True)
    j.update_scale(True)
    assert _np(t.state) == _np(j.state)
    with pytest.raises(RuntimeError):
        t.backward(torch.ones(()))


# ----------------------------------------------- twins of tests/test_loss_scaler.py
def _tick(state, overflow, **kw):
    defaults = dict(dynamic=True, scale_factor=2.0, scale_window=5, min_scale=1.0,
                    delayed_shift=1)
    defaults.update(kw)
    return ls.update_scale(state, overflow, **defaults)


def test_static_never_changes():
    st = ls.static_state(128.0)
    for i in range(10):
        st = ls.update_scale(st, i % 2 == 0, dynamic=False)
    assert float(st.cur_scale) == 128.0


def test_dynamic_halves_on_overflow():
    st = ls.dynamic_state(initial_scale_power=4, delayed_shift=1)  # scale 16
    st = _tick(st, True)
    assert float(st.cur_scale) == 8.0
    st = _tick(st, True)
    assert float(st.cur_scale) == 4.0


def test_dynamic_floor():
    st = ls.dynamic_state(initial_scale_power=1, delayed_shift=1)  # scale 2
    for _ in range(5):
        st = _tick(st, True)
    assert float(st.cur_scale) == 1.0  # min_scale floor


def test_dynamic_grows_after_window():
    st = ls.dynamic_state(initial_scale_power=4, delayed_shift=1)  # 16
    for _ in range(5):
        st = _tick(st, False)
    assert float(st.cur_scale) == 32.0


def test_hysteresis_tolerates_overflows():
    st = ls.dynamic_state(initial_scale_power=4, delayed_shift=3)  # 16, 3 credits
    st = _tick(st, True, delayed_shift=3)
    assert float(st.cur_scale) == 16.0  # credit consumed, no shrink
    st = _tick(st, True, delayed_shift=3)
    assert float(st.cur_scale) == 16.0
    st = _tick(st, True, delayed_shift=3)
    assert float(st.cur_scale) == 8.0  # credits exhausted -> shrink


def test_has_overflow():
    good = {"a": torch.ones(3), "b": torch.zeros((2, 2))}
    assert not bool(ls.has_overflow(good))
    bad = {"a": torch.tensor([1.0, np.inf]), "b": torch.zeros(2)}
    assert bool(ls.has_overflow(bad))
    nan = {"a": torch.tensor([np.nan])}
    assert bool(ls.has_overflow(nan))


def test_create_from_config():
    class FP16:
        dynamic_loss_scale = True
        initial_scale_power = 8
        loss_scale_window = 100
        min_loss_scale = 2
        hysteresis = 2
        loss_scale = 0
    s = ls.create_loss_scaler(FP16())
    assert s.dynamic
    assert s.loss_scale == 256.0

    class FP16s(FP16):
        dynamic_loss_scale = False
        loss_scale = 64
    s = ls.create_loss_scaler(FP16s())
    assert not s.dynamic
    assert s.loss_scale == 64.0


def test_consecutive_hysteresis_replenishes_every_clean_iter():
    st = ls.dynamic_state(initial_scale_power=4, delayed_shift=2)
    st = _tick(st, True, delayed_shift=2, consecutive_hysteresis=True)   # consume
    st = _tick(st, False, delayed_shift=2, consecutive_hysteresis=True)  # replenish
    st = _tick(st, True, delayed_shift=2, consecutive_hysteresis=True)   # consume again
    assert float(st.cur_scale) == 16.0  # never shrank
