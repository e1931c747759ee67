"""The health guardian's host ladder in the port (``runtime/health.py``'s
``HealthMonitor``, ``monitor/ring.py``, the config's ladder keys and the
engine's ``_health_observe`` / ``_health_rewind`` / ``rewind`` /
``_health_abort``) against the JAX package, on the CPU.

Monitor twins of ``tests/test_health.py:179-315`` (escalation, the
per-episode rewind limit, ``on_exhausted=warn``, the ``check_interval``
lag, the host-EMA fallback, the forensic format): the same metric
sequences go to JAX's monitor and the port's, and every action, counter,
pending count and history record is equal.  Engine twins of
``:405-546`` on gpt2-tiny in bf16 (the JAX engine on a 1-device mesh with
its compile cache off, since a cached step executable fails after
``load_checkpoint`` there): rewind and replay at ZeRO-2 and ZeRO-3, the
exhausted abort with forensics, no checkpoint directory → "rewind
failed", the exact batch-stream restore, the exact O(1) fast-forward,
and the bf16 offload skip; rewinds, the loaded tag, ``_stream_step``,
``global_steps`` and the monitor's counters are equal, and the losses
after the rewind agree within 1e-4 relative (bf16 matmuls summed in
another order).  GPT-2's batches are integer tokens, which
``fault.corrupt_batch`` leaves alone, so the engines train on ``(tokens,
gate)`` with a loss of ``model.loss(tokens) * mean(gate)``: the gate is
ones (the loss bit-equal to the model's), and NaN inside a ``grad_nan``
window.  The default ``health_check`` (no ladder key, no checkpoint
directory) aborts after 10 consecutive skips in both packages; the
parent port skipped forever."""

import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import deepspeed_tpu as jds
from deepspeed_tpu import fault as jfault
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.parallel.mesh import make_mesh
from deepspeed_tpu.runtime import health as jhealth
from deepspeed_tpu.runtime.config import (DeepSpeedHealthCheckConfig as JHealthConfig,
                                          DeepSpeedConfigError as JConfigError)

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import fault as tfault
from deepspeed_tpu_torch.models.gpt2 import GPT2
from deepspeed_tpu_torch.monitor.ring import RingBuffer
from deepspeed_tpu_torch.runtime import health as thealth
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfigError,
                                                DeepSpeedHealthCheckConfig)
from deepspeed_tpu_torch.runtime.utils import tree_leaves

LOSS_RTOL = 1e-4
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
TOKENS = np.random.default_rng(0).integers(0, 1024, (32, 33)).astype(np.int32)
GATE = np.ones((32,), np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def faults():
    """Both packages' harnesses, disarmed before and after."""
    jfault.reset()
    tfault.reset()
    yield
    jfault.reset()
    tfault.reset()


def _arm(spec):
    jfault.configure(spec)
    tfault.configure(spec)


# ---------------------------------------------------------------------------
# the monitor (test_health.py:179-315)
# ---------------------------------------------------------------------------
def _mons(**over):
    d = {"consecutive_skip_budget": 3, "rewind_limit": 1, "history": 8}
    d.update(over)
    pd = {"health_check": d}
    return (jhealth.HealthMonitor(JHealthConfig(pd)),
            thealth.HealthMonitor(DeepSpeedHealthCheckConfig(pd)))


def _metrics(pkg, loss=1.0, gnorm=1.0, skip=False, z=0.0, spike=False, with_z=True):
    if pkg == "jax":
        m = {"loss": jnp.float32(loss), "grad_norm": jnp.float32(gnorm),
             "skip": jnp.asarray(skip)}
        z_, s_ = jnp.float32(z), jnp.asarray(spike)
    else:
        m = {"loss": torch.tensor(loss, dtype=torch.float32),
             "grad_norm": torch.tensor(gnorm, dtype=torch.float32), "skip": torch.tensor(skip)}
        z_, s_ = torch.tensor(z, dtype=torch.float32), torch.tensor(spike)
    if with_z:
        m.update(health_z=z_, loss_spike=s_)
    return m


NAN = float("nan")
SKIP = dict(loss=NAN, skip=True)


def _observe(steps, **kw):
    return [("observe", s, kw) for s in steps]


MONITOR_SCRIPTS = {
    # test_monitor_escalation_ladder
    "escalation": ({}, _observe(range(3)) + _observe((3, 4), **SKIP) + [("flush",)]
                   + _observe((5,)) + [("flush",)] + _observe(range(6, 10), **SKIP)
                   + [("rewind", "good"), ("drop_pending",)]
                   + _observe(range(10, 14), **SKIP)),
    # test_monitor_rewind_limit_is_per_episode
    "episode": ({}, _observe(range(4), **SKIP) + [("rewind", "good"), ("drop_pending",)]
                + _observe((4,)) + [("flush",)] + _observe(range(5, 9), **SKIP)
                + [("rewind", "good"), ("drop_pending",)] + _observe(range(9, 13), **SKIP)),
    # test_monitor_on_exhausted_warn_resets_and_continues
    "warn": ({"rewind_limit": 0, "on_exhausted": "warn"},
             _observe(range(3), **SKIP) + [("flush",)] + _observe(range(3, 7), **SKIP)),
    # test_monitor_check_interval_sets_the_lag_window
    "check_interval": ({"check_interval": 4}, _observe(range(5), **SKIP) + [("flush",)]),
    # test_monitor_host_ema_fallback_for_streamed_metrics
    "host_ema": ({"spike_zmax": 3.0, "spike_window": 8},
                 _observe(range(12), with_z=False) + _observe((12,), loss=50.0, with_z=False)
                 + [("flush",)]),
    # a checkpoint load mid-episode, then a spike applied (warned) and a dump's inputs
    "load": ({"spike_zmax": 2.0},
             _observe(range(2), **SKIP) + [("load",)] + _observe((2, 3), **SKIP)
             + _observe((4,), z=5.0, spike=True) + [("flush",)]),
}


def _run_script(mon, pkg, script):
    trace = []
    for op in script:
        if op[0] == "observe":
            got = mon.observe(op[1], op[1], _metrics(pkg, **op[2]))
        elif op[0] == "flush":
            got = mon.flush()
        elif op[0] == "rewind":
            got = mon.record_rewind(tag=op[1])
        elif op[0] == "drop_pending":       # the engine's load drops the in-flight step
            mon._pending = []
            got = None
        else:
            got = mon.on_checkpoint_load()
        trace.append((got, mon.counters(), mon.clean_since_rewind, len(mon._pending),
                      json.dumps(jhealth.json_safe(list(mon.history)))))
    return trace


@pytest.mark.parametrize("name", sorted(MONITOR_SCRIPTS))
def test_monitor_matches_jax(name):
    """Every action, counter, pending count and history record equal to
    JAX's monitor's over the same sequence."""
    over, script = MONITOR_SCRIPTS[name]
    jmon, tmon = _mons(**over)
    want, got = _run_script(jmon, "jax", script), _run_script(tmon, "port", script)
    assert got == want
    assert isinstance(tmon.history, RingBuffer) and tmon.history.maxlen == 8
    actions = [t[0] for t in got]
    expect = {"escalation": "abort", "episode": "abort", "warn": "ok",
              "check_interval": "rewind", "host_ema": "ok", "load": "ok"}[name]
    assert [a for a in actions if a not in (None, "ok")][-1:] == (
        [expect] if expect != "ok" else [])


def test_forensic_dump_matches_jax(tmp_path):
    """The forensic file: JAX's payload keys and values (but the time),
    strict RFC 8259 JSON with the non-finite values as strings, written
    atomically."""
    payloads = []
    for pkg, mon in zip(("jax", "port"), _mons()):
        for s in range(4):
            mon.observe(s, s, _metrics(pkg, loss=NAN, gnorm=float("inf"), skip=True))
        mon.flush()
        path = mon.forensic_dump(str(tmp_path / pkg), "unit test", last_good_tag="global_step2")
        assert os.path.basename(path) == "health_forensics_step3.json"
        assert not os.path.exists(path + ".tmp")
        payloads.append(json.loads(open(path).read(), parse_constant=lambda tok: pytest.fail(
            f"non-RFC token {tok}")))
    want, got = payloads
    assert set(got) == set(want) and isinstance(got.pop("time_unix"), float)
    want.pop("time_unix")
    assert got == want
    assert got["history"][-1]["loss"] == "nan" and got["history"][-1]["grad_norm"] == "inf"
    assert got["counters"]["consecutive_skips"] == 4 and len(got["history"]) == 4
    assert thealth.write_forensics(str(tmp_path / "f" / "x.json"), "y.json", {}) is not None
    assert thealth.write_forensics(str(tmp_path), "bad.json", {"a": object()}) is None


def test_host_ema_matches_jax():
    j, t = jhealth.HostEma(8, 3.0), thealth.HostEma(8, 3.0)
    for loss in [1.0] * 6 + [1.5, NAN, 40.0, 1.1, 0.9]:
        assert t.update(loss) == j.update(loss)


# ---------------------------------------------------------------------------
# the config (test_health.py:88-117)
# ---------------------------------------------------------------------------
LADDER = ("enabled", "skip_nonfinite", "spike_window", "spike_zmax", "skip_on_spike",
          "consecutive_skip_budget", "rewind_limit", "on_exhausted", "check_interval",
          "history", "forensic_dir")


@pytest.mark.parametrize("h", [
    {}, {"consecutive_skip_budget": 0}, {"rewind_limit": 7, "on_exhausted": "warn"},
    {"check_interval": 3, "history": 5, "forensic_dir": "/f"},
    {"spike_window": 1}, {"on_exhausted": "pray"}, {"skip_on_spike": True},
    {"rewind_limit": -1}, {"consecutive_skip_budget": -1}, {"check_interval": 0},
    {"history": 0},
])
def test_health_config_matches_jax(h):
    """Every ladder key parses as in JAX, and what JAX refuses the port
    refuses."""
    pd = {"health_check": h}
    try:
        want = JHealthConfig(pd)
    except JConfigError:
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedHealthCheckConfig(pd)
        return
    got = DeepSpeedHealthCheckConfig(pd)
    assert {k: getattr(got, k) for k in LADDER} == {k: getattr(want, k) for k in LADDER}


def test_health_config_env_override(monkeypatch):
    monkeypatch.setenv("DSTPU_HEALTH_CHECK", "0")
    assert not DeepSpeedHealthCheckConfig({}).enabled
    monkeypatch.setenv("DSTPU_HEALTH_CHECK", "1")
    assert DeepSpeedHealthCheckConfig({"health_check": {"enabled": False}}).enabled


# ---------------------------------------------------------------------------
# the engines (test_health.py:405-546) on gpt2-tiny
# ---------------------------------------------------------------------------
def _cfg(stage=2, **over):
    cfg = {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
           "steps_per_print": 10 ** 9, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "zero_optimization": {"stage": stage}}
    cfg.update(over)
    return cfg


def _np_params():
    return JGPT2(preset="gpt2-tiny", max_seq=32).init_numpy(seed=0)


def _jax(cfg):
    m = JGPT2(preset="gpt2-tiny", dtype=jnp.bfloat16, max_seq=32, **NO_DROPOUT)
    return jds.initialize(config=dict(cfg, compile_cache={"enabled": False}), model=m,
                          loss_fn=lambda p, b, r: m.loss(p, b[0], r) * jnp.mean(b[1]),
                          params=_np_params(), training_data=(TOKENS, GATE),
                          mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]))[0]


def _port(cfg):
    m = GPT2(preset="gpt2-tiny", dtype=torch.bfloat16, device="cpu", max_seq=32, **NO_DROPOUT)
    return tds.initialize(config=dict(cfg), model=m, params=_np_params(),
                          training_data=(TOKENS, GATE),
                          loss_fn=lambda p, b, r: m.loss(p, b[0], r) * b[1].mean())[0]


def _params(e):
    if hasattr(e, "state"):
        return [np.asarray(x).view(np.uint16) for x in jax.tree_util.tree_leaves(e.state.params)]
    return [t.view(torch.int16).numpy().copy() for t in tree_leaves(e.params)]


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _rewind_replay(make, d, stage):
    """JAX's acceptance scenario: 3 steps, save "good", a grad_nan window
    over stream steps 3-7 and 9 steps, then 3 clean steps."""
    e = make(_cfg(stage, checkpoint={"dir": d},
                  health_check={"consecutive_skip_budget": 2, "rewind_limit": 3}))
    losses = [float(e.train_batch()) for _ in range(3)]
    e.save_checkpoint(d, tag="good")
    good = _params(e)
    _arm("grad_nan=3:8")
    losses.append(float(e.train_batch()))
    skipped_same = _same(_params(e), good) and e.skipped_steps == 1
    losses += [float(e.train_batch()) for _ in range(8)]
    mon = e.health_monitor
    state = (mon.rewinds, e.loaded_checkpoint_tag, e._stream_step, e.global_steps,
             mon.counters())
    after = [float(e.train_batch()) for _ in range(3)]
    return {"losses": losses, "after": after, "state": state, "skipped_same": skipped_same,
            "moved": not _same(_params(e), good), "skip": bool(e._last_metrics["skip"]),
            "global": e.global_steps, "stream": e._stream_step}


@pytest.mark.parametrize("stage", [2, 3])
def test_rewind_and_replay_matches_jax(tmp_path, faults, stage):
    """``test_rewind_and_replay_recovers_through_poison_window`` (stage 2)
    and ``test_rewind_zero3_variant``: the same rewinds, loaded tag,
    stream position, step count and counters as the JAX engine; the
    skipped step left the params bit-unchanged; the losses after the
    rewind within 1e-4."""
    want = _rewind_replay(_jax, str(tmp_path / "jax"), stage)
    jfault.reset()
    tfault.reset()
    got = _rewind_replay(_port, str(tmp_path / "port"), stage)
    assert got["state"] == want["state"]
    rewinds, tag, stream, steps, _ = got["state"]
    assert rewinds >= 1 and tag == "good" and stream > 8 and steps < stream
    assert got["skipped_same"] and want["skipped_same"] and got["moved"] and not got["skip"]
    assert all(np.isfinite(got["after"]))
    np.testing.assert_allclose(got["after"], want["after"], rtol=LOSS_RTOL)
    finite = [(a, b) for a, b in zip(got["losses"], want["losses"]) if np.isfinite(b)]
    assert [np.isfinite(x) for x in got["losses"]] == [np.isfinite(x) for x in want["losses"]]
    np.testing.assert_allclose(*zip(*finite), rtol=LOSS_RTOL)
    assert (got["global"], got["stream"]) == (want["global"], want["stream"])


def _abort(make, health, steps=5, clean=1):
    """``clean`` steps, then a grad_nan window from stream step ``clean``
    on: returns the error, its forensic payload and the steps run."""
    e = make(_cfg(0, health_check=health))
    for _ in range(clean):
        e.train_batch()
    _arm(f"grad_nan={clean}:100")
    n = 0
    with pytest.raises(Exception) as info:
        for n in range(1, steps + 1):
            e.train_batch()
    err = info.value
    payload = json.load(open(err.forensic_path)) if getattr(err, "forensic_path", None) else None
    return err, payload, n, e.health_monitor.counters()


def _same_abort(got, want, match):
    assert type(got[0]).__name__ == type(want[0]).__name__ == "TrainingHealthError"
    assert isinstance(got[0], thealth.TrainingHealthError)
    assert match in str(got[0]) and match in str(want[0])
    assert got[2:] == want[2:]
    g, w = got[1], want[1]
    for p in (g, w):
        p.pop("time_unix")
        for rec in p["history"]:        # bf16 losses of the two packages differ in the last bits
            rec.pop("loss")
            rec.pop("grad_norm")
            rec.pop("z")
    assert g == w
    return g


def test_exhausted_ladder_aborts_with_forensics_as_jax(tmp_path, faults):
    """``test_exhausted_ladder_aborts_with_forensics``: rewind_limit 0
    aborts with ``TrainingHealthError`` and the forensic file, at the same
    step and with the same payload as JAX's."""
    health = {"consecutive_skip_budget": 2, "rewind_limit": 0}
    want = _abort(_jax, dict(health, forensic_dir=str(tmp_path / "jax")))
    got = _abort(_port, dict(health, forensic_dir=str(tmp_path / "port")))
    p = _same_abort(got, want, "rewind limit spent")
    assert p["counters"]["consecutive_skips"] >= 2 and p["policy"]["rewind_limit"] == 0
    assert any(r["skip"] for r in p["history"])


def test_rewind_without_checkpoint_dir_aborts_as_jax(tmp_path, faults):
    """``test_rewind_without_checkpoint_dir_aborts_not_loops``."""
    health = {"consecutive_skip_budget": 2, "rewind_limit": 2}
    want = _abort(_jax, dict(health, forensic_dir=str(tmp_path / "jax")))
    got = _abort(_port, dict(health, forensic_dir=str(tmp_path / "port")))
    _same_abort(got, want, "rewind failed")


def test_default_health_check_aborts_as_jax(tmp_path, faults, monkeypatch):
    """The default ``health_check`` (budget 10, rewind limit 4, abort; no
    checkpoint directory): 10 consecutive skips escalate to a rewind that
    cannot run, and both packages abort with "rewind failed" at the same
    step, the forensic file in the working directory.  The parent port
    skipped forever."""
    results = []
    for pkg, make in (("jax", _jax), ("port", _port)):
        os.makedirs(tmp_path / pkg)
        monkeypatch.chdir(tmp_path / pkg)
        results.append(_abort(make, {}, steps=14))
    want, got = results
    p = _same_abort(got, want, "rewind failed")
    # the 10th skip is read when the 11th step is observed; the abort's flush adds the 11th
    assert got[2] == 11 and p["counters"]["total_skips"] == 11
    assert p["policy"]["consecutive_skip_budget"] == 10 and p["policy"]["rewind_limit"] == 4
    assert os.path.dirname(got[0].forensic_path) == str(tmp_path / "port")


def _stream_checks(make, d):
    """Stream restore and the fast-forward: 2 steps, save "s2", the next 6
    batches as drawn; a fresh engine's load draws the same; a rewind past
    stream step 5 lands on position 6."""
    e = make(_cfg(0))
    for _ in range(2):
        e.train_batch()
    e.save_checkpoint(d, tag="s2")
    ref = [np.asarray(next(e._data_iterator)[0]) for _ in range(6)]
    fresh = make(_cfg(0))
    fresh.load_checkpoint(d)
    restored = [np.asarray(next(fresh._data_iterator)[0]) for _ in range(3)]
    e.rewind(load_dir=d, replay_past=5)
    return ref, restored, fresh._stream_step, e._stream_step, np.asarray(
        next(e._data_iterator)[0])


def test_stream_restore_and_fast_forward_match_jax(tmp_path):
    """``test_checkpoint_restores_exact_batch_stream`` and
    ``test_rewind_fast_forward_jumps_to_exact_position``: the loader state
    rides the checkpoint, and the O(1) jump lands where draining would;
    the same batches as the JAX engine's."""
    want = _stream_checks(_jax, str(tmp_path / "jax"))
    got = _stream_checks(_port, str(tmp_path / "port"))
    ref, restored, fresh_step, step, nxt = got
    for a, b in zip(restored, ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert fresh_step == 2 and step == 6
    np.testing.assert_array_equal(nxt, ref[4])
    for a, b in zip(ref, want[0]):
        np.testing.assert_array_equal(a, b)
    assert (fresh_step, step) == want[2:4]


def test_rewind_without_known_position_does_not_fast_forward(tmp_path):
    """A rewind fast-forwards only a stream it knows (JAX :1810-1822): an
    engine with no loader of its own, or one that loaded a checkpoint
    without the loader's state, reloads and warns instead."""
    m = GPT2(preset="gpt2-tiny", dtype=torch.bfloat16, device="cpu", max_seq=32, **NO_DROPOUT)
    bare = tds.initialize(config=_cfg(0), model=m, params=_np_params(),
                          loss_fn=lambda p, b, r: m.loss(p, b[0], r) * b[1].mean())[0]
    bare.train_batch(iter([(TOKENS[:2], GATE[:2])]))
    bare.save_checkpoint(str(tmp_path), tag="s1")
    bare.rewind(replay_past=5)              # the directory it saved to; no iterator to move
    assert bare._stream_step == 1 and bare.loaded_checkpoint_tag == "s1"
    e = _port(_cfg(0))
    e.rewind(load_dir=str(tmp_path), replay_past=5)
    assert not e._stream_pos_known and e._stream_step == 1
    with pytest.raises(ValueError, match="checkpoint directory"):
        _port(_cfg(0)).rewind()


def test_offload_bf16_skip_step_and_counters(faults):
    """``test_offload_bf16_skip_step``: on the offload route a poisoned
    step leaves the host master and moments and the device params
    bit-unchanged; the monitor counts it as JAX's does, and
    ``stats()["health"]`` shows its counters."""
    cfg = _cfg(2, zero_optimization={"stage": 2, "offload_optimizer": {"device": "cpu"}})
    runs = []
    for make in (_jax, _port):
        jfault.reset()
        tfault.reset()
        e = make(cfg)
        e.train_batch()
        before = _params(e)
        master = np.array(e._offload.master)
        moments = [np.array(x) for x in e._offload.moments()]
        _arm("grad_nan=1")
        e.train_batch()
        e.health_monitor.flush()
        runs.append((e.skipped_steps, e.health_monitor.counters()))
        if make is _port:                   # the counters on the engine's stats surface
            assert e.stats()["health"] == e.health_monitor.counters()
        assert _same(_params(e), before)
        np.testing.assert_array_equal(e._offload.master, master)
        for a, b in zip(e._offload.moments(), moments):
            np.testing.assert_array_equal(a, b)
    assert runs[0] == runs[1] and runs[1][0] == 1
