"""The port's fault-tolerance layer on the CPU: retry / backoff
(``utils/retry.py``), the atomic commit protocol (``checkpoint/atomic.py``),
the fault-injection harness (``fault/``), and the engine's crash windows,
fallback, rotation and auto-resume.

Twins of ``tests/test_fault_tolerance.py`` (retry :39-197, config
validation :197 / :222, atomic commit, latest, torn tags and rotation
:256-429, the harness, crash windows :637, corrupted-checkpoint fallback
:682, ``keep_n`` with IO errors :745, auto-resume :767 / :782) over the
port, with a two-layer MLP engine (``loss_fn`` + ``params``) in place of
``SimpleModel``; where the JAX module is deterministic under a seed the
port's draws are held equal to it."""

import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from deepspeed_tpu import fault as jfault
from deepspeed_tpu.checkpoint import atomic as jatomic
from deepspeed_tpu.utils.retry import RetryPolicy as JRetryPolicy

import deepspeed_tpu_torch as tds
from deepspeed_tpu_torch import fault
from deepspeed_tpu_torch.checkpoint import atomic
from deepspeed_tpu_torch.runtime.config import (DeepSpeedCheckpointConfig,
                                                DeepSpeedConfigError,
                                                DeepSpeedIORetryConfig)
from deepspeed_tpu_torch.runtime.utils import tree_leaves
from deepspeed_tpu_torch.utils.logging import logger as port_logger
from deepspeed_tpu_torch.utils.retry import NON_RETRIABLE, RetryPolicy, retry_call


@pytest.fixture
def fault_harness():
    """The port's harness, disarmed before and after the test."""
    fault.reset()
    yield fault
    fault.reset()


# ---------------------------------------------------------------------------
# retry / backoff
# ---------------------------------------------------------------------------
def _fast_policy(**kw):
    slept = []
    kw.setdefault("base_delay_s", 0.05)
    policy = RetryPolicy(sleep=slept.append, seed=kw.pop("seed", 0), **kw)
    return policy, slept


def test_retry_success_after_n():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy, slept = _fast_policy(max_attempts=5)
    assert retry_call(flaky, policy=policy) == "ok"
    assert len(calls) == 3 and len(slept) == 2


def test_retry_exhaustion_reraises_last():
    calls = []

    def always():
        calls.append(1)
        raise OSError(f"fail #{len(calls)}")

    policy, slept = _fast_policy(max_attempts=4)
    with pytest.raises(OSError, match="fail #4"):
        retry_call(always, policy=policy)
    assert len(calls) == 4 and len(slept) == 3


@pytest.mark.parametrize("exc_type", NON_RETRIABLE)
def test_retry_structural_errors_raise_immediately(exc_type):
    calls = []

    def structural():
        calls.append(1)
        raise exc_type("not transient")

    policy, slept = _fast_policy(max_attempts=5)
    with pytest.raises(exc_type):
        retry_call(structural, policy=policy)
    assert len(calls) == 1 and not slept


@pytest.mark.parametrize("mode", ["proportional", "full"])
def test_retry_jitter_bounds_cap_and_jax_draws(mode):
    """Bounds and the cap as in JAX, and the same delays as JAX's policy
    under the same seed (through ``clone`` too)."""
    policy = RetryPolicy(max_attempts=8, base_delay_s=0.1, max_delay_s=1.0, jitter=0.25,
                         jitter_mode=mode, seed=7)
    for attempt in range(8):
        nominal = min(0.1 * 2 ** attempt, 1.0)
        lo, hi = policy.delay_bounds(attempt)
        if mode == "full":
            assert lo == 0.0 and hi == pytest.approx(nominal)
        else:
            assert (lo, hi) == (pytest.approx(nominal * 0.75), pytest.approx(nominal * 1.25))
        for _ in range(50):
            assert lo <= policy.delay(attempt) <= hi
    assert policy.delay_bounds(100)[1] == pytest.approx(1.25 if mode != "full" else 1.0)
    a, j = RetryPolicy(seed=42, jitter_mode=mode), JRetryPolicy(seed=42, jitter_mode=mode)
    assert [a.delay(k) for k in range(6)] == [j.delay(k) for k in range(6)]
    c = RetryPolicy(seed=42, jitter_mode=mode).clone(max_attempts=9)
    d = RetryPolicy(seed=42, jitter_mode=mode)
    assert [c.delay(k) for k in range(5)] == [d.delay(k) for k in range(5)]
    with pytest.raises(AssertionError):
        RetryPolicy(jitter_mode="thundering_herd")


def test_retry_on_retry_hook_runs_before_backoff():
    events = []

    def flaky():
        events.append("call")
        if events.count("call") < 2:
            raise OSError("x")
        return 1

    policy, _ = _fast_policy()
    retry_call(flaky, policy=policy, on_retry=lambda attempt, exc: events.append("drain"))
    assert events == ["call", "drain", "call"]


def test_retry_elapsed_cap_stops_retrying():
    now, slept, calls = [0.0], [], []

    def fake_sleep(d):
        slept.append(d)
        now[0] += d

    def always():
        calls.append(1)
        now[0] += 1.0
        raise OSError(f"fail #{len(calls)}")

    policy = RetryPolicy(max_attempts=10, base_delay_s=0.5, max_delay_s=0.5, jitter=0.0,
                         max_elapsed_s=4.0, sleep=fake_sleep, clock=lambda: now[0], seed=0)
    with pytest.raises(OSError, match="fail #3"):
        retry_call(always, policy=policy)
    assert len(calls) == 3 and len(slept) == 2 and now[0] <= 4.0
    now[0] = 0.0
    calls.clear()
    policy = RetryPolicy(max_attempts=4, base_delay_s=0.5, max_delay_s=0.5, jitter=0.0,
                         sleep=fake_sleep, clock=lambda: now[0], seed=0)
    with pytest.raises(OSError, match="fail #4"):
        retry_call(always, policy=policy)
    assert len(calls) == 4


def test_retry_elapsed_cap_allows_success_within_budget():
    now, calls = [0.0], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    policy = RetryPolicy(max_attempts=5, base_delay_s=0.01, jitter=0.0, max_elapsed_s=60.0,
                         sleep=lambda d: now.__setitem__(0, now[0] + d),
                         clock=lambda: now[0], seed=0)
    assert retry_call(flaky, policy=policy) == "ok"


def test_io_retry_config_validation():
    policy = DeepSpeedIORetryConfig({"io_retry": {"max_attempts": 3,
                                                  "base_delay_s": 0.01}}).policy()
    assert (policy.max_attempts, policy.base_delay_s) == (3, 0.01)
    assert policy.jitter_mode == "proportional" and policy.max_elapsed_s is None
    policy = DeepSpeedIORetryConfig({"io_retry": {"full_jitter": True,
                                                  "max_elapsed_s": 30}}).policy()
    assert policy.jitter_mode == "full" and policy.max_elapsed_s == 30.0
    for bad in ({"max_elapsed_s": 0}, {"max_attempts": 0}, {"jitter": 1.5},
                {"base_delay_s": -1}, {"max_delay_s": -0.5}):
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedIORetryConfig({"io_retry": bad})


def test_checkpoint_config_validation():
    cfg = DeepSpeedCheckpointConfig({"checkpoint": {"keep_n": 3, "verify": "size"}})
    assert cfg.keep_n == 3 and cfg.verify == "size"
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedCheckpointConfig({"checkpoint": {"keep_n": -1}})
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedCheckpointConfig({"checkpoint": {"verify": "paranoid"}})


# ---------------------------------------------------------------------------
# atomic commit protocol
# ---------------------------------------------------------------------------
def _stage_fake_ckpt(save_dir, tag, step, payload=b"x" * 256, mod=atomic):
    staged = mod.stage_path(str(save_dir), tag)
    os.makedirs(staged, exist_ok=True)
    for name in ("model_states.msgpack", "optim_states.msgpack"):
        with open(os.path.join(staged, name), "wb") as f:
            f.write(payload + tag.encode() + name.encode())
    mod.write_manifest(staged, meta={"tag": tag, "global_steps": step})
    return staged


def _commit_fake_ckpt(save_dir, tag, step, mod=atomic, **kw):
    _stage_fake_ckpt(save_dir, tag, step, mod=mod, **kw)
    final = mod.commit_staged(str(save_dir), tag)
    mod.write_latest(str(save_dir), tag)
    return final


def test_atomic_latest_pointer_roundtrip(tmp_path):
    assert atomic.read_latest(str(tmp_path)) is None
    atomic.write_latest(str(tmp_path), "step5")
    assert atomic.read_latest(str(tmp_path)) == "step5"
    atomic.write_latest(str(tmp_path), "step9")
    assert atomic.read_latest(str(tmp_path)) == "step9"
    assert not os.path.exists(os.path.join(str(tmp_path), "latest.tmp"))


def test_commit_staged_publishes_and_clears_staging(tmp_path):
    final = _commit_fake_ckpt(tmp_path, "A", 1)
    assert os.path.isdir(final) and not os.path.isdir(atomic.stage_path(str(tmp_path), "A"))
    ok, problems = atomic.verify_checkpoint(final)
    assert ok, problems


def test_commit_replaces_existing_tag_without_zero_copy_window(tmp_path):
    _commit_fake_ckpt(tmp_path, "A", 1, payload=b"old" * 100)
    _commit_fake_ckpt(tmp_path, "A", 2, payload=b"new" * 100)
    final = os.path.join(str(tmp_path), "A")
    ok, problems = atomic.verify_checkpoint(final)
    assert ok, problems
    assert atomic.read_manifest(final)["meta"]["global_steps"] == 2
    assert not os.path.isdir(final + ".replaced")


@pytest.mark.parametrize("writer,reader", [(atomic, jatomic), (jatomic, atomic)],
                         ids=["port-to-jax", "jax-to-port"])
def test_manifests_verify_across_packages(tmp_path, writer, reader):
    """A tag committed by one package verifies, resolves and rotates in the
    other (the same manifest format)."""
    for step, tag in enumerate(["A", "B", "C"], start=1):
        _commit_fake_ckpt(tmp_path, tag, step, mod=writer)
    assert reader.verify_checkpoint(os.path.join(str(tmp_path), "C"))[0]
    assert reader.read_latest(str(tmp_path)) == "C"
    assert reader.find_latest_valid(str(tmp_path)) == "C"
    assert sorted(reader.rotate_checkpoints(str(tmp_path), keep_n=1)) == ["A", "B"]


def test_verify_detects_truncation_corruption_and_missing(tmp_path):
    final = _commit_fake_ckpt(tmp_path, "A", 1)
    model = os.path.join(final, "model_states.msgpack")
    orig = open(model, "rb").read()
    with open(model, "wb") as f:
        f.write(orig[:-7])
    ok, problems = atomic.verify_checkpoint(final, level="size")
    assert not ok and any("size" in p for p in problems)
    with open(model, "wb") as f:
        f.write(bytes([orig[0] ^ 0xFF]) + orig[1:])
    assert atomic.verify_checkpoint(final, level="size")[0]
    ok, problems = atomic.verify_checkpoint(final, level="full")
    assert not ok and any("sha256" in p for p in problems)
    os.remove(model)
    ok, problems = atomic.verify_checkpoint(final, level="size")
    assert not ok and any("missing" in p for p in problems)
    with open(os.path.join(final, atomic.MANIFEST_FILE), "w") as f:
        f.write('{"version": 1, "files": {tru')
    assert not atomic.verify_checkpoint(final, level="off")[0]
    os.remove(os.path.join(final, atomic.MANIFEST_FILE))
    assert not atomic.verify_checkpoint(final, level="off")[0]
    assert not atomic.verify_checkpoint(_stage_fake_ckpt(tmp_path, "B", 2))[0]


def test_find_latest_valid_orders_by_step_and_skips_torn(tmp_path):
    _commit_fake_ckpt(tmp_path, "A", 1)
    _commit_fake_ckpt(tmp_path, "B", 2)
    final_c = _commit_fake_ckpt(tmp_path, "C", 3)
    assert atomic.find_latest_valid(str(tmp_path)) == "C"
    os.remove(os.path.join(final_c, "optim_states.msgpack"))
    assert atomic.find_latest_valid(str(tmp_path)) == "B"
    assert atomic.find_latest_valid(str(tmp_path), exclude=("B",)) == "A"


def test_clean_stale_staging(tmp_path):
    _commit_fake_ckpt(tmp_path, "A", 1)
    _stage_fake_ckpt(tmp_path, "B", 2)
    assert atomic.clean_stale_staging(str(tmp_path)) == ["B.tmp"]
    assert atomic.list_tags(str(tmp_path)) == ["A"]


def test_clean_stale_staging_restores_orphaned_replaced_dir(tmp_path):
    _commit_fake_ckpt(tmp_path, "A", 1)
    os.rename(os.path.join(str(tmp_path), "A"), os.path.join(str(tmp_path), "A.replaced"))
    atomic.clean_stale_staging(str(tmp_path))
    assert atomic.list_tags(str(tmp_path)) == ["A"]
    assert atomic.verify_checkpoint(os.path.join(str(tmp_path), "A"))[0]
    _commit_fake_ckpt(tmp_path, "B", 2)
    os.makedirs(os.path.join(str(tmp_path), "B.replaced"))
    atomic.clean_stale_staging(str(tmp_path))
    assert not os.path.isdir(os.path.join(str(tmp_path), "B.replaced"))
    assert "B" in atomic.list_tags(str(tmp_path))


def test_clean_stale_staging_min_age_spares_young_tmp(tmp_path):
    _commit_fake_ckpt(tmp_path, "A", 1)
    fresh = _stage_fake_ckpt(tmp_path, "B", 2)
    old = _stage_fake_ckpt(tmp_path, "C", 3)
    past = os.path.getmtime(old) - 3600
    os.utime(old, (past, past))
    assert atomic.clean_stale_staging(str(tmp_path), min_age_s=900) == ["C.tmp"]
    assert os.path.isdir(fresh)
    assert atomic.clean_stale_staging(str(tmp_path)) == ["B.tmp"]


def test_verify_unreadable_file_is_a_problem_not_a_crash(tmp_path, monkeypatch):
    _commit_fake_ckpt(tmp_path, "A", 1)
    final_b = _commit_fake_ckpt(tmp_path, "B", 2)
    bad = os.path.join(final_b, "model_states.msgpack")
    real = atomic.sha256_file

    def flaky_sha(path):
        if path == bad:
            raise PermissionError(13, "injected unreadable file", path)
        return real(path)

    monkeypatch.setattr(atomic, "sha256_file", flaky_sha)
    ok, problems = atomic.verify_checkpoint(final_b, level="full")
    assert not ok and any("unreadable" in p for p in problems)
    assert atomic.find_latest_valid(str(tmp_path)) == "A"


def test_legacy_checkpoints_visible_to_auto_resume_and_fallback(tmp_path):
    legacy = os.path.join(str(tmp_path), "global_step5")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "model_states.msgpack"), "wb") as f:
        f.write(b"old layout")
    assert atomic.is_legacy_checkpoint(legacy) and atomic.has_checkpoint(str(tmp_path))
    assert atomic.find_legacy_tags(str(tmp_path)) == ["global_step5"]
    os.makedirs(os.path.join(str(tmp_path), "tensorboard"))
    assert not atomic.is_legacy_checkpoint(os.path.join(str(tmp_path), "tensorboard"))
    with open(os.path.join(legacy, atomic.MANIFEST_FILE), "w") as f:
        f.write("{not json")
    assert not atomic.is_legacy_checkpoint(legacy)


def test_rotate_never_touches_non_checkpoint_dirs(tmp_path):
    os.makedirs(os.path.join(str(tmp_path), "tensorboard"))
    legacy = os.path.join(str(tmp_path), "legacy_ckpt")
    os.makedirs(legacy)
    with open(os.path.join(legacy, "model_states.msgpack"), "wb") as f:
        f.write(b"old layout, no manifest")
    for step, tag in enumerate(["A", "B", "C"], start=1):
        _commit_fake_ckpt(tmp_path, tag, step)
    assert sorted(atomic.rotate_checkpoints(str(tmp_path), keep_n=1)) == ["A", "B"]
    assert os.path.isdir(os.path.join(str(tmp_path), "tensorboard")) and os.path.isdir(legacy)


def test_rotate_keep_n_never_deletes_newest_valid(tmp_path):
    for step, tag in enumerate(["A", "B", "C", "D"], start=1):
        _commit_fake_ckpt(tmp_path, tag, step)
    assert sorted(atomic.rotate_checkpoints(str(tmp_path), keep_n=2)) == ["A", "B"]
    assert sorted(atomic.list_tags(str(tmp_path))) == ["C", "D"]
    _commit_fake_ckpt(tmp_path, "E", 5)
    for tag in ("D", "E"):
        os.remove(os.path.join(str(tmp_path), tag, "model_states.msgpack"))
    atomic.rotate_checkpoints(str(tmp_path), keep_n=2, level="size")
    assert "C" in atomic.list_tags(str(tmp_path))
    assert atomic.find_latest_valid(str(tmp_path), level="size") == "C"


# ---------------------------------------------------------------------------
# the fault harness
# ---------------------------------------------------------------------------
def test_fault_sites_and_spec_parsing_match_jax(fault_harness):
    assert fault_harness.SITES == jfault.SITES
    spec = "ckpt_crash_after_model_file,io_error_p=0.2,io_delay_ms=50,max_faults=3,seed=11"
    plan = fault_harness.FaultPlan.from_spec(spec)
    assert plan.crash_sites == {"ckpt.after_model_file"}
    assert (plan.io_error_p, plan.io_delay_ms, plan.max_faults) == (0.2, 50.0, 3)
    plan = fault_harness.FaultPlan.from_spec("crash_at=engine.step@3,hang_at=io.read,"
                                             "grad_nan=2:4,logit_nan=5,logit_nan=7")
    assert plan.crash_at_visit == {"engine.step": 3} and plan.hang_at == {"io.read": 1}
    assert plan.grad_nan == (2, 4) and plan.logit_nan == {5, 7}
    with pytest.raises(AssertionError):
        fault_harness.FaultPlan.from_spec("crash_at=no.such.site")
    with pytest.raises(ValueError):
        fault_harness.FaultPlan.from_spec("warp_speed=9")


def test_fault_site_disarmed_is_noop(fault_harness):
    assert not fault_harness.is_enabled()
    fault_harness.site("io.write")
    assert fault_harness.plan() is None
    batch = (np.ones(3, np.float32),)
    assert fault_harness.corrupt_batch(batch, 0) is batch


def test_fault_crash_is_one_shot(fault_harness):
    fault_harness.configure("crash_at=io.write")
    with pytest.raises(fault_harness.InjectedCrash):
        fault_harness.site("io.write")
    fault_harness.site("io.write")
    assert fault_harness.plan().hits["io.write"] == 2


def test_fault_io_errors_deterministic_capped_and_as_jax(fault_harness):
    def run(mod):
        mod.configure(io_error_p=0.5, max_faults=4, seed=3)
        outcomes = []
        for _ in range(64):
            try:
                mod.site("aio.submit")
                outcomes.append(0)
            except mod.InjectedIOError:
                outcomes.append(1)
        mod.reset()
        return outcomes

    first, second = run(fault_harness), run(fault_harness)
    assert first == second == run(jfault) and sum(first) == 4
    assert isinstance(fault_harness.InjectedIOError("x"), OSError)


def test_injected_crash_not_swallowed_by_except_exception(fault_harness):
    fault_harness.configure("crash_at=io.write")
    with pytest.raises(fault_harness.InjectedCrash):
        try:
            fault_harness.site("io.write")
        except Exception:
            pytest.fail("InjectedCrash must escape `except Exception`")


def test_value_faults_match_jax(fault_harness):
    """``corrupt_batch`` / ``corrupt_at`` / ``poison_uid`` give JAX's
    answers on the same plan."""
    batch = {"x": np.arange(4, dtype=np.float32), "i": np.arange(2)}
    for spec in ("grad_nan=1:3", "loss_spike=0,spike_factor=10",
                 "corrupt_at=serving.kv_image_corrupt@2,logit_nan=4"):
        fault_harness.configure(spec)
        jfault.configure(spec)
        try:
            for idx in range(4):
                got, want = fault_harness.corrupt_batch(batch, idx), jfault.corrupt_batch(batch, idx)
                np.testing.assert_array_equal(got["x"], want["x"])
                assert got["i"] is batch["i"]
            assert [fault_harness.corrupt_at("serving.kv_image_corrupt") for _ in range(3)] == \
                [jfault.corrupt_at("serving.kv_image_corrupt") for _ in range(3)]
            assert [fault_harness.poison_uid(u) for u in range(6)] == \
                [jfault.poison_uid(u) for u in range(6)]
        finally:
            jfault.reset()


# ---------------------------------------------------------------------------
# engine-level recovery
# ---------------------------------------------------------------------------
def _mlp_params(seed):
    rng = np.random.default_rng(seed)
    return {"layer_0": {"w": (rng.standard_normal((8, 32)) / np.sqrt(8)).astype(np.float32),
                        "b": np.zeros(32, np.float32)},
            "layer_1": {"w": (rng.standard_normal((32, 8)) / np.sqrt(32)).astype(np.float32),
                        "b": np.zeros(8, np.float32)}}


def _mlp_loss(p, batch, seed):
    h = torch.relu(batch[0] @ p["layer_0"]["w"] + p["layer_0"]["b"])
    return (h @ p["layer_1"]["w"] + p["layer_1"]["b"] - batch[1]).square().mean()


def _dataset(n=64):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return (x, (x @ (rng.normal(size=(8, 8)).astype(np.float32) * 0.5)).astype(np.float32))


def _config(**kw):
    cfg = {"train_micro_batch_size_per_gpu": 4, "steps_per_print": 1000,
           "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(kw)
    return cfg


def _make_engine(seed=0, auto_resume=None, **cfg_kw):
    return tds.initialize(config=_config(**cfg_kw), loss_fn=_mlp_loss, params=_mlp_params(seed),
                          training_data=_dataset(), device="cpu", auto_resume=auto_resume)[0]


def test_mid_save_crash_then_auto_fallback_resume(tmp_path, fault_harness):
    """A kill after model_states is staged leaves ``latest`` and the newest
    committed tag untouched; a restarting job auto-resumes there, the
    load path leaves the young ``.tmp`` alone, and the next save sweeps it."""
    save_dir = str(tmp_path)
    engine = _make_engine()
    for _ in range(3):
        engine.train_batch()
    engine.save_checkpoint(save_dir, tag="good")
    ref = [t.clone() for t in tree_leaves(engine.params)]
    engine.train_batch()
    fault_harness.configure("ckpt_crash_after_model_file")
    with pytest.raises(fault_harness.InjectedCrash):
        engine.save_checkpoint(save_dir, tag="torn")
    assert os.path.isdir(os.path.join(save_dir, "torn.tmp"))
    assert not os.path.isdir(os.path.join(save_dir, "torn"))
    assert atomic.read_latest(save_dir) == "good"
    ok, problems = atomic.verify_checkpoint(os.path.join(save_dir, "good"), level="full")
    assert ok, problems
    engine2 = _make_engine(seed=99, checkpoint={"dir": save_dir, "auto_resume": True,
                                                "verify": "full"})
    assert os.path.isdir(os.path.join(save_dir, "torn.tmp"))
    assert engine2.global_steps == 3 and engine2.loaded_checkpoint_tag == "good"
    for a, b in zip(ref, tree_leaves(engine2.params)):
        assert torch.equal(a, b)
    assert np.isfinite(float(engine2.train_batch()))
    engine2.save_checkpoint(save_dir, tag="resumed")
    assert not os.path.isdir(os.path.join(save_dir, "torn.tmp"))


def test_crash_windows_around_commit(tmp_path, fault_harness):
    """Before the commit rename: B is staged and manifested but invisible;
    after the commit, before ``latest``: a stale pointer at a valid tag
    that load follows, while the newest-valid scan finds B."""
    dir_pre = os.path.join(str(tmp_path), "pre_commit")
    dir_post = os.path.join(str(tmp_path), "post_commit")
    engine = _make_engine()
    engine.train_batch()
    engine.save_checkpoint(dir_pre, tag="A")
    engine.save_checkpoint(dir_post, tag="A")
    engine.train_batch()
    fault_harness.configure("crash_at=ckpt.before_commit")
    with pytest.raises(fault_harness.InjectedCrash):
        engine.save_checkpoint(dir_pre, tag="B")
    assert os.path.isdir(os.path.join(dir_pre, "B.tmp"))
    assert not os.path.isdir(os.path.join(dir_pre, "B"))
    fault_harness.configure("crash_at=ckpt.after_commit")
    with pytest.raises(fault_harness.InjectedCrash):
        engine.save_checkpoint(dir_post, tag="B")
    assert atomic.read_latest(dir_post) == "A"
    assert atomic.verify_checkpoint(os.path.join(dir_post, "B"))[0]
    assert atomic.find_latest_valid(dir_post) == "B"
    engine2 = _make_engine(seed=7)
    for save_dir in (dir_pre, dir_post):
        path, _ = engine2.load_checkpoint(save_dir)
        assert path.endswith("A") and engine2.global_steps == 1


@pytest.mark.parametrize("site", ["ckpt.after_optim_file", "ckpt.before_latest"])
def test_other_crash_sites_leave_the_previous_tag_loadable(tmp_path, fault_harness, site):
    engine = _make_engine()
    engine.train_batch()
    engine.save_checkpoint(str(tmp_path), tag="A")
    engine.train_batch()
    fault_harness.configure(f"crash_at={site}")
    with pytest.raises(fault_harness.InjectedCrash):
        engine.save_checkpoint(str(tmp_path), tag="B")
    assert fault_harness.plan().hits[site] == 1
    assert atomic.read_latest(str(tmp_path)) == "A"
    path, _ = _make_engine(seed=3).load_checkpoint(str(tmp_path))
    assert path.endswith("A")


class _RecordingHandler(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_corrupted_checkpoint_falls_back_with_structured_warning(tmp_path):
    save_dir = str(tmp_path)
    engine = _make_engine()
    engine.train_batch()
    engine.save_checkpoint(save_dir, tag="A")
    engine.train_batch()
    engine.save_checkpoint(save_dir, tag="B")
    model = os.path.join(save_dir, "B", "model_states.msgpack")
    raw = bytearray(open(model, "rb").read())
    raw[100] ^= 0xFF
    with open(model, "wb") as f:
        f.write(bytes(raw))
    engine2 = _make_engine(seed=7)
    handler = _RecordingHandler()
    port_logger.addHandler(handler)
    try:
        path, _ = engine2.load_checkpoint(save_dir)
    finally:
        port_logger.removeHandler(handler)
    assert path.endswith("A") and engine2.global_steps == 1
    logs = [m for m in handler.messages if "checkpoint_fallback" in m]
    assert logs, "fallback must emit a structured warning"
    payload = json.loads(logs[0].split("engaged: ", 1)[1])
    assert (payload["unusable_tag"], payload["fallback_tag"]) == ("B", "A")
    with pytest.raises(atomic.CheckpointValidationError):
        engine2.load_checkpoint(save_dir, tag="B")
    # a manifest-less (legacy) tag loads with a warning
    shutil.rmtree(os.path.join(save_dir, "B"))
    os.remove(os.path.join(save_dir, "A", atomic.MANIFEST_FILE))
    atomic.write_latest(save_dir, "A")
    path, _ = engine2.load_checkpoint(save_dir)
    assert path.endswith("A") and engine2.global_steps == 1
    # with no usable `latest` the legacy tag is the fallback of last resort
    os.remove(os.path.join(save_dir, atomic.LATEST_FILE))
    path, _ = engine2.load_checkpoint(save_dir)
    assert path.endswith("A")
    # a corrupt manifest is a torn tag, never a legacy one: nothing loads
    with open(os.path.join(save_dir, "A", atomic.MANIFEST_FILE), "w") as f:
        f.write('{"version": 1, "files"')
    with pytest.raises(FileNotFoundError):
        engine2.load_checkpoint(save_dir)


def test_engine_keep_n_rotation_and_io_error_retry(tmp_path, fault_harness):
    rot_dir = os.path.join(str(tmp_path), "rotation")
    io_dir = os.path.join(str(tmp_path), "io_errors")
    engine = _make_engine(checkpoint={"keep_n": 2})
    for tag in ("s1", "s2", "s3"):
        engine.train_batch()
        engine.save_checkpoint(rot_dir, tag=tag)
    assert sorted(atomic.list_tags(rot_dir)) == ["s2", "s3"]
    assert atomic.read_latest(rot_dir) == "s3"
    fault_harness.configure(io_error_p=1.0, max_faults=2, seed=0)
    engine.save_checkpoint(io_dir, tag="A")
    assert fault_harness.plan().injected_io_errors == 2
    ok, problems = atomic.verify_checkpoint(os.path.join(io_dir, "A"), level="full")
    assert ok, problems


def test_io_errors_past_the_retry_policy_raise(tmp_path, fault_harness):
    """No fallback: a write that fails every attempt raises and commits
    nothing."""
    engine = _make_engine(io_retry={"max_attempts": 2, "base_delay_s": 0.0})
    fault_harness.configure(io_error_p=1.0, seed=0)
    with pytest.raises(fault_harness.InjectedIOError):
        engine.save_checkpoint(str(tmp_path), tag="A")
    assert fault_harness.plan().injected_io_errors == 2
    assert atomic.list_tags(str(tmp_path)) == [] and atomic.read_latest(str(tmp_path)) is None


def test_env_can_disable_config_auto_resume(tmp_path, monkeypatch):
    save_dir = str(tmp_path)
    engine = _make_engine()
    engine.train_batch()
    engine.save_checkpoint(save_dir)
    monkeypatch.setenv("DSTPU_AUTO_RESUME", "0")
    engine2 = _make_engine(checkpoint={"dir": save_dir, "auto_resume": True})
    assert engine2.global_steps == 0
    monkeypatch.setenv("DSTPU_AUTO_RESUME", "1")
    assert _make_engine(checkpoint={"dir": save_dir}).global_steps == 1
    # the kwarg wins over the environment
    assert _make_engine(checkpoint={"dir": save_dir}, auto_resume=False).global_steps == 0


def test_auto_resume_cold_start_is_not_an_error(tmp_path):
    os.makedirs(os.path.join(str(tmp_path), "tensorboard"))
    engine = _make_engine(checkpoint={"dir": str(tmp_path), "auto_resume": True})
    assert engine.global_steps == 0 and engine.loaded_checkpoint_tag is None
    assert np.isfinite(float(engine.train_batch()))


def test_engine_step_site_and_grad_nan_ride_the_data(fault_harness):
    """``engine.step`` crashes ``train_batch`` before it draws a batch; a
    ``grad_nan`` window poisons the step whose stream index it covers,
    which the health sentinel skips."""
    engine = _make_engine()
    fault_harness.configure("crash_at=engine.step@2,grad_nan=3")
    engine.train_batch()
    with pytest.raises(fault_harness.InjectedCrash):
        engine.train_batch()
    assert engine._stream_step == 1 and engine.global_steps == 1
    for _ in range(3):
        engine.train_batch()
    assert engine._stream_step == 4 and engine.skipped_steps == 1
    assert fault_harness.plan().hits["fault.grad_nan"] == 1
