"""Deterministic fault-injection harness for host-side IO paths.

Counterpart of ``deepspeed_tpu/fault/__init__.py``, ported whole:
``FaultPlan``, ``configure`` / ``reset`` / ``is_enabled`` / ``plan``,
``site``, ``InjectedCrash`` / ``InjectedIOError``, ``corrupt_batch``,
``corrupt_at`` and ``poison_uid``, with the same spec grammar, the same
``SITES`` and the ``DSTPU_FAULT`` environment variable.  The port's
callers are the checkpoint save path (``ckpt.*``), tree serialization
(``io.read`` / ``io.write``) and ``DeepSpeedEngine.train_batch``
(``engine.step`` and ``corrupt_batch`` on the host micro-batches).  The
serving and NVMe-swap sites are accepted by the plan and have no caller
in the port yet.

Zero overhead when disabled: ``site()`` is one module-global load and an
``is None`` test.  Hooks live only in host-side Python, never inside a
captured CUDA graph or a kernel, so the device work of a step is the same
with the harness armed or not; a value fault (``grad_nan`` /
``loss_spike``) rides the host batch before it is copied to the device.

Configuration (env ``DSTPU_FAULT`` or ``configure(spec)``) is a
comma-separated spec, e.g.::

    DSTPU_FAULT=ckpt_crash_after_model_file,io_error_p=0.2,io_delay_ms=50

tokens:
- ``crash_at=<site>[@N]``   raise ``InjectedCrash`` at the named site
                            (one-shot; ``@N`` defers it to the N-th visit)
- ``hang_at=<site>[@N]``    sleep ``hang_s`` seconds there (one-shot)
- ``hang_s=<float>``        hang_at sleep duration (default 0.25 s)
- ``<area>_crash_<point>``  sugar for ``crash_at=<area>.<point>``
- ``io_error_p=<float>``    each ``io.*`` / ``aio.*`` site raises
                            ``InjectedIOError`` with probability p
- ``io_delay_ms=<float>``   sleep this long at each io site
- ``max_faults=<int>``      cap on injected io errors
- ``seed=<int>``            seed for the probability draws
- ``grad_nan=<a>[:<b>]``    NaN-fill the float leaves of every batch whose
                            data-stream index is in [a, b)
- ``loss_spike=<a>[:<b>]``  scale them by ``spike_factor`` instead
- ``spike_factor=<float>``  loss_spike multiplier (default 1e4)
- ``corrupt_at=<site>[@N]`` in-place payload corruption, a query
                            (:func:`corrupt_at`)
- ``logit_nan=<uid>``       poison serving request ``uid`` (a query,
                            :func:`poison_uid`); may repeat
"""

import os
import random
import time

from ..utils.logging import logger

SITES = (
    "ckpt.after_model_file",   # model_states written to staging, optim not yet
    "ckpt.after_optim_file",   # both state files staged, manifest not yet
    "ckpt.before_commit",      # manifest staged, final rename not yet done
    "ckpt.after_commit",       # committed, `latest` pointer not yet updated
    "ckpt.before_latest",      # inside the latest-pointer update, pre-rename
    "io.write",                # serialization writes (save_tree)
    "io.read",                 # serialization reads (load_tree)
    "aio.submit",              # NVMe swap read/write submission
    "engine.step",             # host-side train_batch boundary
    "serving.step",            # serving scheduler iteration (host boundary)
    "serving.admit",           # serving admission (queue -> slot) boundary
    "serving.prefill",         # before a request's prefill dispatch
    # replica-worker loop boundaries (inference/router.py): one visit per
    # worker iteration, so `@N` kills/hangs a REPLICA mid-traffic — the
    # router chaos rung's deterministic replacement for ad-hoc SIGKILL
    "serving.replica_crash_step",   # worker dies here (no clean shutdown)
    "serving.replica_hang_step",    # worker stalls here, then continues
    # between computing a request's answer and journaling its finish:
    # the answered-but-not-durably-finished window (a crash here makes
    # the uid replay as PENDING although a result may already be out —
    # the router's dedup-by-uid case)
    "serving.journal_crash_finish",
    # KV snapshot/migration (docs/fault-tolerance.md#kv-migration):
    # between staging a stream's KV image and its commit rename — a
    # crash here leaves a torn `.tmp` snapshot that manifest resolution
    # must skip (detectable, never restorable)
    "serving.kv_snapshot_torn",
    # post-commit bit rot of a snapshot payload; a VALUE fault
    # (`corrupt_at=`, consulted via :func:`corrupt_at`, not a crash) —
    # restore must catch it via manifest/per-block digests and fall
    # back to recompute with a typed `migration_fallback` event
    "serving.kv_image_corrupt",
    # mid-restore on the SURVIVOR: blocks allocated, image not yet
    # seated — the restore path must unwind without leaking blocks
    "serving.crash_during_restore",
)

_IO_PREFIXES = ("io.", "aio.")


class InjectedCrash(BaseException):
    """Simulated preemption/kill at a named site.  Derives from
    BaseException so ordinary ``except Exception``/``except OSError``
    recovery code cannot accidentally swallow a "kill" — exactly like a
    real SIGKILL, only the test harness catches it."""


class InjectedIOError(OSError):
    """Simulated transient IO failure (retriable by classification)."""


def _parse_window(val):
    """``"a:b"`` -> (a, b); ``"a"`` -> (a, a+1).  Batch-index window,
    half-open."""
    val = str(val).strip()
    if ":" in val:
        a, b = val.split(":", 1)
        lo, hi = int(a), int(b)
    else:
        lo = int(val)
        hi = lo + 1
    if hi <= lo:
        raise ValueError(f"empty fault window {val!r} (need start < stop)")
    return (lo, hi)


def _parse_site_at(val):
    """``"site"`` -> (site, None); ``"site@N"`` -> (site, N) with N the
    1-based visit index the trigger fires on."""
    val = str(val).strip()
    if "@" in val:
        site_name, n = val.rsplit("@", 1)
        visit = int(n)
        if visit < 1:
            raise ValueError(f"visit index must be >= 1 in {val!r}")
        return site_name.strip(), visit
    return val, None


class FaultPlan:
    def __init__(self, crash_sites=(), io_error_p=0.0, io_delay_ms=0.0,
                 max_faults=None, seed=0, grad_nan=None, loss_spike=None,
                 spike_factor=1e4, logit_nan=(), crash_at_visit=None,
                 hang_at=None, hang_s=0.25, corrupt_at=None):
        # crash_at_visit / hang_at / corrupt_at: {site: visit} — fire on
        # that 1-based VISIT of the site (crash_sites entries fire on
        # the next visit)
        self.crash_at_visit = dict(crash_at_visit or {})
        self.hang_at = dict(hang_at or {})
        self.corrupt_at = dict(corrupt_at or {})
        self.hang_s = float(hang_s)
        unknown = (set(crash_sites) | set(self.crash_at_visit)
                   | set(self.hang_at) | set(self.corrupt_at)) - set(SITES)
        assert not unknown, f"unknown fault sites {sorted(unknown)}; " \
                            f"valid: {SITES}"
        self.crash_sites = set(crash_sites)
        self.io_error_p = float(io_error_p)
        self.io_delay_ms = float(io_delay_ms)
        self.max_faults = max_faults
        self.grad_nan = tuple(grad_nan) if grad_nan is not None else None
        self.loss_spike = (tuple(loss_spike) if loss_spike is not None
                           else None)
        self.spike_factor = float(spike_factor)
        if isinstance(logit_nan, int):
            logit_nan = (logit_nan,)
        self.logit_nan = frozenset(int(u) for u in logit_nan)
        self.rng = random.Random(seed)
        self.injected_io_errors = 0
        self.hits = {}            # site -> visit count (test observability)

    @classmethod
    def from_spec(cls, spec):
        crash, kw = [], {}
        for token in str(spec).split(","):
            token = token.strip()
            if not token:
                continue
            if "=" in token:
                key, val = token.split("=", 1)
                key = key.strip()
                if key == "crash_at":
                    site_name, visit = _parse_site_at(val)
                    if visit is None:
                        crash.append(site_name)
                    else:
                        kw.setdefault("crash_at_visit", {})[site_name] = visit
                elif key == "hang_at":
                    site_name, visit = _parse_site_at(val)
                    # visit None = fire on the very next visit
                    kw.setdefault("hang_at", {})[site_name] = visit or 1
                elif key == "corrupt_at":
                    site_name, visit = _parse_site_at(val)
                    kw.setdefault("corrupt_at", {})[site_name] = visit or 1
                elif key in ("io_error_p", "io_delay_ms", "spike_factor",
                             "hang_s"):
                    kw[key] = float(val)
                elif key in ("max_faults", "seed"):
                    kw[key] = int(val)
                elif key in ("grad_nan", "loss_spike"):
                    kw[key] = _parse_window(val)
                elif key == "logit_nan":
                    # may repeat: each token adds one poisoned uid
                    kw.setdefault("logit_nan", []).append(int(val))
                else:
                    raise ValueError(f"unknown fault spec key {key!r}")
            elif "_crash_" in token:
                area, point = token.split("_crash_", 1)
                crash.append(f"{area}.{point}")
            else:
                raise ValueError(f"cannot parse fault spec token {token!r}")
        return cls(crash_sites=crash, **kw)


_PLAN = None  # None = disabled; site() is a load + `is None` test


def configure(spec=None, **kwargs):
    """Arm the harness from a spec string, a FaultPlan, or kwargs."""
    global _PLAN
    if isinstance(spec, FaultPlan):
        _PLAN = spec
    elif spec is not None:
        _PLAN = FaultPlan.from_spec(spec)
    else:
        _PLAN = FaultPlan(**kwargs)
    logger.warning(f"fault injection ARMED: crash_sites="
                   f"{sorted(_PLAN.crash_sites)} io_error_p={_PLAN.io_error_p} "
                   f"io_delay_ms={_PLAN.io_delay_ms}")
    return _PLAN


def reset():
    global _PLAN
    _PLAN = None


def is_enabled():
    return _PLAN is not None


def plan():
    return _PLAN


def site(name, path=None):
    """Fault hook.  Host-side code only — never inside a captured graph."""
    if _PLAN is None:
        return
    p = _PLAN
    p.hits[name] = p.hits.get(name, 0) + 1
    if name in p.hang_at and p.hits[name] >= p.hang_at[name]:
        # one-shot stall that RESOLVES: the site continues afterwards
        del p.hang_at[name]
        logger.warning(f"fault: injected {p.hang_s}s hang at {name}")
        time.sleep(p.hang_s)
    if name in p.crash_at_visit and p.hits[name] >= p.crash_at_visit[name]:
        del p.crash_at_visit[name]    # one-shot, like crash_sites
        raise InjectedCrash(f"injected crash at {name} "
                            f"(visit {p.hits[name]})"
                            + (f" ({path})" if path else ""))
    if name in p.crash_sites:
        p.crash_sites.discard(name)   # one-shot: recovery can proceed
        raise InjectedCrash(f"injected crash at {name}"
                            + (f" ({path})" if path else ""))
    if name.startswith(_IO_PREFIXES):
        if p.io_delay_ms > 0:
            time.sleep(p.io_delay_ms / 1e3)
        if p.io_error_p > 0 and (p.max_faults is None
                                 or p.injected_io_errors < p.max_faults):
            if p.rng.random() < p.io_error_p:
                p.injected_io_errors += 1
                raise InjectedIOError(
                    f"injected IO error at {name}"
                    + (f" ({path})" if path else ""))


def _map_float_leaves(batch, fn):
    """Apply ``fn`` to every float numpy leaf of a host batch pytree
    (dict / tuple / list / ndarray), returning a new tree.  It runs on
    raw loader output, before the engine copies it to the device."""
    import numpy as np
    if isinstance(batch, dict):
        return {k: _map_float_leaves(v, fn) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map_float_leaves(v, fn) for v in batch)
    arr = np.asarray(batch)
    if np.issubdtype(arr.dtype, np.floating):
        return fn(arr)
    return batch


def corrupt_batch(batch, index):
    """Deterministic VALUE-corruption hook for the numerical fault sites.

    Host-side only, applied to the raw loader batch before the engine
    copies it to the device: the step's device work never changes, the
    poison simply rides the data.  ``index`` is the engine's monotonic data-stream batch
    index — checkpointed and restored with the data-pipeline state, so a
    rewind replays the SAME poison window and a fast-forward past it
    genuinely clears the fault.

    Zero overhead disarmed: one module-global load and an ``is None`` test.
    """
    if _PLAN is None:
        return batch
    import numpy as np
    p = _PLAN
    idx = int(index)

    def in_window(w):
        return w is not None and w[0] <= idx < w[1]

    if in_window(p.grad_nan):
        p.hits["fault.grad_nan"] = p.hits.get("fault.grad_nan", 0) + 1
        return _map_float_leaves(batch, lambda a: np.full_like(a, np.nan))
    if in_window(p.loss_spike):
        p.hits["fault.loss_spike"] = p.hits.get("fault.loss_spike", 0) + 1
        return _map_float_leaves(batch, lambda a: a * p.spike_factor)
    return batch


def corrupt_at(name):
    """True when the armed plan marks site ``name`` for in-place VALUE
    corruption (spec key ``corrupt_at=<site>[@N]``, one-shot).

    Like :func:`corrupt_batch`/:func:`poison_uid`, this is a QUERY, not
    a raise site: the owning code (the KV snapshot writer for
    ``serving.kv_image_corrupt``) flips its own committed payload bytes
    when this returns True — simulated bit rot the restore path must
    catch by digest, while the process itself keeps running."""
    if _PLAN is None:
        return False
    p = _PLAN
    p.hits[name] = p.hits.get(name, 0) + 1
    if name in p.corrupt_at and p.hits[name] >= p.corrupt_at[name]:
        del p.corrupt_at[name]        # one-shot, like crash_sites
        logger.warning(f"fault: injected payload corruption at {name} "
                       f"(visit {p.hits[name]})")
        return True
    return False


def poison_uid(uid):
    """True when the armed plan marks serving request ``uid`` as a
    ``logit_nan`` target (the serving quarantine's value fault).

    Like :func:`corrupt_batch`, this is NOT a call site: the serving
    scheduler consults it host-side after the request's prefill and
    NaN-fills the request's OWN KV pool blocks — the poison rides the
    data (slot-local by the paged layout's construction), and the
    decode step stays the same armed or not."""
    if _PLAN is None or not _PLAN.logit_nan:
        return False
    if int(uid) in _PLAN.logit_nan:
        _PLAN.hits["fault.logit_nan"] = \
            _PLAN.hits.get("fault.logit_nan", 0) + 1
        return True
    return False


# env wiring: a preemption-test job (or `deepspeed --fault=...` launch) arms
# the harness before any engine code runs
if os.environ.get("DSTPU_FAULT"):
    configure(os.environ["DSTPU_FAULT"])
