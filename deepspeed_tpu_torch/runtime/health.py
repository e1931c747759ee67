"""The training health guardian: device sentinels and the host ladder.

Counterpart of ``deepspeed_tpu/runtime/health.py`` (lines 48-461), the
ladder detect -> skip -> rewind to the last good checkpoint -> replay
past the poison window -> abort with forensics.

Device sentinels: ``HealthState`` / ``init_state``, ``tree_nonfinite``,
``rows_nonfinite`` and ``update_ema``.  Every function returns device
tensors and reads nothing back to the host, so the engine's branchless
skip-step needs no sync.  :func:`update_ema` returns a new state, as
JAX's does; the engine copies it into its ``HealthState`` tensors in
place (gated by the step's ``commit`` flag), so a captured step keeps
reading and writing the same storage.

Host ladder: :class:`HealthMonitor` (``observe`` with its
``check_interval`` lag window, ``flush``, ``_ingest`` / ``_decide``,
``record_rewind`` with per-episode rewinds, ``on_checkpoint_load``,
``counters``, ``forensic_dump``), :class:`HostEma`, :func:`json_safe`,
:func:`write_forensics` and :class:`TrainingHealthError`, with JAX's
actions, counters, history records and forensic payload keys.  The
monitor reads each step's metrics (``float`` / ``bool``) only
``check_interval`` steps later.  On the card the engine hands it
:class:`LandedScalar` s: the step's sentinels copied to pinned memory
right behind the step, so the late read waits on that step alone, where
a JAX array's read waits on its own computation only and a CUDA tensor's
``.item()`` would wait on everything queued since.  Deliberate
difference: no ``bus`` argument (the monitor bus is not ported, ROADMAP
item 14), so rewinds and dumps are announced in the log only.
"""

import json
import math
import os
import time
from typing import NamedTuple, Optional

import torch

from ..monitor.ring import RingBuffer
from ..utils.logging import log_dist, logger
from .utils import tree_leaves


class TrainingHealthError(RuntimeError):
    """The ladder is exhausted (``on_exhausted: "abort"``); the forensic
    dump's path, where one was written, is ``forensic_path``."""

    def __init__(self, message, forensic_path=None):
        super().__init__(message)
        self.forensic_path = forensic_path


class HealthState(NamedTuple):
    """EMA statistics of the training loss (0-dim device tensors)."""
    ema_loss: torch.Tensor   # f32 — EMA of the (finite) loss
    ema_sq: torch.Tensor     # f32 — EMA of the squared (finite) loss
    count: torch.Tensor      # i32 — finite-loss observations absorbed


def init_state(device=None) -> HealthState:
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    return HealthState(ema_loss=z(torch.float32), ema_sq=z(torch.float32),
                       count=z(torch.int32))


def tree_nonfinite(tree) -> torch.Tensor:
    """Global any-non-finite flag over the floating leaves of a tree
    (integer leaves skipped; an empty tree is finite)."""
    leaves = [l for l in tree_leaves(tree) if l.is_floating_point()]
    if not leaves:
        return torch.zeros((), dtype=torch.bool)
    return torch.stack([~torch.isfinite(l).all() for l in leaves]).any()


def rows_nonfinite(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-row any-non-finite flag, reduced over ``dim`` only.

    The serving quarantine computes it on the decode logits, one bool
    per batch slot, on the device and before any host read, so a
    poisoned request is evicted while its neighbours' rows are
    untouched."""
    return ~torch.isfinite(x).all(dim=dim)


def update_ema(state: HealthState, loss, *, window: int, zmax: float = 0.0,
               warmup: Optional[int] = None):
    """One EMA tick and the loss-spike z-score, branchless.  Returns
    ``(new_state, z, spike)``: ``z`` against the prior EMA (0 until
    ``warmup`` finite losses were absorbed, and for a non-finite loss);
    ``spike = z > zmax`` (False when ``zmax <= 0``); the EMA absorbs only
    finite, non-spike losses."""
    if warmup is None:
        warmup = max(4, int(window) // 4)
    alpha = 2.0 / (float(window) + 1.0)
    loss = loss.float()
    finite = torch.isfinite(loss)
    var = torch.clamp(state.ema_sq - state.ema_loss * state.ema_loss, min=0.0)
    std = torch.sqrt(var) + 1e-6 * (1.0 + state.ema_loss.abs())
    warmed = state.count >= warmup
    z = torch.where(finite & warmed, (loss - state.ema_loss) / std,
                    torch.zeros_like(loss))
    spike = z > zmax if zmax > 0.0 else torch.zeros_like(finite)
    absorb = finite & ~spike
    l_eff = torch.where(absorb, loss, state.ema_loss)
    first = state.count == 0
    new_ema = torch.where(first, l_eff, state.ema_loss + alpha * (l_eff - state.ema_loss))
    new_sq = torch.where(first, l_eff * l_eff,
                         state.ema_sq + alpha * (l_eff * l_eff - state.ema_sq))
    new_state = HealthState(
        ema_loss=torch.where(absorb, new_ema, state.ema_loss),
        ema_sq=torch.where(absorb, new_sq, state.ema_sq),
        count=state.count + absorb.int())
    return new_state, z, spike


# ---------------------------------------------------------------------------
# the host twin of the EMA sentinel
# ---------------------------------------------------------------------------

class HostEma:
    """:func:`update_ema` on host floats: the monitor's z-score for
    metrics that carry no ``health_z``."""

    def __init__(self, window, zmax):
        self.window = int(window)
        self.zmax = float(zmax)
        self.reset()

    def reset(self):
        self._ema = 0.0
        self._sq = 0.0
        self._count = 0

    def update(self, loss):
        """One tick; returns ``(z, spike)`` with :func:`update_ema`'s warm-up
        and spike exclusion."""
        loss = float(loss)
        warmup = max(4, self.window // 4)
        alpha = 2.0 / (self.window + 1.0)
        finite = math.isfinite(loss)
        var = max(self._sq - self._ema * self._ema, 0.0)
        std = var ** 0.5 + 1e-6 * (1.0 + abs(self._ema))
        z = (loss - self._ema) / std if finite and self._count >= warmup else 0.0
        spike = self.zmax > 0 and z > self.zmax
        if finite and not spike:
            if self._count == 0:
                self._ema, self._sq = loss, loss * loss
            else:
                self._ema += alpha * (loss - self._ema)
                self._sq += alpha * (loss * loss - self._sq)
            self._count += 1
        return z, spike


# ---------------------------------------------------------------------------
# forensic dumps
# ---------------------------------------------------------------------------

def json_safe(obj):
    """Non-finite floats as strings ('nan', 'inf', '-inf'): a forensic
    dump exists for those values, and bare NaN / Infinity tokens are not
    RFC 8259 JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def write_forensics(dirpath, filename, payload):
    """Write a forensic JSON file atomically (a temporary, then a rename);
    returns its path, or None when it could not be written (a failed dump
    never hides the abort it goes with)."""
    path = os.path.join(dirpath, filename)
    try:
        os.makedirs(dirpath, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(json_safe(payload), f, indent=2, allow_nan=False)
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError) as e:
        logger.warning(f"could not write forensic dump to {path}: {e}")
        return None
    return path


# ---------------------------------------------------------------------------
# the host monitor: the escalation ladder
# ---------------------------------------------------------------------------

# the step metrics the monitor reads
METRIC_KEYS = ("loss", "grad_norm", "skip", "health_z", "loss_spike",
               "nonfinite_grads", "nonfinite_loss", "nonfinite_params")


class LandedScalar:
    """One sentinel of a step, copied to pinned host memory behind the step
    on the card's stream: ``float`` / ``bool`` wait on the event recorded
    after that copy, which passes before the next step's work, so reading
    step t-1 never waits on step t (a ``.item()`` on the device tensor
    would: its copy is queued behind step t)."""

    __slots__ = ("buf", "i", "event")

    def __init__(self, buf, i, event):
        self.buf, self.i, self.event = buf, i, event

    def _get(self):
        self.event.synchronize()
        return self.buf[self.i].item()

    def __float__(self):
        return float(self._get())

    def __bool__(self):
        return bool(self._get())


class HealthMonitor:
    """The escalation policy over the device sentinels.

    :meth:`observe` keeps each step's sentinels (tensors, or
    :class:`LandedScalar` copies on the card) and trails the card by
    ``check_interval`` steps: an entry is read only once that many newer
    steps were dispatched, so the read waits on work the card has
    finished.  Decisions come back as ``"ok"``, ``"rewind"`` or
    ``"abort"``, which the engine carries out.  The forensic history is a
    :class:`~..monitor.ring.RingBuffer`."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.history = RingBuffer(int(cfg.history))
        self.consecutive_skips = 0
        self.total_skips = 0
        self.total_spikes = 0
        self.rewinds = 0            # in the process's life
        self.episode_rewinds = 0    # in the current poison episode, which a clean
        # step applied after a rewind ends; rewind_limit bounds these (_decide)
        self.clean_since_rewind = 0
        self.last_bad_stream_step = None
        self.last_step = None
        self._pending = []
        self._hema = HostEma(cfg.spike_window, cfg.spike_zmax)

    # ---------------------------------------------------------------- intake
    def observe(self, step_no, stream_step, metrics) -> str:
        """Record one finished step; the entries older than the
        ``check_interval`` lag window are read and processed now."""
        m = {k: metrics[k] for k in METRIC_KEYS if k in metrics}
        self._pending.append((step_no, stream_step, m))
        lag = max(1, int(self.cfg.check_interval))
        if len(self._pending) <= lag:
            return "ok"
        ready, self._pending = self._pending[:-lag], self._pending[-lag:]
        return self._process(ready)

    def flush(self) -> str:
        """Read and process everything pending, the lag window included;
        returns the escalation action (the engine calls it at saves and
        before a forensic dump)."""
        ready, self._pending = self._pending, []
        return self._process(ready)

    def _process(self, entries) -> str:
        action = "ok"
        for step_no, stream_step, m in entries:
            act = self._decide(self._ingest(step_no, stream_step, m))
            if act != "ok":
                action = act
        return action

    def _ingest(self, step_no, stream_step, m):
        loss = float(m.get("loss", math.nan))
        gnorm = float(m["grad_norm"]) if "grad_norm" in m else None
        skip = bool(m["skip"]) if "skip" in m else not math.isfinite(loss)
        if "health_z" in m:
            z = float(m["health_z"])
            spike = bool(m.get("loss_spike", False))
        else:
            z, spike = self._hema.update(loss)
        rec = {"step": step_no, "stream_step": stream_step, "loss": loss,
               "grad_norm": gnorm, "z": round(z, 4), "skip": skip, "spike": spike}
        for k in ("nonfinite_grads", "nonfinite_loss", "nonfinite_params"):
            if k in m:
                rec[k] = bool(m[k])
        self.history.append(rec)
        self.last_step = step_no
        if skip:
            self.consecutive_skips += 1
            self.total_skips += 1
            if stream_step is not None:
                self.last_bad_stream_step = stream_step
        else:
            self.consecutive_skips = 0
            self.clean_since_rewind += 1
            # a clean applied step after a rewind closes the poison episode
            self.episode_rewinds = 0
        if spike:
            self.total_spikes += 1
            if not skip:
                why = ("health_check.skip_on_spike is off" if not self.cfg.skip_on_spike
                       else "this step's path applied it before the spike was classified")
                logger.warning("health: loss spike at step %s (loss=%.6g z=%.2f > zmax=%.2f); "
                               "step applied (%s)", step_no, loss, z, self.cfg.spike_zmax, why)
        return rec

    # -------------------------------------------------------------- decision
    def _decide(self, rec) -> str:
        budget = int(self.cfg.consecutive_skip_budget)
        if budget <= 0 or self.consecutive_skips < budget:
            return "ok"
        if self.episode_rewinds < int(self.cfg.rewind_limit):
            return "rewind"
        if self.cfg.on_exhausted == "warn":
            logger.warning("health: skip budget exhausted (%d consecutive) and the episode's "
                           "rewind limit (%d) spent; on_exhausted=warn: counters reset, "
                           "training continues UNPROTECTED against this fault",
                           self.consecutive_skips, self.cfg.rewind_limit)
            self.consecutive_skips = 0
            return "ok"
        return "abort"

    # ------------------------------------------------------------ transitions
    def record_rewind(self, tag=None):
        """After a rewind the engine ran."""
        self.rewinds += 1
        self.episode_rewinds += 1
        self.consecutive_skips = 0
        self.clean_since_rewind = 0
        self._hema.reset()
        log_dist("health rewind engaged: " + json.dumps({
            "event": "health_rewind", "rewind": self.rewinds,
            "episode_rewind": self.episode_rewinds, "limit": int(self.cfg.rewind_limit),
            "restored_tag": tag, "replayed_past_stream_step": self.last_bad_stream_step}),
            ranks=[0])

    def on_checkpoint_load(self):
        """A load supersedes the observed run: the consecutive count, the
        pending entries and the host EMA describe discarded steps; the
        totals stay."""
        self.consecutive_skips = 0
        self._pending = []
        self._hema.reset()

    # ------------------------------------------------------------- forensics
    def counters(self):
        return {"consecutive_skips": self.consecutive_skips,
                "total_skips": self.total_skips,
                "total_spikes": self.total_spikes,
                "rewinds": self.rewinds,
                "episode_rewinds": self.episode_rewinds,
                "last_bad_stream_step": self.last_bad_stream_step}

    def forensic_dump(self, dirpath, reason, last_good_tag=None):
        """Write the forensic JSON (the history, the counters, the policy)
        atomically; returns its path, or None."""
        payload = {
            "event": "health_forensics",
            "reason": reason,
            "time_unix": time.time(),
            "step": self.last_step,
            "last_good_tag": last_good_tag,
            "counters": self.counters(),
            "policy": {
                "skip_nonfinite": bool(self.cfg.skip_nonfinite),
                "spike_window": int(self.cfg.spike_window),
                "spike_zmax": float(self.cfg.spike_zmax),
                "skip_on_spike": bool(self.cfg.skip_on_spike),
                "consecutive_skip_budget": int(self.cfg.consecutive_skip_budget),
                "rewind_limit": int(self.cfg.rewind_limit),
                "on_exhausted": self.cfg.on_exhausted,
                "check_interval": int(self.cfg.check_interval),
            },
            "history": list(self.history),
        }
        step = self.last_step if self.last_step is not None else 0
        path = write_forensics(dirpath, f"health_forensics_step{step}.json", payload)
        if path is not None:
            logger.warning("health forensics written: " + json.dumps({
                "event": "health_forensics_written", "path": path, "reason": reason}))
        return path
