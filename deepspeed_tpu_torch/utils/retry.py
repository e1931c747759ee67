"""Bounded retry with exponential backoff, jitter, and error classification.

Counterpart of ``deepspeed_tpu/utils/retry.py`` (``RetryPolicy`` :38,
``retry_call`` :105), copied with no change of behaviour: the same jitter
modes, caps and classification.  No deliberate differences.

Checkpoint IO goes through ``retry_call``: a transient submit or write
error (device hiccup, momentary ENOSPC while another tag rotates out,
preempted-then-resumed filesystem) is retried a bounded number of times with exponential
backoff and deterministic jitter; a *structural* error (missing file,
permission, is-a-directory) is raised immediately.

Design points:
- classification is explicit: ``retriable_types`` opt types in,
  ``NON_RETRIABLE`` carves the structural ``OSError`` subclasses back out.
- jitter is sampled from an injectable ``random.Random`` so tests (and the
  fault harness) are deterministic end to end.  Two modes:
  ``proportional`` (default): ``nominal * (1 ± jitter)``;
  ``full`` (AWS-style full jitter): ``uniform(0, nominal)`` — decorrelates
  a thundering herd of retriers far better when many workers hit the same
  shared-filesystem hiccup at once.
- ``max_elapsed_s`` caps the TOTAL wall-clock a retry loop may consume
  (attempt time + backoff): a preemption-imminent checkpoint save must not
  burn its grace window sleeping.  The clock is injectable so tests (and
  the fault harness) never really sleep.
- ``sleep`` is injectable so unit tests run in microseconds.
"""

import random
import time

from .logging import logger

# Structural OSErrors: retrying cannot help, surface them immediately.
NON_RETRIABLE = (FileNotFoundError, IsADirectoryError, NotADirectoryError,
                 PermissionError, FileExistsError)

JITTER_MODES = ("proportional", "full")


class RetryPolicy:
    """Bounded exponential backoff: nominal delay(k) = base * 2**k capped at
    ``max_delay_s``, jittered per ``jitter_mode``; at most ``max_attempts``
    total attempts and (when set) ``max_elapsed_s`` total wall-clock."""

    def __init__(self, max_attempts=5, base_delay_s=0.05, max_delay_s=2.0,
                 jitter=0.25, jitter_mode="proportional",
                 max_elapsed_s=None, retriable_types=(OSError,),
                 non_retriable_types=NON_RETRIABLE, seed=None,
                 sleep=time.sleep, clock=time.monotonic):
        assert max_attempts >= 1, "max_attempts must be >= 1"
        assert 0.0 <= jitter < 1.0, "jitter must be in [0, 1)"
        assert jitter_mode in JITTER_MODES, \
            f"jitter_mode must be one of {JITTER_MODES}"
        assert max_elapsed_s is None or max_elapsed_s > 0, \
            "max_elapsed_s must be > 0 (or None for no cap)"
        self.max_attempts = max_attempts
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.jitter_mode = jitter_mode
        self.max_elapsed_s = max_elapsed_s
        self.retriable_types = tuple(retriable_types)
        self.non_retriable_types = tuple(non_retriable_types)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock

    def clone(self, **overrides):
        """Copy with some fields overridden (e.g. extra retriable types)."""
        kw = dict(max_attempts=self.max_attempts,
                  base_delay_s=self.base_delay_s,
                  max_delay_s=self.max_delay_s, jitter=self.jitter,
                  jitter_mode=self.jitter_mode,
                  max_elapsed_s=self.max_elapsed_s,
                  retriable_types=self.retriable_types,
                  non_retriable_types=self.non_retriable_types,
                  sleep=self._sleep, clock=self._clock)
        kw.update(overrides)
        out = RetryPolicy(**kw)
        if "seed" not in overrides:
            # a seeded policy must stay deterministic through clones
            out._rng.setstate(self._rng.getstate())
        return out

    def classify(self, exc):
        """True if ``exc`` is worth retrying under this policy."""
        if isinstance(exc, self.non_retriable_types):
            return False
        return isinstance(exc, self.retriable_types)

    def delay_bounds(self, attempt):
        """[lo, hi] of the possible backoff after failed attempt ``attempt``
        (0-based) — exposed so tests can assert jitter stays in bounds."""
        nominal = min(self.base_delay_s * (2 ** attempt), self.max_delay_s)
        if self.jitter_mode == "full":
            return 0.0, nominal
        return nominal * (1.0 - self.jitter), nominal * (1.0 + self.jitter)

    def delay(self, attempt):
        lo, hi = self.delay_bounds(attempt)
        return self._rng.uniform(lo, hi)

    def backoff(self, attempt):
        self._sleep(self.delay(attempt))


def retry_call(fn, *args, policy=None, describe=None, on_retry=None, **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    ``on_retry(attempt, exc)`` runs before each backoff (e.g. drain pending
    async writes so the retried acquisition can succeed).  The final failure
    re-raises the last exception unchanged — as does hitting the policy's
    ``max_elapsed_s`` wall-clock cap (checked before each backoff, counting
    the backoff about to be taken, so the loop never sleeps past the cap).
    """
    policy = policy or RetryPolicy()
    what = describe or getattr(fn, "__name__", "call")
    start = policy._clock()
    for attempt in range(policy.max_attempts):
        try:
            return fn(*args, **kwargs)
        except Exception as exc:
            last = attempt == policy.max_attempts - 1
            if last or not policy.classify(exc):
                raise
            delay = policy.delay(attempt)
            if policy.max_elapsed_s is not None and \
                    (policy._clock() - start) + delay > policy.max_elapsed_s:
                logger.warning(
                    f"retry of {what} abandoned: elapsed cap "
                    f"{policy.max_elapsed_s}s would be exceeded "
                    f"(attempt {attempt + 1}/{policy.max_attempts})")
                raise
            logger.warning(
                f"retriable failure in {what} "
                f"(attempt {attempt + 1}/{policy.max_attempts}): {exc!r}")
            if on_retry is not None:
                on_retry(attempt, exc)
            policy._sleep(delay)
