"""Log-bucketed latency histogram with a relative-error quantile bound.

Copy of ``deepspeed_tpu/monitor/histogram.py:LogHistogram`` (the
DDSketch construction: geometric buckets ``(γ^(i-1), γ^i]`` with
``γ = (1+ε)/(1-ε)``, exact counts, quantiles within ``ε`` of a sample
at the exact rank).  ``ServingEngine.stats()`` reads p50/p99 from it.
Differences: the merge and wire-form methods (``merge``, ``to_dict``,
``from_dict``) are not ported — nothing in the port aggregates
histograms across replicas yet.
"""

import math
from typing import Dict, Optional

DEFAULT_REL_ERR = 0.01
DEFAULT_MAX_BUCKETS = 4096


class LogHistogram:
    """Fixed-γ geometric-bucket histogram; values ``<= 0`` count in the
    zero bucket."""

    __slots__ = ("rel_err", "_gamma", "_log_gamma", "max_buckets",
                 "buckets", "zero_count", "count", "sum", "min", "max")

    def __init__(self, rel_err: float = DEFAULT_REL_ERR, *,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not (0.0 < rel_err < 1.0):
            raise ValueError(f"rel_err must be in (0, 1), got {rel_err}")
        if max_buckets < 8:
            raise ValueError(f"max_buckets must be >= 8, got {max_buckets}")
        self.rel_err = float(rel_err)
        self._gamma = (1.0 + rel_err) / (1.0 - rel_err)
        self._log_gamma = math.log(self._gamma)
        self.max_buckets = int(max_buckets)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def add(self, value: float, count: int = 1):
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"histogram values must be finite, got {value}")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        self.count += count
        self.sum += value * count
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if value <= 0.0:
            self.zero_count += count
            return
        i = math.ceil(math.log(value) / self._log_gamma)
        self.buckets[i] = self.buckets.get(i, 0) + count
        if len(self.buckets) > self.max_buckets:
            # hard memory cap: fold the lowest buckets together
            order = sorted(self.buckets)
            spill = 0
            while len(order) > self.max_buckets - 1:
                spill += self.buckets.pop(order.pop(0))
            self.buckets[order[0]] = self.buckets.get(order[0], 0) + spill

    def quantile(self, q: float) -> Optional[float]:
        """Value at quantile ``q`` (rank ``ceil(q·n)``), within
        ``rel_err`` of the exact sample at that rank, clamped to the
        exact [min, max].  None on an empty histogram."""
        if not (0.0 <= q <= 1.0):
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        if rank <= self.zero_count:
            return min(self.min, 0.0)
        cum = self.zero_count
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= rank:
                rep = 2.0 * math.exp(i * self._log_gamma) / (self._gamma + 1.0)
                return min(max(rep, self.min), self.max)
        return self.max

    def percentiles(self) -> dict:
        return {"p50": self.quantile(0.50), "p99": self.quantile(0.99),
                "p999": self.quantile(0.999), "max": self.max}

    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def __len__(self):
        return self.count

    def __bool__(self):
        return self.count > 0
