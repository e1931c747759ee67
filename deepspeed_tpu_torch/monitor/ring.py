"""Bounded in-memory record ring.

Counterpart of ``deepspeed_tpu/monitor/ring.py`` (``RingBuffer``),
copied with no change of behaviour: the health guardian's forensic step
history (``runtime/health.py``).  The monitor bus's ring sink that JAX
also builds on it is not ported (ROADMAP item 14).
"""

from collections import deque


class RingBuffer:
    """Fixed-capacity FIFO: appending past ``maxlen`` drops the oldest
    record.  Iteration yields oldest first."""

    def __init__(self, maxlen: int):
        maxlen = int(maxlen)
        if maxlen < 1:
            raise ValueError(f"RingBuffer maxlen must be >= 1, got {maxlen}")
        self._d = deque(maxlen=maxlen)

    @property
    def maxlen(self) -> int:
        return self._d.maxlen

    def append(self, item):
        self._d.append(item)

    def extend(self, items):
        self._d.extend(items)

    def clear(self):
        self._d.clear()

    def to_list(self) -> list:
        return list(self._d)

    def __len__(self):
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __getitem__(self, i):
        return self._d[i]

    def __repr__(self):
        return f"RingBuffer(len={len(self._d)}, maxlen={self._d.maxlen})"
