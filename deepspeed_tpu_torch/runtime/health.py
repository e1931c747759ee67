"""Non-finite sentinels (counterpart of ``deepspeed_tpu/runtime/health.py``;
only ``rows_nonfinite`` is ported — the serving quarantine's per-slot
flag).  The training health monitor comes with the training slice."""

import torch


def rows_nonfinite(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Per-row any-non-finite flag, reduced over ``dim`` only.

    The serving quarantine computes it on the decode logits, one bool
    per batch slot, on the device and before any host read, so a
    poisoned request is evicted while its neighbours' rows are
    untouched."""
    return ~torch.isfinite(x).all(dim=dim)
