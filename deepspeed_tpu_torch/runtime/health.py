"""Non-finite and loss-spike sentinels on the device.

Counterpart of ``deepspeed_tpu/runtime/health.py``: ``HealthState`` /
``init_state``, ``tree_nonfinite``, ``rows_nonfinite`` and
``update_ema`` (lines 63-148).  Every function returns device tensors
and reads nothing back to the host, so the engine's branchless skip-step
needs no sync.  :func:`update_ema` returns a new state, as JAX's does;
the engine copies it into its ``HealthState`` tensors in place (gated by
the step's ``commit`` flag), so a captured step keeps reading and writing
the same storage.  The host-side ``HealthMonitor`` escalation ladder
(rewind / abort) is not ported.
"""

from typing import NamedTuple, Optional

import torch

from .utils import tree_leaves


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
