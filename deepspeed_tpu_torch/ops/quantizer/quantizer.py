"""Groupwise quantization (symmetric / asymmetric, nearest / stochastic).

Counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``: ``quantize``,
``dequantize`` and the ``Quantizer`` facade.  Groups are taken over the
FLATTENED tensor (``_group_reshape``), and nearest rounding is
bit-identical to JAX: ``scale = where(absmax == 0, 1, absmax / qmax)``
and ``round(x / scale)`` (a division, as JAX does, not a multiply by the
reciprocal), round half to even, clipped to [-qmax-1, qmax].

Deliberate differences: stochastic rounding draws its uniform noise in
[-0.5, 0.5) from an explicit ``torch.Generator`` (``rng``) in place of a
JAX PRNG key, so it is held to its contract (unbiased) and not to JAX's
bits; a size that the groups do not divide raises ``ValueError`` (JAX:
``AssertionError``).  These are plain elementwise PyTorch ops, as the
JAX module leaves them to XLA.
"""

import torch


def _group_reshape(x, groups):
    n = x.numel()
    if groups < 1 or n % groups:
        raise ValueError(f"size {n} not divisible by groups {groups}")
    return x.reshape(groups, n // groups)


def quantize(x, groups=1, bits=8, symmetric=True, stochastic=False, rng=None):
    """Groupwise quantize to int: returns ``(q, scale, zero_point)`` with
    ``q`` in ``x``'s shape (int8 for ``bits <= 8``, else int32) and the
    fp32 ``scale`` / ``zero_point`` of each group (zeros when symmetric).

    - symmetric: ``q = round(x / scale)``, ``scale = absmax / qmax``;
    - asymmetric: ``q = round((x - zero) / scale)``, ``scale = (max -
      min) / (2 qmax)``, ``zero`` the group's midpoint;
    - stochastic: ``floor(x / scale + 0.5 + u)`` with ``u`` uniform in
      [-0.5, 0.5) from the generator ``rng`` (unbiased)."""
    orig_shape = x.shape
    xg = _group_reshape(torch.as_tensor(x).float(), groups)
    qmax = 2.0 ** (bits - 1) - 1
    one = torch.ones((), dtype=torch.float32, device=xg.device)

    if symmetric:
        absmax = xg.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax == 0, one, absmax / qmax)
        zero = torch.zeros_like(scale)
        scaled = xg / scale
    else:
        lo = xg.amin(dim=1, keepdim=True)
        hi = xg.amax(dim=1, keepdim=True)
        span = torch.where(hi == lo, one, hi - lo)
        scale = span / (2.0 * qmax)
        zero = lo + scale * qmax          # the midpoint maps to 0
        scaled = (xg - zero) / scale

    if stochastic:
        if rng is None:
            raise ValueError("stochastic rounding needs a torch.Generator (rng=)")
        noise = torch.rand(scaled.shape, generator=rng, device=scaled.device,
                           dtype=torch.float32) - 0.5
        q = torch.floor(scaled + 0.5 + noise)
    else:
        q = torch.round(scaled)          # half to even, as jnp.round
    q = q.clamp(-qmax - 1, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int32
    return q.to(dtype).reshape(orig_shape), scale[:, 0], zero[:, 0]


def dequantize(q, scale, zero=None, groups=None):
    """Inverse of :func:`quantize`: fp32 ``q * scale (+ zero)`` per group."""
    orig_shape = q.shape
    groups = groups if groups is not None else scale.shape[0]
    x = _group_reshape(q.float(), groups) * scale.float().reshape(-1)[:, None]
    if zero is not None:
        x = x + zero.float().reshape(-1)[:, None]
    return x.reshape(orig_shape)


class Quantizer:
    """Stateful facade of the reference wrapper (``ops/quantizer``)."""

    def __init__(self, q_groups=1, q_bits=8, q_type="symmetric",
                 q_rounding="nearest"):
        self.q_groups = q_groups
        self.q_bits = q_bits
        self.symmetric = q_type == "symmetric"
        self.stochastic = q_rounding == "stochastic"

    def quantize(self, x, rng=None, bits=None):
        return quantize(x, groups=self.q_groups, bits=bits or self.q_bits,
                        symmetric=self.symmetric, stochastic=self.stochastic,
                        rng=rng)

    def dequantize(self, q, scale, zero=None):
        return dequantize(q, scale, zero, groups=self.q_groups)
