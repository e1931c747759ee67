"""Inference engine: KV-cache generation.

Counterpart of ``deepspeed_tpu/inference/engine.py:InferenceEngine`` —
model, params and dtype, and ``generate()`` (greedy, or seeded sampling
with optional top-k) through ``GPT2.apply_with_cache``.

Deliberate differences: the token loop is a Python loop of eager steps
(the JAX engine jits one ``lax.scan``); sampling draws token ``i`` of
the continuation from a generator seeded by ``(seed, i)``
(:func:`sample_seed`), so it is reproducible within the port but not
bit-identical to JAX's ``fold_in(PRNGKey(seed), i)``; ``generate`` takes
an int ``seed`` where JAX takes a PRNG key.  Meshes, tensor parallelism,
int8 weights, the compile cache, checkpoint loading and HF injection are
not ported.
"""

from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.logging import log_dist

_MASK64 = (1 << 64) - 1


def sample_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed that is a pure function of
    ``(seed, index)`` (splitmix64 over the pair): the port's stand-in
    for ``fold_in(PRNGKey(seed), index)``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def sample_logits(logits, temperature: float, top_k: Optional[int],
                  seed: int, index: int) -> torch.Tensor:
    """Categorical draws from ``logits`` (..., V) fp32 at
    ``temperature`` (top-k filtered when given), by Gumbel-max with
    noise of the logits' shape from a generator seeded by
    ``sample_seed(seed, index)``.  Returns the drawn ids (...,)."""
    lg = logits / max(float(temperature), 1e-6)
    if top_k is not None:
        kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -float("inf")), lg)
    g = torch.Generator(device=lg.device)
    g.manual_seed(sample_seed(seed, index))
    u = torch.rand(lg.shape, generator=g, device=lg.device, dtype=torch.float32)
    return torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)


class InferenceEngine:
    """``InferenceEngine(model, params=None, dtype=None, device=None)``.

    ``params``: the port's params dict (``params_from_jax``); None →
    ``model.init_params(rng_seed)``.  ``dtype`` overrides the model's
    compute dtype and casts the params to it.  ``device`` defaults to the
    model's device."""

    def __init__(self, model=None, params=None, dtype=None, device=None,
                 rng_seed: int = 0):
        if model is None:
            raise ValueError("InferenceEngine needs a model")
        self.module = model
        self.device = (model.device if device is None
                       else resolve_device(device))
        if dtype is not None:
            model.dtype = dtype
        self.dtype = model.dtype
        if params is None:
            params = model.init_params(rng_seed)
        self.params = _to(params, self.device, self.dtype)
        log_dist(f"InferenceEngine ready: device={self.device} "
                 f"dtype={self.dtype}", ranks=[0])

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 1.0, do_sample: bool = False,
                 top_k: Optional[int] = None, seed: int = 0):
        """``tokens`` (B, T) int prompt → (B, T + max_new_tokens)."""
        model = self.module
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        B, T = tokens.shape
        cache = model.init_cache(B, T + max_new_tokens)
        logits, cache = model.apply_with_cache(self.params, tokens, cache)
        last = logits[:, -1]
        out = []
        for i in range(max_new_tokens):
            if do_sample:
                nxt = sample_logits(last, temperature, top_k, seed, i)
            else:
                nxt = torch.argmax(last, dim=-1)
            out.append(nxt)
            if i + 1 < max_new_tokens:
                logits, cache = model.apply_with_cache(self.params,
                                                       nxt[:, None], cache)
                last = logits[:, -1]
        return torch.cat([tokens, torch.stack(out, dim=1)], dim=1)


def _to(params, device, dtype):
    if isinstance(params, dict):
        return {k: _to(v, device, dtype) for k, v in params.items()}
    return params.to(device=device, dtype=dtype)
