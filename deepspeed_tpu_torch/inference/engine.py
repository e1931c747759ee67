"""Inference engine: KV-cache generation, optionally over int8 weights.

Counterpart of ``deepspeed_tpu/inference/engine.py:InferenceEngine`` —
model, params and dtype, ``generate()`` (greedy, or seeded sampling with
optional top-k) through ``apply_with_cache``, ``forward`` (full-context
logits), ``_normalize_dtype``, and int8 weights (62-116): ``dtype=
torch.int8`` or ``quantization_setting`` (an int, ``(mlp_extra_grouping,
groups)`` or None) quantizes the params with ``quantize_param_tree``
(never a cast), params that arrive quantized are detected, and the model
is wrapped in a ``QuantizedModel`` whose inner model computes in bf16
(``engine.dtype`` is then None: the params keep their storage dtypes).
``generate`` and the serving layer route through
``resolve_decode_params``, so GPT-2's decode takes the int8 leaves
itself.

Deliberate differences: the token loop is a Python loop of eager steps
(the JAX engine jits one ``lax.scan``); sampling draws token ``i`` of
the continuation from a generator seeded by ``(seed, i)``
(:func:`sample_seed`), so it is reproducible within the port but not
bit-identical to JAX's ``fold_in(PRNGKey(seed), i)``; ``generate`` takes
an int ``seed`` where JAX takes a PRNG key; without a quantization the
engine's ``dtype`` is the model's compute dtype (JAX: the ``dtype``
argument, None when not given).  Meshes, tensor parallelism, the compile
cache, checkpoint loading and HF injection are not ported.
"""

from typing import Optional

import torch

from ..module_inject.module_quantize import (QuantizedModel, is_quantized_leaf,
                                              quantize_param_tree, resolve_decode_params)
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
    """``InferenceEngine(model, params=None, dtype=None, device=None,
    rng_seed=0, quantization_setting=None)``.

    ``params``: the port's params dict (``params_from_jax``), possibly
    quantized already; None → ``model.init_params(rng_seed)``.  ``dtype``
    (a torch, numpy or string spelling): a floating dtype overrides the
    model's compute dtype and casts the params; ``torch.int8`` quantizes
    them.  ``device`` defaults to the model's device."""

    def __init__(self, model=None, params=None, dtype=None, device=None,
                 rng_seed: int = 0, quantization_setting=None):
        if model is None:
            raise ValueError("InferenceEngine needs a model")
        self.module = model
        self.device = (model.device if device is None
                       else resolve_device(device))
        dtype = _normalize_dtype(dtype)
        if params is None:
            params = model.init_params(rng_seed)
        # params may arrive quantized (a QuantizedModel + an int8 tree)
        self.quantized = _any_leaf(params, is_quantized_leaf)
        # dtype=int8 means "quantize", never "cast": an int8 cast of weights in
        # [-1, 1] would leave 0 / ±1 (engine.py:82-91)
        if dtype is not None and dtype != torch.int8 and not self.quantized:
            model.dtype = dtype
        wants_q = ((quantization_setting is not None or dtype == torch.int8)
                   and not self.quantized)
        act_dtype = torch.bfloat16 if dtype in (None, torch.int8) else dtype
        if wants_q:
            groups = _quant_groups(quantization_setting)
            # a floating dtype casts before quantizing; int8 and None quantize
            # the values as given
            cast = None if dtype in (None, torch.int8) else dtype
            params, _ = quantize_param_tree(_to(params, self.device, cast), bits=8,
                                            groups=groups)
            self.quantized = True
        if self.quantized:
            if not isinstance(model, QuantizedModel):
                # activations run in act_dtype; the params keep int8 storage
                model.dtype = act_dtype
                self.module = model = QuantizedModel(model, act_dtype)
            self.dtype = None
            self.params = _to(params, self.device, None)
        else:
            self.dtype = model.dtype
            self.params = _to(params, self.device, self.dtype)
        log_dist(f"InferenceEngine ready: device={self.device} "
                 f"dtype={self.dtype} quantized={self.quantized}", ranks=[0])

    @torch.no_grad()
    def forward(self, tokens, **kwargs):
        """Full-context forward: ``tokens`` (B, T) → logits (B, T, V) fp32
        (``QuantizedModel.apply`` dequantizes int8 params for the call).
        ``kwargs`` are accepted and unused, as in JAX (engine.py:256-266)."""
        del kwargs
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        return self.module.apply(self.params, tokens)

    __call__ = forward

    @torch.no_grad()
    def generate(self, tokens, max_new_tokens: int = 32,
                 temperature: float = 1.0, do_sample: bool = False,
                 top_k: Optional[int] = None, seed: int = 0):
        """``tokens`` (B, T) int prompt → (B, T + max_new_tokens)."""
        model, deq = resolve_decode_params(self.module)
        params = deq(self.params)           # once, outside the token loop
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        B, T = tokens.shape
        cache = model.init_cache(B, T + max_new_tokens)
        logits, cache = model.apply_with_cache(params, tokens, cache)
        last = logits[:, -1]
        out = []
        for i in range(max_new_tokens):
            if do_sample:
                nxt = sample_logits(last, temperature, top_k, seed, i)
            else:
                nxt = torch.argmax(last, dim=-1)
            out.append(nxt)
            if i + 1 < max_new_tokens:
                logits, cache = model.apply_with_cache(params, nxt[:, None],
                                                       cache)
                last = logits[:, -1]
        return torch.cat([tokens, torch.stack(out, dim=1)], dim=1)


def _any_leaf(tree, pred):
    if pred(tree):
        return True
    if isinstance(tree, dict):
        return any(_any_leaf(v, pred) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_any_leaf(v, pred) for v in tree)
    return False


def _quant_groups(setting) -> int:
    """Groups of ``quantization_setting``: an int, the reference's
    ``(mlp_extra_grouping, groups)``, or None (1)."""
    if isinstance(setting, (tuple, list)):
        _mlp_extra, groups = setting
    elif isinstance(setting, int) and not isinstance(setting, bool):
        groups = setting
    elif setting is None:
        groups = 1
    else:
        raise ValueError("quantization_setting must be int, (mlp_extra_grouping, "
                         f"groups), or None; got {setting!r}")
    return max(1, int(groups))


def _to(params, device, dtype):
    """``params`` on ``device``, floating leaves cast to ``dtype`` (None:
    kept); int8 payloads, fp32 scales and integer leaves keep their
    dtypes."""
    if isinstance(params, dict):
        if is_quantized_leaf(params):
            return {k: v.to(device=device) for k, v in params.items()}
        return {k: _to(v, device, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_to(v, device, dtype) for v in params)
    params = torch.as_tensor(params)
    if dtype is None or not params.is_floating_point():
        return params.to(device=device)
    return params.to(device=device, dtype=dtype)


_DTYPE_NAMES = {"int8": torch.int8, "float32": torch.float32, "fp32": torch.float32,
                "float16": torch.float16, "fp16": torch.float16, "half": torch.float16,
                "bfloat16": torch.bfloat16, "bf16": torch.bfloat16}


def _normalize_dtype(dtype):
    """A torch dtype from a torch, numpy or string spelling (reference
    users call ``init_inference(dtype=torch.int8)``); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
    else:
        import numpy as np
        try:
            name = np.dtype(dtype).name
        except TypeError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported inference dtype {dtype!r}")
    return _DTYPE_NAMES[name]
