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

``generate`` (JAX 232-330) makes the JAX engine's two dispatches: the
prefill, then the token step.  With the model's ``decode_impl`` "fused"
(the default) the token step is one CUDA graph (``runtime/step_graph.py``)
over a static cache and token buffer, replayed ``max_new_tokens - 1``
times: the greedy token feeds back on the device and the host reads
nothing until the end; ``"unroll"`` keeps a Python loop of eager steps,
and the CPU calls the token step's body directly.

Deliberate differences: the JAX ``lax.scan`` over tokens becomes a graph
replayed once a token; the prefill runs eagerly (one forward per call,
JAX jits it too); sampling draws token ``i`` of the continuation from a
generator seeded by ``(seed, i)`` (:func:`sample_seed`), after each
replay from the step's static logits, so it is reproducible within the
port but not bit-identical to JAX's ``fold_in(PRNGKey(seed), i)``;
``generate`` takes an int ``seed`` where JAX takes a PRNG key; without a
quantization the engine's ``dtype`` is the model's compute dtype (JAX:
the ``dtype`` argument, None when not given).  ``checkpoint=`` loads
``params`` saved by either package's ``save_checkpoint`` from a
directory (through its ``latest`` pointer), a tag directory or a model
file (JAX ``_load_checkpoint``, :328-344), before the cast or the int8
quantization.  Meshes, tensor parallelism, the compile cache and HF
injection are not ported.
"""

import os
from collections import OrderedDict
from typing import Optional

import torch

from ..checkpoint.constants import LATEST_FILE, MODEL_FILE
from ..checkpoint.serialization import load_tree
from ..module_inject.module_quantize import (QuantizedModel, is_quantized_leaf,
                                              quantize_param_tree, resolve_decode_params)
from ..runtime.step_graph import GraphPool, StepGraph
from ..utils.device import resolve_device
from ..utils.logging import log_dist

TOKEN_STEPS_CAP = 8     # live token-step graphs, least recently used out (JAX 198)

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
    rng_seed=0, quantization_setting=None, checkpoint=None)``.

    ``params``: the port's params dict (``params_from_jax``), possibly
    quantized already; None → the ``params`` of ``checkpoint`` when given,
    else ``model.init_params(rng_seed)``.  ``dtype``
    (a torch, numpy or string spelling): a floating dtype overrides the
    model's compute dtype and casts the params; ``torch.int8`` quantizes
    them.  ``device`` defaults to the model's device."""

    def __init__(self, model=None, params=None, dtype=None, device=None,
                 rng_seed: int = 0, quantization_setting=None,
                 checkpoint: Optional[str] = None):
        if model is None:
            raise ValueError("InferenceEngine needs a model")
        self.module = model
        self.device = (model.device if device is None
                       else resolve_device(device))
        dtype = _normalize_dtype(dtype)
        if params is None:
            params = (self._load_checkpoint(checkpoint) if checkpoint is not None
                      else model.init_params(rng_seed))
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
        self._graphs = None       # the token steps' GraphPool, made at first use
        # (B, max_len, do_sample) → (StepGraph, its state), LRU-ordered
        self._token_steps = OrderedDict()
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
                 top_k: Optional[int] = None, seed: int = 0,
                 max_len: Optional[int] = None):
        """``tokens`` (B, T) int prompt → (B, T + max_new_tokens).
        ``max_len`` (the cache's length) defaults to ``T +
        max_new_tokens`` and may not be smaller (JAX 252-253)."""
        model, deq = resolve_decode_params(self.module)
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=self.device)
        B, T = tokens.shape
        total = T + max_new_tokens
        max_len = max_len or total
        if max_len < total:
            raise ValueError(f"max_len {max_len} must cover prompt + new tokens "
                             f"({T} + {max_new_tokens} = {total})")
        if model.decode_impl() == "unroll":
            return self._generate_unroll(model, deq(self.params), tokens,
                                         max_new_tokens, temperature, do_sample,
                                         top_k, seed, max_len)
        step, st = self._token_step(model, deq, B, max_len, do_sample)
        step.prepare()                      # its warm-up advances the cache: reset after
        cache, seq = st["cache"], st["seq"]
        for t in (cache["k"], cache["v"], cache["index"]):
            t.zero_()
        logits, _ = model.apply_with_cache(st["params"], tokens, cache)
        seq[:, :T] = tokens
        seq[:, T] = self._select(logits[:, -1], do_sample, temperature, top_k, seed, 0)
        for i in range(1, max_new_tokens):
            logits = step()
            if do_sample:
                seq[:, T + i] = sample_logits(logits, temperature, top_k, seed, i)
        return seq[:, :total].clone()

    def _token_step(self, model, deq, B, max_len, do_sample):
        """The captured token step of ``(B, max_len, do_sample)`` and its
        state (params, cache, the token sequence), built at first use."""
        key = (B, max_len, bool(do_sample))
        hit = self._token_steps.get(key)
        if hit is not None:
            self._token_steps.move_to_end(key)
            return hit
        if self._graphs is None and self.device.type == "cuda":
            self._graphs = GraphPool(self.device)
        st = {"params": deq(self.params),          # once, outside the token loop
              "cache": model.init_cache(B, max_len),
              "seq": torch.zeros((B, max_len), dtype=torch.long, device=self.device)}

        def body():
            """Feed ``seq[:, index]``, advance the cache; greedy: write the
            argmax at ``seq[:, index + 1]``, sampled: return the logits."""
            cache, seq = st["cache"], st["seq"]
            tok = seq.index_select(1, cache["index"].reshape(1))
            logits, _ = model.apply_with_cache(st["params"], tok, cache)
            logits = logits[:, -1]
            if not do_sample:
                seq.index_copy_(1, cache["index"].reshape(1),
                                torch.argmax(logits, dim=-1)[:, None])
            return logits

        step = StepGraph(f"generate.token[{B}x{max_len},{'sample' if do_sample else 'greedy'}]",
                         body, {}, self.device, self._graphs)
        while len(self._token_steps) >= TOKEN_STEPS_CAP:
            self._token_steps.popitem(last=False)
        self._token_steps[key] = (step, st)
        return step, st

    @staticmethod
    def _select(logits, do_sample, temperature, top_k, seed, index):
        if do_sample:
            return sample_logits(logits, temperature, top_k, seed, index)
        return torch.argmax(logits, dim=-1)

    def _generate_unroll(self, model, params, tokens, max_new_tokens, temperature,
                         do_sample, top_k, seed, max_len):
        """``decode_impl="unroll"``: a Python loop of eager token steps."""
        cache = model.init_cache(tokens.shape[0], max_len)
        logits, cache = model.apply_with_cache(params, tokens, cache)
        out = []
        for i in range(max_new_tokens):
            nxt = self._select(logits[:, -1], do_sample, temperature, top_k, seed, i)
            out.append(nxt)
            if i + 1 < max_new_tokens:
                logits, cache = model.apply_with_cache(params, nxt[:, None], cache)
        return torch.cat([tokens, torch.stack(out, dim=1)], dim=1)

    @staticmethod
    def _load_checkpoint(load_dir, tag=None):
        """The ``params`` tree of a checkpoint, as CPU tensors: ``load_dir``
        is a save directory (its ``latest`` tag unless ``tag``), a tag
        directory, or a model file."""
        if os.path.isdir(load_dir):
            latest = os.path.join(load_dir, LATEST_FILE)
            if tag is None and os.path.isfile(latest):
                with open(latest) as f:
                    tag = f.read().strip()
            path = os.path.join(load_dir, tag) if tag else load_dir
            path = os.path.join(path, MODEL_FILE)
        else:
            path = load_dir
        return load_tree(path)["params"]


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
