"""Weight quantization for inference: int8 storage, dequant on use.

Counterpart of ``deepspeed_tpu/module_inject/module_quantize.py``:
``QUANT_KEYS``, ``default_predicate``, ``quantize_param_tree``,
``is_quantized_leaf``, ``q_matmul``, ``q_gather``, ``dequantize_tree``,
``QuantizedModel``, ``resolve_decode_params`` and
``quantize_transformer_layer``.  Weights become ``{"q": int8 tensor,
"scale": fp32 tensor}`` leaves (groupwise symmetric, the quantizer of
``ops/quantizer/quantizer.py``); a stacked (L, ...) leaf quantizes with
``L * groups`` groups and keeps its scale as (L, groups), so layer ``l``
of both payload and scale is ``leaf[...][l]``.

Paths are spelled as ``jax.tree_util.keystr`` spells them
(``"['blocks']['qkv_w']"``; ``"[0]"`` for a list or tuple item), so a
predicate behaves alike in both packages.

Deliberate differences: ``q_matmul`` sends a quantized leaf whose scale
is per-tensor or per-output-channel to the CUDA kernel of
``ops/transformer/int8_matmul.py`` for CUDA tensors (its plain version
on the CPU), where JAX lets XLA fuse the convert into the dot; a scale
of any other shape is dequantized and takes the plain product, as in
JAX.  ``dequantize_tree`` runs eagerly (JAX traces it into a jitted
forward), so a :class:`QuantizedModel` forward materializes the
dequantized tree for that call.
"""

import re
from typing import Callable, Optional

import torch

from ..ops.quantizer.quantizer import dequantize as _dequantize
from ..ops.quantizer.quantizer import quantize as _quantize
from ..utils.logging import log_dist

QUANT_KEYS = ("q", "scale")


def is_quantized_leaf(x):
    """True for an ``{"q", "scale"}`` int8 payload leaf."""
    return isinstance(x, dict) and set(x.keys()) == set(QUANT_KEYS)


def _numel(leaf):
    return leaf.numel() if isinstance(leaf, torch.Tensor) else int(leaf.size)


def default_predicate(path: str, leaf) -> bool:
    """Quantize matmul weights only: large, matrix-shaped leaves
    (embeddings included).  Stacked per-layer vectors (LayerNorm scales
    and biases, (L, D)) and leaves named ``b`` / ``*_b`` (biases, which
    pass the shape gate once L >= 64) stay in floating point."""
    if not (hasattr(leaf, "ndim") and leaf.ndim >= 2 and _numel(leaf) >= 4096):
        return False
    if min(leaf.shape[-2:]) < 64:      # stacked vectors, tiny matrices
        return False
    components = re.findall(r"\w+", path)
    if components and (components[-1] == "b" or components[-1].endswith("_b")):
        return False
    name = path.lower()
    return not any(t in name for t in ("ln", "bias", "scale", "norm"))


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, dict keys
    visited in sorted order (as ``tree_flatten``); the output keeps the
    input's structure.  Quantized leaves are leaves."""
    if isinstance(tree, dict) and not is_quantized_leaf(tree):
        out = {k: _map_with_path(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _nbytes(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(getattr(leaf, "nbytes", 0))


def quantize_param_tree(params, *, bits: int = 8, groups: int = 1,
                        predicate: Optional[Callable] = None):
    """Replace the leaves ``predicate(path, leaf)`` selects with
    ``{"q": int8, "scale": fp32}`` payloads on the leaf's device.
    Returns ``(tree, {"bytes_before", "bytes_after"})``."""
    predicate = predicate or default_predicate
    stats = {"bytes_before": 0, "bytes_after": 0}

    def one(path, leaf):
        nbytes = _nbytes(leaf)
        stats["bytes_before"] += nbytes
        if not predicate(path, leaf):
            stats["bytes_after"] += nbytes
            return leaf
        x = torch.as_tensor(leaf).float()
        if x.dim() >= 3:
            # stacked per-layer weights (L, ...): each layer slice in its own
            # groups, the layer axis leading on the scale
            L = x.shape[0]
            q, scale, _ = _quantize(x, groups=L * groups, bits=bits, symmetric=True)
            scale = scale.reshape(L, groups)
        else:
            q, scale, _ = _quantize(x, groups=groups, bits=bits, symmetric=True)
        stats["bytes_after"] += q.numel() + scale.numel() * 4
        return {"q": q.to(torch.int8), "scale": scale}

    tree = _map_with_path(one, params)
    log_dist(f"quantized weights: {stats['bytes_before'] / 1e6:.1f} MB → "
             f"{stats['bytes_after'] / 1e6:.1f} MB", ranks=[0])
    return tree, stats


def q_matmul(h, w, *, w_transposed=False, out_dtype=None):
    """``h @ w`` (or ``h @ w.T``) where ``w`` may be a quantized leaf.

    A quantized leaf with a per-tensor or per-output-channel scale goes
    to :func:`~deepspeed_tpu_torch.ops.transformer.int8_matmul.int8_matmul`
    (the CUDA kernel for CUDA tensors); any other scale is dequantized
    and takes the plain product.  The plain product multiplies in
    ``h.dtype`` and returns ``out_dtype`` (default ``h.dtype``)."""
    out_dtype = out_dtype or h.dtype

    def plain(w):
        w = w.to(h.dtype)
        w = w.t() if w_transposed else w
        if out_dtype == h.dtype:
            return h @ w
        # bf16 operands, fp32 sums: every product of two bf16 values is exact in fp32
        return (h.float() @ w.float()).to(out_dtype)

    if not is_quantized_leaf(w):
        return plain(w)
    from ..ops.transformer.int8_matmul import int8_matmul
    q, scale = w["q"], w["scale"]
    N = q.shape[0] if w_transposed else q.shape[1]
    if scale.numel() == 1 or (w_transposed and scale.numel() == N):
        return int8_matmul(h, q, scale, w_transposed=w_transposed, out_dtype=out_dtype)
    return plain(dequantize_tree(w, h.dtype))


def q_gather(w, idx, dtype=torch.bfloat16):
    """Row gather (embedding lookup) from a possibly quantized table:
    the int8 rows are gathered, then rescaled -- never the whole table."""
    if not is_quantized_leaf(w):
        return w.to(dtype)[idx]
    q = w["q"]
    scale = w["scale"].float().reshape(-1)
    if scale.numel() == 1:
        return (q[idx].float() * scale[0]).to(dtype)
    if scale.numel() == q.shape[0]:      # per-row groups
        return (q[idx].float() * scale[idx][..., None]).to(dtype)
    return dequantize_tree(w, dtype)[idx]


def dequantize_tree(params, dtype=torch.bfloat16):
    """Every quantized leaf of ``params`` (or ``params`` itself, a leaf)
    back to a ``dtype`` tensor; other leaves unchanged."""
    def deq(_, x):
        if is_quantized_leaf(x):
            scale = x["scale"].float().reshape(-1)   # (L, g) -> (L·g,): the
            # quantizer's flattened group order
            return _dequantize(x["q"], scale, groups=max(1, scale.numel())).to(dtype)
        return x
    return _map_with_path(deq, params)


class QuantizedModel:
    """Wraps a model so ``apply`` / ``apply_with_cache`` take quantized
    params (dequantized to ``dtype`` for the call)."""

    def __init__(self, model, dtype=torch.bfloat16):
        self._model = model
        self._dtype = dtype

    def __getattr__(self, name):
        return getattr(self._model, name)

    def apply(self, params, *a, **kw):
        return self._model.apply(dequantize_tree(params, self._dtype), *a, **kw)

    def apply_with_cache(self, params, *a, **kw):
        return self._model.apply_with_cache(dequantize_tree(params, self._dtype), *a, **kw)


def resolve_decode_params(module):
    """``(inner_model, deq)`` for cached and paged decode, shared by
    ``InferenceEngine.generate`` and ``ServingEngine``: a
    :class:`QuantizedModel` whose inner model takes int8 leaves itself
    (``supports_quantized_decode``) gets the params untouched; any other
    :class:`QuantizedModel` dequantizes them once per call through
    ``deq``; a plain model passes through."""
    if isinstance(module, QuantizedModel):
        inner = module._model
        if getattr(inner, "supports_quantized_decode", False):
            return inner, lambda p: p
        return inner, lambda p, _d=module._dtype: dequantize_tree(p, _d)
    return module, lambda p: p


def quantize_transformer_layer(model, params, megatron=False, preln=False,
                               bits: int = 8, groups: int = 1):
    """The reference-named entry: returns ``(QuantizedModel,
    quantized_params)``; ``megatron`` and ``preln`` are accepted for
    signature parity."""
    qparams, _ = quantize_param_tree(params, bits=bits, groups=groups)
    dtype = getattr(model, "dtype", torch.bfloat16)
    return QuantizedModel(model, dtype), qparams
