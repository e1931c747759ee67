"""Checkpoint tree serialization: path-keyed arrays + JSON meta in one file.

Counterpart of ``deepspeed_tpu/checkpoint/serialization.py``
(``save_tree``, ``load_tree``, ``restore_like``; ``reshard_put`` becomes
:func:`place_like`).  The container is the JAX package's: a
``.msgpack``-suffixed zip (``ZIP_STORED``) holding ``meta.json`` first,
then one raw ``arrays/<path>.bin`` per leaf in flatten order, then
``treedef.json`` with the ``{"index": {path: {"dtype", "shape"}}}``
record.  A leaf's path joins its dict keys, NamedTuple field names and
sequence indices with ``/`` (``opt_state/exp_avg/blocks/qkv_w``), dict
keys in sorted order, as ``jax.tree_util`` flattens them, so either
package reads the other's files.

Deliberate differences:

- leaves are torch tensors (or numpy arrays), and :func:`load_tree`
  returns CPU tensors;
- bf16 without ``ml_dtypes``: a bf16 tensor's raw 2-byte words are
  written under the dtype name ``"bfloat16"`` (the name JAX writes) and
  read back by viewing the bytes as ``torch.bfloat16``; the float8 names
  map to torch's float8 dtypes the same way.  Nothing here imports
  ``ml_dtypes``;
- ``place_like(loaded, like_tree, cast=None)`` builds each leaf on the
  like-leaf's device and dtype (one device: nothing to re-shard).

As in JAX, save moves leaves device to host one at a time inside the
write loop, so host memory holds one leaf, not a copy of the checkpoint.
"""

import json
import os
import zipfile

import numpy as np
import torch

from .. import fault
from ..utils.retry import RetryPolicy, retry_call

# dtype names as numpy / ml_dtypes spell them (what JAX writes) <-> torch
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
# dtypes numpy has no spelling for: stored as words of the same width
_WORDS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
          torch.float8_e5m2: torch.uint8}


def _path_items(tree, prefix=()):
    """``(path tuple, leaf)`` in ``jax.tree_util`` flatten order: dict keys
    sorted, NamedTuple fields by name, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _path_items(v, prefix + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _path_items(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _flatten_with_paths(tree):
    return {"/".join(path): leaf for path, leaf in _path_items(tree)}


def _resolve_dtype(name):
    if name not in _TORCH_DTYPES:
        raise TypeError(f"checkpoint leaf dtype {name!r} has no torch counterpart")
    return _TORCH_DTYPES[name]


def _host_record(leaf):
    """``(dtype name, shape, bytes)`` of one leaf, moved to host here."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in _DTYPE_NAMES:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        words = t.view(_WORDS[t.dtype]) if t.dtype in _WORDS else t
        return _DTYPE_NAMES[t.dtype], list(t.shape), words.numpy().tobytes()
    arr = np.asarray(leaf)
    return arr.dtype.name, list(arr.shape), np.ascontiguousarray(arr).tobytes()


def save_tree(path, tree, meta=None, fsync=True, retry=None):
    """Write a tree of tensors (or numpy arrays) to one file.

    Leaves are stored as raw bytes + a dtype-name/shape record.  The file
    is flushed (and fsynced unless ``fsync=False``) before close; transient
    IO errors are retried with bounded backoff."""
    flat = _flatten_with_paths(tree)

    def _write():
        fault.site("io.write", path=path)
        index = {}
        with open(path, "wb") as f:
            with zipfile.ZipFile(f, "w", compression=zipfile.ZIP_STORED) as zf:
                if meta is not None:
                    zf.writestr("meta.json", json.dumps(meta))
                for key, leaf in flat.items():
                    name, shape, raw = _host_record(leaf)   # one leaf on the host
                    index[key] = {"dtype": name, "shape": shape}
                    zf.writestr(f"arrays/{key}.bin", raw)
                    del raw
                zf.writestr("treedef.json", json.dumps({"index": index}))
            f.flush()
            if fsync:
                os.fsync(f.fileno())

    retry_call(_write, policy=retry or RetryPolicy(), describe=f"save_tree({path})")


def _read_leaf(zf, key, rec):
    info = zf.getinfo(f"arrays/{key}.bin")
    buf = bytearray(info.file_size)
    with zf.open(info) as f:
        if f.readinto(buf) != len(buf):
            raise OSError(f"short read of {key}")
    dtype = _resolve_dtype(rec["dtype"])
    shape = rec["shape"]
    if not buf:
        return torch.empty(shape, dtype=dtype)
    t = torch.frombuffer(buf, dtype=_WORDS.get(dtype, dtype))
    if dtype in _WORDS:
        t = t.view(dtype)
    return t.reshape(shape)


def load_tree(path, with_meta=False, retry=None):
    """Read back as a nested dict of CPU tensors (the dict-of-dicts mirror
    of the saved tree, rebuilt from the path keys).  Transient IO errors are
    retried with bounded backoff."""
    def _read():
        fault.site("io.read", path=path)
        with zipfile.ZipFile(path, "r") as zf:
            meta = None
            if "meta.json" in zf.namelist():
                meta = json.loads(zf.read("meta.json"))
            index = json.loads(zf.read("treedef.json"))["index"]
            tree = {}
            for key, rec in index.items():
                parts = key.split("/")
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = _read_leaf(zf, key, rec)
        return tree, meta

    tree, meta = retry_call(_read, policy=retry or RetryPolicy(),
                            describe=f"load_tree({path})")
    if with_meta:
        return tree, meta
    return tree


def _rebuild(target, leaves):
    if isinstance(target, dict):
        return {k: _rebuild(target[k], leaves) for k in sorted(target)}
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_rebuild(v, leaves) for v in target))
    if isinstance(target, (tuple, list)):
        return type(target)(_rebuild(v, leaves) for v in target)
    if target is None:
        return None
    return next(leaves)


def restore_like(target_tree, loaded):
    """Rebuild ``target_tree``'s structure (NamedTuples included) from a
    loaded nested dict, matching leaves by path.  A missing path raises
    ``KeyError``."""
    leaves = []
    for key in _flatten_with_paths(target_tree):
        node = loaded
        for p in key.split("/"):
            node = node[p]
        leaves.append(node)
    return _rebuild(target_tree, iter(leaves))


def place_like(loaded, like_tree, cast=None):
    """The one-device ``reshard_put``: each loaded leaf, rebuilt into
    ``like_tree``'s structure, as a tensor on the like-leaf's device in its
    dtype (or ``cast`` when given).  A shape that differs raises."""
    restored = restore_like(like_tree, loaded)
    flat_like = _flatten_with_paths(like_tree)
    out = []
    for key, src in _flatten_with_paths(restored).items():
        like = flat_like[key]
        if tuple(src.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {tuple(src.shape)} != "
                             f"{tuple(like.shape)}")
        out.append(torch.as_tensor(src).to(device=like.device,
                                           dtype=cast or like.dtype, copy=True))
    return _rebuild(like_tree, iter(out))
