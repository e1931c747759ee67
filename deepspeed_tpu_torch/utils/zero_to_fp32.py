#!/usr/bin/env python
"""Extract standalone fp32 weights from a checkpoint.

Counterpart of ``deepspeed_tpu/utils/zero_to_fp32.py``
(``get_fp32_state_dict_from_zero_checkpoint`` /
``convert_zero_checkpoint_to_fp32_state_dict`` /
``load_state_dict_from_zero_checkpoint``), over the port's
``load_tree``.  Checkpoints store full arrays, so consolidation prefers
the fp32 master of the optimizer file over the compute params, flattens
the tree to ``/``-joined names and writes a framework-free ``.npz``.
The engine copies this file beside each checkpoint.

Deliberate difference: ``load_state_dict_from_zero_checkpoint`` returns
fp32 CPU tensors in the target tree's structure (JAX: numpy arrays).

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <out.npz> [-t TAG]
"""

import argparse
import os

import numpy as np
import torch

from ..checkpoint import constants as CK
from ..checkpoint.serialization import load_tree, restore_like
from .logging import logger


def _resolve_dir(checkpoint_dir, tag=None):
    latest = os.path.join(checkpoint_dir, CK.LATEST_FILE)
    if tag is None:
        if os.path.isfile(latest):
            with open(latest) as f:
                tag = f.read().strip()
        elif os.path.isfile(os.path.join(checkpoint_dir, CK.MODEL_FILE)):
            return checkpoint_dir      # checkpoint_dir is a tag directory
        else:
            raise ValueError(f"Unable to find 'latest' file at {latest}")
    ds_dir = os.path.join(checkpoint_dir, str(tag))
    if not os.path.isdir(ds_dir):
        raise FileNotFoundError(f"Directory '{ds_dir}' doesn't exist")
    return ds_dir


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag=None):
    """``{'/'-joined param name: fp32 numpy array}``: the fp32 master of
    the optimizer file when it holds one, else the params upcast."""
    ds_dir = _resolve_dir(checkpoint_dir, tag)
    params = load_tree(os.path.join(ds_dir, CK.MODEL_FILE))["params"]
    optim_path = os.path.join(ds_dir, CK.OPTIM_FILE)
    master = None
    if os.path.isfile(optim_path):
        master = load_tree(optim_path).get(CK.FP32_MASTER)
    src = master if master is not None else params
    return {k: v.float().numpy() for k, v in _flatten(src).items()}


def convert_zero_checkpoint_to_fp32_state_dict(checkpoint_dir, output_file, tag=None):
    """Write the consolidated fp32 weights to ``output_file`` (.npz)."""
    state_dict = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **state_dict)
    logger.info(f"Saved fp32 state dict to {output_file}")
    return state_dict


def load_state_dict_from_zero_checkpoint(target_params, checkpoint_dir, tag=None):
    """``target_params``' tree structure with the checkpoint's fp32 weights."""
    nested = {}
    for key, arr in get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag).items():
        node = nested
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(arr)
    return restore_like(target_params, nested)


def main():
    parser = argparse.ArgumentParser(description="Extract fp32 weights from a checkpoint")
    parser.add_argument("checkpoint_dir", type=str,
                        help="checkpoint folder, e.g. path/checkpoint-12")
    parser.add_argument("output_file", type=str, help="output .npz path")
    parser.add_argument("-t", "--tag", type=str, default=None)
    args = parser.parse_args()
    base = args.checkpoint_dir.rstrip("/")
    convert_zero_checkpoint_to_fp32_state_dict(
        os.path.dirname(base) if os.path.basename(base).startswith("global_step") else base,
        args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
