#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py        # from the repo root; one CUDA card, nvcc

Drives the port only (``deepspeed_tpu_torch``; nothing of JAX or of the
JAX package ``deepspeed_tpu``):

1. setup: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of the CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, started together) with its time and ptxas
   register/spill summary; ``flash_fwd_sm90``'s library (its build
   seconds, registers and spills per instance) must build with no spill;
2. kernels vs plain: ``paged_attention_online`` and ``paged_attention_exact``
   against ``paged_attention_reference`` at the serving shape (8 slots,
   12 heads, head dim 64, block 16, 64 blocks per slot), lengths
   0..1020, windows 1 and 4, bf16 / int8+scales / fp32 pools; then the
   dense forward its route takes (``flash_fwd_sm90`` for bf16 at head
   dims 64 and 128, whose first launch waits on an event under a
   deadline; the template ``flash_fwd`` for the rest, and beside every
   ``flash_fwd_sm90`` case the template too), O and lse, and
   ``flash_bwd_dkdv`` and ``flash_bwd_dq`` against their plain versions
   fed the routed forward's (O, lse) and the same dO, at B=2, H=4, T in
   {64, 96, 1000, 1024} (and 1088, 4096 for ``flash_fwd_sm90``), head dims
   64/96/128, bf16 and fp32 (TF32 off), causal and not, q/k/v as views of
   one qkv tensor and contiguous, each element within its limit; and one
   gradient check of the ``flash_attention`` autograd function against
   autograd of a dense attention in fp32;
3. serving: GPT-2 125M at full width (bf16, random weights from
   ``init_numpy(seed=0)``) answers 16 greedy requests with 16-bit KV, with
   int8 KV, and with the exact kernel; every outcome must be OK, every
   block recycled, and the kernel's launch count equal decode steps x 12;
   one decode step's logits through the kernels are held against the
   ``gather`` path;
4. timing: each paged kernel, its plain version and a library yardstick
   (``scaled_dot_product_attention`` over pre-gathered K/V, which the port
   never calls) with CUDA events at the phase-3 shape, beside the least
   time the card could take (the bytes the call must move over the
   card's memory rate);
5. training: GPT-2 350M at full width (T=1024, micro-batch 8, gas 1,
   bf16, ZeRO-1, AdamW 6e-4 / wd 0.1, clip 1.0, dropout 0, no remat)
   through ``deepspeed_tpu_torch.initialize`` -> ``train_batch()`` on
   tokens ``rng(0).integers(0, 50257, (64, 1025))``: step 1 with
   ``attention_impl="flash"`` against ``"jnp"`` from the same weights and
   batch; 3 warm-up and 10 timed steps (tokens/s, step time p50/p99, MFU,
   peak memory); exactly 24 launches per step of ``flash_fwd_sm90``,
   ``flash_bwd_dkdv`` and ``flash_bwd_dq``, and none of ``flash_fwd``;
   finite losses and no skipped step; 20 steps on one fixed batch lower
   its loss by at least 0.5; a ``torch.profiler`` breakdown of a step,
   with the flash forward's device time per step;
6. the flash kernels at the training shape, B=8, H=16, T=1024, d=64,
   causal, bf16 (q, k, v views of one qkv tensor, as the model passes
   them): each held against its plain version (these errors go into the
   kernels line), then timed (three readings, the spread printed) beside
   its bound, its plain version and the library's attention in the (B, H,
   T, d) layout, which the port never calls: ``flash_fwd_sm90`` and the
   template ``flash_fwd`` (the PR 2 design) beside
   ``scaled_dot_product_attention`` forward, the backward kernels beside
   the flash-attention backward op (dQ, dK and dV in one call), and
   forward+backward; then ``flash_fwd_sm90`` against SDPA ``is_causal``
   at B*T=8192, H=16, T in {1024, 2048, 4096, 8192}, head dims 64 and 128;
7. sparse kernels vs plain: ``flash_fwd_lut``, ``flash_fwd_lut_ring``,
   ``flash_bwd_dkdv_lut``, ``flash_bwd_dq_lut`` and the dense biased
   ``flash_fwd_biased``, ``flash_bwd_dkdv_biased``, ``flash_bwd_dq_biased``
   against their plain versions fed the same (O, lse, dO), element by
   element with phase 2's limits: B=2, H=4, T in {256, 1024} and 1008,
   layouts Fixed block 16 (per-head patterns), Fixed 32, BigBird 64,
   BSLongformer 128 and a diagonal one whose first 64 queries and keys
   have no live tile, no bias / an ``add`` key bias / a ``mul`` key bias
   with a fully padded batch row / a (T, T) score bias, causal and not,
   bf16 and fp32, head dims 64/96/128, qkv views and contiguous;
8. BERT-large masked-LM training at full width (24 layers, 1024 wide, 16
   heads, vocab 30522), position embeddings extended 512 -> 2048 with
   ``extend_position_embedding``, T=2048, micro-batch 8, gas 1, bf16,
   ZeRO-1, AdamW 1e-4, hidden dropout 0.1, remat, the
   ``docs/tutorials/bert-pretraining.md`` ``sparse_attention`` section
   (fixed, block 16, per-head layouts, local 4, global 1, bidirectional)
   read through the engine config and ``build_sparsity_config``, through
   ``build("bert-large")`` -> ``replace_model_self_attention`` ->
   ``initialize`` -> ``train_batch()`` on padded batches from a numpy
   seed: step 1 through the kernels against step 1 with the plain
   ``_masked_dense`` attention from the same weights and batch; 3
   warm-up and 10 timed steps (tokens/s, step p50/p99, MFU, peak memory);
   exactly 48 / 24 / 24 launches per step of ``flash_fwd_lut`` /
   ``flash_bwd_dkdv_lut`` / ``flash_bwd_dq_lut`` (remat runs each forward
   twice); finite losses and no skipped step; 20 steps on one fixed batch
   lower its loss by at least 0.5; a ``torch.profiler`` breakdown of one
   step; 8b, two steps on unpadded batches (``flash_fwd_lut_ring``, not
   ``flash_fwd_lut``); 8c, two padded steps with ``"mode": "dense"``
   (an all-ones layout: the dense biased kernels);
9. the sparse and biased kernels at the training shape, B=8, H=16,
   T=2048, d=64, bf16, q/k/v views of one qkv tensor: the tutorial's
   block-16 layout with the padding bias (and without it, the ring), the
   block-64 Fixed layout of ``docs/tutorials/sparse-attention.md`` (tiles
   skipped) and the all-ones layout with the padding bias; each kernel
   held against its plain version (these errors go into the kernels
   line), then timed beside its bound, its plain version and
   ``scaled_dot_product_attention`` with the expanded boolean
   layout-and-padding mask, forward and forward+backward.

10. int8 kernels vs plain: ``int8_mm_nt`` and ``int8_mm_t`` against
    ``int8_matmul_reference`` at the GPT-2 125M and 1.3B weight shapes
    (qkv, proj, fc, fc_proj; the tied head transposed, N = 50257), M in
    {1, 8, 16, 17, 64, 512}, per-tensor scales (and per-channel for the
    head), bf16 and fp32 outputs: fp32 within d = 1e-5 of the largest |value|
    + 1e-6, bf16 within one bf16 ulp of each value + d, and two calls
    bit-identical;
11. int8 serving: GPT-2 1.3B at published widths (24 layers, 2048 wide, 32
    heads, vocab 50257), weights drawn on the card from a seeded generator
    with ``init_numpy``'s distributions, through
    ``deepspeed_tpu_torch.init_inference(model, params=..., dtype=torch.int8)``
    -> ``ServingEngine(engine=...)`` with phase 3's traffic: every outcome OK,
    every block recycled, ``int8_mm_nt`` launched (decode steps + prefills) x
    96 times and ``int8_mm_t`` (decode steps + prefills) times, the int8
    tree at most 0.55x the bf16 tree's bytes; the oracle serves the same
    int8 values dequantized to bf16: its greedy choice on the int8 streams'
    contexts agrees on at least 0.9 of the tokens, one decode step's logits
    within 0.25; ``InferenceEngine.generate`` at int8 (B=4, T=64, +16)
    against the serving streams; a ``torch.profiler`` breakdown of a decode
    step of each;
12. the int8 kernels at 1.3B's weights, decode (M = 8) and prefill (M =
    512): each held against its plain version, then timed beside its bound,
    its plain version, ``torch.matmul`` over the dequantized bf16 weight and
    (the head) ``torch._weight_int8pack_mm``, which the port never calls;
13. banded and merged-row kernels vs plain: ``flash_fwd_banded`` and
    ``flash_fwd_merged`` against ``flash_attention_reference_fwd`` over
    their schedules (O and lse, phase 2's limits) at B=2,
    H=4: causal BSLongformer layouts at blocks 16, 32, 64, 128 and 512,
    windows 1, 3 and 5, global blocks [0] and [0, 3], T 1024 and 4096, a
    ragged T=1008 at block 16 and an odd tile count (T=1088 at block 32);
    the merged kernel also on a causal Fixed layout, per-head Fixed layouts
    (causal and not), BigBird 64, phase 7's empty-rows layout and one whose
    every merged row has an empty upper half; bf16 and fp32, head dims
    64/96/128; then ``flash_attention_with_lse`` at GPT-2 350M's attention
    shape (B=8, T=1024, H=16, d=64, bf16) under a loss on both outputs
    (one launch each of ``flash_fwd_sm90`` and the two dense backward
    kernels; O, lse and gradients against the plain
    forward and backward with ``delta - dlse``) and in fp32 against autograd
    of a dense attention returning its logsumexp;
14. the causal block-sparse path at the repo's sparse workload
    (``examples/bench_sparse_attention.py``: BSLongformer, a 3 x 512-token
    window, the first 512 tokens global, unidirectional), B=1, H=8, d=64,
    bf16, T in {4096, 8192, 16384}, layout blocks 512 and 64:
    ``SparseSelfAttention`` forward + ``backward()`` with exactly one launch
    each of ``flash_fwd_banded``, ``flash_bwd_dkdv_lut`` and
    ``flash_bwd_dq_lut`` per call (``flash_fwd_lut_ring`` 0), and the same
    through ``sparse_flash_attention(..., block_q_merge=2)`` (one
    ``flash_fwd_merged``), then that merged path on the tutorial block-16
    layout at BERT-large's attention shape (B=8, T=2048, H=16, non-causal);
    O, lse and gradients against the plain versions at T <= 8192, O and lse
    against ``flash_fwd_lut_ring`` at 16384; each forward timed (three
    readings, the spread printed) beside its bound, its plain version, the
    ring on the same LUT, the dense causal forward (``flash_fwd_sm90``), SDPA with the
    expanded boolean layout mask and SDPA ``is_causal``, and each path's
    forward+backward beside SDPA's with the mask.

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without that line; with no CUDA device it exits 2.
"""

import itertools
import json
import math
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request,
                                           ServingConfig, ServingEngine)
from deepspeed_tpu_torch.inference import paged_kv as pk
from deepspeed_tpu_torch.models import build
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax
from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig,
    SparseSelfAttention, build_sparsity_config, extend_position_embedding,
    replace_model_self_attention)
from deepspeed_tpu_torch.module_inject.module_quantize import dequantize_tree
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import int8_matmul as im
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.runtime.comm.quantized import quantize_blockwise

L_CYCLE = 12          # layers cycled through when timing (cold L2 per launch)
SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"
FLASH_REF = "deepspeed_tpu/ops/transformer/flash_attention.py"
REPLACES = {"paged_attention_online":
            "deepspeed_tpu/ops/transformer/paged_attention.py:180",
            "paged_attention_exact":
            "deepspeed_tpu/ops/transformer/paged_attention.py:90",
            "flash_fwd": f"{FLASH_REF}:144",
            "flash_fwd_sm90": f"{FLASH_REF}:144",        # dense, bf16 at head dims 64 / 128
            "flash_bwd_dkdv": f"{FLASH_REF}:617",
            "flash_bwd_dq": f"{FLASH_REF}:691",
            "flash_fwd_biased": f"{FLASH_REF}:144",      # use_kbias / use_abias
            "flash_bwd_dkdv_biased": f"{FLASH_REF}:617",
            "flash_bwd_dq_biased": f"{FLASH_REF}:691",
            "flash_fwd_lut": f"{FLASH_REF}:144",         # use_lut + biases
            "flash_fwd_lut_ring": f"{FLASH_REF}:306",    # _fwd_kernel_dma
            "flash_fwd_banded": f"{FLASH_REF}:180",      # _fwd_kernel use_banded
            "flash_fwd_merged": f"{FLASH_REF}:161",      # use_merge (and _fwd_kernel_dma 317)
            "flash_bwd_dkdv_lut": f"{FLASH_REF}:617",
            "flash_bwd_dq_lut": f"{FLASH_REF}:691",
            "int8_mm_nt": "deepspeed_tpu/ops/transformer/int8_matmul.py:45",
            "int8_mm_t": "deepspeed_tpu/ops/transformer/int8_matmul.py:53"}
INT8_SOURCE = "deepspeed_tpu_torch/csrc/int8_matmul.cu"
SM90_LIB = fa.ENTRIES["flash_fwd_sm90"][0]
SM90_DEADLINE_S = 10.0   # the first flash_fwd_sm90 launch must complete within this


def flash_source(name):
    """The CUDA source of a flash entry (the kernels are in the .cuh it
    includes)."""
    return f"deepspeed_tpu_torch/csrc/{fa.ENTRIES[name][0]}.cu"
# flash kernels vs their plain versions, element by element:
#   O, dK, dV, dQ: |kernel - plain| <= a * rms(plain) + r * |plain|
#   lse (fp32 on both sides): |kernel - plain| <= FLASH_LSE_TOL
# bf16: r is one bf16 ulp of |plain| (both sides round an fp32 result to
# bf16), a four ulps at the tensor's rms (the kernel rounds P and dS to bf16
# against its running max, the plain version against the row's final one).
# fp32: the same formula summed in another order, exp2 for exp.  Readings
# these were set from (H100, B=2 H=4 T 64..1024 d 64..128): bf16 at most one
# ulp of the element (1.6e-2 at |dV| in [2, 4)), fp32 at most 1.5e-6, lse at
# most 9.6e-7.  A dropped 40-key tail tile at T=1000 moves lse by ~4e-2.
FLASH_TOL = {torch.bfloat16: (2 ** -5, 2 ** -7),
             torch.float32: (1e-4, 1e-5)}
FLASH_LSE_TOL = 1e-4
GRAD_TOL = 1e-4       # flash_attention's autograd vs a dense attention's, fp32
# step 1 of GPT-2 350M, flash vs plain attention, bf16: the plain path rounds
# the scores to bf16 before the fp32 softmax (JAX _attention_jnp), the kernel
# keeps them in fp32.  Readings (H100): loss gaps 8.3e-5 and 1.6e-4 near 11,
# grad-norm gaps 4.3e-5 and 1.2e-4 relative; the limits are 6x and 16x those
STEP1_LOSS_TOL = 1e-3        # absolute
STEP1_GNORM_TOL = 2e-3       # relative
# tolerances on outputs of magnitude ~1 (attention averages of N(0,1) rows)
TOL = {"fp32": 1e-4,    # same fp32 formula, sums in another order
       "bf16": 2e-2,    # one bf16 ulp at 1 is 7.8e-3; the online kernel keeps
       #                  the softmax denominator in fp32 where the plain
       #                  version rounds each probability to bf16
       "int8": 2e-2}    # the same, on identically dequantized values
# one decode step of GPT-2 125M, kernel vs gather path, bf16: the logits
# are a bf16 matmul result (|logit| < 4 here, one bf16 ulp 0.016-0.031)
# and attention differences of a bf16 ulp pass through 12 layers; a few
# ulps at the largest logits
LOGIT_TOL = 0.1


def peak_bytes_per_s(name):
    """Published memory rate of the card (NVIDIA data sheets)."""
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12          # H100 SXM
    if "H200" in name:
        return 4.8e12
    raise RuntimeError(f"no published memory rate known for {name!r}")


PEAK_OPS = {"bf16": 989e12, "int8": 989e12, "fp32": 67e12}   # dense, per s


def nvidia_smi():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """[kernel, registers, shared-memory bytes, spill bytes] per kernel."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            out.append([m.group(1).replace("_ZN12_GLOBAL__N_1", ""), 0, 0, 0])
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1][1:3] = [int(m.group(1)), int(smem.group(1)) if smem else 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and out:
            out[-1][3] = int(m.group(1)) + int(m.group(2))
    return out


def setup():
    """Phase 1: card, versions, kernel build.  Returns the nvidia-smi line."""
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; host CPU "
          f"{host_cpu()}")
    t0 = time.perf_counter()
    builder.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    for name in sorted(builder.build_log):
        log = builder.build_log[name]
        with open(f"chiprun_out/ptxas_{name}.txt", "w") as f:
            f.write(log["ptxas"])
        print(f"  {name}.cu: nvcc {log['seconds']:.2f} s, cached={log['cached']}")
        for row in ptxas_summary(log["ptxas"]):
            print("  ptxas", row)
        for line in log["ptxas"].splitlines():
            if "Potential Performance Loss" in line:
                print("  ptxas", line.strip())
    sm90 = ptxas_summary(builder.build_log[SM90_LIB]["ptxas"])
    print(f"{SM90_LIB}.cu: built in {builder.build_log[SM90_LIB]['seconds']:.2f} s; " + "; ".join(
        f"{kname[kname.find('fwd_sm90_kernel'):]} {regs} registers, {spill} spill bytes"
        for kname, regs, _, spill in sm90))
    if not sm90 or any(spill for *_, spill in sm90):
        raise AssertionError(f"{SM90_LIB}: no kernel built, or ptxas spilled registers: {sm90}")
    return card


def check_kernels(dev, gen, B=8, H=12, HD=64, BS=16, NB_MAX=64,
                  lengths_list=(0, 15, 16, 500, 1020, 37, 255, 768)):
    """Phase 2: both kernels against the plain version on the card.
    Returns the max abs error per kernel."""
    max_err = {name: 0.0 for name in pa.KERNELS.values()}

    def random_pool(kind):
        shape = (2, 1 + B * NB_MAX, BS, H, HD)
        k = torch.randn(shape, generator=gen, device=dev)
        v = torch.randn(shape, generator=gen, device=dev)
        if kind == "int8":
            qk, sk = quantize_blockwise(k, block_size=64)
            qv, sv = quantize_blockwise(v, block_size=64)
            return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}, torch.bfloat16
        dt = torch.float32 if kind == "fp32" else torch.bfloat16
        return {"k": k.to(dt), "v": v.to(dt)}, dt

    def tables_for(W):
        perm = torch.randperm(B * NB_MAX, generator=gen, device=dev) + 1
        t = torch.zeros((B, NB_MAX), dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths_list):
            live = pk.blocks_needed(n + W, BS)
            t[b, :live] = perm[b * NB_MAX:b * NB_MAX + live].int()
        return t

    lengths = torch.tensor(lengths_list, dtype=torch.int32, device=dev)
    for kind in ("bf16", "int8", "fp32"):
        pool, dt = random_pool(kind)
        for W in (1, 4):
            tables = tables_for(W)
            q = torch.randn((B, W, H, HD), generator=gen, device=dev).to(dt)
            ref = pa.paged_attention_reference(q, pool, tables, lengths, 1)
            for mode, name in pa.KERNELS.items():
                out = pa.paged_attention(q, pool, tables, lengths, 1, mode=mode)
                torch.cuda.synchronize()
                if out.shape != ref.shape or not torch.isfinite(out).all():
                    raise AssertionError(f"{name} {kind} W={W}: bad output")
                err = (out.float() - ref.float()).abs().max().item()
                max_err[name] = max(max_err[name], err)
                print(f"kernel-check {name} pool={kind} W={W}: max_abs_err "
                      f"{err:.3e} (tol {TOL[kind]:g})")
                if not err <= TOL[kind]:
                    raise AssertionError(f"{name} pool={kind} W={W}: error "
                                         f"{err} above {TOL[kind]}")
    return max_err


def flash_inputs(dev, gen, dt, B, T, H, d, layout):
    """q, k, v, dO of shape (B, T, H, d): q/k/v as views of one fused
    (B, T, 3*H*d) qkv tensor (``layout="qkv"``, as the model passes them)
    or contiguous (``"dense"``)."""
    if layout == "qkv":
        qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(dt)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    else:
        q, k, v = (torch.randn((B, T, H, d), generator=gen, device=dev).to(dt)
                   for _ in range(3))
    return q, k, v, torch.randn((B, T, H, d), generator=gen, device=dev).to(dt)


def flash_close(what, label, got, ref):
    """(max abs error, largest share of its limit) of one flash output
    against its plain version; raises when an element is past its limit
    (FLASH_TOL, FLASH_LSE_TOL)."""
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"{what} {label}: bad output {tuple(got.shape)} {got.dtype}")
    tol = FLASH_TOL[got.dtype]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if label == "lse":
        limit = torch.full_like(ref, FLASH_LSE_TOL)
    else:
        limit = tol[0] * ref.pow(2).mean().sqrt() + tol[1] * ref.abs()
    share = (err / limit).max().item()
    if not share <= 1.0:
        raise AssertionError(f"{what} {label}: error {err.max().item():.3e} is "
                             f"{share:.2f}x its limit")
    return err.max().item(), share


def check_flash_case(q, k, v, do, causal, what):
    """Each flash kernel against its plain version on the same inputs: the
    dense forward the route takes (and beside ``flash_fwd_sm90`` the
    template ``flash_fwd`` too), the backward ones fed the routed forward's
    O and lse, as in training.  Returns {kernel: [(output, max abs error,
    share of limit)]}."""
    fwd = fa.dense_fwd_kernel(q.dtype, q.shape[-1])
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal)
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal)
    rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal)
    pairs = {fwd: [("o", o, ro), ("lse", lse, rlse)],
             "flash_bwd_dkdv": [("dk", dk, rdk), ("dv", dv, rdv)],
             "flash_bwd_dq": [("dq", dq, rdq)]}
    if fwd != "flash_fwd":
        to, tlse = fa.flash_fwd_template(q, k, v, causal)
        pairs["flash_fwd"] = [("o", to, ro), ("lse", tlse, rlse)]
    torch.cuda.synchronize()
    return {name: [(label, *flash_close(f"{name} {what}", label, got, ref))
                   for label, got, ref in ps] for name, ps in pairs.items()}


def flash_line(res):
    """``output max-abs-error (share of its limit)`` for each output."""
    return ", ".join(f"{label} {err:.2e} ({share:.2f})"
                     for rows in res.values() for label, err, share in rows)


def first_sm90_launch(dev, gen):
    """The first ``flash_fwd_sm90`` launches (T=64, one tile, each head
    dim), each waited for on a CUDA event polled under SM90_DEADLINE_S: a
    launch that does not complete raises (the kernel also traps on an
    mbarrier wait of more than 2 s), so a fault of its schedule ends the
    run instead of stalling it."""
    for d in fa.SM90_HEAD_DIMS[torch.bfloat16]:
        q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, 1, 64, 1, d, "dense")
        t0 = time.perf_counter()
        o, lse = fa.flash_fwd_sm90(q, k, v, True)
        done = torch.cuda.Event()
        done.record()
        while not done.query():
            if time.perf_counter() - t0 > SM90_DEADLINE_S:
                raise RuntimeError(f"flash_fwd_sm90 d={d}: the first launch did not complete "
                                   f"within {SM90_DEADLINE_S} s")
            time.sleep(1e-3)
        err = (o.float() - fa.flash_attention_reference_fwd(q, k, v, True)[0].float()).abs().max()
        print(f"flash_fwd_sm90 first launch d={d} T=64: completed in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, O max abs error {err.item():.2e}")


def check_flash_kernels(dev, gen, B=2, H=4):
    """Phase 2, flash: each kernel against its plain version over head
    dims, lengths, masks, dtypes and both layouts.  Returns the max abs
    error per kernel."""
    first_sm90_launch(dev, gen)
    max_err = {name: 0.0 for name in fa.DENSE_KERNELS}
    for dt, dims in fa.HEAD_DIMS.items():
        for d, T, causal, layout in itertools.product(
                dims, (64, 96, 1000, 1024, 1088, 4096), (True, False), ("qkv", "dense")):
            if T > 1024 and fa.dense_fwd_kernel(dt, d) != "flash_fwd_sm90":
                continue
            what = f"{str(dt)[6:]} d={d} T={T} causal={int(causal)} {layout}"
            res = check_flash_case(*flash_inputs(dev, gen, dt, B, T, H, d, layout),
                                   causal, what)
            for name, rows in res.items():
                max_err[name] = max([max_err[name]] + [err for _, err, _ in rows])
            print(f"flash-check {what}: {flash_line(res)}")
    return max_err


def check_flash_grad(dev, gen, B=2, T=256, H=4, d=64):
    """Phase 2, flash: gradients through the ``flash_attention`` autograd
    function against autograd of a dense causal attention, fp32."""
    q, k, v, w = (torch.randn((B, T, H, d), generator=gen, device=dev) for _ in range(4))
    grads = []
    for flash in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if flash:
            out = fa.flash_attention(*leaves, causal=True)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]) / math.sqrt(d)
            s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=dev).tril(),
                              -math.inf)
            out = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2])
        (out * w).sum().backward()
        grads.append([x.grad for x in leaves])
    errs = [(a - b).abs().max().item() for a, b in zip(*grads)]
    print(f"flash autograd vs dense autograd (fp32): dq {errs[0]:.2e} dk {errs[1]:.2e} "
          f"dv {errs[2]:.2e} (tol {GRAD_TOL:g})")
    if not max(errs) <= GRAD_TOL:
        raise AssertionError(f"flash_attention gradients differ by {errs}")


def serve(engine, prompts, new, tag, kv_bits, mode):
    """Phase 3 (and 11) run: serve ``prompts`` greedily with counts reset
    just before and read just after; checks outcomes, tokens, recycling,
    paged-attention launches == decode steps x layers and, for an int8
    engine, ``int8_mm_nt`` == (steps + prefills) x 4 x layers and
    ``int8_mm_t`` == steps + prefills (0 for a float engine).  Returns
    (server, paged launches, tokens)."""
    c = engine.module.config
    c.paged_attention_mode = mode
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=kv_bits,
                        max_new_tokens=new)
    ServingEngine(engine=engine, config=cfg).run(
        [Request(tokens=prompts[0][:40], max_new_tokens=4)])   # warm-up
    srv = ServingEngine(engine=engine, config=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    pa.reset_launches()
    im.reset_launches()
    t0 = time.perf_counter()
    res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(pa.launches)
    int8_counts = dict(im.launches)
    st = srv.stats()
    steps = st["decode_steps"]
    want = pa.KERNELS["exact" if mode == "exact" else "online"]
    for name, n in counts.items():
        expect = steps * c.n_layer if name == want else 0
        if n != expect:
            raise AssertionError(f"{tag}: {name} launched {n} times, "
                                 f"expected {expect} ({steps} steps)")
    calls = (steps + len(prompts)) if engine.quantized else 0   # decode steps + prefills
    for name, expect in (("int8_mm_nt", calls * 4 * c.n_layer), ("int8_mm_t", calls)):
        if int8_counts[name] != expect:
            raise AssertionError(f"{tag}: {name} launched {int8_counts[name]} times, "
                                 f"expected {expect} ({steps} steps, {len(prompts)} "
                                 f"prefills)")
    for uid in range(len(prompts)):
        r = res[uid]
        if r["outcome"] != OK or len(r["tokens"]) != new:
            raise AssertionError(f"{tag}: uid {uid} {r['outcome']} {r['tokens']}")
        if not all(0 <= t < c.vocab_size for t in r["tokens"]):
            raise AssertionError(f"{tag}: uid {uid} token out of range")
    if srv.allocator.free_blocks != srv.num_blocks - 1:
        raise AssertionError(f"{tag}: {srv.allocator.free_blocks} free of "
                             f"{srv.num_blocks - 1}: blocks leaked")
    int8_line = (f"int8_mm_nt {int8_counts['int8_mm_nt']} = (steps + prefills) x "
                 f"{4 * c.n_layer}, int8_mm_t {int8_counts['int8_mm_t']} = steps + "
                 f"prefills; " if engine.quantized else "")
    print(f"serve {tag}: {len(prompts)} requests OK, {steps} decode steps, "
          f"{want} launches {counts[want]} = steps x {c.n_layer}; {int8_line}"
          f"{st['generated_tokens'] / wall:.1f} tokens/s, decode step p50 "
          f"{st['step_ms']['p50']:.3f} ms p99 {st['step_ms']['p99']:.3f} ms, "
          f"TTFT p50 {st['ttft_ms']['p50']:.1f} ms, wall {wall:.2f} s, "
          f"pool {pk.pool_bytes(srv.pool) / 1e6:.1f} MB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB (resident before the run "
          f"{resident / 1e6:.1f} MB)")
    srv.int8_launches = int8_counts
    return srv, counts[want], {uid: res[uid]["tokens"] for uid in res}


def seat(srv, prompts):
    """Prefill ``prompts`` into the slots without decoding; returns the
    decode operands (toks, tables, lengths) on the engine's device."""
    for i, p in enumerate(prompts):
        srv.submit(Request(tokens=p, uid=1000 + i))
    srv._admit()
    dev = srv.device
    return (torch.as_tensor(srv._toks, device=dev),
            torch.as_tensor(srv._tables, device=dev),
            torch.as_tensor(srv._lengths, device=dev))


def check_decode_logits(srv, tag, toks, tables, lengths):
    """One decode step through each kernel vs the gather path, each on its
    own copy of the pool."""
    model, params = srv.model, srv.engine.params
    c = model.config
    logits = {}
    for impl, mode in (("kernel", "online"), ("kernel", "exact"),
                       ("gather", "auto")):
        c.paged_attention_impl, c.paged_attention_mode = impl, mode
        pool = {k: v.clone() for k, v in srv.pool.items()}
        with torch.no_grad():
            logits[(impl, mode)], _ = model.decode_step_paged(
                params, toks, pool, tables, lengths)
    c.paged_attention_impl, c.paged_attention_mode = "auto", "auto"
    ref = logits[("gather", "auto")]
    if ref.shape != (toks.shape[0], c.vocab_size) or not torch.isfinite(ref).all():
        raise AssertionError(f"gather logits {tuple(ref.shape)} not finite")
    for key in (("kernel", "online"), ("kernel", "exact")):
        err = (logits[key] - ref).abs().max().item()
        agree = (logits[key].argmax(-1) == ref.argmax(-1)).sum().item()
        print(f"decode-step logits {tag} {key[1]} kernel vs gather: "
              f"max_abs_err {err:.3e} (tol {LOGIT_TOL}), max|logit| "
              f"{ref.abs().max().item():.2f}, argmax agree {agree}/{toks.shape[0]}")
        if not err <= LOGIT_TOL:
            raise AssertionError(f"{tag} {key}: logits differ by {err}")


def time_ms(fn, n, warmup=L_CYCLE):
    """Mean device time of ``fn(layer)`` over ``n`` calls cycling the
    layers (CUDA events around a backlogged stream); ``fn`` may ignore
    the layer."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    # a device-side backlog, so the host's enqueue time never shows
    torch.cuda._sleep(int(3e7))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(i % L_CYCLE)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timing(srv, tag, pool_kind, gen, bytes_per_s):
    """Phase 4 at the seated state of ``srv`` (W = 1): each kernel, the
    plain version, the SDPA yardstick, and the bound."""
    dev, pool = srv.device, srv.pool
    H, HD = pool["k"].shape[3], pool["k"].shape[4]
    B, S = srv._tables.shape[0], srv.nb_max * srv.config.block_size
    tables = torch.as_tensor(srv._tables, device=dev)
    lengths = torch.as_tensor(srv._lengths, device=dev)
    q = torch.randn((B, 1, H, HD), generator=gen, device=dev).to(torch.bfloat16)
    lens = srv._lengths.astype(np.int64)
    rows = int(np.minimum(lens + 1, S).sum())
    nbytes = (q.numel() * 2 * 2                             # q read, out written
              + rows * H * HD * pool["k"].element_size() * 2   # live K and V
              + tables.numel() * 4 + lengths.numel() * 4)
    if pk.is_quantized_pool(pool):
        nbytes += rows * H * pool["k_scale"].shape[-1] * 4 * 2
    ops = 4 * rows * H * HD                                 # QK and PV
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = ops / PEAK_OPS[pool_kind] * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    # library yardstick: SDPA over pre-gathered dense K/V (gather untimed)
    dense = []
    for layer in range(L_CYCLE):
        k, v = pk.gather_kv(pool, layer, tables, torch.bfloat16)
        dense.append((k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()))
    mask = (torch.arange(S, device=dev)[None, :]
            <= lengths.long()[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, *dense[0], attn_mask=mask).transpose(1, 2).reshape(B, 1, H * HD)
    lib_err = (lib.float() - pa.paged_attention_reference(
        q, pool, tables, lengths, 0).float()).abs().max().item()
    if not lib_err <= TOL[pool_kind]:
        raise AssertionError(f"SDPA yardstick disagrees by {lib_err}")
    library_ms = time_ms(lambda l: sdpa(qh, *dense[l], attn_mask=mask), 200)
    plain_ms = time_ms(lambda l: pa.paged_attention_reference(
        q, pool, tables, lengths, l), 40)
    out = {"shape": {"slots": B, "mean_length": float(lens.mean()),
                     "live_rows": rows, "pool": pool_kind},
           "bytes": nbytes, "ops": ops, "bound_ms": bound_ms,
           "bound_by": bound_by, "plain_ms": plain_ms,
           "library_ms": library_ms, "kernels_ms": {}}
    saved = dict(pa.launches)
    for mode, name in pa.KERNELS.items():
        ms = time_ms(lambda l: pa.paged_attention(q, pool, tables, lengths, l,
                                                  mode=mode), 200)
        out["kernels_ms"][name] = ms
        print(f"timing {tag} {name}: {ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}), plain "
              f"{plain_ms * 1e3:.2f} us, library {library_ms * 1e3:.2f} us, "
              f"mean length {lens.mean():.1f}")
    pa.launches.update(saved)          # timing launches are not path launches
    return out


def profile_steps(step, tag, steps=6, unit="decode step"):
    """Where a step's time goes: ``steps`` calls of ``step()`` (after one
    to reach steady state) under ``torch.profiler``; prints the wall time
    per step, the device's busy and idle shares, the kernel launches per
    step and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()                                      # steady state first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {tag}: the profiler saw no device events")
        return {}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, -math.inf
    for a, b in spans:                          # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(f"profile {tag}: {wall_us / steps:.1f} us per {unit}, device busy "
          f"{busy / steps:.1f} us ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%, {len(kernels) / steps:.1f} kernel "
          f"launches per step")
    for name, (t, n) in top:
        print(f"  {t / steps:8.1f} us/step {n / steps:6.1f} launches/step  {name[:90]}")
    return {name: (t / steps, n / steps) for name, (t, n) in by_name.items()}


TRAIN_CONFIG = {
    "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 1,
    "steps_per_print": 10 ** 9,
    "gradient_clipping": 1.0,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1},
}


def train_engine(dev, np_params, tokens, impl, preset, seq, micro):
    model = GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                 embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0, remat=False,
                 attention_impl=impl)
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=config, model=model, params=np_params, training_data=(tokens,))
    return engine


def train(dev, card, warmup=3, timed=10, fit_steps=20, preset="gpt2-350m", seq=1024,
          micro=8):
    """Phase 5: GPT-2 training through initialize -> train_batch (350M,
    T=1024, micro-batch 8 as the driver runs it).  Returns the flash
    kernels' launches in the timed run."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    np_params = GPT2(preset=preset, max_seq=seq, device=dev).init_numpy(seed=0)
    eng = train_engine(dev, np_params, tokens, "jnp", preset, seq, micro)
    plain = (float(eng.train_batch()), eng.get_global_grad_norm())
    del eng
    torch.cuda.empty_cache()

    eng = train_engine(dev, np_params, tokens, "flash", preset, seq, micro)
    model = eng.module
    n_layer = model.config.n_layer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            flash = (losses[0], eng.get_global_grad_norm())
            first_counts = dict(fa.launches)
    counts = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"train step 1: loss flash {flash[0]:.6f} plain {plain[0]:.6f}; grad norm "
          f"flash {flash[1]:.6f} plain {plain[1]:.6f} (tol {STEP1_LOSS_TOL:g} abs, "
          f"{STEP1_GNORM_TOL:g} rel)")
    if not (abs(flash[0] - plain[0]) <= STEP1_LOSS_TOL
            and abs(flash[1] - plain[1]) <= STEP1_GNORM_TOL * abs(plain[1])):
        raise AssertionError(f"step 1 flash {flash} vs plain {plain}")
    n_steps = warmup + timed
    fwd = fa.dense_fwd_kernel(torch.bfloat16, model.config.n_embd // model.config.n_head)
    per_step = {fwd: n_layer, "flash_bwd_dkdv": n_layer, "flash_bwd_dq": n_layer}
    check_launches(f"train {preset} step 1", first_counts, per_step, 1)
    check_launches(f"train {preset}", counts, per_step, n_steps)
    if not all(math.isfinite(x) for x in losses) or eng.skipped_steps != 0:
        raise AssertionError(f"losses {losses}, skipped {eng.skipped_steps}")
    step_ms = np.asarray(times[warmup:]) * 1e3
    tok_s = timed * eng.train_batch_size() * model.config.max_seq / (step_ms.sum() / 1e3)
    mfu = tok_s * model.flops_per_token() / PEAK_OPS["bf16"]
    print(f"train {preset} T={seq} micro {micro} bf16 zero1: launches per step " +
          ", ".join(f"{n} {counts[n] // n_steps}" for n in fa.DENSE_KERNELS) +
          f"; losses finite, skipped 0; {tok_s:.1f} tokens/s, step p50 "
          f"{np.percentile(step_ms, 50):.3f} ms p99 {np.percentile(step_ms, 99):.3f} ms, "
          f"MFU {mfu:.4f} of 989 TFLOP/s ({card}), peak device memory "
          f"{peak / 1e9:.2f} GB; losses {[round(x, 4) for x in losses]}")

    fixed = itertools.repeat((tokens[:micro],))
    fit = [float(eng.train_batch(fixed)) for _ in range(fit_steps)]
    print(f"train fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over {fit_steps} steps")
    if not fit[0] - fit[-1] >= 0.5:
        raise AssertionError(f"fixed-batch loss fell only {fit[0] - fit[-1]}")
    by_name = profile_steps(lambda: eng.train_batch(), f"train {preset}", steps=2,
                            unit="training step")
    flash = {}
    for name, (t, c) in by_name.items():
        m = re.search(r"\b(fwd_sm90_kernel|fwd_kernel|dkdv_kernel|dq_kernel)\b", name)
        if m:
            t0, c0 = flash.get(m.group(1), (0.0, 0.0))
            flash[m.group(1)] = (t0 + t, c0 + c)
    print(f"profile train {preset}: flash kernels' device time per step: " + "; ".join(
        f"{k} {t:.1f} us ({c:.0f} launches)" for k, (t, c) in flash.items()))
    return counts


def sdpa_backward(qh, kh, vh, doh):
    """The library's flash-attention backward (``aten::_scaled_dot_product_
    flash_attention_backward``) on its own forward's saved output and
    lse: (call, (dq, dk, dv)), or (None, None) where this torch has none."""
    aten = torch.ops.aten
    try:
        out, lse, cq, ck, mq, mk, seed, offset, _ = \
            aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True)

        def call():
            return aten._scaled_dot_product_flash_attention_backward(
                doh, qh, kh, vh, out, lse, cq, ck, mq, mk, 0.0, True, seed, offset)
        return call, call()
    except (AttributeError, NotImplementedError, RuntimeError) as e:
        print(f"timing SDPA backward: no flash-attention backward op "
              f"({str(e).splitlines()[0][:200]})")
        return None, None


def flash_work(B, T, H, d):
    """(bytes, operations) of each dense flash kernel on a causal call:
    each input read once and each output written once, and the products
    the causal (q, k) pairs need."""
    pairs = B * H * T * (T + 1) // 2           # causal (q, k) pairs with q >= k
    elem, stat = B * T * H * d * 2, B * H * T * 4
    fwd = (4 * elem + stat, 4 * d * pairs)                             # QK, PV
    return {"flash_fwd": fwd, "flash_fwd_sm90": fwd,
            "flash_bwd_dkdv": (6 * elem + 2 * stat, 8 * d * pairs),   # QK, dOV, PdO, dSQ
            "flash_bwd_dq": (5 * elem + 2 * stat, 6 * d * pairs)}     # QK, dOV, dSK


def bound_ms(nbytes, ops, bytes_per_s):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_timing(dev, gen, bytes_per_s, card, B=8, T=1024, H=16, d=64,
                 sweep_t=(1024, 2048, 4096, 8192), sweep_tokens=8192):
    """Phase 6 at the training shape (q, k, v views of one qkv tensor):
    each flash kernel held against its plain version (the kernels' errors
    in the kernels line), then timed (three readings) beside its plain
    version, SDPA and the bound: ``flash_fwd_sm90`` and the template
    ``flash_fwd`` (the PR 2 design) beside SDPA forward, the backward
    kernels beside the flash-attention backward op.  Then
    ``flash_fwd_sm90`` against SDPA ``is_causal`` over ``sweep_t`` at
    B*T = ``sweep_tokens``, head dims 64 and 128."""
    q, k, v, do = flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    what = f"B={B} T={T} H={H} d={d} causal bf16 qkv views"
    res = check_flash_case(q, k, v, do, True, what)
    print(f"flash-check {what} (the training shape): {flash_line(res)}")
    max_err = {name: max(err for _, err, _ in rows) for name, rows in res.items()}
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(o, do)
    work = flash_work(B, T, H, d)
    kernel = {"flash_fwd_sm90": lambda: fa.flash_fwd_sm90(q, k, v, True),
              "flash_fwd": lambda: fa.flash_fwd_template(q, k, v, True),
              "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(q, k, v, do, lse, delta, True),
              "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)}
    plain_fwd = lambda: fa.flash_attention_reference_fwd(q, k, v, True)
    plain = {"flash_fwd_sm90": plain_fwd, "flash_fwd": plain_fwd,
             "flash_bwd_dkdv": lambda: fa.flash_attention_reference_bwd_dkdv(
                 q, k, v, do, lse, delta, True),
             "flash_bwd_dq": lambda: fa.flash_attention_reference_bwd_dq(
                 q, k, v, do, lse, delta, True)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    # the yardsticks must compute the same function: within 2% of the
    # largest plain value (other rounding points, another order)
    lib = {"o": (sdpa(qh, kh, vh, is_causal=True).transpose(1, 2), o)}
    bwd_call, lib_grads = sdpa_backward(qh, kh, vh, doh)
    if bwd_call is not None:
        dq, dk, dv = (g.transpose(1, 2) for g in lib_grads)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True)
        lib.update(dq=(dq, fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta,
                                                               True)),
                   dk=(dk, rdk), dv=(dv, rdv))
    for label, (got, ref) in lib.items():
        err = (got.float() - ref.float()).abs().max().item()
        if not err <= 2e-2 * ref.float().abs().max().item():
            raise AssertionError(f"SDPA yardstick {label} disagrees by {err}")
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    sdpa_r = repeat_ms(lambda _: sdpa(qh, kh, vh, is_causal=True), 50)
    sdpa_fb_ms = time_ms(lambda _: sdpa(*leaves, is_causal=True).backward(doh), 20)
    sdpa_b = repeat_ms(lambda _: bwd_call(), 50) if bwd_call is not None else None
    saved = dict(fa.launches)
    out = {}
    for name in ("flash_fwd_sm90", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        nbytes, ops = work[name]
        bound, by = bound_ms(nbytes, ops, bytes_per_s)
        r = repeat_ms(lambda _: kernel[name](), 50)
        plain_ms = time_ms(lambda _: plain[name](), 5)
        lib_r = sdpa_r if name.startswith("flash_fwd") else sdpa_b
        out[name] = {"max_abs_err": max_err[name], "ms": r[0], "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": None if lib_r is None else lib_r[0]}
        design = " (the PR 2 design)" if name == "flash_fwd" else ""
        lib_note = ("SDPA forward" if name.startswith("flash_fwd")
                    else "the flash-attention backward op (dq, dk, dv)")
        print(f"timing {name}{design} B={B} T={T} H={H} d={d} causal bf16 ({card}): "
              f"{spread(r)}; bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP); plain {plain_ms * 1e3:.2f} us; {lib_note} "
              f"{'not available' if lib_r is None else spread(lib_r)}")
    path_ms = sum(out[n]["ms"] for n in ("flash_fwd_sm90", "flash_bwd_dkdv", "flash_bwd_dq"))
    print(f"timing SDPA (B, H, T, d) causal bf16: forward+backward {sdpa_fb_ms * 1e3:.2f} us; "
          f"flash_fwd_sm90 + dkdv + dq {path_ms * 1e3:.2f} us")
    del q, k, v, do, qh, kh, vh, doh, leaves, lib, lib_grads
    for hd, t in itertools.product(fa.SM90_HEAD_DIMS[torch.bfloat16], sweep_t):
        b = sweep_tokens // t
        sq, sk, sv, _ = flash_inputs(dev, gen, torch.bfloat16, b, t, H, hd, "qkv")
        bound, by = bound_ms(*flash_work(b, t, H, hd)["flash_fwd_sm90"], bytes_per_s)
        r = repeat_ms(lambda _: fa.flash_fwd_sm90(sq, sk, sv, True), 20)
        sh, kh_, vh_ = (x.transpose(1, 2).contiguous() for x in (sq, sk, sv))
        lr = repeat_ms(lambda _: sdpa(sh, kh_, vh_, is_causal=True), 20)
        ops = flash_work(b, t, H, hd)["flash_fwd_sm90"][1]
        print(f"timing flash_fwd_sm90 sweep B={b} T={t} H={H} d={hd} causal bf16 ({card}): "
              f"{spread(r)}, {ops / r[0] / 1e9:.1f} TFLOP/s; SDPA is_causal {spread(lr)}; "
              f"ratio {r[0] / lr[0]:.3f}; bound {bound * 1e3:.2f} us ({by})")
        del sq, sk, sv, sh, kh_, vh_
    fa.launches.update(saved)          # timing launches are not path launches
    return out


# ------------------------------------------------- 7. sparse kernels vs plain
BIAS_KINDS = ("none", "add", "mul", "attn")


def sparse_configs(H):
    """Phase 7's layouts: (label, SparsityConfig)."""
    return [("fixed16", FixedSparsityConfig(
                num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
                different_layout_per_head=True, num_different_global_patterns=4)),
            ("fixed32", FixedSparsityConfig(num_heads=H, block=32, num_local_blocks=4,
                                            num_global_blocks=1)),
            ("bigbird64", BigBirdSparsityConfig(num_heads=H, block=64, num_random_blocks=1,
                                                num_sliding_window_blocks=3)),
            ("longformer128", BSLongformerSparsityConfig(
                num_heads=H, block=128, num_sliding_window_blocks=3,
                global_block_indices=[0]))]


class EmptyRowsLayout:
    """Block 16, the diagonal blocks only, with the first 64 queries and
    keys in no live block: LUT rows and columns with no live tile."""

    def make_layout(self, T):
        layout = np.zeros((1, T // 16, T // 16), np.int32)
        live = np.arange(4, T // 16)
        layout[0, live, live] = 1
        return layout


def key_lengths(gen, B, T, dev):
    """Per-row live lengths uniform in [T/2, T]."""
    return torch.randint(T // 2, T + 1, (B,), generator=gen, device=dev)


def bias_inputs(kind, gen, B, T, dev):
    """``(key_padding_bias (B, T), attn_bias (T, T))`` of one kind, fp32:
    ``add``, BERT's -10000 past each row's length; ``mul``, 0 / NEG_INF
    with batch row 1 fully padded; ``attn``, a (T, T) score bias (N(0,
    0.5), a tenth NEG_INF off the diagonal)."""
    pos = torch.arange(T, device=dev)
    if kind in ("add", "mul"):
        keep = pos[None, :] < key_lengths(gen, B, T, dev)[:, None]
        if kind == "mul":
            keep[1 % B] = False
            return torch.where(keep, 0.0, fa.NEG_INF).float(), None
        return torch.where(keep, 0.0, -10000.0).float(), None
    if kind == "attn":
        noise = torch.randn((T, T), generator=gen, device=dev) * 0.5
        drop = (torch.rand((T, T), generator=gen, device=dev) < 0.1) & (
            pos[:, None] != pos[None, :])
        return None, torch.where(drop, torch.full_like(noise, fa.NEG_INF), noise)
    return None, None


def masked_calls(q, k, v, do, lut, kb, ab, causal):
    """The biased (``lut`` None) or LUT kernels of one case: ``(names,
    kernel calls, plain calls)``, the backward calls taking (lse, delta).
    An unbiased LUT case takes the ring forward, as the model path does."""
    if lut is None:
        names = fa.BIASED_KERNELS
        calls = (lambda: fa.flash_fwd_biased(q, k, v, kb, ab, causal),
                 lambda lse, de: fa.flash_bwd_dkdv_biased(q, k, v, do, lse, de, kb, ab,
                                                          causal),
                 lambda lse, de: fa.flash_bwd_dq_biased(q, k, v, do, lse, de, kb, ab, causal))
    else:
        ring = kb is None and ab is None
        names = ("flash_fwd_lut_ring" if ring else "flash_fwd_lut", "flash_bwd_dkdv_lut",
                 "flash_bwd_dq_lut")
        calls = ((lambda: fa.flash_fwd_lut_ring(q, k, v, lut)) if ring
                 else (lambda: fa.flash_fwd_lut(q, k, v, lut, kb, ab)),
                 lambda lse, de: fa.flash_bwd_dkdv_lut(q, k, v, do, lse, de, lut, kb, ab),
                 lambda lse, de: fa.flash_bwd_dq_lut(q, k, v, do, lse, de, lut, kb, ab))
    kw = dict(lut=lut, key_padding_bias=kb, attn_bias=ab)
    plains = (lambda: fa.flash_attention_reference_fwd(q, k, v, causal, **kw),
              lambda lse, de: fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, de,
                                                                    causal, **kw),
              lambda lse, de: fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, de,
                                                                  causal, **kw))
    return names, calls, plains


def check_masked_case(q, k, v, do, lut, kb, ab, causal, what):
    """Each kernel of a biased / LUT case against its plain version on the
    same inputs (the backward ones fed the kernel's own O and lse).
    Returns {kernel: [(output, max abs error, share of limit)]}."""
    names, calls, plains = masked_calls(q, k, v, do, lut, kb, ab, causal)
    o, lse = calls[0]()
    delta = fa.attention_delta(o, do)
    dk, dv = calls[1](lse, delta)
    dq = calls[2](lse, delta)
    ro, rlse = plains[0]()
    rdk, rdv = plains[1](lse, delta)
    rdq = plains[2](lse, delta)
    torch.cuda.synchronize()
    pairs = {names[0]: [("o", o, ro), ("lse", lse, rlse)],
             names[1]: [("dk", dk, rdk), ("dv", dv, rdv)],
             names[2]: [("dq", dq, rdq)]}
    return {name: [(label, *flash_close(f"{name} {what}", label, got, ref))
                   for label, got, ref in ps] for name, ps in pairs.items()}


def sparse_cases(H):
    """Phase 7's cases: (T, layout label, config or None, dtype, causal,
    bias kind, head dim, q/k/v layout)."""
    dims, views = (64, 96, 128), ("qkv", "dense")
    bf16, fp32 = torch.bfloat16, torch.float32
    cases, i = [], 0
    for T in (256, 1024):
        for label, cfg in sparse_configs(H):
            for dt, causal in itertools.product((bf16, fp32), (False, True)):
                cases.append((T, label, cfg, dt, causal, BIAS_KINDS[i % 4],
                              dims[(i // 4) % 3], views[(i // 2) % 2]))
                i += 1
    fixed16 = sparse_configs(H)[0][1]
    for kind, dt in itertools.product(BIAS_KINDS, (bf16, fp32)):    # ragged T at block 16
        cases.append((1008, "fixed16", fixed16, dt, False, kind, 64, "qkv"))
    for d, dt in itertools.product(dims, (bf16, fp32)):   # the ring at every head dim
        cases.append((1024, "fixed16", fixed16, dt, False, "none", d, "qkv"))
    # not "add": a row whose every live key carries -10000 has scores of
    # magnitude 1e4, resolved to ~1e-3 in fp32 on both sides (phase-7 reading)
    for kind, dt in itertools.product(("none", "mul"), (bf16, fp32)):
        cases.append((256, "empty-rows", EmptyRowsLayout(), dt, False, kind, 64, "qkv"))
    for kind, dt, causal in itertools.product(BIAS_KINDS[1:], (bf16, fp32), (False, True)):
        cases.append((1000, "dense", None, dt, causal, kind, 64, "qkv"))
    return cases


def check_sparse_kernels(dev, gen, B=2, H=4):
    """Phase 7: every biased and LUT kernel against its plain version.
    Returns the max abs error per kernel."""
    max_err = {name: 0.0 for name in fa.BIASED_KERNELS + fa.LUT_KERNELS}
    for T, label, cfg, dt, causal, kind, d, view in sparse_cases(H):
        lut = None if cfg is None else fa.layout_luts(cfg.make_layout(T), T, H, causal)
        kb, ab = bias_inputs(kind, gen, B, T, dev)
        what = (f"{str(dt)[6:]} d={d} T={T} {label} bias={kind} causal={int(causal)} "
                f"{view}")
        res = check_masked_case(*flash_inputs(dev, gen, dt, B, T, H, d, view), lut, kb, ab,
                                causal, what)
        for name, rows in res.items():
            max_err[name] = max([max_err[name]] + [err for _, err, _ in rows])
        print(f"sparse-check {what}: {flash_line(res)}")
    return max_err


# ------------------------------------------------------ 8. BERT training
SPARSE_SECTION = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
                  "num_local_blocks": 4, "num_global_blocks": 1,
                  "attention": "bidirectional"}   # docs/tutorials/bert-pretraining.md:31-38
BERT_CONFIG = {
    "train_micro_batch_size_per_gpu": 8,
    "gradient_accumulation_steps": 1,
    "steps_per_print": 10 ** 9,
    "bf16": {"enabled": True},
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4}},
    "zero_optimization": {"stage": 1},
    "sparse_attention": SPARSE_SECTION,
}
# step 1 of BERT-large, kernels vs the plain _masked_dense attention, bf16: the
# plain path rounds the scores to bf16 before the fp32 softmax (as JAX's
# einsum in the input dtype does), the kernels keep them in fp32.  Readings
# (H100): loss gap 2.3e-5 near 10.5, grad-norm gap 2.1e-4 relative; the
# limits are about 40x and 10x those
BERT_STEP1_LOSS_TOL = 1e-3        # absolute
BERT_STEP1_GNORM_TOL = 2e-3       # relative
BERT_FIT_MARGIN = 0.5             # fixed-batch loss fall over 20 steps


class PlainSparseAttention(SparseSelfAttention):
    """``SparseSelfAttention`` on the plain path: ``_masked_dense`` (the
    layout expanded to an element mask, dense softmax) in place of the
    kernels."""

    def __call__(self, query, key, value, *, causal=None, sm_scale=None,
                 key_padding_mask=None, attn_mask=None):
        return self._masked_dense(query, key, value, self.get_layout(query.shape[1]),
                                  self._causal(causal), sm_scale, key_padding_mask,
                                  attn_mask)


def bert_data(seed, n, T, vocab, padded=True):
    """MLM samples from a numpy seed: ``input_ids`` uniform over the
    vocab; per-row lengths uniform in [T/2, T] with ``attention_mask`` 0
    past them (``padded``); ``labels`` the token at 15% of live
    positions, -100 elsewhere; ``token_type_ids`` zero."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (n, T)).astype(np.int64)
    lengths = rng.integers(T // 2, T + 1, n) if padded else np.full(n, T)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int64)
    labels = np.where((rng.random((n, T)) < 0.15) & (mask > 0), ids, -100)
    data = {"input_ids": ids, "labels": labels, "token_type_ids": np.zeros_like(ids)}
    if padded:
        data["attention_mask"] = mask
    return data


def bert_engine(dev, base, data, section=SPARSE_SECTION, plain=False, preset="bert-large",
                seq=2048, micro=8):
    """``build(preset)`` -> ``extend_position_embedding`` (to ``seq``) ->
    ``initialize`` -> ``replace_model_self_attention`` with the layout of
    the engine config's ``sparse_attention`` section (``plain``: the
    ``_masked_dense`` attention instead)."""
    model = build(preset, dtype=torch.bfloat16, device=dev)
    params, model = extend_position_embedding(base, model, seq)
    config = dict(BERT_CONFIG, train_micro_batch_size_per_gpu=micro,
                  sparse_attention=section)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(config=config, model=model,
                                                     params=params, training_data=data)
    cfg = build_sparsity_config(engine.config.sparse_attention, model.config.n_head)
    replace_model_self_attention(model, cfg, max_seq_length=seq)
    if plain:
        model.sparse_self_attention = PlainSparseAttention(cfg, max_seq_length=seq)
    return engine


def check_launches(tag, counts, want, steps):
    """Exact launch counts of a run: ``want`` per step for the kernels it
    names, 0 for every other flash kernel."""
    for name in fa.KERNELS:
        expect = want.get(name, 0) * steps
        if counts[name] != expect:
            raise AssertionError(f"{tag}: {name} launched {counts[name]} times in {steps} "
                                 f"steps, expected {expect}")


def bert_train(dev, card, warmup=3, timed=10, fit_steps=20, preset="bert-large", seq=2048,
               micro=8):
    """Phase 8 (and 8b, 8c): BERT MLM training through initialize ->
    train_batch.  Returns the launches of each phase's run."""
    vocab = build(preset, device=dev).config.vocab_size
    base = build(preset, device=dev).init(0)          # the 512-row position table
    data = bert_data(0, 64, seq, vocab)
    eng = bert_engine(dev, base, data, plain=True, preset=preset, seq=seq, micro=micro)
    plain = (float(eng.train_batch()), eng.get_global_grad_norm())
    del eng
    torch.cuda.empty_cache()

    eng = bert_engine(dev, base, data, preset=preset, seq=seq, micro=micro)
    model = eng.module
    L = model.config.n_layer
    per_step = {"flash_fwd_lut": 2 * L, "flash_bwd_dkdv_lut": L, "flash_bwd_dq_lut": L}
    lut = fa.layout_luts(model.sparse_self_attention.get_layout(seq), seq,
                         model.config.n_head, False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    losses, times = [], []
    for i in range(warmup + timed):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch()))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            step1 = (losses[0], eng.get_global_grad_norm())
            check_launches(f"train {preset} step 1", dict(fa.launches), per_step, 1)
    counts = {"8": dict(fa.launches)}
    peak = torch.cuda.max_memory_allocated()
    gaps = (abs(step1[0] - plain[0]), abs(step1[1] - plain[1]) / abs(plain[1]))
    print(f"train {preset} step 1: loss kernels {step1[0]:.6f} plain {plain[0]:.6f}; grad "
          f"norm kernels {step1[1]:.6f} plain {plain[1]:.6f} (gaps {gaps[0]:.3e} abs, "
          f"{gaps[1]:.3e} rel; tol {BERT_STEP1_LOSS_TOL:g} abs, {BERT_STEP1_GNORM_TOL:g} rel)")
    if not (gaps[0] <= BERT_STEP1_LOSS_TOL and gaps[1] <= BERT_STEP1_GNORM_TOL):
        raise AssertionError(f"step 1 kernels {step1} vs plain {plain}")
    n_steps = warmup + timed
    check_launches(f"train {preset}", counts["8"], per_step, n_steps)
    if not all(math.isfinite(x) for x in losses) or eng.skipped_steps != 0:
        raise AssertionError(f"losses {losses}, skipped {eng.skipped_steps}")
    step_ms = np.asarray(times[warmup:]) * 1e3
    tok_s = timed * eng.train_batch_size() * seq / (step_ms.sum() / 1e3)
    mfu = tok_s * model.flops_per_token() / PEAK_OPS["bf16"]
    print(f"train {preset} T={seq} micro {micro} bf16 zero1 remat sparse16: launches per "
          f"step " + ", ".join(f"{n} {counts['8'][n] // n_steps}" for n in per_step) +
          f"; losses finite, skipped 0; {tok_s:.1f} tokens/s (padded positions "
          f"counted), step p50 {np.percentile(step_ms, 50):.3f} ms p99 "
          f"{np.percentile(step_ms, 99):.3f} ms, MFU {mfu:.4f} of 989 TFLOP/s by "
          f"flops_per_token (dense attention FLOPs at T={seq}) ({card}), peak device "
          f"memory {peak / 1e9:.2f} GB; tile density {lut.tile_density:.3f}, element "
          f"density {lut.element_density:.4f}; losses {[round(x, 4) for x in losses]}")

    first = {key: val[:micro] for key, val in data.items()}
    fixed = itertools.repeat(first)
    fit = [float(eng.train_batch(fixed)) for _ in range(fit_steps)]
    print(f"train {preset} fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over "
          f"{fit_steps} steps (margin {BERT_FIT_MARGIN})")
    if not fit[0] - fit[-1] >= BERT_FIT_MARGIN:
        raise AssertionError(f"fixed-batch loss fell only {fit[0] - fit[-1]}")
    profile_steps(lambda: eng.train_batch(), f"train {preset} sparse16", steps=1,
                  unit="training step")
    del eng
    torch.cuda.empty_cache()

    # 8b: unpadded batches (packed sequences): the ring forward, no bias
    # 8c: "mode": "dense" (an all-ones layout) with padding: the dense biased kernels
    for tag, section, padded, want in (
            ("8b", SPARSE_SECTION, False, {"flash_fwd_lut_ring": 2 * L,
                                           "flash_bwd_dkdv_lut": L, "flash_bwd_dq_lut": L}),
            ("8c", {"mode": "dense", "block": 16}, True, {
                "flash_fwd_biased": 2 * L, "flash_bwd_dkdv_biased": L,
                "flash_bwd_dq_biased": L})):
        eng = bert_engine(dev, base, bert_data(1, 16, seq, vocab, padded), section=section,
                          preset=preset, seq=seq, micro=micro)
        torch.cuda.synchronize()
        fa.reset_launches()
        run = [float(eng.train_batch()) for _ in range(2)]
        counts[tag] = dict(fa.launches)
        check_launches(f"train {preset} {tag}", counts[tag], want, 2)
        if not all(math.isfinite(x) for x in run) or eng.skipped_steps != 0:
            raise AssertionError(f"{tag}: losses {run}, skipped {eng.skipped_steps}")
        print(f"train {preset} {tag} ({'padded' if padded else 'unpadded'}, mode "
              f"{section['mode']}): 2 steps, losses {[round(x, 4) for x in run]}, launches "
              f"per step " + ", ".join(f"{n} {counts[tag][n] // 2}" for n in want))
        del eng
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------- 9. sparse kernels at the shape
def sparse_timing(dev, gen, bytes_per_s, B=8, T=2048, H=16, d=64):
    """Phase 9 at the training shape (q, k, v views of one qkv tensor):
    the biased / LUT kernels of four cases, each held against its plain
    version, then timed beside its bound, its plain version and SDPA with
    the expanded boolean layout-and-padding mask.  Returns {case:
    {kernel: kernels-line fields}} and the cases' densities."""
    q, k, v, do = flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    keep = torch.arange(T, device=dev)[None, :] < key_lengths(gen, B, T, dev)[:, None]
    kb = torch.where(keep, 0.0, -10000.0).float()
    tutorial = build_sparsity_config(SPARSE_SECTION, H)
    fixed64 = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1, attention="bidirectional")
    lut16 = fa.layout_luts(tutorial.make_layout(T), T, H, False)
    lut64 = fa.layout_luts(fixed64.make_layout(T), T, H, False)
    cases = {"tutorial16+pad": (lut16, kb), "tutorial16": (lut16, None),
             "fixed64": (lut64, None), "dense+pad": (None, kb)}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    elem, stat = B * T * H * d * 2, B * H * T * 4
    saved = dict(fa.launches)
    out, density = {}, {}
    for case, (lut, bias) in cases.items():
        what = f"B={B} T={T} H={H} d={d} bf16 qkv views {case}"
        res = check_masked_case(q, k, v, do, lut, bias, None, False, what)
        print(f"sparse-check {what} (the training shape): {flash_line(res)}")
        names, calls, plains = masked_calls(q, k, v, do, lut, bias, None, False)
        o, lse = calls[0]()
        delta = fa.attention_delta(o, do)
        layout_mask = (torch.ones((1, T, T), dtype=torch.bool, device=dev) if lut is None
                       else lut.element_mask(dev))
        pairs = B * int(layout_mask.sum().item()) * (H // layout_mask.shape[0])
        density[case] = {"tile": 1.0 if lut is None else lut.tile_density,
                         "element": pairs / (B * H * T * T)}
        mask = layout_mask[None] & keep[:, None, None, :] if bias is not None else \
            layout_mask[None]
        mask = mask.expand(B, H, T, T)
        lib = sdpa(qh, kh, vh, attn_mask=mask).transpose(1, 2)
        err = (lib.float() - o.float()).abs().max().item()
        if not err <= 2e-2 * o.float().abs().max().item():
            raise AssertionError(f"SDPA yardstick {case} disagrees by {err}")
        leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
        lib_f = time_ms(lambda _: sdpa(qh, kh, vh, attn_mask=mask), 10, warmup=2)
        lib_fb = time_ms(lambda _: sdpa(*leaves, attn_mask=mask).backward(doh), 5, warmup=2)
        kbytes = 0 if bias is None else B * T * 4
        work = {names[0]: (4 * elem + stat + kbytes, 4 * d * pairs),
                names[1]: (6 * elem + 2 * stat + kbytes, 8 * d * pairs),
                names[2]: (5 * elem + 2 * stat + kbytes, 6 * d * pairs)}
        kernel = {names[0]: calls[0], names[1]: lambda: calls[1](lse, delta),
                  names[2]: lambda: calls[2](lse, delta)}
        plain = {names[0]: plains[0], names[1]: lambda: plains[1](lse, delta),
                 names[2]: lambda: plains[2](lse, delta)}
        out[case] = {}
        for name in names:
            nbytes, ops = work[name]
            t_bytes, t_ops = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
            bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ms = time_ms(lambda _: kernel[name](), 20, warmup=3)
            plain_ms = time_ms(lambda _: plain[name](), 2, warmup=1)
            out[case][name] = {
                "max_abs_err": max(e for _, e, _ in res[name]), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib_f if name == names[0] else lib_fb}
            print(f"timing {name} {what}: {ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
                  f"({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP), plain "
                  f"{plain_ms * 1e3:.2f} us; tile density {density[case]['tile']:.3f}, "
                  f"element density {density[case]['element']:.4f}")
        total = sum(out[case][n]["ms"] for n in names)
        print(f"timing SDPA {case} (B, H, T, d) bf16 with the boolean layout-and-padding "
              f"mask: forward {lib_f * 1e3:.2f} us, forward+backward {lib_fb * 1e3:.2f} us; "
              f"the port's {' + '.join(names)} {total * 1e3:.2f} us")
        del mask, lib, leaves
        torch.cuda.empty_cache()
    fa.launches.update(saved)          # timing launches are not path launches
    return out, density


# ------------------------------------------------- 10. int8 kernels vs plain
# int8_mm_nt / int8_mm_t vs int8_matmul_reference, element by element.  Both
# sum exact bf16 x int8 products in fp32, in another order (the kernel's
# split-K adds its partials in a fixed order): fp32 outputs within
# d = INT8_FP32_TOL * max|plain| + 1e-6; bf16 outputs within one bf16 ulp of
# the plain value plus d (both round an fp32 sum that may differ by d, and
# near zero, where cancellation leaves small values, d exceeds their ulp: a
# first chip run of the kernel read up to 624 ulps of such elements at M=512
# under a bare one-ulp limit, every large element within one).
INT8_FP32_TOL = 1e-5
INT8_M = (1, 8, 16, 17, 64, 512)
INT8_SHAPES = {name: {"qkv_w": (D, 3 * D), "proj_w": (D, D), "fc_w": (D, 4 * D),
                      "fc_proj_w": (4 * D, D), "wte": (50257, D)}
               for name, D in (("125m", 768), ("1.3b", 2048))}


def int8_error(got, ref):
    """(max abs error, largest share of its limit) of one int8 output."""
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise AssertionError(f"bad output {tuple(got.shape)} {got.dtype}")
    ref = ref.float()
    err = (got.float() - ref).abs()
    limit = INT8_FP32_TOL * ref.abs().max() + 1e-6
    if got.dtype == torch.bfloat16:
        limit = limit + torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return err.max().item(), (err / limit).max().item()


def check_int8_kernels(dev, gen):
    """Phase 10: both entries against the plain version over the 125M and
    1.3B weight shapes (the head transposed, N = 50257), M in INT8_M,
    per-tensor scales (and per-channel for the head), bf16 and fp32
    outputs; each output within its limit and bit-identical on a second
    call.  Returns the max abs error per kernel."""
    max_err = {name: 0.0 for name in im.KERNELS.values()}
    saved = dict(im.launches)
    for preset, shapes in INT8_SHAPES.items():
        for wname, (rows, cols) in shapes.items():
            t = wname == "wte"
            q = torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                              dtype=torch.int8)
            K, N = (cols, rows) if t else (rows, cols)
            name = im.KERNELS["t" if t else "nt"]
            for M in INT8_M:
                x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                for kind in (("tensor", "channel") if t else ("tensor",)):
                    scale = (torch.rand((N if kind == "channel" else 1,), generator=gen,
                                        device=dev) + 0.5) * 1e-2
                    res = []
                    for od in (torch.bfloat16, torch.float32):
                        got = im.int8_matmul(x, q, scale, w_transposed=t, out_dtype=od)
                        again = im.int8_matmul(x, q, scale, w_transposed=t, out_dtype=od)
                        ref = im.int8_matmul_reference(x, q, scale, w_transposed=t,
                                                       out_dtype=od)
                        torch.cuda.synchronize()
                        if not torch.equal(got, again):
                            raise AssertionError(f"{name} {preset} {wname} M={M}: two calls "
                                                 "differ")
                        err, share = int8_error(got, ref)
                        if not share <= 1.0:
                            raise AssertionError(f"{name} {preset} {wname} M={M} {kind} "
                                                 f"{od}: error {err:.3e} is {share:.2f}x "
                                                 "its limit")
                        max_err[name] = max(max_err[name], err)
                        res.append(f"{str(od)[6:]} {err:.2e} ({share:.2f})")
                    tile, splits, per = im.plan(M, N, K, torch.cuda.get_device_properties(
                        dev).multi_processor_count)
                    print(f"int8-check {name} {preset} {wname} K={K} N={N} M={M} "
                          f"scale={kind} tile {tile} splits {splits}: {', '.join(res)}; "
                          f"deterministic")
    im.launches.update(saved)          # checking launches are not path launches
    return max_err


# ------------------------------------------------- 11. int8 serving at 1.3B
# one decode step, int8 weights vs the same int8 values dequantized to bf16:
# the oracle rounds every dequantized weight to bf16 (2^-9 relative) where the
# kernel scales the exact fp32 sum, and both round activations to bf16 through
# 24 layers.  This phase read 6.9e-2 at max|logit| 4.15 on an H100 80GB HBM3
# at 700 W; the limit is about 4x that.
INT8_LOGIT_TOL = 0.25
INT8_AGREE_MIN = 0.9          # teacher-forced greedy agreement with the oracle
INT8_BYTES_MAX = 0.55         # int8 tree bytes over the bf16 tree's


def draw_gpt2_params(model, dev, seed):
    """fp32 parameters on the card with ``init_numpy``'s distributions
    (normal(0.02), the output projections' std over sqrt(2L), wpe std
    0.01, LayerNorms ones/zeros, biases zero) from a seeded generator."""
    c = model.config
    D, L, V, T = c.n_embd, c.n_layer, c.vocab_size, c.max_seq
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(shape, std):
        return torch.randn(shape, generator=g, device=dev) * std

    proj = 0.02 / math.sqrt(2.0 * L)
    ones, zeros = (lambda *s: torch.ones(s, device=dev)), (lambda *s: torch.zeros(s, device=dev))
    return {"wte": n((V, D), 0.02), "wpe": n((T, D), 0.01),
            "blocks": {"ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
                       "qkv_w": n((L, D, 3 * D), 0.02), "qkv_b": zeros(L, 3 * D),
                       "proj_w": n((L, D, D), proj), "proj_b": zeros(L, D),
                       "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
                       "fc_w": n((L, D, 4 * D), 0.02), "fc_b": zeros(L, 4 * D),
                       "fc_proj_w": n((L, 4 * D, D), proj), "fc_proj_b": zeros(L, D)},
            "lnf_scale": ones(D), "lnf_bias": zeros(D)}


def tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def teacher_forced(model, params, prompts, streams):
    """Share of the streams' tokens that ``model``'s greedy choice picks on
    each stream's own context (prompt + the stream's earlier tokens)."""
    hit = total = 0
    with torch.no_grad():
        for p, s in zip(prompts, streams):
            seq = torch.as_tensor(np.concatenate([p, s[:-1]]), device=model.device)[None]
            logits, _ = model.apply_with_cache(params, seq, model.init_cache(1, seq.shape[1]))
            pick = logits[0, len(p) - 1:].argmax(-1).cpu().numpy()
            hit += int((pick == np.asarray(s)).sum())
            total += len(s)
    return hit / total


def int8_serving(dev, card, prompts, preset="gpt2-1.3b", new=32):
    """Phase 11: GPT-2 1.3B at published widths with int8 weights through
    ``init_inference(dtype=torch.int8)`` -> ``ServingEngine(engine=...)``,
    phase 3's traffic; the oracle serves the same int8 values dequantized
    to bf16.  Returns the int8 kernels' launches of the run."""
    t0 = time.perf_counter()
    model = GPT2(preset=preset, dtype=torch.bfloat16, device=dev)
    c = model.config
    params = draw_gpt2_params(model, dev, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(model, params=params, dtype=torch.int8)
    del params
    torch.cuda.synchronize()
    print(f"int8 {preset}: weights drawn on the card in {t1 - t0:.2f} s, quantized in "
          f"{time.perf_counter() - t1:.2f} s")
    # the int8 run first, with no other model on the card
    srv, _, toks_q = serve(engine, prompts, new, f"{preset} int8w kv16", 16, "auto")
    launches = dict(srv.int8_launches)
    del srv
    torch.cuda.empty_cache()
    oracle = InferenceEngine(GPT2(preset=preset, dtype=torch.bfloat16, device=dev),
                             params=dequantize_tree(engine.params, torch.bfloat16))
    int8_bytes, bf16_bytes = tree_bytes(engine.params), tree_bytes(oracle.params)
    print(f"int8 {preset}: parameter bytes int8 tree {int8_bytes / 1e9:.3f} GB, bf16 oracle "
          f"{bf16_bytes / 1e9:.3f} GB ({int8_bytes / bf16_bytes:.3f}, limit {INT8_BYTES_MAX})")
    if not (engine.quantized and engine.dtype is None
            and int8_bytes <= INT8_BYTES_MAX * bf16_bytes):
        raise AssertionError(f"int8 tree {int8_bytes} vs bf16 {bf16_bytes}")
    # the oracle's run holds the int8 engine's tree too (resident before its run)
    _, _, toks_o = serve(oracle, prompts, new, f"{preset} bf16-oracle kv16", 16, "auto")
    uids = sorted(toks_q)
    agree = teacher_forced(oracle.module, oracle.params, [prompts[u] for u in uids],
                           [toks_q[u] for u in uids])
    same = sum(toks_q[u] == toks_o[u] for u in uids)
    free = np.mean([np.mean(np.asarray(toks_q[u]) == np.asarray(toks_o[u])) for u in uids])
    print(f"int8 vs bf16 oracle: the oracle's greedy choice on the int8 streams' contexts "
          f"agrees on {agree:.4f} of the tokens (bound {INT8_AGREE_MIN}); free-running "
          f"streams agree on {free:.4f} of the positions, {same}/{len(uids)} identical")
    if not agree >= INT8_AGREE_MIN:
        raise AssertionError(f"teacher-forced agreement {agree}")

    # one decode step on the same seated state, int8 vs oracle
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=16, max_new_tokens=new)
    srv_q, srv_o = ServingEngine(engine=engine, config=cfg), ServingEngine(engine=oracle,
                                                                           config=cfg)
    toks, tables, lengths = seat(srv_q, prompts[::2])
    seat(srv_o, prompts[::2])
    with torch.no_grad():
        lq, _ = srv_q.model.decode_step_paged(engine.params, toks, srv_q.pool, tables, lengths)
        lo, _ = srv_o.model.decode_step_paged(oracle.params, toks, srv_o.pool, tables, lengths)
    err = (lq - lo).abs().max().item()
    print(f"decode-step logits {preset} int8 vs bf16 oracle: max_abs_err {err:.3e} (tol "
          f"{INT8_LOGIT_TOL}), max|logit| {lo.abs().max().item():.2f}, argmax agree "
          f"{(lq.argmax(-1) == lo.argmax(-1)).sum().item()}/{toks.shape[0]}")
    if not (torch.isfinite(lq).all() and lq.shape == (8, c.vocab_size) and err <= INT8_LOGIT_TOL):
        raise AssertionError(f"int8 decode logits differ from the oracle by {err}")
    del srv_q, srv_o

    # InferenceEngine.generate at int8 against the serving streams
    rng = np.random.default_rng(1)
    gp = [rng.integers(0, c.vocab_size, (64,)) for _ in range(4)]
    im.reset_launches()
    gen_out = engine.generate(np.stack(gp), max_new_tokens=16).cpu().numpy()[:, 64:]
    gen_launches = dict(im.launches)
    if gen_launches != {"int8_mm_nt": 16 * 4 * c.n_layer, "int8_mm_t": 16}:
        raise AssertionError(f"generate launches {gen_launches}")
    sres = ServingEngine(engine=engine, config=cfg).run(
        [Request(tokens=p, uid=i, max_new_tokens=16) for i, p in enumerate(gp)])
    streams = [sres[i]["tokens"] for i in range(4)]
    g_agree = teacher_forced(engine.module._model, engine.params, gp, streams)
    g_same = sum(list(gen_out[i]) == streams[i] for i in range(4))
    print(f"generate B=4 T=64 +16 (launches {gen_launches}) vs serving the same prompts: "
          f"generate's model chooses the serving streams' tokens on {g_agree:.4f} of their "
          f"contexts (bound {INT8_AGREE_MIN}); {g_same}/4 streams identical (the contiguous "
          f"cache's plain attention and the paged kernel round bf16 at other places)")
    if not g_agree >= INT8_AGREE_MIN:
        raise AssertionError(f"generate vs serving agreement {g_agree}")

    prof = ServingEngine(engine=engine, config=cfg)
    for i, p in enumerate(prompts[:8]):
        prof.submit(Request(tokens=p, uid=i))
    profile_steps(prof.step, f"{preset} int8w")
    prof_o = ServingEngine(engine=oracle, config=cfg)
    for i, p in enumerate(prompts[:8]):
        prof_o.submit(Request(tokens=p, uid=i))
    profile_steps(prof_o.step, f"{preset} bf16 oracle")
    return launches


# ------------------------------------------------------ 12. int8 timing
def int8_timing(dev, gen, bytes_per_s):
    """Phase 12 at GPT-2 1.3B's weights, decode (M = 8) and prefill
    (M = 512): each entry held against its plain version, then timed with
    CUDA events (12 weights cycled, 12x the 50 MB L2 at qkv) beside its
    bound, its plain version and two yardsticks the port never calls:
    ``torch.matmul`` over the pre-dequantized bf16 weight (the dequantize
    untimed; it reads twice the weight bytes) and, for the head with
    per-channel scales, ``torch._weight_int8pack_mm``.  Returns the
    kernels-line fields at the decode shape (int8_mm_nt: qkv_w)."""
    saved = dict(im.launches)
    out = {}
    for wname, (rows, cols) in INT8_SHAPES["1.3b"].items():
        t = wname == "wte"
        K, N = (cols, rows) if t else (rows, cols)
        name = im.KERNELS["t" if t else "nt"]
        od = torch.float32 if t else torch.bfloat16
        qs = [torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(L_CYCLE if not t else 2)]
        scale = (torch.rand((N if t else 1,), generator=gen, device=dev) + 0.5) * 1e-2
        deq = [(q.float() * (scale[:, None] if t else scale)).to(torch.bfloat16) for q in qs]
        for M in (8, 512):
            x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            n = len(qs)
            got = im.int8_matmul(x, qs[0], scale, w_transposed=t, out_dtype=od)
            ref = im.int8_matmul_reference(x, qs[0], scale, w_transposed=t, out_dtype=od)
            err, share = int8_error(got, ref)
            if not share <= 1.0:
                raise AssertionError(f"{name} {wname} M={M}: {err} is {share:.2f}x its limit")
            lib = torch.matmul(x, deq[0].t() if t else deq[0])
            lib_err = (lib.float() - ref.float()).abs().max().item()
            if not lib_err <= 2e-2 * ref.float().abs().max().item():
                raise AssertionError(f"cuBLAS yardstick {wname} M={M} disagrees by {lib_err}")
            nbytes = M * K * 2 + K * N + M * N * got.element_size() + scale.numel() * 4
            ops = 2 * M * N * K
            t_b, t_o = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
            bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
            reps = 200 if M == 8 else 50
            ms = time_ms(lambda l: im.int8_matmul(x, qs[l % n], scale, w_transposed=t,
                                                  out_dtype=od), reps)
            plain_ms = time_ms(lambda l: im.int8_matmul_reference(
                x, qs[l % n], scale, w_transposed=t, out_dtype=od), 10, warmup=2)
            lib_ms = time_ms(lambda l: torch.matmul(x, deq[l % n].t() if t else deq[l % n]),
                             reps)
            pack_ms, pack_note = None, "not timed (block weight: (K, N) layout)"
            if t:
                try:
                    sc16 = scale.to(torch.bfloat16)
                    pk_out = torch._weight_int8pack_mm(x, qs[0], sc16)
                    pk_err = (pk_out.float() - ref.float()).abs().max().item()
                    pack_ms = time_ms(lambda l: torch._weight_int8pack_mm(x, qs[l % n], sc16),
                                      20 if M == 8 else 3, warmup=2)
                    pack_note = (f"{pack_ms * 1e3:.2f} us (bf16 scales, bf16 out; max abs "
                                 f"diff {pk_err:.2e})")
                except (RuntimeError, AttributeError, NotImplementedError) as e:
                    pack_note = f"not available ({str(e).splitlines()[0][:120]})"
            tile, splits, per = im.plan(M, N, K, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            print(f"timing {name} 1.3b {wname} M={M} K={K} N={N} out={str(od)[6:]} (tile "
                  f"{tile}, {splits} splits of {per} k tiles): {ms * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e9:.2f} "
                  f"GFLOP), plain {plain_ms * 1e3:.2f} us, cuBLAS bf16 over the dequantized "
                  f"weight {lib_ms * 1e3:.2f} us; _weight_int8pack_mm: {pack_note}")
            if M == 8 and wname in ("qkv_w", "wte"):
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                             "int8pack_ms": pack_ms}
        del qs, deq
        torch.cuda.empty_cache()
    im.launches.update(saved)          # timing launches are not path launches
    return out


# ------------------------------ 13. banded and merged-row kernels vs plain
class AlternateEmptyRowsLayout:
    """Block 16, the diagonal blocks of the odd 64-row q tiles only: every
    merged row's upper half has no live tile while its lower half has."""

    def make_layout(self, T):
        layout = np.zeros((1, T // 16, T // 16), np.int32)
        live = np.arange(T // 16)
        live = live[(live // 4) % 2 == 1]
        layout[0, live, live] = 1
        return layout


def longformer(H, block, window, globals_, causal=True):
    return BSLongformerSparsityConfig(
        num_heads=H, block=block, num_sliding_window_blocks=window,
        global_block_indices=globals_,
        attention="unidirectional" if causal else "bidirectional")


BAND_MERGE = ("flash_fwd_banded", "flash_fwd_merged")


def band_cases(H):
    """Phase 13's cases: (label, config, T, causal, dtype, head dim, q/k/v
    layout, kernels).  The banded ones are causal BSLongformer layouts (each
    band-expressible: W + globals < blocks); the merged kernel runs them too,
    and the layouts that are not bands."""
    dims, views = (64, 96, 128), ("qkv", "dense")
    bf16, fp32 = torch.bfloat16, torch.float32
    cases, i = [], 0
    for T in (1024, 4096):
        for block, window, g in ((16, 3, [0]), (16, 5, [0, 3]), (32, 1, [0]), (32, 5, [0, 3]),
                                 (64, 3, [0]), (64, 5, [0, 3]), (128, 1, [0]),
                                 (128, 5, [0]), (512, 1, [0]), (512, 3, [0])):
            if T // block >= 8:
                cases.append((f"longformer{block} w{window} g{g}",
                              longformer(H, block, window, g), T, True, (bf16, fp32)[i % 2],
                              dims[(i // 2) % 3], views[(i // 3) % 2], BAND_MERGE))
                i += 1
    # ragged: T not a multiple of the 64-row tiles (block 16, 63 rows: banded only);
    # an odd tile count (block 32, 17 tiles: the last merged row has no lower half)
    for dt in (bf16, fp32):
        cases.append(("longformer16 w5 g[0, 3]", longformer(H, 16, 5, [0, 3]), 1008, True, dt,
                      64, "qkv", ("flash_fwd_banded",)))
        cases.append(("longformer32 w5 g[0, 3]", longformer(H, 32, 5, [0, 3]), 1088, True, dt,
                      128, "dense", BAND_MERGE))
    fixed = FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
                                attention="unidirectional")
    per_head = FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                   num_global_blocks=1, different_layout_per_head=True,
                                   num_different_global_patterns=4)
    merged_only = (("fixed16 causal", fixed, 1024, True),
                   ("fixed16 per-head", per_head, 1024, True),
                   ("fixed16 per-head", per_head, 1024, False),
                   ("bigbird64", sparse_configs(H)[2][1], 1024, False),
                   ("empty-rows", EmptyRowsLayout(), 256, True),
                   ("empty-rows", EmptyRowsLayout(), 256, False),
                   ("alternate-empty-rows", AlternateEmptyRowsLayout(), 512, True))
    for (label, cfg, T, causal), dt in itertools.product(merged_only, (bf16, fp32)):
        cases.append((label, cfg, T, causal, dt, dims[i % 3], views[i % 2],
                      ("flash_fwd_merged",)))
        i += 1
    return cases


def band_merge_schedule(layout, T, H, causal, name):
    """The schedule ``flash_fwd_banded`` (the layout's :class:`BandLut`) or
    ``flash_fwd_merged`` (its :class:`MergedLut`) runs over."""
    if name == "flash_fwd_merged":
        return fa.layout_luts(layout, T, H, causal).merged
    st = fa.banded_structure(layout, causal)
    if st is None:
        raise AssertionError("layout is not band-expressible")
    return fa.band_lut(*st, T // layout.shape[1], T)


def check_band_merge_kernels(dev, gen, B=2, H=4):
    """Phase 13: the banded and merged forwards against their plain
    versions, O and lse element by element.  Returns the max abs error per
    kernel."""
    max_err = {name: 0.0 for name in BAND_MERGE}
    for label, cfg, T, causal, dt, d, view, names in band_cases(H):
        layout = np.asarray(cfg.make_layout(T), np.int32)
        q, k, v, _ = flash_inputs(dev, gen, dt, B, T, H, d, view)
        what = f"{str(dt)[6:]} d={d} T={T} {label} causal={int(causal)} {view}"
        res = {}
        for name in names:
            sched = band_merge_schedule(layout, T, H, causal, name)
            o, lse = getattr(fa, name)(q, k, v, sched)
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, sched.causal, lut=sched)
            torch.cuda.synchronize()
            res[name] = [(label_, *flash_close(f"{name} {what}", label_, got, ref))
                         for label_, got, ref in (("o", o, ro), ("lse", lse, rlse))]
            max_err[name] = max([max_err[name]] + [err for _, err, _ in res[name]])
        print(f"band-check {what}: " + "; ".join(
            f"{name[10:]} {flash_line({name: rows})}" for name, rows in res.items()))
    return max_err


def check_flash_lse(dev, gen, B=8, T=1024, H=16, d=64):
    """Phase 13: ``flash_attention_with_lse`` at GPT-2 350M's attention
    shape, bf16, under a loss on both outputs: exactly one launch of each
    dense kernel; O, lse and the gradients against the plain forward and
    backward fed the kernel's (O, lse) with ``delta - dlse``.  Then fp32 at
    B=2 T=256 H=4 against autograd of a dense attention returning its
    logsumexp."""
    q, k, v, w = flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    u = torch.randn((B, H, T), generator=gen, device=dev)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    torch.cuda.synchronize()
    fa.reset_launches()
    o, lse = fa.flash_attention_with_lse(*leaves, causal=True)
    ((o.float() * w.float()).sum() + (lse * u).sum()).backward()
    torch.cuda.synchronize()
    fwd = fa.dense_fwd_kernel(q.dtype, d)
    check_launches("flash_attention_with_lse", dict(fa.launches),
                   {fwd: 1, "flash_bwd_dkdv": 1, "flash_bwd_dq": 1}, 1)
    o, lse = o.detach(), lse.detach()
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True)
    delta = fa.attention_delta(o, w) - u
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, w, lse, delta, True)
    rdq = fa.flash_attention_reference_bwd_dq(q, k, v, w, lse, delta, True)
    rows = [(label, *flash_close(f"flash_attention_with_lse {label}", label, got, ref))
            for label, got, ref in (("o", o, ro), ("lse", lse, rlse), ("dq", leaves[0].grad, rdq),
                                    ("dk", leaves[1].grad, rdk), ("dv", leaves[2].grad, rdv))]
    print(f"flash_attention_with_lse B={B} T={T} H={H} d={d} causal bf16, loss on out and "
          f"lse: launches {fwd} 1, flash_bwd_dkdv 1, flash_bwd_dq 1; {flash_line({'': rows})}")

    # forward + backward beside its bound (rows 1, 3 and 4's work), the plain
    # versions and SDPA forward + backward (no lse output), which the port never calls
    def fwd_bwd(_):
        out, l = fa.flash_attention_with_lse(*leaves, causal=True)
        torch.autograd.grad((out, l), leaves, (w, u))

    def plain_fwd_bwd(_):
        po, plse = fa.flash_attention_reference_fwd(q, k, v, True)
        de = fa.attention_delta(po, w) - u
        fa.flash_attention_reference_bwd_dkdv(q, k, v, w, plse, de, True)
        fa.flash_attention_reference_bwd_dq(q, k, v, w, plse, de, True)

    saved = dict(fa.launches)
    pairs = B * H * T * (T + 1) // 2
    elem, stat = B * T * H * d * 2, B * H * T * 4
    t_b = (15 * elem + 5 * stat) / peak_bytes_per_s(torch.cuda.get_device_name(0)) * 1e3
    t_o = 18 * d * pairs / PEAK_OPS["bf16"] * 1e3
    bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    ms = repeat_ms(fwd_bwd, 10)
    plain_ms = time_ms(plain_fwd_bwd, 2, warmup=1)
    qh, kh, vh, doh = (x.detach().transpose(1, 2).contiguous() for x in (q, k, v, w))
    lib_leaves = [x.requires_grad_(True) for x in (qh, kh, vh)]
    lib = repeat_ms(lambda _: torch.autograd.grad(
        torch.nn.functional.scaled_dot_product_attention(*lib_leaves, is_causal=True),
        lib_leaves, doh), 10)
    fa.launches.update(saved)
    print(f"timing flash_attention_with_lse forward+backward B={B} T={T} H={H} d={d} causal "
          f"bf16: {spread(ms)}; bound {bound * 1e3:.2f} us ({by}); plain "
          f"{plain_ms * 1e3:.2f} us; SDPA forward+backward (no lse output) {spread(lib)}")

    B, T, H = 2, 256, 4
    q, k, v, w = (torch.randn((B, T, H, d), generator=gen, device=dev) for _ in range(4))
    u = torch.randn((B, H, T), generator=gen, device=dev)
    grads = []
    for flash in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        if flash:
            out, lse = fa.flash_attention_with_lse(*leaves, causal=True)
        else:
            s = torch.einsum("bqhd,bkhd->bhqk", *leaves[:2]) / math.sqrt(d)
            s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device=dev).tril(),
                              -math.inf)
            lse = torch.logsumexp(s, -1)
            out = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2])
        ((out * w).sum() + (lse * u).sum()).backward()
        grads.append([x.grad for x in leaves])
    errs = [(a - b).abs().max().item() for a, b in zip(*grads)]
    print(f"flash_attention_with_lse autograd vs dense autograd (fp32, loss on out and lse): "
          f"dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} (tol {GRAD_TOL:g})")
    if not max(errs) <= GRAD_TOL:
        raise AssertionError(f"flash_attention_with_lse gradients differ by {errs}")


# ------------------ 14. the causal block-sparse path at the sparse workload
WORKLOAD_T = (4096, 8192, 16384)
WORKLOAD_BLOCKS = (512, 64)
# the plain versions' (B, H, T, T) fp32 tensors: 2.1 GB each at 8192 (H=8),
# 8.6 GB at 16384, where the banded and merged O and lse are held against the
# LUT ring (itself held against its plain version below 16384)
PLAIN_T_MAX = 8192


def workload_config(H, block):
    """examples/bench_sparse_attention.py:53-98's layout (SPARSE_BENCH.json):
    BSLongformer, a 3 x 512-token window, the first 512 tokens global,
    causal, at layout block ``block``."""
    return BSLongformerSparsityConfig(
        num_heads=H, block=block, num_sliding_window_blocks=1536 // block,
        global_block_indices=list(range(512 // block)), attention="unidirectional")


def layout_pairs(layout, causal, block):
    """Live (q, k) pairs of a block layout, summed over its head layouts."""
    live = np.asarray(layout) > 0
    if not causal:
        return int(live.sum()) * block * block
    nb = live.shape[-1]
    below = int((live & np.tril(np.ones((nb, nb), bool), -1)).sum())
    diag = int((live & np.eye(nb, dtype=bool)).sum())
    return below * block * block + diag * block * (block + 1) // 2


def host_cpu():
    """The host's CPU as ``lscpu`` names it (vendor, model name, BIOS model
    name; ``/proc/cpuinfo``'s model name where there is no ``lscpu``) and
    its logical CPUs."""
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout
        fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    except (OSError, subprocess.SubprocessError):
        try:
            with open("/proc/cpuinfo") as f:
                fields = {"Model name": next(line.split(":", 1)[1] for line in f
                                             if line.startswith("model name"))}
        except (OSError, StopIteration):
            pass
    names = [fields[k].strip() for k in ("Vendor ID", "Model name", "BIOS Model name")
             if k in fields]
    return f"{' / '.join(names) or platform.machine()}, {os.cpu_count()} logical CPUs"


def repeat_ms(fn, n, warmup=3, times=3):
    """``times`` readings of :func:`time_ms`: (median, min, max)."""
    ms = sorted(time_ms(fn, n, warmup=warmup) for _ in range(times))
    return ms[len(ms) // 2], ms[0], ms[-1]


def spread(r):
    return f"{r[0] * 1e3:.2f} us (min {r[1] * 1e3:.2f}, max {r[2] * 1e3:.2f})"


def path_run(route, attn_or_layout, leaf, do, B, T, H, d, causal=True):
    """One call of the slice's path, forward and ``backward()``, with the
    counts reset just before and read just after: ``SparseSelfAttention``
    (the banded route) or ``sparse_flash_attention(block_q_merge=2)``.
    Returns (out, launches)."""
    q, k, v = (t.view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
    torch.cuda.synchronize()
    fa.reset_launches()
    if route == "banded":
        out = attn_or_layout(q, k, v)
    else:
        out = fa.sparse_flash_attention(q, k, v, attn_or_layout, causal=causal, block_q_merge=2)
    out.backward(do)
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    check_launches(f"{route} path", counts, {f"flash_fwd_{route}": 1, "flash_bwd_dkdv_lut": 1,
                                             "flash_bwd_dq_lut": 1}, 1)
    return out.detach(), counts


def check_path(route, name, sched, lut, leaf, do, out, B, T, H, d, what):
    """The path's O (the kernel again gives the same bits), lse and
    gradients against the plain versions at T <= PLAIN_T_MAX (the backward
    ones fed the kernel's O and lse); above, O and lse against the ring.
    Returns the rows of ``flash_line``."""
    q, k, v = (t.detach().view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
    dq, dk, dv = (g.view(B, T, H, d) for g in leaf.grad.split(H * d, dim=-1))
    kern = fa.flash_fwd_banded if route == "banded" else fa.flash_fwd_merged
    o, lse = kern(q, k, v, sched)
    if not torch.equal(o, out):
        raise AssertionError(f"{what}: a second {name} launch gives other bits")
    if T <= PLAIN_T_MAX:
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, sched.causal, lut=sched)
        delta = fa.attention_delta(o, do)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut)
        rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut)
        pairs = (("o", o, ro), ("lse", lse, rlse), ("dq", dq, rdq), ("dk", dk, rdk),
                 ("dv", dv, rdv))
    else:
        ro, rlse = fa.flash_fwd_lut_ring(q, k, v, lut)
        if not all(torch.isfinite(g).all() for g in (dq, dk, dv)):
            raise AssertionError(f"{what}: gradients not finite")
        pairs = (("o vs ring", o, ro), ("lse vs ring", lse, rlse))
    torch.cuda.synchronize()
    return [(label, *flash_close(f"{name} {what}", label.split()[0], got, ref))
            for label, got, ref in pairs]


def time_path(dev, route, name, sched, lut, layout, attn, leaf, do, B, T, H, d, causal,
              bytes_per_s, card):
    """Phase 14 timing at one shape: the kernel (three readings), its bound,
    its plain version (T <= PLAIN_T_MAX), the LUT ring on the same LUT, the
    dense causal ``flash_fwd``, SDPA with the expanded boolean layout mask
    and SDPA ``is_causal``; the path's forward+backward against SDPA's with
    the mask.  Returns the kernels-line fields."""
    q, k, v = (t.detach().view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
    kern = fa.flash_fwd_banded if route == "banded" else fa.flash_fwd_merged
    block = T // layout.shape[1]
    pairs = layout_pairs(layout, causal, block) * B * (H // layout.shape[0])
    nbytes, ops = 4 * B * T * H * d * 2 + B * H * T * 4, 4 * d * pairs
    t_b, t_o = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
    bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    n = 20
    ms = repeat_ms(lambda _: kern(q, k, v, sched), n)
    ring = repeat_ms(lambda _: fa.flash_fwd_lut_ring(q, k, v, lut), n)
    dense = repeat_ms(lambda _: fa.flash_fwd(q, k, v, causal), n)
    plain_ms = time_ms(lambda _: fa.flash_attention_reference_fwd(
        q, k, v, sched.causal, lut=sched), 2, warmup=1) if T <= PLAIN_T_MAX else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    mask = lut.element_mask(dev)[None]                       # (1, Lh, T, T)
    o, _ = kern(q, k, v, sched)
    err = (sdpa(qh, kh, vh, attn_mask=mask).transpose(1, 2).float() - o.float()).abs().max()
    if not err.item() <= 2e-2 * o.float().abs().max().item():
        raise AssertionError(f"SDPA yardstick {route} T={T} disagrees by {err.item()}")
    lib = repeat_ms(lambda _: sdpa(qh, kh, vh, attn_mask=mask), 5, warmup=2)
    lib_causal = repeat_ms(lambda _: sdpa(qh, kh, vh, is_causal=True), 5, warmup=2)
    fb_leaf = leaf.detach().clone().requires_grad_(True)

    def path_fb(_):
        fq, fk, fv = (t.view(B, T, H, d) for t in fb_leaf.split(H * d, dim=-1))
        out = attn(fq, fk, fv) if route == "banded" else fa.sparse_flash_attention(
            fq, fk, fv, layout, causal=causal, block_q_merge=2)
        out.backward(do)
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    fb = repeat_ms(path_fb, 5, warmup=2)
    lib_fb = repeat_ms(lambda _: sdpa(*leaves, attn_mask=mask).backward(doh), 3, warmup=1)
    plain_note = "not measured" if plain_ms is None else f"{plain_ms * 1e3:.2f} us"
    print(f"timing {name} B={B} T={T} H={H} d={d} bf16 block {block} causal={int(causal)} "
          f"({card}): {spread(ms)}; bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, "
          f"{ops / 1e9:.2f} GFLOP, {pairs} live pairs); plain {plain_note}; "
          f"flash_fwd_lut_ring {spread(ring)}; dense {'causal ' * causal}"
          f"{fa.dense_fwd_kernel(q.dtype, d)} {spread(dense)}; SDPA "
          f"with the layout mask {spread(lib)}; SDPA is_causal {spread(lib_causal)}")
    print(f"timing {route} path forward+backward B={B} T={T} block {block}: {spread(fb)}; "
          f"SDPA forward+backward with the layout mask {spread(lib_fb)}")
    del mask, leaves
    return {"ms": ms[0], "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib[0]}


def sparse_workload(dev, gen, card, bytes_per_s, B=1, H=8, d=64, line_shape=(64, 8192),
                    tutorial=(8, 2048, 16)):
    """Phase 14: ``SparseSelfAttention`` over the workload's unidirectional
    layouts (the banded forward) and ``sparse_flash_attention(...,
    block_q_merge=2)`` (the merged forward), forward and ``backward()``, B=1
    H=8 d=64 bf16 (q, k, v views of one qkv tensor), T in WORKLOAD_T, layout
    blocks 512 and 64; then the merged path on the tutorial's block-16
    layout at BERT-large's attention shape.  Exact launches per call,
    outputs and gradients against the plain versions, timings.  Returns
    (path launches per kernel, {kernel: kernels-line fields at
    ``line_shape``})."""
    print(f"{card}; host CPU {host_cpu()}")
    saved = dict(fa.launches)
    total = {name: 0 for name in BAND_MERGE}
    line = {}
    for block, T in itertools.product(WORKLOAD_BLOCKS, WORKLOAD_T):
        attn = SparseSelfAttention(workload_config(H, block), max_seq_length=T)
        layout = attn.get_layout(T)
        lut = fa.layout_luts(layout, T, H, True)
        W, gcols = fa.banded_structure(layout, True)
        band = fa.band_lut(W, gcols, block, T)
        qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
        for route, sched in (("banded", band), ("merged", lut.merged)):
            name = f"flash_fwd_{route}"
            leaf = qkv.detach().clone().requires_grad_(True)
            out, counts = path_run(route, attn if route == "banded" else layout, leaf, do,
                                   B, T, H, d)
            total[name] += counts[name]
            what = f"B={B} T={T} H={H} d={d} bf16 block {block}"
            rows = check_path(route, name, sched, lut, leaf, do, out, B, T, H, d, what)
            print(f"sparse-path {route} {what} (W={W}, {len(gcols)} gcols, kernel gcols "
                  f"{list(band.kernel_gcols)}): launches {name} 1, flash_bwd_dkdv_lut 1, "
                  f"flash_bwd_dq_lut 1, flash_fwd_lut_ring 0; {flash_line({name: rows})}")
            fields = time_path(dev, route, name, sched, lut, layout, attn, leaf, do, B, T, H,
                               d, True, bytes_per_s, card)
            if (block, T) == line_shape:      # the forward kernel's own outputs
                line[name] = {"max_abs_err": max(e for label, e, _ in rows
                                                 if label in ("o", "lse")), **fields}
            fa.launches.update(saved)
            del leaf, out
        del qkv, do
        torch.cuda.empty_cache()

    # the merged path on the tutorial layout at BERT-large's attention shape
    B, T, H = tutorial
    layout = np.asarray(build_sparsity_config(SPARSE_SECTION, H).make_layout(T), np.int32)
    lut = fa.layout_luts(layout, T, H, False)
    del attn
    qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    do = torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
    leaf = qkv.detach().clone().requires_grad_(True)
    out, counts = path_run("merged", layout, leaf, do, B, T, H, d, causal=False)
    total["flash_fwd_merged"] += counts["flash_fwd_merged"]
    what = f"B={B} T={T} H={H} d={d} bf16 tutorial16 non-causal"
    rows = check_path("merged", "flash_fwd_merged", lut.merged, lut, leaf, do, out, B, T, H, d,
                      what)
    print(f"sparse-path merged {what}: launches flash_fwd_merged 1, flash_bwd_dkdv_lut 1, "
          f"flash_bwd_dq_lut 1; {flash_line({'flash_fwd_merged': rows})}")
    time_path(dev, "merged", "flash_fwd_merged", lut.merged, lut, layout, None, leaf, do, B, T,
              H, d, False, bytes_per_s, card)
    fa.launches.update(saved)          # timing launches are not path launches
    del qkv, do, leaf, out
    torch.cuda.empty_cache()
    return total, line


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # fp32 references run in full fp32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = setup()
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = check_kernels(dev, gen)
    flash_err = check_flash_kernels(dev, gen)
    check_flash_grad(dev, gen)

    # 3. serving at full width: GPT-2 125M, bf16, random weights from a seed
    model = GPT2(preset="gpt2-125m", dtype=torch.bfloat16, device=dev)
    params = params_from_jax(model.init_numpy(seed=0), dev, torch.bfloat16)
    engine = InferenceEngine(model, params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, (int(n),))
               for n in rng.integers(32, 513, (16,))]
    launches = {}
    srv16, launches[pa.KERNELS["online"]], toks16 = serve(
        engine, prompts, 32, "kv16", 16, "auto")
    srv8, _, _ = serve(engine, prompts, 32, "kv8", 8, "auto")
    _, launches[pa.KERNELS["exact"]], toks_exact = serve(
        engine, prompts, 32, "kv16-exact", 16, "exact")
    same = sum(toks16[u] == toks_exact[u] for u in toks16)
    print(f"exact-kernel streams identical to online-kernel streams: "
          f"{same}/{len(prompts)}")
    model.config.paged_attention_mode = "auto"
    # every other prompt: 8 slots at a mean length of about 270
    for tag, srv in (("kv16", srv16), ("kv8", srv8)):
        check_decode_logits(srv, tag, *seat(srv, prompts[::2]))

    # 4. kernel timing at the seated phase-3 state
    bw = peak_bytes_per_s(kind)
    t16 = timing(srv16, "kv16", "bf16", gen, bw)
    t8 = timing(srv8, "kv8", "int8", gen, bw)
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": max_err[name], "ms": t16["kernels_ms"][name],
                "plain_ms": t16["plain_ms"], "bound_ms": t16["bound_ms"],
                "bound_by": t16["bound_by"], "library_ms": t16["library_ms"]}
               for name in pa.KERNELS.values()]
    print(json.dumps({"int8_pool_timing": {k: t8[k] for k in (
        "kernels_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "shape")}}))
    print(json.dumps({"bf16_pool_shape": t16["shape"]}))
    profile_steps(srv16.step, "kv16")
    profile_steps(srv8.step, "kv8")
    del srv16, srv8, engine
    torch.cuda.empty_cache()

    # 5. training at full width; 6. flash kernel timing at its shape
    train_launches = train(dev, card)
    tf = flash_timing(dev, gen, bw, card)
    print(json.dumps({"flash_sweep_max_abs_err": flash_err}))
    kernels += [{"name": name, "route": "cuda", "source": flash_source(name),
                 "replaces": REPLACES[name], "launches": train_launches[name],
                 **tf[name]} for name in fa.DENSE_KERNELS]
    torch.cuda.empty_cache()

    # 7. sparse kernels vs plain; 8. BERT-large training; 9. sparse timing
    sparse_err = check_sparse_kernels(dev, gen)
    print(json.dumps({"sparse_sweep_max_abs_err": sparse_err}))
    bert_launches = bert_train(dev, card)
    ts, density = sparse_timing(dev, gen, bw)
    print(json.dumps({"sparse_timing": ts, "density": density}))
    # the kernels line: each kernel at the shape its main-path run gives it
    # (8: the tutorial layout with padding; 8b: without; 8c: dense with padding)
    for name, case, run in (
            ("flash_fwd_biased", "dense+pad", "8c"),
            ("flash_bwd_dkdv_biased", "dense+pad", "8c"),
            ("flash_bwd_dq_biased", "dense+pad", "8c"),
            ("flash_fwd_lut", "tutorial16+pad", "8"),
            ("flash_fwd_lut_ring", "tutorial16", "8b"),
            ("flash_bwd_dkdv_lut", "tutorial16+pad", "8"),
            ("flash_bwd_dq_lut", "tutorial16+pad", "8")):
        kernels.append({"name": name, "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": bert_launches[run][name],
                        **ts[case][name]})

    # 10. int8 kernels vs plain; 11. int8 serving of GPT-2 1.3B; 12. int8 timing
    int8_err = check_int8_kernels(dev, gen)
    print(json.dumps({"int8_sweep_max_abs_err": int8_err}))
    int8_launches = int8_serving(dev, card, prompts)
    torch.cuda.empty_cache()
    ti = int8_timing(dev, gen, bw)
    for name in im.KERNELS.values():
        fields = {k: v for k, v in ti[name].items() if k != "int8pack_ms"}
        kernels.append({"name": name, "route": "cuda", "source": INT8_SOURCE,
                        "replaces": REPLACES[name], "launches": int8_launches[name], **fields})
    torch.cuda.empty_cache()

    # 13. banded and merged kernels vs plain, flash_attention_with_lse;
    # 14. the causal block-sparse path at the sparse workload, with timing
    band_err = check_band_merge_kernels(dev, gen)
    print(json.dumps({"band_merge_sweep_max_abs_err": band_err}))
    check_flash_lse(dev, gen)
    torch.cuda.empty_cache()
    band_launches, tb = sparse_workload(dev, gen, card, bw)
    for name in BAND_MERGE:
        kernels.append({"name": name, "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": band_launches[name],
                        **tb[name]})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
