#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py        # from the repo root; one CUDA card, nvcc

Drives the port only (``deepspeed_tpu_torch``; nothing of JAX or of the
JAX package ``deepspeed_tpu``):

1. setup: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of the CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, started together) with its time and ptxas
   register/spill summary; ``flash_fwd_sm90``'s, ``int8_mm_nt_decode``'s,
   ``int8_mm_nt_prefill``'s and ``int8_mm_t_prefill``'s (the latter's four
   instances with no wgmma serialized), the sm90 backward library's
   (``flash_bwd_dkdv_lut_sm90`` / ``flash_bwd_dq_lut_sm90`` and the dense
   ``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90``) and the sm90 LUT
   forward's (``flash_fwd_lut_sm90``; their build seconds, registers and
   spills per instance) must build with no spill, and the backward, the
   LUT forward and the ``flash_fwd_sm90`` libraries with no wgmma
   serialized by ptxas; the dense backward's four instances
   (``dense_dkdv_kernel`` / ``dense_dq_kernel`` with and without the key
   bias) and ``flash_fwd_sm90``'s eight (head dims 64 and 128: dense with
   and without the key bias, the banded schedule, the merged one) must each
   be built once,
   ``paged_attention_exact_sm90``'s twelve (``exact_split_kernel``: three
   compute dtypes, 16-bit and int8 pools, head dims 64 and 128) with no
   spill, and ``paged_attention_online_sm90``'s 24 (``online_split_kernel``:
   the same twelve for W = 1 and for W up to 8) with no spill;
2. kernels vs plain: the first ``paged_attention_exact_sm90`` and
   ``paged_attention_online_sm90`` launches (waited on under a deadline,
   each from a generator of its own), then the two routed kernels
   ``paged_attention_online_sm90`` and ``paged_attention_exact_sm90`` and
   beside them their first designs ``paged_attention_online`` and
   ``paged_attention_exact`` against ``paged_attention_reference`` at the
   serving shape (8 slots, 12 heads, head dim 64, block 16, 64 blocks per
   slot), lengths 0..1020, windows 1 and 4, bf16 / int8+scales / fp32
   pools, and over ``split_cases`` (their own generator): the three pools
   at head dims 64 and 128, windows 1, 4 and 8, lengths at 0, at S - W, on
   the ranks' chunk edges and one row past each kernel's staging buffer,
   S = 1024 (and 320 for bf16); then the
   dense forward its route takes (``flash_fwd_sm90`` for bf16 at head
   dims 64 and 128, whose first launch waits on an event under a
   deadline; the template ``flash_fwd`` for the rest, and beside every
   ``flash_fwd_sm90`` case the template too), O and lse, and the dense
   backward ``dense_bwd_kernel`` routes to (``flash_bwd_dkdv_sm90`` and
   ``flash_bwd_dq_sm90`` for bf16 at head dim 64, whose first launches, at
   T 33, 65 and 200 on the plain forward's O and lse, wait on an event under
   the deadline; the templates ``flash_bwd_dkdv`` and ``flash_bwd_dq`` for
   the rest, and beside every sm90 case the templates too) against their
   plain versions fed the routed forward's (O, lse) and the same dO, at
   B=2, H=4, T in
   {64, 96, 1000, 1024} (and 1088, 4096 for ``flash_fwd_sm90``), head dims
   64/96/128, bf16 and fp32 (TF32 off), causal and not, q/k/v as views of
   one qkv tensor and contiguous, each element within its limit; and one
   gradient check of the ``flash_attention`` autograd function against
   autograd of a dense attention in fp32;
3. serving: GPT-2 125M at full width (bf16, random weights from
   ``init_numpy(seed=0)``) answers 16 greedy requests with 16-bit and with
   int8 KV (both on ``paged_attention_online_sm90``), and in exact mode
   (``paged_attention_exact_sm90``), each step a CUDA graph (the model's
   ``decode_impl`` "fused", the default: the decode step one graph, each
   prefill bucket one); every outcome must be OK, every block recycled,
   and the kernel's launch count equal (decode replays + decode warm-ups)
   x 12 (every other paged kernel 0); then the kv16 traffic through both
   decode impls (``ab_serve``: "fused" and "unroll", the same step bodies
   run eagerly), each with its launches checked (eager: decode steps x
   12), its greedy streams identical to the captured serve's request by
   request, three timed passes (tokens/s, decode step p50/p99, TTFT p50,
   every bucket captured by then, each with its readings and spread), its
   graphs and the memory of their pool, and a profiled decode step (wall,
   busy and idle shares), then one decode step of each on the same seated
   state (max |delta logits|); one decode step's logits through the
   kernels are held against the ``gather`` path;
4. timing: each paged kernel, its plain version and a library yardstick
   (``scaled_dot_product_attention`` over pre-gathered K/V, which the port
   never calls) with CUDA events at the phase-3 shape, beside the least
   time the card could take (the bytes the call must move over the
   card's memory rate) and its share of it; each mode's two designs in
   turns (first design, split, split, first design), each the least of its
   readings; the paged kernels' device time per decode step from the
   kv16 and kv8 profiles (and phase 11's);
5. training: GPT-2 350M at full width (T=1024, micro-batch 8, gas 1,
   bf16, ZeRO-1, AdamW 6e-4 / wd 0.1, clip 1.0, dropout 0, no remat)
   through ``deepspeed_tpu_torch.initialize`` -> ``train_batch()`` on
   tokens ``rng(0).integers(0, 50257, (64, 1025))``: step 1 with
   ``attention_impl="flash"`` against ``"jnp"`` from the same weights and
   batch; 3 warm-up and 10 timed steps (tokens/s, step time p50/p99, MFU,
   peak memory); exactly 24 launches per step of ``flash_fwd_sm90``,
   ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``, and none of
   ``flash_fwd``, ``flash_bwd_dkdv`` and ``flash_bwd_dq``;
   finite losses and no skipped step; 20 steps on one fixed batch lower
   its loss by at least 0.5; a ``torch.profiler`` breakdown of a step,
   with the flash kernels' device time per step;
6. the flash kernels at the training shape, B=8, H=16, T=1024, d=64,
   causal, bf16 (q, k, v views of one qkv tensor, as the model passes
   them): each held against its plain version (these errors go into the
   kernels line), then timed (three readings, the spread printed) beside
   its bound, its plain version and the library's attention in the (B, H,
   T, d) layout, which the port never calls: ``flash_fwd_sm90`` and the
   template ``flash_fwd`` (the template design) beside
   ``scaled_dot_product_attention`` forward, ``flash_bwd_dkdv_sm90`` and
   ``flash_bwd_dq_sm90`` and the templates ``flash_bwd_dkdv`` and
   ``flash_bwd_dq`` (the template design) beside the flash-attention backward op
   (dQ, dK and dV in one call), and forward+backward; then
   ``flash_fwd_sm90`` against SDPA ``is_causal`` at B*T=8192, H=16, T in
   {1024, 2048, 4096, 8192}, head dims 64 and 128;
7. sparse kernels vs plain: the first ``flash_fwd_lut_sm90`` launch
   (tutorial layout, T=256, a key bias; waited on under the deadline) and
   the first launches of the dense sm90 pair's key-bias instances (T 33, 65
   and 200; each waited on under the deadline), then
   the LUT forward ``sparse_fwd_kernel`` routes to (``flash_fwd_lut_sm90``
   for bf16 at head dim 64 without a score bias, and beside it the template
   it replaced: ``flash_fwd_lut_ring`` without a bias, ``flash_fwd_lut``
   with one; the templates for the rest), the dK/dV kernel
   ``sparse_dkdv_kernel`` routes to
   (``flash_bwd_dkdv_lut_sm90`` for bf16 at head dim 64 without a score
   bias, and beside it the template ``flash_bwd_dkdv_lut`` through
   ``flash_bwd_dkdv_lut_tiled``; the template for the rest), the dQ kernel
   ``sparse_dq_kernel`` routes to (``flash_bwd_dq_lut_sm90`` by the same
   rule, and beside it the template ``flash_bwd_dq_lut`` through
   ``flash_bwd_dq_lut_tiled``; the template for the rest; with a ``mul``
   key bias and causal masking only dQ is held: dK/dV's limit there is
   open, PERF.md section 7), the dense biased forward ``biased_fwd_kernel``
   routes to (the key-bias instance of ``flash_fwd_sm90`` for bf16 at head
   dims 64 and 128 without a score bias, whose first launches at T 33, 65
   and 200 wait on an event under the deadline, and beside it the template
   ``flash_fwd_biased``; the template for the rest; a fully padded batch
   row must read O = 0 and lse = NEG_INF in both) and the dense biased
   backward ``biased_bwd_kernel`` routes to (the
   key-bias instances of ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``
   for bf16 at head dim 64 without a score bias, and beside them the
   templates ``flash_bwd_dkdv_biased`` and ``flash_bwd_dq_biased``; the
   templates for the rest), each against its plain version fed the same
   (O, lse, dO), element by element with phase 2's limits: B=2, H=4, T in
   {256, 1024} and 1008 (the dense biased path also at T 64, 65 and 1000,
   ``add`` and ``mul`` biases, causal and not, and at head dim 128),
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
   exactly 48 / 24 / 24 launches per step of ``flash_fwd_lut_sm90`` /
   ``flash_bwd_dkdv_lut_sm90`` / ``flash_bwd_dq_lut_sm90`` (remat runs each
   forward twice) and none of the templates ``flash_fwd_lut``,
   ``flash_bwd_dkdv_lut`` and ``flash_bwd_dq_lut``; finite losses and no
   skipped step; 20 steps on one fixed batch lower its loss by at least
   0.5; a ``torch.profiler`` breakdown of one step, with the forward, dK/dV
   and dQ device time per step; 8b, two steps on unpadded batches
   (``flash_fwd_lut_sm90`` without the bias, 0 on ``flash_fwd_lut_ring``;
   the same backward kernels); 8c, two padded steps
   with ``"mode": "dense"`` (an all-ones layout): exactly 48 launches per
   step of ``flash_fwd_sm90`` and 24 of each of ``flash_bwd_dkdv_sm90``
   and ``flash_bwd_dq_sm90`` (their key-bias instances), none of the
   templates ``flash_fwd_biased``, ``flash_bwd_dkdv_biased`` and
   ``flash_bwd_dq_biased``, then one profiled step with the dense biased
   forward's and backward's device time per step;
9. the sparse and biased kernels at the training shape, B=8, H=16,
   T=2048, d=64, bf16, q/k/v views of one qkv tensor: the tutorial's
   block-16 layout with the padding bias (and without it, the ring), the
   block-64 Fixed layout of ``docs/tutorials/sparse-attention.md`` (tiles
   skipped) and the all-ones layout with the padding bias; each kernel
   held against its plain version (these errors go into the kernels
   line), then timed beside its bound, its plain version and
   ``scaled_dot_product_attention`` with the expanded boolean
   layout-and-padding mask: forward, forward+backward and its backward
   alone (``autograd.grad`` over a retained graph), which the port never
   calls; ``flash_fwd_lut_sm90`` beside its template (``flash_fwd_lut``
   with the padding bias, ``flash_fwd_lut_ring`` without), each forward
   three readings with their spread, ``flash_bwd_dkdv_lut_sm90`` and
   ``flash_bwd_dq_lut_sm90`` beside the templates ``flash_bwd_dkdv_lut``
   and ``flash_bwd_dq_lut`` (the template design) on the same call, with
   the visits per head of each schedule, and at dense+pad the key-bias
   instances of ``flash_fwd_sm90`` (three readings), ``flash_bwd_dkdv_sm90``
   and ``flash_bwd_dq_sm90`` beside ``flash_fwd_biased``,
   ``flash_bwd_dkdv_biased`` and ``flash_bwd_dq_biased``; and the path's
   forward+backward (``sparse_flash_attention`` under ``autograd.grad``,
   three readings).

10. int8 kernels vs plain: the first ``int8_mm_t_prefill`` launch (the
    head at M = 272, waited on under a deadline, from a generator of its
    own), then ``int8_mm_nt_decode`` (the block weights at M <= 16),
    ``int8_mm_nt_prefill`` (M > 16), ``int8_mm_t`` (the head at M <= 16) and
    ``int8_mm_t_prefill`` (the head at M > 16) against
    ``int8_matmul_reference`` at the GPT-2 125M and 1.3B weight shapes
    (qkv, proj, fc, fc_proj; the tied head transposed, N = 50257), M in
    {1, 8, 16, 17, 64, 512} (the head also 127, 128, 129 and 272, from a
    generator of its own), per-tensor scales (and per-channel for the
    head), bf16 and fp32 outputs, each from the kernel its route names, and
    the earlier tiled design (``int8_mm_nt`` / ``int8_mm_t`` through
    ``int8_matmul_tiled``) at every M > 16 case: fp32 within d = 1e-5 of
    the largest |value| + 1e-6, bf16 within one bf16 ulp of each value + d,
    and two calls bit-identical;
11. int8 serving: GPT-2 1.3B at published widths (24 layers, 2048 wide, 32
    heads, vocab 50257), weights drawn on the card from a seeded generator
    with ``init_numpy``'s distributions, through
    ``deepspeed_tpu_torch.init_inference(model, params=..., dtype=torch.int8)``
    -> ``ServingEngine(engine=...)`` with phase 3's traffic on the captured
    steps: every outcome OK, every block recycled, ``int8_mm_nt_decode``
    launched decode runs x 96 times, ``int8_mm_nt_prefill`` prefill runs x
    96, the tiled ``int8_mm_nt`` never, ``int8_mm_t`` decode runs times and
    ``int8_mm_t_prefill`` prefill runs times (the head), a run being a
    graph's replay or warm-up; then phase 3's ``ab_serve`` on this
    traffic (both decode impls: launches, identical streams, timed
    passes, graphs, profiles, one step's logits); the int8
    tree at most 0.55x the bf16 tree's bytes; the oracle serves the same
    int8 values dequantized to bf16: its greedy choice on the int8 streams'
    contexts agrees on at least 0.9 of the tokens, one decode step's logits
    within 0.25; ``InferenceEngine.generate`` at int8 (B=4, T=64, +16; its
    token step captured, 15 replays and a warm-up) against the serving
    streams (launches per token-step run as per decode step), then three
    calls on each decode impl, the tokens identical; a
    ``torch.profiler`` breakdown of a decode step of each, with the int8
    products' device time per step, and of a prefill of 272 tokens (the
    mean prompt, its own bucket), captured and eager, with the int8
    products' device time per captured prefill (the block products and
    the head);
12. the int8 kernels at 1.3B's weights, decode (M = 8) and prefill (M =
    272 and 512): each held against its plain version, then timed beside its
    bound, its plain version, ``torch.matmul`` over the dequantized bf16
    weight and (the head) ``torch._weight_int8pack_mm`` and the port's own
    bf16 head call (``torch.mm`` over the vocab-padded weight, fp32 out),
    which the int8 path never calls; the routed kernel (``int8_mm_nt_decode``
    / ``int8_mm_nt_prefill`` for the block weights, ``int8_mm_t`` /
    ``int8_mm_t_prefill`` for the head) beside the earlier tiled design
    (``int8_mm_nt`` / ``int8_mm_t`` through ``int8_matmul_tiled``; the head
    at M = 8 routes to it), the two timed in turns, median of three
    readings each;
13. banded and merged-row kernels vs plain: the first
    ``flash_fwd_banded_sm90`` and ``flash_fwd_merged_sm90`` launches (under
    the deadline, from a generator of their own), then the
    kernel ``banded_fwd_kernel`` / ``merged_fwd_kernel`` routes to
    (``flash_fwd_banded_sm90`` / ``flash_fwd_merged_sm90`` for bf16 at
    head dims 64 and 128, and beside them the templates ``flash_fwd_banded`` /
    ``flash_fwd_merged`` by name; the templates for the rest) against
    ``flash_attention_reference_fwd`` over
    their schedules (O and lse, phase 2's limits) at B=2,
    H=4: causal BSLongformer layouts at blocks 16, 32, 64, 128 and 512,
    windows 1, 3 and 5, global blocks [0] and [0, 3], T 1024 and 4096, a
    ragged T=1008 at block 16 and an odd tile count (T=1088 at block 32);
    the merged kernel also on a causal Fixed layout, per-head Fixed layouts
    (causal and not), BigBird 64, phase 7's empty-rows layout and one whose
    every merged row has an empty upper half; bf16 and fp32, head dims
    64/96/128; then ``flash_attention_with_lse`` at GPT-2 350M's attention
    shape (B=8, T=1024, H=16, d=64, bf16) under a loss on both outputs
    (one launch each of ``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90`` and
    ``flash_bwd_dq_sm90``; O, lse and gradients against the plain
    forward and backward with ``delta - dlse``) and in fp32 against autograd
    of a dense attention returning its logsumexp; then both sm90 instances'
    O and lse over three seeds (generators of their own) at phase 14's
    shapes up to T=8192, each within phase 2's limits;
14. the causal block-sparse path at the repo's sparse workload
    (``examples/bench_sparse_attention.py``: BSLongformer, a 3 x 512-token
    window, the first 512 tokens global, unidirectional), B=1, H=8, d=64,
    bf16, T in {4096, 8192, 16384}, layout blocks 512 and 64:
    ``SparseSelfAttention`` forward + ``backward()`` with exactly one launch
    each of ``flash_fwd_banded_sm90``, ``flash_bwd_dkdv_lut_sm90`` and
    ``flash_bwd_dq_lut_sm90`` per call (the template ``flash_fwd_banded`` and
    ``flash_fwd_lut_ring`` 0), and the same
    through ``sparse_flash_attention(..., block_q_merge=2)`` (one
    ``flash_fwd_merged_sm90``), then that merged path on the tutorial block-16
    layout at BERT-large's attention shape (B=8, T=2048, H=16, non-causal);
    O, lse and gradients against the plain versions at T <= 8192, O and lse
    against ``flash_fwd_lut_ring`` at 16384 (the template design's O and lse
    beside them); each forward and the template design timed in turns (three
    readings each, the spread printed) beside its bound, its plain version, the ring and
    ``flash_fwd_lut_sm90`` on the same LUT, the dense causal forward
    (``flash_fwd_sm90``), SDPA with the expanded boolean layout mask and
    SDPA ``is_causal``, and each path's forward+backward beside SDPA's with
    the mask;
15. checkpoints: phase 5's configuration (GPT-2 350M, T=1024, micro 8,
    bf16, ZeRO-1, AdamW, clip 1.0, dropout 0) with ``WarmupLR``, so the lr
    moves every step.  Run A trains 3 steps, ``save_checkpoint``\ s to a
    temporary directory (removed at the end), trains steps 4-6, reloads
    its own checkpoint and repeats steps 4-6 (the repeat difference).  Run
    B, from other weights (seed 1), calls ``load_checkpoint`` and trains
    steps 4-6.  Hard: every restored leaf (params, master, ``exp_avg``,
    ``exp_avg_sq``) ``torch.equal`` to its host snapshot taken at the save,
    after B's load and after A's reload; the counters, lr, lr-schedule and
    loader state equal; the same batches; step 4's loss bit-equal; steps
    5-6 within the measured repeat difference (never a constant); 24
    launches a step of ``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90`` and
    ``flash_bwd_dq_sm90`` after the load, 0 on the templates;
    ``InferenceEngine(model, checkpoint=dir)`` gives the params, greedy
    ``generate`` tokens (B=2, T=32, 8 new, the captured token step) and
    served streams (``paged_attention_online_sm90``, launches checked as
    in phase 3) of an engine built from A's in-memory step-3 weights; a
    save crashed at ``ckpt.before_commit`` (``fault.configure``) leaves a
    ``.tmp`` that ``load_checkpoint`` skips for the step-3 tag.  Prints the
    model and optimizer files' bytes, save and load seconds (median of 3)
    and the peak host RSS during a save.

Prints a ``{"kernels": [...]}`` line (the dense sm90 kernels' key-bias
instances as ``flash_fwd_sm90 (key bias)``, ``flash_bwd_dkdv_sm90 (key
bias)`` and ``flash_bwd_dq_sm90 (key bias)``, with phase 8c's launches and
phase 9's dense+pad figures; ``paged_attention_exact_sm90`` with the
exact-mode serve's launches and the first design ``paged_attention_exact``
beside it with 0; ``paged_attention_online_sm90`` with the kv16 serve's
launches and the first design ``paged_attention_online`` beside it with
0; ``flash_fwd_banded_sm90`` and ``flash_fwd_merged_sm90`` with phase 14's
path launches and their figures at block 64, T=8192, the template
``flash_fwd_banded`` and ``flash_fwd_merged`` beside them with 0), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that line; with no
CUDA device it exits 2.
"""

import gc
import itertools
import json
import math
import os
import platform
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import fault
from deepspeed_tpu_torch.checkpoint import atomic
from deepspeed_tpu_torch.checkpoint.constants import MODEL_FILE, OPTIM_FILE
from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request,
                                           ServingConfig, ServingEngine)
from deepspeed_tpu_torch.inference import paged_kv as pk
from deepspeed_tpu_torch.models import build
from deepspeed_tpu_torch.models.gpt2 import GPT2, _pad_vocab, params_from_jax
from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, BSLongformerSparsityConfig, FixedSparsityConfig,
    SparseSelfAttention, build_sparsity_config, extend_position_embedding,
    replace_model_self_attention)
from deepspeed_tpu_torch.module_inject.module_quantize import dequantize_tree
from deepspeed_tpu_torch.monitor.histogram import LogHistogram
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
from deepspeed_tpu_torch.ops.transformer import int8_matmul as im
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.runtime import engine as engine_module
from deepspeed_tpu_torch.runtime.comm.quantized import quantize_blockwise
from deepspeed_tpu_torch.runtime.utils import tree_leaves, tree_map

L_CYCLE = 12          # layers cycled through when timing (cold L2 per launch)
PAGED_LIB = "paged_attention"
SOURCE = f"deepspeed_tpu_torch/csrc/{PAGED_LIB}.cu"
SPLIT_SM90 = pa.KERNELS["exact"]          # paged_attention_exact_sm90, the cluster-split kernel
ONLINE_SM90 = pa.KERNELS["online"]        # paged_attention_online_sm90, the same split, online
FLASH_REF = "deepspeed_tpu/ops/transformer/flash_attention.py"
REPLACES = {"paged_attention_online":
            "deepspeed_tpu/ops/transformer/paged_attention.py:180",
            "paged_attention_online_sm90":
            "deepspeed_tpu/ops/transformer/paged_attention.py:180",
            "paged_attention_exact":
            "deepspeed_tpu/ops/transformer/paged_attention.py:90",
            "paged_attention_exact_sm90":
            "deepspeed_tpu/ops/transformer/paged_attention.py:90",
            "flash_fwd": f"{FLASH_REF}:144",
            "flash_fwd_sm90": f"{FLASH_REF}:144",        # dense, bf16 at head dims 64 / 128
            "flash_fwd_sm90 (key bias)": f"{FLASH_REF}:144",   # use_kbias, 218
            "flash_bwd_dkdv": f"{FLASH_REF}:617",
            "flash_bwd_dq": f"{FLASH_REF}:691",
            "flash_bwd_dkdv_sm90": f"{FLASH_REF}:617",     # dense, bf16 at d 64
            "flash_bwd_dq_sm90": f"{FLASH_REF}:691",       # dense, bf16 at d 64
            "flash_bwd_dkdv_sm90 (key bias)": f"{FLASH_REF}:617",   # use_kbias, 659-660
            "flash_bwd_dq_sm90 (key bias)": f"{FLASH_REF}:691",     # use_kbias, 731-732
            "flash_fwd_biased": f"{FLASH_REF}:144",      # use_kbias / use_abias
            "flash_bwd_dkdv_biased": f"{FLASH_REF}:617",
            "flash_bwd_dq_biased": f"{FLASH_REF}:691",
            "flash_fwd_lut": f"{FLASH_REF}:144",         # use_lut + biases
            "flash_fwd_lut_ring": f"{FLASH_REF}:306",    # _fwd_kernel_dma
            "flash_fwd_lut_sm90": f"{FLASH_REF}:144",    # use_lut + use_kbias, and 306; bf16 d 64
            "flash_fwd_banded": f"{FLASH_REF}:180",      # _fwd_kernel use_banded
            "flash_fwd_merged": f"{FLASH_REF}:161",      # use_merge (and _fwd_kernel_dma 317)
            "flash_fwd_banded_sm90": f"{FLASH_REF}:180",  # use_banded, bf16 at d 64 / 128
            "flash_fwd_merged_sm90": f"{FLASH_REF}:161",  # use_merge, bf16 at d 64 / 128
            "flash_bwd_dkdv_lut": f"{FLASH_REF}:617",
            "flash_bwd_dkdv_lut_sm90": f"{FLASH_REF}:617",   # use_lut, bf16 at d 64
            "flash_bwd_dq_lut": f"{FLASH_REF}:691",
            "flash_bwd_dq_lut_sm90": f"{FLASH_REF}:691",     # use_lut, bf16 at d 64
            "int8_mm_nt": "deepspeed_tpu/ops/transformer/int8_matmul.py:45",     # the rest
            "int8_mm_nt_decode": "deepspeed_tpu/ops/transformer/int8_matmul.py:45",  # M <= 16
            "int8_mm_nt_prefill": "deepspeed_tpu/ops/transformer/int8_matmul.py:45",  # M > 16
            "int8_mm_t": "deepspeed_tpu/ops/transformer/int8_matmul.py:53",       # M <= 16
            "int8_mm_t_prefill": "deepspeed_tpu/ops/transformer/int8_matmul.py:53"}  # M > 16
INT8_DECODE_LIB = im.LIBRARIES["int8_mm_nt_decode"]
INT8_PREFILL_LIB = im.LIBRARIES["int8_mm_nt_prefill"]
INT8_SOURCES = {name: f"deepspeed_tpu_torch/csrc/{lib}.cu" for name, lib in im.LIBRARIES.items()}
SM90_LIB = fa.ENTRIES["flash_fwd_sm90"][0]
# and flash_bwd_dq_lut_sm90, flash_bwd_dkdv_sm90, flash_bwd_dq_sm90
GROUP_SM90_LIB = fa.ENTRIES["flash_bwd_dkdv_lut_sm90"][0]
FWD_LUT_SM90_LIB = fa.ENTRIES["flash_fwd_lut_sm90"][0]
SM90_DEADLINE_S = 10.0   # the first launch of an sm90 kernel must complete within this
KEY_BIAS = "(key bias)"  # the kernels line's name suffix of the dense sm90 kernels' biased instances


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
        f"{kname[kname.find('fwd_sm90_kernel'):kname.find('EEv')]} {regs} registers, "
        f"{spill} spill bytes" for kname, regs, _, spill in sm90))
    # each head dim's instances, once: dense with and without the key bias, banded, merged
    # (mangled <D, kBias, kSched>)
    fwd = {(d, bias, sched): sum(f"fwd_sm90_kernelILi{d}ELb{bias}ELi{sched}EE" in kname
                                 for kname, *_ in sm90)
           for d in fa.SM90_HEAD_DIMS[torch.bfloat16]
           for bias, sched in ((0, 0), (1, 0), (0, 1), (0, 2))}
    if any(n != 1 for n in fwd.values()) or any(spill for *_, spill in sm90):
        raise AssertionError(f"{SM90_LIB}: an instance (head dim, key bias, schedule) "
                             f"not built once {fwd}, or ptxas spilled registers: {sm90}")
    # 3 compute dtypes x 2 pools x 2 head dims; the online kernel also x 2 (W = 1, W <= 8)
    for kernel, name, n in (("exact_split_kernel", SPLIT_SM90, 12),
                            ("online_split_kernel", ONLINE_SM90, 24)):
        split = [(kname, regs, spill) for kname, regs, _, spill in
                 ptxas_summary(builder.build_log[PAGED_LIB]["ptxas"]) if kernel in kname]
        print(f"{PAGED_LIB}.cu {kernel} ({name}): {len(split)} instances, registers "
              f"{sorted({regs for _, regs, _ in split})}, spill bytes "
              f"{sorted({spill for *_, spill in split})}")
        if len(split) != n or any(spill for *_, spill in split):
            raise AssertionError(f"{PAGED_LIB}: {kernel} not built in {n} instances, or ptxas "
                                 f"spilled registers: {split}")
    for lib, kernels in ((INT8_DECODE_LIB, ("int8_decode_kernel",)),
                         (INT8_PREFILL_LIB, ("int8_prefill_kernel", "int8_t_prefill_kernel")),
                         (GROUP_SM90_LIB, ("dkdv_sm90_kernel", "dq_sm90_kernel",
                                           "dense_dkdv_kernel", "dense_dq_kernel")),
                         (FWD_LUT_SM90_LIB, ("fwd_lut_sm90_kernel",))):
        rows = ptxas_summary(builder.build_log[lib]["ptxas"])
        named = [(kernel, kname[kname.find(kernel):], regs, spill)
                 for kname, regs, _, spill in rows for kernel in kernels if kernel in kname]
        print(f"{lib}.cu: built in {builder.build_log[lib]['seconds']:.2f} s; " + "; ".join(
            f"{kname} {regs} registers, {spill} spill bytes" for _, kname, regs, spill in named))
        if any(kernel not in (k for k, *_ in named) for kernel in kernels) or any(
                spill for *_, spill in rows):
            raise AssertionError(f"{lib}: a kernel of {kernels} not built, or ptxas spilled "
                                 f"registers: {rows}")
    # the dense pair's instances with and without the key bias (mangled <64, true / false>)
    rows = ptxas_summary(builder.build_log[GROUP_SM90_LIB]["ptxas"])
    dense = {f"{kernel}<64, {bias}>": [(regs, spill) for kname, regs, _, spill in rows
                                       if f"{kernel}ILi64ELb{int(bias == 'true')}E" in kname]
             for kernel in ("dense_dkdv_kernel", "dense_dq_kernel") for bias in ("false", "true")}
    print(f"{GROUP_SM90_LIB}.cu dense instances: " + "; ".join(
        f"{name} {found[0][0]} registers, {found[0][1]} spill bytes" if found else
        f"{name} not built" for name, found in dense.items()))
    if not all(len(found) == 1 for found in dense.values()):
        raise AssertionError(f"{GROUP_SM90_LIB}: a dense instance not built once: {dense}")
    t_rows = [kname for kname, *_ in ptxas_summary(builder.build_log[INT8_PREFILL_LIB]["ptxas"])
              if "int8_t_prefill_kernel" in kname]
    if len(t_rows) != 2 * len(im.T_PREFILL_TILES):
        raise AssertionError(f"{INT8_PREFILL_LIB}: int8_mm_t_prefill's instances (token tiles x "
                             f"bf16 / fp32 out) not built once each: {t_rows}")
    for lib, kernel in ((GROUP_SM90_LIB, ""), (FWD_LUT_SM90_LIB, ""), (SM90_LIB, ""),
                        (INT8_PREFILL_LIB, "int8_t_prefill_kernel")):
        serialized = [line.strip() for line in builder.build_log[lib]["ptxas"].splitlines()
                      if ("C7515" in line or "C7512" in line) and kernel in line]
        if serialized:
            raise AssertionError(f"{lib}: ptxas serialized wgmmas: {serialized}")
    return card


def paged_pool(dev, gen, kind, B, H, HD, BS, NB_MAX, layers=2):
    """A pool of ``layers`` layers of ``1 + B * NB_MAX`` random blocks: bf16,
    fp32, or int8 with fp32 scales (bf16 compute); returns (pool, compute
    dtype)."""
    shape = (layers, 1 + B * NB_MAX, BS, H, HD)
    k = torch.randn(shape, generator=gen, device=dev)
    v = torch.randn(shape, generator=gen, device=dev)
    if kind == "int8":
        qk, sk = quantize_blockwise(k, block_size=64)
        qv, sv = quantize_blockwise(v, block_size=64)
        return {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}, torch.bfloat16
    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    return {"k": k.to(dt), "v": v.to(dt)}, dt


def paged_tables(dev, gen, lengths_list, W, BS, NB_MAX):
    """Block tables of distinct random blocks, each slot's live blocks only."""
    B = len(lengths_list)
    perm = torch.randperm(B * NB_MAX, generator=gen, device=dev) + 1
    t = torch.zeros((B, NB_MAX), dtype=torch.int32, device=dev)
    for b, n in enumerate(lengths_list):
        live = pk.blocks_needed(n + W, BS)
        t[b, :live] = perm[b * NB_MAX:b * NB_MAX + live].int()
    return t


def paged_calls(q, pool, tables, lengths):
    """``{kernel: fn(layer)}``: the routed kernels of both modes and their
    first designs, each called by name."""
    calls = {name: (lambda l, mode=mode: pa.paged_attention(q, pool, tables, lengths, l,
                                                            mode=mode))
             for mode, name in pa.KERNELS.items()}
    calls[pa.TEMPLATES["exact"]] = lambda l: pa.paged_attention_exact_template(
        q, pool, tables, lengths, l)
    calls[pa.TEMPLATES["online"]] = lambda l: pa.paged_attention_online_template(
        q, pool, tables, lengths, l)
    return calls


def paged_case(q, pool, tables, lengths, what, kind, max_err):
    """Each paged kernel against the plain version on one case: the routed
    kernels (``paged_attention_online_sm90``, ``paged_attention_exact_sm90``)
    and beside them their first designs (``paged_attention_online``,
    ``paged_attention_exact``).  Raises past TOL."""
    ref = pa.paged_attention_reference(q, pool, tables, lengths, 1)
    calls = {name: (lambda fn=fn: fn(1))
             for name, fn in paged_calls(q, pool, tables, lengths).items()}
    errs = {}
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{name} {what}: bad output")
        errs[name] = (out.float() - ref.float()).abs().max().item()
        max_err[name] = max(max_err[name], errs[name])
        if not errs[name] <= TOL[kind]:
            raise AssertionError(f"{name} {what}: error {errs[name]} above {TOL[kind]}")
    return errs


def first_split_launch(dev, mode="exact", seed=17):
    """The first launch of the cluster-split kernel of ``mode`` (one slot of
    300 tokens, a cluster of 8 at S = 1024), waited for under
    SM90_DEADLINE_S and held against the plain version.  Its inputs come
    from a generator of its own, so the phases after it draw what they
    drew before."""
    name = pa.KERNELS[mode]
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool, dt = paged_pool(dev, gen, "bf16", 1, 12, 64, 16, 64)
    tables = paged_tables(dev, gen, [300], 1, 16, 64)
    lengths = torch.tensor([300], dtype=torch.int32, device=dev)
    q = torch.randn((1, 1, 12, 64), generator=gen, device=dev).to(dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pa.paged_attention(q, pool, tables, lengths, 1, mode=mode)
    ms = wait_first(name, "len=300", t0)
    err = (out.float() - pa.paged_attention_reference(q, pool, tables, lengths, 1).float()
           ).abs().max().item()
    print(f"{name} first launch len=300: completed in {ms:.1f} ms, max abs error "
          f"{err:.2e} (tol {TOL['bf16']:g})")
    if not err <= TOL["bf16"]:
        raise AssertionError(f"{name} first launch: error {err}")


def check_kernels(dev, gen, B=8, H=12, HD=64, BS=16, NB_MAX=64,
                  lengths_list=(0, 15, 16, 500, 1020, 37, 255, 768)):
    """Phase 2: every paged kernel against the plain version on the card
    (:func:`paged_case`), then the exact ones over :func:`split_cases`.
    Returns the max abs error per kernel."""
    max_err = {name: 0.0 for name in pa.launches}
    first_split_launch(dev)
    first_split_launch(dev, "online", seed=20)
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device=dev)
    for kind in ("bf16", "int8", "fp32"):
        pool, dt = paged_pool(dev, gen, kind, B, H, HD, BS, NB_MAX)
        for W in (1, 4):
            tables = paged_tables(dev, gen, lengths_list, W, BS, NB_MAX)
            q = torch.randn((B, W, H, HD), generator=gen, device=dev).to(dt)
            errs = paged_case(q, pool, tables, lengths, f"pool={kind} W={W}", kind, max_err)
            for name, err in errs.items():
                print(f"kernel-check {name} pool={kind} W={W}: max_abs_err "
                      f"{err:.3e} (tol {TOL[kind]:g})")
    check_split_kernels(dev, max_err)
    return max_err


def split_cases():
    """Phase 2's cases for the exact kernels: (pool kind, head dim, W,
    blocks a slot): bf16 / int8 / fp32 pools at head dims 64 and 128,
    windows 1, 4 and 8, S = 1024 (a cluster of 8); bf16 at S = 320 (3)."""
    return ([(kind, hd, W, 64) for kind in ("bf16", "int8", "fp32") for hd in (64, 128)
             for W in (1, 4, 8)] + [("bf16", 64, W, 20) for W in (1, 8)])


def split_lengths(S, W, C, R, R_online):
    """Slot lengths that put the split kernels on their edges: 0, the
    window reaching S, rows a multiple of the ranks and one past, a rank's
    chunk filling each kernel's staging buffer (R rows, R_online rows) and
    one row past it (streamed in pieces), and two between."""
    edges = (0, S - W, C * 40 - W, C * 40 + 1 - W, C * R - W, C * R + 1 - W, 37, S // 2,
             C * R_online - W, C * R_online + 1 - W)
    return [min(max(n, 0), S - W) for n in edges]


def check_split_kernels(dev, max_err, H=12, BS=16, seed=18):
    """Phase 2, split: ``paged_attention_exact_sm90`` and
    ``paged_attention_online_sm90`` and their first designs beside them
    against the plain version over :func:`split_cases`, one slot for each
    of :func:`split_lengths`; inputs from a generator of their own."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for kind, hd, W, nb_max in split_cases():
        S = BS * nb_max
        itemsize = 4 if kind == "fp32" else 1 if kind == "int8" else 2
        n_scales = hd // 64 if kind == "int8" else 0      # paged_pool's quant block of 64
        C, _, R = pa.exact_sm90_plan(S, hd, itemsize, n_scales)
        R_online = pa.online_sm90_plan(S, hd, itemsize, n_scales)[2]
        lengths_list = split_lengths(S, W, C, R, R_online)
        B = len(lengths_list)
        pool, dt = paged_pool(dev, gen, kind, B, H, hd, BS, nb_max)
        tables = paged_tables(dev, gen, lengths_list, W, BS, nb_max)
        lengths = torch.tensor(lengths_list, dtype=torch.int32, device=dev)
        q = torch.randn((B, W, H, hd), generator=gen, device=dev).to(dt)
        what = f"pool={kind} hd={hd} W={W} S={S}"
        errs = paged_case(q, pool, tables, lengths, what, kind, max_err)
        print(f"split-check {what} (ranks {C}, staged rows {R} exact / {R_online} online, "
              f"lengths {lengths_list}): " +
              ", ".join(f"{name} {err:.3e}" for name, err in errs.items()) +
              f" (tol {TOL[kind]:g})")


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
    template ``flash_fwd`` too), the backward ones the route takes (and
    beside ``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90`` the templates
    too) fed the routed forward's O and lse, as in training.  Returns
    {kernel: [(output, max abs error, share of limit)]}."""
    fwd = fa.dense_fwd_kernel(q.dtype, q.shape[-1])
    dkdv, dqk = fa.dense_bwd_kernel(q.dtype, q.shape[-1])
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = fa.attention_delta(o, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal)
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal)
    rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal)
    pairs = {fwd: [("o", o, ro), ("lse", lse, rlse)],
             dkdv: [("dk", dk, rdk), ("dv", dv, rdv)],
             dqk: [("dq", dq, rdq)]}
    if fwd != "flash_fwd":
        to, tlse = fa.flash_fwd_template(q, k, v, causal)
        pairs["flash_fwd"] = [("o", to, ro), ("lse", tlse, rlse)]
    if dkdv != "flash_bwd_dkdv":
        tdk, tdv = fa.flash_bwd_dkdv_template(q, k, v, do, lse, delta, causal)
        pairs["flash_bwd_dkdv"] = [("dk", tdk, rdk), ("dv", tdv, rdv)]
        pairs["flash_bwd_dq"] = [("dq", fa.flash_bwd_dq_template(q, k, v, do, lse, delta, causal),
                                  rdq)]
    torch.cuda.synchronize()
    return {name: [(label, *flash_close(f"{name} {what}", label, got, ref))
                   for label, got, ref in ps] for name, ps in pairs.items()}


def flash_line(res):
    """``output max-abs-error (share of its limit)`` for each output."""
    return ", ".join(f"{label} {err:.2e} ({share:.2f})"
                     for rows in res.values() for label, err, share in rows)


def wait_first(name, what, t0):
    """Poll an event recorded after a first launch under SM90_DEADLINE_S: a
    launch that does not complete raises (the sm90 kernels also trap on an
    mbarrier wait of more than 2 s), so a fault of its schedule ends the run
    instead of stalling it.  Returns the milliseconds it took."""
    done = torch.cuda.Event()
    done.record()
    while not done.query():
        if time.perf_counter() - t0 > SM90_DEADLINE_S:
            raise RuntimeError(f"{name} {what}: the first launch did not complete within "
                               f"{SM90_DEADLINE_S} s")
        time.sleep(1e-3)
    return (time.perf_counter() - t0) * 1e3


def first_sm90_launch(dev, gen):
    """The first ``flash_fwd_sm90`` launches (T=64, one tile, each head
    dim), then the first ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``
    launches (B=2, H=4, d=64, T 33, 65 and 200, causal, q/k/v views of one
    qkv tensor, fed the plain forward's O and lse), each waited for under
    SM90_DEADLINE_S (:func:`wait_first`) and held against its plain
    version with phase 2's limits."""
    for d in fa.SM90_HEAD_DIMS[torch.bfloat16]:
        q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, 1, 64, 1, d, "dense")
        t0 = time.perf_counter()
        o, lse = fa.flash_fwd_sm90(q, k, v, True)
        ms = wait_first("flash_fwd_sm90", f"d={d}", t0)
        err = (o.float() - fa.flash_attention_reference_fwd(q, k, v, True)[0].float()).abs().max()
        print(f"flash_fwd_sm90 first launch d={d} T=64: completed in {ms:.1f} ms, O max abs "
              f"error {err.item():.2e}")
    for T in (33, 65, 200):
        q, k, v, do = flash_inputs(dev, gen, torch.bfloat16, 2, T, 4, 64, "qkv")
        o, lse = fa.flash_attention_reference_fwd(q, k, v, True)
        delta = fa.attention_delta(o, do)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk, dv = fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, True)
        ms = wait_first("flash_bwd_dkdv_sm90", f"T={T}", t0)
        t0 = time.perf_counter()
        dq = fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta, True)
        ms_dq = wait_first("flash_bwd_dq_sm90", f"T={T}", t0)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True)
        rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, True)
        rows = [(label, *flash_close(f"first launch T={T}", label, got, ref))
                for label, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq))]
        print(f"flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90 first launches T={T}: completed in "
              f"{ms:.1f} / {ms_dq:.1f} ms; {flash_line({'': rows})}")


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
    """Phase 3 (and 11) run: a warm-up serve, then ``prompts`` served
    greedily by a fresh server through :func:`run_checked`.  Returns
    (server, paged launches by kernel, tokens)."""
    c = engine.module.config
    c.paged_attention_mode = mode
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=kv_bits,
                        max_new_tokens=new)
    ServingEngine(engine=engine, config=cfg).run(
        [Request(tokens=prompts[0][:40], max_new_tokens=4)])   # warm-up
    return run_checked(ServingEngine(engine=engine, config=cfg), engine, prompts, new, tag,
                       mode)


def step_runs(srv, prefills):
    """(decode steps, prefills) that launched kernels in ``srv``'s runs:
    each graph's replays plus its warm-ups when the steps are captured
    (``decode_impl`` fused), the steps and prefills themselves when eager."""
    st = srv.stats()
    g = st["graphs"]
    if g["decode_impl"] == "fused":
        return (g["decode_replays"] + g["decode_warmups"],
                g["prefill_replays"] + g["prefill_warmups"])
    return st["decode_steps"], prefills


def graph_pool_mb(srv):
    """MB of the caching allocator's segments in ``srv``'s graph pool
    (``torch.cuda.memory_snapshot``), or None with no pool."""
    pool = srv._graphs
    if pool is None:
        return None
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool.handle)) / 1e6


def graphs_line(srv):
    g = srv.stats()["graphs"]
    mb = graph_pool_mb(srv)
    return (f"decode_impl {g['decode_impl']}: {g['graphs']} graphs ({g['captures']} captures; "
            f"decode warm-ups {g['decode_warmups']}, replays {g['decode_replays']}; prefill "
            f"warm-ups {g['prefill_warmups']}, replays {g['prefill_replays']}), graph pool "
            + ("none" if mb is None else f"{mb:.1f} MB"))


def run_checked(srv, engine, prompts, new, tag, mode):
    """Serve ``prompts`` greedily on ``srv`` with counts reset just before
    and read just after; checks outcomes, tokens, recycling, paged-attention
    launches == decode runs x layers and, for an int8 engine,
    ``int8_mm_nt_decode`` == decode runs x 4 x layers, ``int8_mm_nt_prefill``
    == prefill runs x 4 x layers, the tiled ``int8_mm_nt`` 0, ``int8_mm_t``
    == decode runs and ``int8_mm_t_prefill`` == prefill runs (all 0 for a
    float engine), a run being a replay or a warm-up of the step's graph, or
    an eager step (:func:`step_runs`).
    Returns (server, paged launches by kernel, tokens)."""
    c = engine.module.config
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
    runs, pre = step_runs(srv, len(prompts))
    want = pa.KERNELS["exact" if mode == "exact" else "online"]
    for name, n in counts.items():
        expect = runs * c.n_layer if name == want else 0
        if n != expect:
            raise AssertionError(f"{tag}: {name} launched {n} times, "
                                 f"expected {expect} ({runs} decode runs)")
    # int8: the block products of each decode step (8 rows) on the decode kernel, of each
    # prefill (a prompt of 32 rows or more) on the prefill kernel, none on the tiled one;
    # the head once per step (int8_mm_t) or prefill (int8_mm_t_prefill).  A float engine
    # launches none.
    q = int(engine.quantized)
    for name, expect in (("int8_mm_nt_decode", q * runs * 4 * c.n_layer),
                         ("int8_mm_nt_prefill", q * pre * 4 * c.n_layer),
                         ("int8_mm_nt", 0),
                         ("int8_mm_t", q * runs),
                         ("int8_mm_t_prefill", q * pre)):
        if int8_counts[name] != expect:
            raise AssertionError(f"{tag}: {name} launched {int8_counts[name]} times, "
                                 f"expected {expect} ({runs} decode runs, {pre} prefill "
                                 f"runs)")
    for uid in range(len(prompts)):
        r = res[uid]
        if r["outcome"] != OK or len(r["tokens"]) != new:
            raise AssertionError(f"{tag}: uid {uid} {r['outcome']} {r['tokens']}")
        if not all(0 <= t < c.vocab_size for t in r["tokens"]):
            raise AssertionError(f"{tag}: uid {uid} token out of range")
    if srv.allocator.free_blocks != srv.num_blocks - 1:
        raise AssertionError(f"{tag}: {srv.allocator.free_blocks} free of "
                             f"{srv.num_blocks - 1}: blocks leaked")
    int8_line = (f"int8_mm_nt_decode {int8_counts['int8_mm_nt_decode']} = decode runs x "
                 f"{4 * c.n_layer}, int8_mm_nt_prefill {int8_counts['int8_mm_nt_prefill']} = "
                 f"prefill runs x {4 * c.n_layer}, int8_mm_nt {int8_counts['int8_mm_nt']}, "
                 f"int8_mm_t {int8_counts['int8_mm_t']} = decode runs, int8_mm_t_prefill "
                 f"{int8_counts['int8_mm_t_prefill']} = prefill runs; "
                 if engine.quantized else "")
    others = ", ".join(f"{name} {n}" for name, n in counts.items() if name != want)
    print(f"serve {tag}: {len(prompts)} requests OK, {steps} decode steps, {runs} decode "
          f"runs, {pre} prefill runs, {want} launches {counts[want]} = decode runs x "
          f"{c.n_layer} ({others}); {int8_line}"
          f"{st['generated_tokens'] / wall:.1f} tokens/s, decode step p50 "
          f"{st['step_ms']['p50']:.3f} ms p99 {st['step_ms']['p99']:.3f} ms, "
          f"TTFT p50 {st['ttft_ms']['p50']:.1f} ms, wall {wall:.2f} s (captures included), "
          f"pool {pk.pool_bytes(srv.pool) / 1e6:.1f} MB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB (resident before the run "
          f"{resident / 1e6:.1f} MB); {graphs_line(srv)}")
    srv.int8_launches = int8_counts
    return srv, counts, {uid: res[uid]["tokens"] for uid in res}


AB_PASSES = 3   # timed passes of each decode impl


def ab_serve(engine, prompts, new, tag, kv_bits, fused_tokens):
    """The same traffic through both decode impls, "fused" (each step a
    CUDA graph) and "unroll" (the same step bodies, eager).  For each: a
    first pass through :func:`run_checked` (launches, outcomes, recycling;
    every prefill bucket captured), whose streams must equal
    ``fused_tokens`` request by request; AB_PASSES timed passes (tokens/s,
    decode step p50/p99, TTFT p50); its graphs and their pool; one decode
    step profiled.  Then one decode step of each on the same seated state:
    max |delta logits| and the argmax.  Returns {impl: [(tokens/s, p50,
    p99, TTFT p50), ...]}."""
    c = engine.module.config
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=kv_bits, max_new_tokens=new)
    readings, logits = {}, {}
    try:
        for impl in ("fused", "unroll"):
            c.decode_impl = impl
            srv, _, toks = run_checked(ServingEngine(engine=engine, config=cfg), engine,
                                       prompts, new, f"{tag} {impl}", "auto")
            diff = [u for u in fused_tokens if toks[u] != fused_tokens[u]]
            if diff:
                raise AssertionError(f"{tag} {impl}: streams differ from the captured serve's "
                                     f"for uids {diff}")
            rows = []
            for r in range(AB_PASSES):
                # each pass's own step and TTFT percentiles
                srv._step_wall_hist, srv._ttft_hist = LogHistogram(), LogHistogram()
                reqs = [Request(tokens=p, uid=1000 * (r + 1) + i) for i, p in enumerate(prompts)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = srv.run(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if not all(res[q.uid]["outcome"] == OK for q in reqs):
                    raise AssertionError(f"{tag} {impl}: pass {r} not all OK")
                st = srv.stats()
                rows.append((len(prompts) * new / wall, st["step_ms"]["p50"],
                             st["step_ms"]["p99"], st["ttft_ms"]["p50"]))
            readings[impl] = rows
            cols = list(zip(*rows))
            print(f"ab {tag} {impl}: " + ", ".join(
                f"{name} {statistics.median(col):.3f} (readings "
                f"{', '.join(f'{x:.3f}' for x in col)}; spread {max(col) - min(col):.3f})"
                for name, col in zip(("tokens/s", "decode step p50 ms", "decode step p99 ms",
                                      "TTFT p50 ms"), cols))
                  + f"; {graphs_line(srv)}")
            for i, p in enumerate(prompts[:8]):
                srv.submit(Request(tokens=p, uid=10 ** 6 + i))
            profile_steps(srv.step, f"{tag} {impl}")
            del srv
            # one decode step on the same seated state
            one = ServingEngine(engine=engine, config=cfg)
            seat(one, prompts[::2])
            with torch.no_grad():
                logits[impl] = one._decode_graph()(toks=one._toks, tables=one._tables,
                                                   lengths=one._lengths)[0].clone()
            del one
            gc.collect()
    finally:
        c.decode_impl = "auto"
    err = (logits["fused"] - logits["unroll"]).abs().max().item()
    agree = (logits["fused"].argmax(-1) == logits["unroll"].argmax(-1)).sum().item()
    print(f"ab {tag}: one decode step, captured vs eager: max |delta logits| {err:.3e}, "
          f"argmax agree {agree}/{logits['fused'].shape[0]}")
    if not torch.isfinite(logits["fused"]).all():
        raise AssertionError(f"{tag}: captured decode logits not finite")
    return readings


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
    # a device-side backlog, so the host's enqueue time never shows: ~17 ms, and ~285 us of
    # enqueue a call at 200 calls (a slow host enqueues a paged call in over 100 us)
    torch.cuda._sleep(int(max(3e7, 5e5 * n)))
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
    calls = paged_calls(q, pool, tables, lengths)
    # each mode's two designs in turns (the first design, the split, the split, the first
    # design); each kernel's time is the least of its readings
    readings = {}
    for mode in ("exact", "online"):
        first, split = pa.TEMPLATES[mode], pa.KERNELS[mode]
        for name in (first, split, split, first):
            readings.setdefault(name, []).append(time_ms(calls[name], 200))
    for name, rs in readings.items():
        ms = out["kernels_ms"][name] = min(rs)
        design = " (the first design)" if name in pa.TEMPLATES.values() else ""
        print(f"timing {tag} {name}{design}: {ms * 1e3:.2f} us (readings "
              f"{', '.join(f'{r * 1e3:.2f}' for r in rs)}), bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}, share {bound_ms / ms:.3f}), plain "
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
    head_dim = model.config.n_embd // model.config.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    per_step = {name: n_layer for name in (fwd, *fa.dense_bwd_kernel(torch.bfloat16, head_dim))}
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
        m = re.search(r"\b(fwd_sm90_kernel|fwd_kernel|dkdv_kernel|dq_kernel|dense_dkdv_kernel|"
                      r"dense_dq_kernel)\b", name)
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
    dkdv = (6 * elem + 2 * stat, 8 * d * pairs)                        # QK, dOV, PdO, dSQ
    dq = (5 * elem + 2 * stat, 6 * d * pairs)                          # QK, dOV, dSK
    return {"flash_fwd": fwd, "flash_fwd_sm90": fwd, "flash_bwd_dkdv": dkdv,
            "flash_bwd_dkdv_sm90": dkdv, "flash_bwd_dq": dq, "flash_bwd_dq_sm90": dq}


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
    ``flash_fwd`` (the template design) beside SDPA forward, the backward
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
              "flash_bwd_dkdv_sm90": lambda: fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, True),
              "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv_template(q, k, v, do, lse, delta, True),
              "flash_bwd_dq_sm90": lambda: fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta, True),
              "flash_bwd_dq": lambda: fa.flash_bwd_dq_template(q, k, v, do, lse, delta, True)}
    plain_fwd = lambda: fa.flash_attention_reference_fwd(q, k, v, True)
    plain_dkdv = lambda: fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True)
    plain_dq = lambda: fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, True)
    plain = {"flash_fwd_sm90": plain_fwd, "flash_fwd": plain_fwd,
             "flash_bwd_dkdv_sm90": plain_dkdv, "flash_bwd_dkdv": plain_dkdv,
             "flash_bwd_dq_sm90": plain_dq, "flash_bwd_dq": plain_dq}
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
    for name in ("flash_fwd_sm90", "flash_fwd", "flash_bwd_dkdv_sm90", "flash_bwd_dkdv",
                 "flash_bwd_dq_sm90", "flash_bwd_dq"):
        nbytes, ops = work[name]
        bound, by = bound_ms(nbytes, ops, bytes_per_s)
        r = repeat_ms(lambda _: kernel[name](), 50)
        plain_ms = time_ms(lambda _: plain[name](), 5)
        lib_r = sdpa_r if name.startswith("flash_fwd") else sdpa_b
        out[name] = {"max_abs_err": max_err[name], "ms": r[0], "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": None if lib_r is None else lib_r[0]}
        design = " (the template design)" if name in ("flash_fwd", "flash_bwd_dkdv",
                                                      "flash_bwd_dq") else ""
        lib_note = ("SDPA forward" if name.startswith("flash_fwd")
                    else "the flash-attention backward op (dq, dk, dv)")
        print(f"timing {name}{design} B={B} T={T} H={H} d={d} causal bf16 ({card}): "
              f"{spread(r)}; bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP); plain {plain_ms * 1e3:.2f} us; {lib_note} "
              f"{'not available' if lib_r is None else spread(lib_r)}")
    bwd_ms = {design: sum(out[n]["ms"] for n in names) for design, names in (
        ("sm90", ("flash_bwd_dkdv_sm90", "flash_bwd_dq_sm90")),
        ("template", ("flash_bwd_dkdv", "flash_bwd_dq")))}
    print(f"timing dense backward B={B} T={T} H={H} d={d} causal bf16 ({card}): "
          f"flash_bwd_dkdv_sm90 + flash_bwd_dq_sm90 {bwd_ms['sm90'] * 1e3:.2f} us, the "
          f"template design {bwd_ms['template'] * 1e3:.2f} us; the flash-attention backward op "
          f"{'not available' if sdpa_b is None else f'{sdpa_b[0] * 1e3:.2f} us'}")
    path_ms = out["flash_fwd_sm90"]["ms"] + bwd_ms["sm90"]
    print(f"timing SDPA (B, H, T, d) causal bf16: forward+backward {sdpa_fb_ms * 1e3:.2f} us; "
          f"flash_fwd_sm90 + flash_bwd_dkdv_sm90 + flash_bwd_dq_sm90 {path_ms * 1e3:.2f} us")
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
    A LUT case takes the forward ``sparse_fwd_kernel`` names, as the model
    path does, dK/dV the kernel ``sparse_dkdv_kernel`` names and dQ the one
    ``sparse_dq_kernel`` names; a biased case the forward ``biased_fwd_kernel``
    names and the backward ``biased_bwd_kernel`` names."""
    if lut is None:
        names = (fa.biased_fwd_kernel(q.dtype, q.shape[-1], ab is not None),
                 *fa.biased_bwd_kernel(q.dtype, q.shape[-1], ab is not None))
        calls = (lambda: fa.flash_fwd_biased(q, k, v, kb, ab, causal),
                 lambda lse, de: fa.flash_bwd_dkdv_biased(q, k, v, do, lse, de, kb, ab,
                                                          causal),
                 lambda lse, de: fa.flash_bwd_dq_biased(q, k, v, do, lse, de, kb, ab, causal))
    else:
        names = (fa.sparse_fwd_kernel(q.dtype, q.shape[-1], ab is not None, kb is not None),
                 fa.sparse_dkdv_kernel(q.dtype, q.shape[-1], ab is not None),
                 fa.sparse_dq_kernel(q.dtype, q.shape[-1], ab is not None))
        calls = (lambda: fa.sparse_fwd(names[0], q, k, v, lut, kb, ab),
                 lambda lse, de: fa.flash_bwd_dkdv_lut(q, k, v, do, lse, de, lut, kb, ab),
                 lambda lse, de: fa.flash_bwd_dq_lut(q, k, v, do, lse, de, lut, kb, ab))
    kw = dict(lut=lut, key_padding_bias=kb, attn_bias=ab)
    plains = (lambda: fa.flash_attention_reference_fwd(q, k, v, causal, **kw),
              lambda lse, de: fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, de,
                                                                    causal, **kw),
              lambda lse, de: fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, de,
                                                                  causal, **kw))
    return names, calls, plains


def fwd_template(kb):
    """The template the sm90 LUT forward is held beside: the ring without a
    key bias, the biased LUT kernel with one (the template design)."""
    return "flash_fwd_lut_ring" if kb is None else "flash_fwd_lut"


def fwd_templates(q, k, v, lut, kb, ab, causal, name):
    """The template design beside a case's sm90 forward ``name``: ``{template
    name: call()}``, the LUT templates through ``sparse_fwd`` (beside
    ``flash_fwd_lut_sm90``), the dense biased one through
    ``flash_fwd_biased_template`` (beside the key-bias ``flash_fwd_sm90``);
    none beside a template."""
    if name == "flash_fwd_lut_sm90":
        return {fwd_template(kb): lambda: fa.sparse_fwd(fwd_template(kb), q, k, v, lut, kb, ab)}
    if name == "flash_fwd_sm90":
        return {"flash_fwd_biased": lambda: fa.flash_fwd_biased_template(q, k, v, kb, ab, causal)}
    return {}


def padded_rows(kb):
    """The batch rows whose every key a ``mul`` bias pads (NEG_INF)."""
    return [] if kb is None else [b for b in range(kb.shape[0])
                                  if bool((kb[b] <= fa.NEG_INF * 0.5).all())]


# the sm90 backward kernels and the template each is held beside (the dense pair: on the
# biased path, its key-bias instances beside the biased templates)
SM90_TEMPLATES = {"flash_bwd_dkdv_lut_sm90": "flash_bwd_dkdv_lut",
                  "flash_bwd_dq_lut_sm90": "flash_bwd_dq_lut"}
BIASED_TEMPLATES = {"flash_bwd_dkdv_sm90": "flash_bwd_dkdv_biased",
                    "flash_bwd_dq_sm90": "flash_bwd_dq_biased"}


def bwd_templates(q, k, v, do, lut, kb, ab, causal, names):
    """The template design beside a case's sm90 backward kernels (``names``
    as :func:`masked_calls` gives them): ``{sm90 name: (template name,
    call(lse, delta))}``, the LUT templates through
    ``flash_bwd_*_lut_tiled``, the biased ones through
    ``flash_bwd_*_biased_template``."""
    if lut is None:
        pairs = BIASED_TEMPLATES
        calls = (lambda lse, de: fa.flash_bwd_dkdv_biased_template(q, k, v, do, lse, de, kb, ab,
                                                                   causal),
                 lambda lse, de: fa.flash_bwd_dq_biased_template(q, k, v, do, lse, de, kb, ab,
                                                                 causal))
    else:
        pairs = SM90_TEMPLATES
        calls = (lambda lse, de: fa.flash_bwd_dkdv_lut_tiled(q, k, v, do, lse, de, lut, kb, ab),
                 lambda lse, de: fa.flash_bwd_dq_lut_tiled(q, k, v, do, lse, de, lut, kb, ab))
    return {name: (pairs[name], call) for name, call in zip(names[1:], calls) if name in pairs}


def check_masked_case(q, k, v, do, lut, kb, ab, causal, what, held=None):
    """Each kernel of a biased / LUT case against its plain version on the
    same inputs (the backward ones fed the kernel's own O and lse); where
    the forward, dK/dV or dQ routes to its sm90 kernel, the template too
    (:func:`fwd_templates`, :func:`bwd_templates`).
    ``held``: the kernels whose outputs are held (all by default).  On the
    dense biased path a fully padded batch row must read O = 0 and lse =
    NEG_INF exactly in both forwards.  Returns {kernel: [(output, max abs
    error, share of limit)]}."""
    names, calls, plains = masked_calls(q, k, v, do, lut, kb, ab, causal)
    o, lse = calls[0]()
    delta = fa.attention_delta(o, do)
    dk, dv = calls[1](lse, delta)
    dq = calls[2](lse, delta)
    ro, rlse = plains[0]()
    rdk, rdv = plains[1](lse, delta)
    rdq = plains[2](lse, delta)
    pairs = {names[0]: [("o", o, ro), ("lse", lse, rlse)],
             names[1]: [("dk", dk, rdk), ("dv", dv, rdv)],
             names[2]: [("dq", dq, rdq)]}
    forwards = {names[0]: (o, lse)}
    for template, call in fwd_templates(q, k, v, lut, kb, ab, causal, names[0]).items():
        to, tlse = forwards[template] = call()
        pairs[template] = [("o", to, ro), ("lse", tlse, rlse)]
    if lut is None:
        # the dense biased forwards write O = 0 and lse = NEG_INF on a fully padded row
        for name, (fo, flse) in forwards.items():
            for b in padded_rows(kb):
                if fo[b].any() or not (flse[b] == fa.NEG_INF).all():
                    raise AssertionError(f"{name} {what}: batch row {b} has no live key but "
                                         "O != 0 or lse != NEG_INF")
    for name, (template, call) in bwd_templates(q, k, v, do, lut, kb, ab, causal,
                                                names).items():
        got = call(lse, delta)
        pairs[template] = ([("dk", got[0], rdk), ("dv", got[1], rdv)] if name == names[1]
                           else [("dq", got, rdq)])
    torch.cuda.synchronize()
    return {name: [(label, *flash_close(f"{name} {what}", label, got, ref))
                   for label, got, ref in ps]
            for name, ps in pairs.items() if held is None or name in held}


def sparse_cases(H):
    """Phase 7's cases: (T, layout label, config or None, dtype, causal,
    bias kind, head dim, q/k/v layout); :func:`dq_cases` adds the ones
    where only dQ is held, :func:`dense_bias_cases` more of the dense
    biased path."""
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
    # flash_bwd_dkdv_lut_sm90 (and the template beside it) at every layout, T, causal
    # flag, key bias and q/k/v layout its route takes; T=1008 at block 16 only, the
    # empty-rows layout not with "add" (above), and "mul" not causal: with the padded keys,
    # the fully padded row and the keys no causal query reaches, over half of dV is 0,
    # which lowers the rms its limit scales with, while one P that rounds to the other
    # bf16 neighbour (S summed in another order) moves dV by ulp(P) |dO| all the same:
    # at bigbird64 T=1024 both dK/dV kernels, bit-identical there, read 1.0026 of it
    configs = sparse_configs(H) + [("empty-rows", EmptyRowsLayout())]
    for j, ((label, cfg), T, causal, kind) in enumerate(itertools.product(
            configs, (256, 1024, 1008), (False, True), ("none", "add", "mul"))):
        if (T == 1008 and label not in ("fixed16", "empty-rows")) or (
                label == "empty-rows" and kind == "add") or (kind == "mul" and causal):
            continue
        cases.append((T, label, cfg, bf16, causal, kind, 64, views[j % 2]))
    return cases


def dense_bias_cases():
    """Phase 7's further cases of the dense biased path, where the key-bias
    instances of ``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90`` and
    ``flash_bwd_dq_sm90`` are held (and the biased templates beside them):
    bf16, head dim 64, one tile, its ragged neighbour, T=1000 with
    contiguous q/k/v (:func:`sparse_cases` holds its qkv views) and a ragged
    T=1008, ``add`` and ``mul`` key biases, causal and not; then head dim 128
    (the forward's key-bias instance; the backward takes the templates) at
    T 65 and 1000, q/k/v views."""
    return [(T, "dense", None, torch.bfloat16, causal, kind, 64, view)
            for T, kind, causal, view in itertools.product(
                (64, 65, 1000, 1008), ("add", "mul"), (False, True), ("qkv", "dense"))
            if (T, view) != (1000, "qkv")] + [
        (T, "dense", None, torch.bfloat16, causal, kind, 128, "qkv")
        for T, kind, causal in itertools.product((65, 1000), ("add", "mul"), (False, True))]


def dq_cases(H):
    """Phase 7's cases where the forward and dQ (its sm90 kernel and the
    template) are held, not dK/dV: the sm90 sweep's layouts, T and q/k/v
    layouts with ``mul`` and causal masking, which :func:`sparse_cases`
    leaves out for dK/dV."""
    configs = sparse_configs(H) + [("empty-rows", EmptyRowsLayout())]
    return [(T, label, cfg, torch.bfloat16, True, "mul", 64, ("qkv", "dense")[j % 2])
            for j, ((label, cfg), T) in enumerate(itertools.product(configs, (256, 1024, 1008)))
            if T != 1008 or label in ("fixed16", "empty-rows")]


def first_fwd_lut_launch(dev, T=256, H=2, seed=14):
    """The first ``flash_fwd_lut_sm90`` launch (the tutorial layout, B=1,
    a key bias), waited for under SM90_DEADLINE_S and held against its
    plain version with phase 2's limits.  Its inputs come from a generator
    of its own, so the sweep after it draws what it drew before."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lut = fa.layout_luts(build_sparsity_config(SPARSE_SECTION, H).make_layout(T), T, H, False)
    q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, 1, T, H, 64, "qkv")
    kb, _ = bias_inputs("add", gen, 1, T, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o, lse = fa.flash_fwd_lut_sm90(q, k, v, lut, kb)
    ms = wait_first("flash_fwd_lut_sm90", f"T={T}", t0)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    rows = [(label, *flash_close(f"first launch T={T}", label, got, ref))
            for label, got, ref in (("o", o, ro), ("lse", lse, rlse))]
    print(f"flash_fwd_lut_sm90 first launch tutorial16 T={T}: completed in {ms:.1f} ms; "
          f"{flash_line({'': rows})}")


def first_biased_fwd_launch(dev, H=4, seed=19):
    """The first launches of the key-bias instances of ``flash_fwd_sm90``
    (B=2, H=4, head dims 64 and 128, T 33, 65 and 200, causal, an ``add`` and
    a ``mul`` key bias, batch row 1 fully padded with ``mul``, q/k/v views of
    one qkv tensor), each waited for under SM90_DEADLINE_S and held against
    its plain version with phase 2's limits.  Its inputs come from a
    generator of its own."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for d in fa.SM90_HEAD_DIMS[torch.bfloat16]:
        for T, kind in ((33, "add"), (65, "mul"), (200, "add")):
            kb, _ = bias_inputs(kind, gen, 2, T, dev)
            q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, 2, T, H, d, "qkv")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, lse = fa.flash_fwd_sm90(q, k, v, True, key_padding_bias=kb)
            ms = wait_first(f"flash_fwd_sm90 {KEY_BIAS}", f"d={d} T={T}", t0)
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True, key_padding_bias=kb)
            rows = [(label, *flash_close(f"first key-bias launch d={d} T={T}", label, got, ref))
                    for label, got, ref in (("o", o, ro), ("lse", lse, rlse))]
            print(f"flash_fwd_sm90 {KEY_BIAS} first launch d={d} T={T} {kind}: completed in "
                  f"{ms:.1f} ms; {flash_line({'': rows})}")


def first_biased_bwd_launch(dev, H=4, seed=15):
    """The first launches of the key-bias instances of
    ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90`` (B=2, H=4, d=64, T 33,
    65 and 200, causal, an ``add`` key bias, q/k/v views of one qkv tensor,
    fed the plain forward's O and lse), each waited for under
    SM90_DEADLINE_S and held against its plain version with phase 2's
    limits.  Its inputs come from a generator of its own."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    for T in (33, 65, 200):
        kb, _ = bias_inputs("add", gen, 2, T, dev)
        q, k, v, do = flash_inputs(dev, gen, torch.bfloat16, 2, T, H, 64, "qkv")
        o, lse = fa.flash_attention_reference_fwd(q, k, v, True, key_padding_bias=kb)
        delta = fa.attention_delta(o, do)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk, dv = fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, True, key_padding_bias=kb)
        ms = wait_first("flash_bwd_dkdv_sm90 (key bias)", f"T={T}", t0)
        t0 = time.perf_counter()
        dq = fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta, True, key_padding_bias=kb)
        ms_dq = wait_first("flash_bwd_dq_sm90 (key bias)", f"T={T}", t0)
        rdq, rdk, rdv = (fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, True,
                                                             key_padding_bias=kb),
                         *fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True,
                                                                key_padding_bias=kb))
        rows = [(label, *flash_close(f"first key-bias launch T={T}", label, got, ref))
                for label, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq))]
        print(f"flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90 (key bias) first launches T={T}: "
              f"completed in {ms:.1f} / {ms_dq:.1f} ms; {flash_line({'': rows})}")


def check_sparse_kernels(dev, gen, B=2, H=4):
    """Phase 7: every biased and LUT kernel against its plain version, after
    the first ``flash_fwd_lut_sm90`` launch and the first launches of the
    dense sm90 pair's key-bias instances.  :func:`dense_bias_cases` draw
    from a generator of their own, so the phases after this one draw what
    they drew before.  Returns the max abs error per kernel
    (``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90``: their key-bias
    instances)."""
    first_fwd_lut_launch(dev)
    first_biased_fwd_launch(dev)
    first_biased_bwd_launch(dev)
    max_err = {name: 0.0 for name in fa.BIASED_KERNELS + fa.LUT_KERNELS + fa.DENSE_SM90}
    dq_only = ("flash_fwd_lut_sm90", "flash_fwd_lut", "flash_bwd_dq_lut_sm90",
               "flash_bwd_dq_lut")
    for held, cases, gen in ((None, sparse_cases(H), gen), (dq_only, dq_cases(H), gen),
                             (None, dense_bias_cases(),
                              torch.Generator(device=dev).manual_seed(16))):
        for T, label, cfg, dt, causal, kind, d, view in cases:
            lut = None if cfg is None else fa.layout_luts(cfg.make_layout(T), T, H, causal)
            kb, ab = bias_inputs(kind, gen, B, T, dev)
            what = (f"{str(dt)[6:]} d={d} T={T} {label} bias={kind} causal={int(causal)} "
                    f"{view}")
            res = check_masked_case(*flash_inputs(dev, gen, dt, B, T, H, d, view), lut, kb, ab,
                                    causal, what, held)
            for name, rows in res.items():
                max_err[name] = max([max_err[name]] + [err for _, err, _ in rows])
            note = "" if held is None else " (dK/dV not held: its limit here is open)"
            print(f"sparse-check {what}{note}: {flash_line(res)}")
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
    # flash_fwd_lut_sm90, flash_bwd_dkdv_lut_sm90 and flash_bwd_dq_lut_sm90 at BERT-large's
    # head dim 64, with the padding bias (8b: without it)
    head_dim = model.config.hidden_size // model.config.n_head
    fwd = fa.sparse_fwd_kernel(torch.bfloat16, head_dim, False, True)
    fwd_8b = fa.sparse_fwd_kernel(torch.bfloat16, head_dim, False, False)
    dkdv = fa.sparse_dkdv_kernel(torch.bfloat16, head_dim, False)
    dq = fa.sparse_dq_kernel(torch.bfloat16, head_dim, False)
    per_step = {fwd: 2 * L, dkdv: L, dq: L}
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
    by_name = profile_steps(lambda: eng.train_batch(), f"train {preset} sparse16", steps=1,
                            unit="training step")
    for what, pattern, name, template in (
            ("forward", r"\bfwd_lut_sm90_kernel", fwd, "flash_fwd_lut took 87.8"),
            ("dK/dV", r"\bdkdv_", dkdv, "flash_bwd_dkdv_lut took 78.40"),
            ("dQ", r"\bdq_", dq, "flash_bwd_dq_lut took ~38.5")):
        spent = [(t, c) for kname, (t, c) in by_name.items() if re.search(pattern, kname)]
        print(f"profile train {preset} sparse16: {what} device time per step "
              f"{sum(t for t, _ in spent) / 1e3:.2f} ms over {sum(c for _, c in spent):.0f} "
              f"launches ({name}; the template {template} ms a step, PERF.md section 5) "
              f"({card})")
    del eng
    torch.cuda.empty_cache()

    # 8b: unpadded batches (packed sequences): the forward with no bias
    # 8c: "mode": "dense" (an all-ones layout) with padding: the key-bias instances of
    # flash_fwd_sm90 (biased_fwd_kernel) and of flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90
    # (biased_bwd_kernel)
    fwd_8c = fa.biased_fwd_kernel(torch.bfloat16, head_dim, False)
    dkdv_8c, dq_8c = fa.biased_bwd_kernel(torch.bfloat16, head_dim, False)
    for tag, section, padded, want in (
            ("8b", SPARSE_SECTION, False, {fwd_8b: 2 * L, dkdv: L, dq: L}),
            ("8c", {"mode": "dense", "block": 16}, True, {
                fwd_8c: 2 * L, dkdv_8c: L, dq_8c: L})):
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
        if tag == "8c":
            by_name = profile_steps(lambda: eng.train_batch(), f"train {preset} 8c dense",
                                    steps=1, unit="training step")
            spent = {what: [(t, c) for kname, (t, c) in by_name.items()
                            if re.search(pattern, kname)]
                     for what, pattern in (("forward", r"\bfwd_sm90_kernel"),
                                           ("dK/dV", r"\bdense_dkdv_kernel"),
                                           ("dQ", r"\bdense_dq_kernel"))}
            ms = {what: sum(t for t, _ in v) / 1e3 for what, v in spent.items()}
            print(f"profile train {preset} 8c dense: dense biased forward device time per step "
                  f"{ms['forward']:.2f} ms over {sum(c for _, c in spent['forward']):.0f} "
                  f"launches ({fwd_8c} {KEY_BIAS}; the template design took 83.8 ms a step, "
                  f"PERF.md section 5), dense biased backward device time per step "
                  f"{ms['dK/dV'] + ms['dQ']:.2f} ms (" +
                  ", ".join(f"{what} {ms[what]:.2f} ms over {sum(c for _, c in spent[what]):.0f} "
                            f"launches" for what in ("dK/dV", "dQ"))
                  + f"; {dkdv_8c} / {dq_8c}; the template design took 24 x 4.03 ms a step, "
                  f"PERF.md section 6) ({card})")
        del eng
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------- 9. sparse kernels at the shape
def sparse_timing(dev, gen, bytes_per_s, card, B=8, T=2048, H=16, d=64):
    """Phase 9 at the training shape (q, k, v views of one qkv tensor):
    the biased / LUT kernels of four cases, each held against its plain
    version, then timed beside its bound, its plain version and SDPA with
    the expanded boolean layout-and-padding mask (forward, forward+backward
    and the backward alone: ``autograd.grad`` over a retained graph); where
    the forward, dK/dV or dQ takes its sm90 kernel, the template (the
    template design) on the same call beside it; the forwards three
    readings each (median, min, max); then the path's forward+backward
    (``sparse_flash_attention`` under ``autograd.grad``).
    The backward kernels' library time is SDPA's backward alone.  Returns
    {case: {kernel: kernels-line fields}} and the cases' densities."""
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
        lib_out = sdpa(*leaves, attn_mask=mask)
        lib_b = time_ms(lambda _: torch.autograd.grad(lib_out, leaves, doh, retain_graph=True),
                        5, warmup=2)
        del lib_out
        kbytes = 0 if bias is None else B * T * 4
        work = {names[0]: (4 * elem + stat + kbytes, 4 * d * pairs),
                names[1]: (6 * elem + 2 * stat + kbytes, 8 * d * pairs),
                names[2]: (5 * elem + 2 * stat + kbytes, 6 * d * pairs)}
        kernel = {names[0]: calls[0], names[1]: lambda: calls[1](lse, delta),
                  names[2]: lambda: calls[2](lse, delta)}
        plain = {names[0]: plains[0], names[1]: lambda: plains[1](lse, delta),
                 names[2]: lambda: plains[2](lse, delta)}
        timed = list(names)
        # the template design on the same call
        forwards = {names[0]}
        for template, call in fwd_templates(q, k, v, lut, bias, None, False, names[0]).items():
            timed.append(template)
            forwards.add(template)
            work[template], plain[template], kernel[template] = work[names[0]], plain[names[0]], call
        if names[0] == "flash_fwd_lut_sm90":
            groups = lut.groups("q")
            print(f"schedule {case}: {names[0]} {groups.visits_per_head.mean():.0f} visits on "
                  f"{groups.tiles_per_head.mean():.0f} output tiles per head (rows "
                  f"{groups.unit} a slot); the template {fwd_template(bias)} "
                  f"{lut.klen.sum() / lut.heads:.0f} 64 x 64 tiles per head")
        nt = -(-T // fa.TILE)
        for (name, (template, call)), side, tiles in zip(
                bwd_templates(q, k, v, do, lut, bias, None, False, names).items(), "kq",
                ("qlen", "klen")):
            timed.append(template)
            work[template], plain[template] = work[name], plain[name]
            kernel[template] = lambda call=call: call(lse, delta)
            if lut is None:
                print(f"schedule {case}: {name} {nt * nt} visits on {nt} output tiles per head "
                      f"(64 rows each, computed in the kernel); the template {template} "
                      f"{nt * nt} 64 x 64 tiles per head")
                continue
            groups = lut.groups(side)
            print(f"schedule {case}: {name} {groups.visits_per_head.mean():.0f} visits on "
                  f"{groups.tiles_per_head.mean():.0f} output tiles per head (rows "
                  f"{groups.unit} a slot); the template "
                  f"{getattr(lut, tiles).sum() / lut.heads:.0f} 64 x 64 tiles per head")
        out[case] = {}
        for name in timed:
            nbytes, ops = work[name]
            t_bytes, t_ops = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
            bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            if name in forwards:
                reading = repeat_ms(lambda _: kernel[name](), 20)
                ms, shown = reading[0], spread(reading)
            else:
                ms = time_ms(lambda _: kernel[name](), 20, warmup=3)
                shown = f"{ms * 1e3:.2f} us"
            plain_ms = time_ms(lambda _: plain[name](), 2, warmup=1)
            out[case][name] = {
                "max_abs_err": max(e for _, e, _ in res[name]), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                "library_ms": lib_f if name in forwards else lib_b}
            design = " (the template design)" if name not in names else ""
            print(f"timing {name}{design} {what} ({card}): {shown}, bound "
                  f"{bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; "
                  f"{bound / ms:.3f} of it), plain {plain_ms * 1e3:.2f} us; tile density "
                  f"{density[case]['tile']:.3f}, element density "
                  f"{density[case]['element']:.4f}")
        total = sum(out[case][n]["ms"] for n in names)
        # the path: sparse_flash_attention forward and backward, as the model calls it
        layout = np.ones((1, T // 16, T // 16), np.int32) if lut is None else lut.layout
        leaves3 = [x.detach().requires_grad_(True) for x in (q, k, v)]
        path = repeat_ms(lambda _: torch.autograd.grad(fa.sparse_flash_attention(
            *leaves3, layout, causal=False, key_padding_bias=bias), leaves3, do), 5, warmup=2)
        print(f"timing SDPA {case} (B, H, T, d) bf16 with the boolean layout-and-padding "
              f"mask: forward {lib_f * 1e3:.2f} us, forward+backward {lib_fb * 1e3:.2f} us, "
              f"backward alone {lib_b * 1e3:.2f} us; the port's {' + '.join(names)} "
              f"{total * 1e3:.2f} us, its path forward+backward {spread(path)} ({card})")
        del mask, lib, leaves, leaves3
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
INT8_HEAD_M = (127, 128, 129, 272)   # the head's token tiles' edges and two 136-token tiles
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


def first_t_prefill_launch(dev, M=272, seed=21):
    """The first ``int8_mm_t_prefill`` launch: GPT-2 1.3B's head at M
    tokens, per-channel scales, fp32 out, from a generator of its own (so
    the later phases draw what they drew before), waited on under
    SM90_DEADLINE_S and held against the plain version."""
    g = torch.Generator(device=dev).manual_seed(seed)
    N, K = INT8_SHAPES["1.3b"]["wte"]
    q = torch.randint(-128, 128, (N, K), generator=g, device=dev, dtype=torch.int8)
    x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
    scale = (torch.rand((N,), generator=g, device=dev) + 0.5) * 1e-2
    torch.cuda.synchronize()
    before = im.launches["int8_mm_t_prefill"]
    t0 = time.perf_counter()
    got = im.int8_matmul(x, q, scale, w_transposed=True, out_dtype=torch.float32)
    ms = wait_first("int8_mm_t_prefill", f"head M={M}", t0)
    if im.launches["int8_mm_t_prefill"] != before + 1:
        raise AssertionError(f"head M={M}: not launched on int8_mm_t_prefill: {im.launches}")
    err, share = int8_error(got, im.int8_matmul_reference(x, q, scale, w_transposed=True,
                                                          out_dtype=torch.float32))
    print(f"int8_mm_t_prefill first launch head 1.3b M={M}: completed in {ms:.1f} ms, max abs "
          f"error {err:.2e} ({share:.2f} of its limit)")
    if not share <= 1.0:
        raise AssertionError(f"int8_mm_t_prefill first launch: {err} is {share:.2f}x its limit")
    im.launches["int8_mm_t_prefill"] = before   # a checking launch, not a path launch


def check_int8_kernels(dev, gen):
    """Phase 10: the first ``int8_mm_t_prefill`` launch, then the entries
    against the plain version over the 125M and 1.3B weight shapes (the
    head transposed, N = 50257), M in INT8_M (the head also INT8_HEAD_M,
    drawn from a generator of its own) (``int8_mm_nt_decode`` takes the
    block weights at M <= 16, ``int8_mm_nt_prefill`` the rest;
    ``int8_mm_t`` the head at M <= 16, ``int8_mm_t_prefill`` the rest),
    per-tensor scales (and per-channel for the head), bf16 and fp32
    outputs; each output from the kernel its route names, and at every
    M > 16 case from the earlier tiled design (``int8_mm_nt`` /
    ``int8_mm_t``) through ``int8_matmul_tiled`` too; within its limit and
    bit-identical on a second call.  Returns the max abs error per
    kernel."""
    first_t_prefill_launch(dev)
    max_err = {name: 0.0 for name in im.KERNELS.values()}
    saved = dict(im.launches)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    head_gen = torch.Generator(device=dev).manual_seed(22)
    for preset, shapes in INT8_SHAPES.items():
        for wname, (rows, cols) in shapes.items():
            t = wname == "wte"
            q = torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                              dtype=torch.int8)
            K, N = (cols, rows) if t else (rows, cols)
            for M in INT8_M + (INT8_HEAD_M if t else ()):
                g = head_gen if M in INT8_HEAD_M else gen
                name = (im.int8_t_kernel if t else im.int8_nt_kernel)(M, N, K, True)
                x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
                routes = [(name, im.int8_matmul)]
                if name in (im.KERNELS["prefill"], im.KERNELS["t_prefill"]):
                    routes.append((im.KERNELS["t" if t else "nt"], im.int8_matmul_tiled))
                for kind in (("tensor", "channel") if t else ("tensor",)):
                    scale = (torch.rand((N if kind == "channel" else 1,), generator=g,
                                        device=dev) + 0.5) * 1e-2
                    for kname, fn in routes:
                        res = []
                        for od in (torch.bfloat16, torch.float32):
                            before = im.launches[kname]
                            got = fn(x, q, scale, w_transposed=t, out_dtype=od)
                            again = fn(x, q, scale, w_transposed=t, out_dtype=od)
                            ref = im.int8_matmul_reference(x, q, scale, w_transposed=t,
                                                           out_dtype=od)
                            torch.cuda.synchronize()
                            if im.launches[kname] != before + 2:
                                raise AssertionError(f"{preset} {wname} M={M}: not launched on "
                                                     f"{kname}: {im.launches}")
                            if not torch.equal(got, again):
                                raise AssertionError(f"{kname} {preset} {wname} M={M}: two "
                                                     "calls differ")
                            err, share = int8_error(got, ref)
                            if not share <= 1.0:
                                raise AssertionError(f"{kname} {preset} {wname} M={M} {kind} "
                                                     f"{od}: error {err:.3e} is {share:.2f}x "
                                                     "its limit")
                            max_err[kname] = max(max_err[kname], err)
                            res.append(f"{str(od)[6:]} {err:.2e} ({share:.2f})")
                        if kname == "int8_mm_nt_decode":
                            nt, kb, blocks = im.int8_decode_plan(N, K, sms)
                            grid = f"{nt} tiles x {kb} k boxes on {blocks} blocks"
                        elif kname == "int8_mm_nt_prefill":
                            mt, nt, kb, splits, per = im.int8_prefill_plan(M, N, K, sms)
                            grid = (f"{mt} x {nt} tiles x {splits} splits of {per} k boxes "
                                    f"(of {kb})")
                        elif kname == "int8_mm_t_prefill":
                            tm, mt, nt, kb, splits, per = im.int8_t_prefill_plan(M, N, K, sms)
                            grid = (f"{mt} x {nt} tiles of {tm} tokens x 128 rows x {splits} "
                                    f"splits of {per} k boxes (of {kb})")
                        else:
                            tile, splits, _ = im.plan(M, N, K, sms)
                            grid = f"tile {tile} splits {splits}"
                        print(f"int8-check {kname} {preset} {wname} K={K} N={N} M={M} "
                              f"scale={kind} {grid}: {', '.join(res)}; deterministic")
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
INT8_PREFILL_T = 272          # the profiled prefill: about phase 3's mean prompt (274.1 tokens)


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
    ab_serve(engine, prompts, new, f"{preset} int8w", 16, toks_q)
    gc.collect()
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
    token_step = engine._token_steps[(4, 80, False)][0]
    runs = token_step.replays + token_step.warmups      # 15 replays + its warm-up
    # one eager prefill of 4 x 64 rows, the token step's runs of 4 rows, the head each time
    if gen_launches != {"int8_mm_nt_prefill": 4 * c.n_layer, "int8_mm_nt": 0,
                        "int8_mm_nt_decode": runs * 4 * c.n_layer, "int8_mm_t": runs,
                        "int8_mm_t_prefill": 1} or token_step.replays != 15:
        raise AssertionError(f"generate launches {gen_launches} ({runs} token-step runs)")
    # generate's two paths: the captured token step (three calls after the one that
    # captured it) and the eager loop, the same tokens
    gen_ms = {}
    for impl in ("fused", "unroll"):
        c.decode_impl = impl
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.generate(np.stack(gp), max_new_tokens=16).cpu().numpy()[:, 64:]
            walls.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(out, gen_out):
                raise AssertionError(f"generate {impl}: tokens differ from the captured run's")
        gen_ms[impl] = walls
    c.decode_impl = "auto"
    print("generate B=4 T=64 +16, wall ms per call (prefill + 15 token steps; tokens "
          "identical on both paths): " + "; ".join(
              f"{impl} {statistics.median(w):.2f} (readings {', '.join(f'{x:.2f}' for x in w)}"
              f"; spread {max(w) - min(w):.2f})" for impl, w in gen_ms.items()))
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
    by_name = profile_steps(prof.step, f"{preset} int8w")
    paged_device_time(by_name, f"{preset} int8w", c.n_layer)
    # the int8 products' device time per decode step: the block products (decode kernel)
    # and the tied head (int8_matmul.cu's kernel, transposed layout)
    int8_device_time(by_name, preset, "decode step", "int8_decode_kernel", "int8_mm_nt_decode",
                     "int8_mm_kernel", "int8_mm_t")
    # one prefill of the mean prompt (a block multiple: its own bucket) as
    # ServingEngine._start runs it, captured and eager
    T = INT8_PREFILL_T
    toks = np.random.default_rng(2).integers(0, c.vocab_size, (1, T))
    blocks = np.arange(1, 1 + T // cfg.block_size, dtype=np.int64)
    for impl in ("fused", "unroll"):
        c.decode_impl = impl
        step = ServingEngine(engine=engine, config=cfg)._prefill_step(T)

        def prefill():
            with torch.no_grad():
                step(toks=toks, blocks=blocks, t_real=np.int64(T))

        by_name = profile_steps(prefill, f"{preset} int8w prefill T={T} {impl}", steps=4,
                                unit="prefill")
        if impl == "fused":
            int8_device_time(by_name, preset, "prefill", "int8_prefill_kernel",
                             "int8_mm_nt_prefill", "int8_t_prefill_kernel", "int8_mm_t_prefill")
    c.decode_impl = "auto"
    del step
    gc.collect()
    prof_o = ServingEngine(engine=oracle, config=cfg)
    for i, p in enumerate(prompts[:8]):
        prof_o.submit(Request(tokens=p, uid=i))
    profile_steps(prof_o.step, f"{preset} bf16 oracle")
    return launches


def paged_device_time(by_name, tag, layers):
    """The paged-attention kernels' device time per decode step from a
    profile (one launch a layer on the routed kernel)."""
    paged = {name: tn for name, tn in by_name.items()
             if any(k in name for k in ("online_split_kernel", "online_kernel",
                                        "exact_split_kernel", "exact_kernel"))}
    t = sum(tn[0] for tn in paged.values())
    n = sum(tn[1] for tn in paged.values())
    print(f"profile {tag}: paged attention's device time per decode step {t:.1f} us over "
          f"{n:.1f} launches ({layers} layers): " + "; ".join(
              f"{name[:60]} {tn[0]:.1f} us" for name, tn in paged.items()))


def int8_device_time(by_name, preset, unit, kernel, name, head_kernel, head_name):
    """The int8 products' device time per ``unit`` from a profile: the block
    products (``kernel``, entry ``name``), the tied head (``head_kernel``,
    entry ``head_name``) and any other int8 kernel (int8_matmul.cu's tiled
    ones, or the other entry's)."""
    rows = {}
    for k, v in by_name.items():
        if "int8" not in k:
            continue
        key = name if kernel in k else head_name if head_kernel in k else "other int8"
        rows.setdefault(key, []).append(v)
    total = sum(t for vs in rows.values() for t, _ in vs)
    print(f"profile {preset} int8w: int8 products' device time per {unit} {total:.1f} us: "
          + ", ".join(f"{key} {sum(t for t, _ in rows.get(key, [])):.1f} us "
                      f"({sum(n for _, n in rows.get(key, [])):.1f} launches)"
                      for key in (name, head_name, "other int8")))


# ------------------------------------------------------ 12. int8 timing
INT8_TIMING_M = {"block": (8, 272, 512), "head": (8, 272, 512)}
INT8_TIMING_OWN = ("wte", 272)   # drawn from a generator of its own: later phases draw as before


def int8_timing(dev, gen, bytes_per_s):
    """Phase 12 at GPT-2 1.3B's weights, decode (M = 8) and prefill (M = 272,
    the mean prompt, and 512): the kernel each call routes to
    (``int8_mm_nt_decode`` / ``int8_mm_nt_prefill`` for the block weights,
    ``int8_mm_t`` / ``int8_mm_t_prefill`` for the head) held against its
    plain version, then timed with CUDA events (12 block weights cycled, 12x
    the 50 MB L2 at qkv; two 103 MB heads), and beside it (but for the head
    at M = 8, which routes to it) the earlier tiled design (``int8_matmul.cu``, held against the plain
    version too) through ``int8_matmul_tiled``, the two timed in turns
    (routed, tiled, routed, tiled, ...), median of three readings each; the
    bound, the plain version, and yardsticks the int8 path never calls:
    ``torch.matmul`` over the pre-dequantized bf16 weight (the dequantize
    untimed; it reads twice the weight bytes) and, for the head with
    per-channel scales, ``torch._weight_int8pack_mm`` and the port's own
    bf16 head call (``tied_head``'s ``torch.mm`` over the vocab-padded
    weight, fp32 out, the pad included).  Returns the kernels-line fields at
    the shape the main path gives each kernel: qkv at M = 8 (decode), qkv
    at M = 512 (prefill, and the tiled design there), the head at M = 8
    (``int8_mm_t``) and M = 512 (``int8_mm_t_prefill``)."""
    saved = dict(im.launches)
    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    own = torch.Generator(device=dev).manual_seed(23)
    for wname, (rows, cols) in INT8_SHAPES["1.3b"].items():
        t = wname == "wte"
        K, N = (cols, rows) if t else (rows, cols)
        od = torch.float32 if t else torch.bfloat16
        qs = [torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(L_CYCLE if not t else 2)]
        scale = (torch.rand((N if t else 1,), generator=gen, device=dev) + 0.5) * 1e-2
        deq = [(q.float() * (scale[:, None] if t else scale)).to(torch.bfloat16) for q in qs]
        for M in INT8_TIMING_M["head" if t else "block"]:
            name = (im.int8_t_kernel if t else im.int8_nt_kernel)(M, N, K, True)
            g = own if (wname, M) == INT8_TIMING_OWN else gen
            x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(torch.bfloat16)
            n = len(qs)
            before = im.launches[name]
            got = im.int8_matmul(x, qs[0], scale, w_transposed=t, out_dtype=od)
            if im.launches[name] != before + 1:
                raise AssertionError(f"{wname} M={M}: not launched on {name}")
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

            def routed(l):
                return im.int8_matmul(x, qs[l % n], scale, w_transposed=t, out_dtype=od)

            def tiled_call(l):
                return im.int8_matmul_tiled(x, qs[l % n], scale, w_transposed=t, out_dtype=od)

            tiled, tiled_fields = "", None
            if M == 8 and t:                            # the routed kernel is the tiled one
                readings = [time_ms(routed, reps)]
            else:
                tiled_kernel = im.KERNELS["t" if t else "nt"]
                tiled_out = tiled_call(0)
                tiled_err, tiled_share = int8_error(tiled_out, ref)
                if not tiled_share <= 1.0:
                    raise AssertionError(f"{tiled_kernel} {wname} M={M}: {tiled_err} is "
                                         f"{tiled_share:.2f}x its limit")
                readings, tiled_ms = [], []
                for _ in range(3):                      # in turns: routed, tiled, ...
                    readings.append(time_ms(routed, reps))
                    tiled_ms.append(time_ms(tiled_call, reps))
                readings, tiled_ms = sorted(readings), sorted(tiled_ms)
                tiled = (f"; the tiled {tiled_kernel} {tiled_ms[1] * 1e3:.2f} us "
                         f"[{tiled_ms[0] * 1e3:.2f}, {tiled_ms[2] * 1e3:.2f}] "
                         f"({bound / tiled_ms[1]:.3f} of the bound)")
                tiled_fields = {"max_abs_err": tiled_err, "ms": tiled_ms[1]}
            ms = readings[len(readings) // 2]
            plain_ms = time_ms(lambda l: im.int8_matmul_reference(
                x, qs[l % n], scale, w_transposed=t, out_dtype=od), 10, warmup=2)
            lib_ms = time_ms(lambda l: torch.matmul(x, deq[l % n].t() if t else deq[l % n]),
                             reps)
            pack_ms, pack_note, head_note = None, "not timed (block weight: (K, N) layout)", ""
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
                head_ms = time_ms(lambda l: torch.mm(x, _pad_vocab(deq[l % n], 0).t(),
                                                     out_dtype=torch.float32), reps)
                head_note = (f"; the port's bf16 head (torch.mm over the vocab-padded weight, "
                             f"fp32 out, the pad included) {head_ms * 1e3:.2f} us")
            if name == "int8_mm_nt_decode":
                grid = "{} tiles x {} k boxes on {} blocks".format(*im.int8_decode_plan(N, K, sms))
            elif name == "int8_mm_nt_prefill":
                grid = "{} x {} tiles, {} k boxes in {} splits of {}".format(
                    *im.int8_prefill_plan(M, N, K, sms))
            elif name == "int8_mm_t_prefill":
                grid = "{}-token tiles: {} x {} tiles, {} k boxes in {} splits of {}".format(
                    *im.int8_t_prefill_plan(M, N, K, sms))
            else:
                grid = "tile {}, {} splits of {} k tiles".format(*im.plan(M, N, K, sms))
            spread = (f" [{readings[0] * 1e3:.2f}, {readings[-1] * 1e3:.2f}]"
                      if len(readings) > 1 else "")
            print(f"timing {name} 1.3b {wname} M={M} K={K} N={N} out={str(od)[6:]} ({grid}): "
                  f"{ms * 1e3:.2f} us{spread}, bound {bound * 1e3:.2f} us ({by}; "
                  f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.2f} GFLOP, {bound / ms:.3f} of the bound), "
                  f"plain {plain_ms * 1e3:.2f} us, cuBLAS bf16 over the dequantized weight "
                  f"{lib_ms * 1e3:.2f} us ({ms / lib_ms:.2f}x){tiled}; _weight_int8pack_mm: "
                  f"{pack_note}{head_note}")
            fields = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "library_ms": lib_ms}
            if (wname, M) in (("qkv_w", 8), ("qkv_w", 512), ("wte", 8), ("wte", 512)):
                out[name] = fields
            if (wname, M) == ("qkv_w", 512):
                out[im.KERNELS["nt"]] = {**fields, **tiled_fields}
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
# the schedule instances of flash_fwd_sm90 that replace them for bf16 at head dims 64 / 128
BAND_MERGE_SM90 = fa.SCHED_SM90
BAND_MERGE_ROUTE = {"flash_fwd_banded": fa.banded_fwd_kernel,
                    "flash_fwd_merged": fa.merged_fwd_kernel}


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
    for (label, cfg, T, causal), dt in itertools.product(merged_only_layouts(H), (bf16, fp32)):
        cases.append((label, cfg, T, causal, dt, dims[i % 3], views[i % 2],
                      ("flash_fwd_merged",)))
        i += 1
    return cases


def merged_only_layouts(H):
    """The layouts phase 13 runs through the merged kernel alone (no band):
    (label, config, T, causal)."""
    fixed = FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4, num_global_blocks=1,
                                attention="unidirectional")
    per_head = FixedSparsityConfig(num_heads=H, block=16, num_local_blocks=4,
                                   num_global_blocks=1, different_layout_per_head=True,
                                   num_different_global_patterns=4)
    return (("fixed16 causal", fixed, 1024, True),
            ("fixed16 per-head", per_head, 1024, True),
            ("fixed16 per-head", per_head, 1024, False),
            ("bigbird64", sparse_configs(H)[2][1], 1024, False),
            ("empty-rows", EmptyRowsLayout(), 256, True),
            ("empty-rows", EmptyRowsLayout(), 256, False),
            ("alternate-empty-rows", AlternateEmptyRowsLayout(), 512, True))


def band_merge_schedule(layout, T, H, causal, name):
    """The schedule ``flash_fwd_banded`` (the layout's :class:`BandLut`) or
    ``flash_fwd_merged`` (its :class:`MergedLut`) runs over."""
    if name == "flash_fwd_merged":
        return fa.layout_luts(layout, T, H, causal).merged
    st = fa.banded_structure(layout, causal)
    if st is None:
        raise AssertionError("layout is not band-expressible")
    return fa.band_lut(*st, T // layout.shape[1], T)


def band_merge_runs(name, q, k, v, sched):
    """The kernels phase 13 holds for the forward ``name`` on these inputs:
    {kernel: (o, lse)}, the one :data:`BAND_MERGE_ROUTE` names through the
    routed wrapper and, where that is an sm90 instance, the template design
    beside it by name."""
    routed = BAND_MERGE_ROUTE[name](q.dtype, q.shape[-1])
    runs = {routed: getattr(fa, name)(q, k, v, sched)}
    if routed != name:
        runs[name] = getattr(fa, f"{name}_template")(q, k, v, sched)
    return runs


def first_band_merge_launch(dev, seed=22):
    """The first ``flash_fwd_banded_sm90`` and ``flash_fwd_merged_sm90``
    launches, B=1, H=2, d=64, T=512, the
    causal BSLongformer layout at block 32 (a window of 5, globals [0, 3]),
    each waited for under SM90_DEADLINE_S and held against its plain
    version with phase 2's limits, from a generator of its own so later
    phases draw what they drew before."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, T, H, d = 1, 512, 2, 64
    layout = np.asarray(longformer(H, 32, 5, [0, 3]).make_layout(T), np.int32)
    q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    band = band_merge_schedule(layout, T, H, True, "flash_fwd_banded")
    merged = band_merge_schedule(layout, T, H, True, "flash_fwd_merged")
    calls = [("flash_fwd_banded_sm90", band, lambda: fa.flash_fwd_banded_sm90(q, k, v, band)),
             ("flash_fwd_merged_sm90", merged, lambda: fa.flash_fwd_merged_sm90(q, k, v, merged))]
    for name, sched, call in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, lse = call()
        ms = wait_first(name, f"T={T}", t0)
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True, lut=sched)
        rows = [(label, *flash_close(f"{name} first launch", label, got, ref))
                for label, got, ref in (("o", o, ro), ("lse", lse, rlse))]
        print(f"{name} first launch T={T} longformer32: completed in {ms:.1f} ms; "
              f"{flash_line({'': rows})}")


def check_band_merge_kernels(dev, gen, B=2, H=4):
    """Phase 13: the banded and merged forwards against their plain
    versions, O and lse element by element: the kernel each case's route
    names and, beside an sm90 instance, the template design by
    name; then every merged-only layout in bf16 at each sm90 head dim (the
    cases' rotation of head dims sends some to 96), from a generator of its
    own so later phases draw what they drew before.  Returns the max abs
    error per kernel."""
    first_band_merge_launch(dev)
    own = torch.Generator(device=dev).manual_seed(26)
    sm90 = [(label, cfg, T, causal, torch.bfloat16, d, "qkv", ("flash_fwd_merged",), own)
            for (label, cfg, T, causal), d in itertools.product(
                merged_only_layouts(H), fa.SM90_HEAD_DIMS[torch.bfloat16])]
    max_err = {}
    for label, cfg, T, causal, dt, d, view, names, g in (
            [case + (gen,) for case in band_cases(H)] + sm90):
        layout = np.asarray(cfg.make_layout(T), np.int32)
        q, k, v, _ = flash_inputs(dev, g, dt, B, T, H, d, view)
        what = f"{str(dt)[6:]} d={d} T={T} {label} causal={int(causal)} {view}"
        res = {}
        for name in names:
            sched = band_merge_schedule(layout, T, H, causal, name)
            ro, rlse = fa.flash_attention_reference_fwd(q, k, v, sched.causal, lut=sched)
            for kernel, (o, lse) in band_merge_runs(name, q, k, v, sched).items():
                torch.cuda.synchronize()
                res[kernel] = [(label_, *flash_close(f"{kernel} {what}", label_, got, ref))
                               for label_, got, ref in (("o", o, ro), ("lse", lse, rlse))]
                max_err[kernel] = max([max_err.get(kernel, 0.0)]
                                      + [err for _, err, _ in res[kernel]])
        print(f"band-check {what}: " + "; ".join(
            f"{name[10:]} {flash_line({name: rows})}" for name, rows in res.items()))
    return max_err


def check_band_merge_seeds(dev, seeds=(23, 24, 25), B=1, H=8, d=64):
    """Phase 13: the two sm90 instances' O and lse against their plain
    versions over three seeds (generators of their own) at phase 14's
    shapes at T <= PLAIN_T_MAX, phase 2's limits: no single draw decides
    the forward's limit.  Returns the largest share of a limit per
    kernel."""
    worst = {name: 0.0 for name in BAND_MERGE_SM90}
    for block, T in itertools.product(WORKLOAD_BLOCKS, WORKLOAD_T):
        if T > PLAIN_T_MAX:
            continue
        layout = np.asarray(workload_config(H, block).make_layout(T), np.int32)
        scheds = {"flash_fwd_banded_sm90": band_merge_schedule(layout, T, H, True,
                                                               "flash_fwd_banded"),
                  "flash_fwd_merged_sm90": band_merge_schedule(layout, T, H, True,
                                                               "flash_fwd_merged")}
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            q, k, v, _ = flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
            shares = {}
            for name, sched in scheds.items():
                o, lse = getattr(fa, name)(q, k, v, sched)
                ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True, lut=sched)
                torch.cuda.synchronize()
                shares[name] = [flash_close(f"{name} seed {seed} T={T}", label, got, ref)[1]
                                for label, got, ref in (("o", o, ro), ("lse", lse, rlse))]
                worst[name] = max([worst[name]] + shares[name])
                del ro, rlse
            print(f"band-seeds B={B} T={T} H={H} d={d} bf16 block {block} seed {seed}: " +
                  "; ".join(f"{name} o {sh[0]:.2f} lse {sh[1]:.2f} of the limit"
                            for name, sh in shares.items()))
            del q, k, v
        torch.cuda.empty_cache()
    return worst


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
    dkdv, dqk = fa.dense_bwd_kernel(q.dtype, d)
    check_launches("flash_attention_with_lse", dict(fa.launches), {fwd: 1, dkdv: 1, dqk: 1}, 1)
    o, lse = o.detach(), lse.detach()
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True)
    delta = fa.attention_delta(o, w) - u
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, w, lse, delta, True)
    rdq = fa.flash_attention_reference_bwd_dq(q, k, v, w, lse, delta, True)
    rows = [(label, *flash_close(f"flash_attention_with_lse {label}", label, got, ref))
            for label, got, ref in (("o", o, ro), ("lse", lse, rlse), ("dq", leaves[0].grad, rdq),
                                    ("dk", leaves[1].grad, rdk), ("dv", leaves[2].grad, rdv))]
    print(f"flash_attention_with_lse B={B} T={T} H={H} d={d} causal bf16, loss on out and "
          f"lse: launches {fwd} 1, {dkdv} 1, {dqk} 1; {flash_line({'': rows})}")

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
    (the banded route) or ``sparse_flash_attention(block_q_merge=2)``:
    one launch each of the forward its route names (the sm90 instance),
    ``flash_bwd_dkdv_lut_sm90`` and ``flash_bwd_dq_lut_sm90``, none of any
    other flash kernel.  Returns (out, launches)."""
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
    fwd = BAND_MERGE_ROUTE[f"flash_fwd_{route}"](q.dtype, d)
    check_launches(f"{route} path", counts, {fwd: 1, "flash_bwd_dkdv_lut_sm90": 1,
                                             "flash_bwd_dq_lut_sm90": 1}, 1)
    return out.detach(), counts


def check_path(route, name, sched, lut, leaf, do, out, B, T, H, d, what):
    """The path's O (the kernel again gives the same bits), lse and
    gradients against the plain versions at T <= PLAIN_T_MAX (the backward
    ones fed the kernel's O and lse), and the template design's O and lse beside
    them; above, O and lse against the ring.  Returns the rows of
    ``flash_line`` for the routed kernel and for the template design."""
    q, k, v = (t.detach().view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
    dq, dk, dv = (g.view(B, T, H, d) for g in leaf.grad.split(H * d, dim=-1))
    o, lse = getattr(fa, f"flash_fwd_{route}")(q, k, v, sched)
    to, tlse = getattr(fa, f"flash_fwd_{route}_template")(q, k, v, sched)
    if not torch.equal(o, out):
        raise AssertionError(f"{what}: a second {name} launch gives other bits")
    if T <= PLAIN_T_MAX:
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, sched.causal, lut=sched)
        delta = fa.attention_delta(o, do)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut)
        rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut)
        pairs = (("o", o, ro), ("lse", lse, rlse), ("dq", dq, rdq), ("dk", dk, rdk),
                 ("dv", dv, rdv))
        tpairs = (("o", to, ro), ("lse", tlse, rlse))
    else:
        ro, rlse = fa.flash_fwd_lut_ring(q, k, v, lut)
        if not all(torch.isfinite(g).all() for g in (dq, dk, dv)):
            raise AssertionError(f"{what}: gradients not finite")
        pairs = (("o vs ring", o, ro), ("lse vs ring", lse, rlse))
        tpairs = (("o vs ring", to, ro), ("lse vs ring", tlse, rlse))
    torch.cuda.synchronize()
    return [[(label, *flash_close(f"{kernel} {what}", label.split()[0], got, ref))
             for label, got, ref in ps]
            for kernel, ps in ((name, pairs), (f"flash_fwd_{route}", tpairs))]


def turns_ms(fns, n, rounds=3, warmup=3):
    """Each of ``fns`` timed with :func:`time_ms` in turns (one reading of
    each, then the next round): {label: (median, min, max)}."""
    ms = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            ms[label].append(time_ms(fn, n, warmup=warmup))
    return {label: (sorted(r)[len(r) // 2], min(r), max(r)) for label, r in ms.items()}


def time_path(dev, route, name, sched, lut, layout, attn, leaf, do, B, T, H, d, causal,
              bytes_per_s, card):
    """Phase 14 timing at one shape: the routed kernel and the template design in
    turns (three readings each), its bound, its plain version (T <= PLAIN_T_MAX), the LUT ring and
    ``flash_fwd_lut_sm90`` on the same LUT, the dense causal forward, SDPA
    with the expanded boolean layout mask and SDPA ``is_causal``; the
    path's forward+backward against SDPA's with the mask.  Returns the
    kernels-line fields of the routed kernel and of the template design."""
    q, k, v = (t.detach().view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
    template = f"flash_fwd_{route}"
    block = T // layout.shape[1]
    pairs = layout_pairs(layout, causal, block) * B * (H // layout.shape[0])
    nbytes, ops = 4 * B * T * H * d * 2 + B * H * T * 4, 4 * d * pairs
    t_b, t_o = nbytes / bytes_per_s * 1e3, ops / PEAK_OPS["bf16"] * 1e3
    bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    n = 20
    turns = turns_ms({name: lambda _: getattr(fa, template)(q, k, v, sched),
                      template: lambda _: getattr(fa, f"{template}_template")(q, k, v, sched)}, n)
    ring = repeat_ms(lambda _: fa.flash_fwd_lut_ring(q, k, v, lut), n)
    lut_sm90 = repeat_ms(lambda _: fa.flash_fwd_lut_sm90(q, k, v, lut), n)
    dense = repeat_ms(lambda _: fa.flash_fwd(q, k, v, causal), n)
    plain_ms = time_ms(lambda _: fa.flash_attention_reference_fwd(
        q, k, v, sched.causal, lut=sched), 2, warmup=1) if T <= PLAIN_T_MAX else None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    mask = lut.element_mask(dev)[None]                       # (1, Lh, T, T)
    o, _ = getattr(fa, template)(q, k, v, sched)
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
          f"({card}): {spread(turns[name])}, {bound / turns[name][0]:.3f} of the bound; "
          f"the template design {template} in turns {spread(turns[template])}; "
          f"bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, "
          f"{ops / 1e9:.2f} GFLOP, {pairs} live pairs); plain {plain_note}; "
          f"flash_fwd_lut_ring {spread(ring)}; flash_fwd_lut_sm90 {spread(lut_sm90)}; dense "
          f"{'causal ' * causal}{fa.dense_fwd_kernel(q.dtype, d)} {spread(dense)}; SDPA "
          f"with the layout mask {spread(lib)}; SDPA is_causal {spread(lib_causal)}")
    print(f"timing {route} path forward+backward B={B} T={T} block {block}: {spread(fb)}; "
          f"SDPA forward+backward with the layout mask {spread(lib_fb)}")
    if not turns[name][0] < turns[template][0]:
        print(f"NOTE {name} B={B} T={T} block {block}: {spread(turns[name])} does not read "
              f"below the template design {template} {spread(turns[template])}")
    del mask, leaves
    return {kernel: {"ms": turns[kernel][0], "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib[0]} for kernel in (name, template)}


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
    ``line_shape``}) for the sm90 instances and the template designs."""
    print(f"{card}; host CPU {host_cpu()}")
    saved = dict(fa.launches)
    total = {name: 0 for name in BAND_MERGE + BAND_MERGE_SM90}
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
            name = BAND_MERGE_ROUTE[f"flash_fwd_{route}"](torch.bfloat16, d)
            leaf = qkv.detach().clone().requires_grad_(True)
            out, counts = path_run(route, attn if route == "banded" else layout, leaf, do,
                                   B, T, H, d)
            for kernel in total:
                total[kernel] += counts[kernel]
            what = f"B={B} T={T} H={H} d={d} bf16 block {block}"
            rows, trows = check_path(route, name, sched, lut, leaf, do, out, B, T, H, d, what)
            print(f"sparse-path {route} {what} (W={W}, {len(gcols)} gcols, kernel gcols "
                  f"{list(band.kernel_gcols)}): launches {name} 1, flash_bwd_dkdv_lut_sm90 1, "
                  f"flash_bwd_dq_lut_sm90 1, flash_fwd_{route} 0, flash_fwd_lut_ring 0; "
                  f"{flash_line({name: rows})}; the template design flash_fwd_{route} "
                  f"{flash_line({'': trows})}")
            fields = time_path(dev, route, name, sched, lut, layout, attn, leaf, do, B, T, H,
                               d, True, bytes_per_s, card)
            if (block, T) == line_shape:      # the forward kernels' own outputs
                for kernel, kr in ((name, rows), (f"flash_fwd_{route}", trows)):
                    line[kernel] = {"max_abs_err": max(e for label, e, _ in kr
                                                       if label in ("o", "lse")),
                                    **fields[kernel]}
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
    for kernel in total:
        total[kernel] += counts[kernel]
    name = fa.merged_fwd_kernel(torch.bfloat16, d)
    what = f"B={B} T={T} H={H} d={d} bf16 tutorial16 non-causal"
    rows, trows = check_path("merged", name, lut.merged, lut, leaf, do, out, B, T, H, d, what)
    print(f"sparse-path merged {what}: launches {name} 1, flash_bwd_dkdv_lut_sm90 1, "
          f"flash_bwd_dq_lut_sm90 1, flash_fwd_merged 0; {flash_line({name: rows})}; the template "
          f"design flash_fwd_merged {flash_line({'': trows})}")
    time_path(dev, "merged", name, lut.merged, lut, layout, None, leaf, do, B, T, H, d, False,
              bytes_per_s, card)
    fa.launches.update(saved)          # timing launches are not path launches
    del qkv, do, leaf, out
    torch.cuda.empty_cache()
    return total, line

CKPT_WARMUP_STEPS = 10      # phase 15's WarmupLR warm-up: the lr moves at every step it runs
CKPT_TIMED = 3              # saves and loads timed in phase 15 (the median is reported)


def host_rss_bytes():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssPeak:
    """The peak resident set size of this process while the ``with``
    block runs, sampled every 2 ms by a thread (``base``: before it)."""

    def __enter__(self):
        self.base = self.peak = host_rss_bytes()
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.002):
                self.peak = max(self.peak, host_rss_bytes())

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, host_rss_bytes())


def ckpt_state(eng):
    """The engine's checkpointed tensors by group, in tree order."""
    return {"params": tree_leaves(eng.params), "master": tree_leaves(eng.master),
            "exp_avg": tree_leaves(eng.opt_state.exp_avg),
            "exp_avg_sq": tree_leaves(eng.opt_state.exp_avg_sq)}


def host_snapshot(eng):
    return {k: [t.detach().to("cpu", copy=True) for t in v] for k, v in ckpt_state(eng).items()}


def check_restored(tag, eng, snap):
    """Every leaf of ``eng`` ``torch.equal`` to the snapshot; returns the
    number of leaves held."""
    n = 0
    for group, leaves in ckpt_state(eng).items():
        if len(leaves) != len(snap[group]):
            raise AssertionError(f"{tag}: {group} has {len(leaves)} leaves, "
                                 f"saved {len(snap[group])}")
        for i, (t, s) in enumerate(zip(leaves, snap[group])):
            if t.dtype != s.dtype or not torch.equal(t.cpu(), s):
                raise AssertionError(f"{tag}: {group} leaf {i} differs from the saved one")
            n += 1
    return n


def ckpt_counters(eng):
    return {"global_steps": eng.global_steps, "optimizer_steps": eng.optimizer_steps,
            "skipped_steps": eng.skipped_steps, "micro_steps": eng.micro_steps,
            "global_samples": eng.global_samples, "stream_step": eng._stream_step,
            "lr": eng.get_lr()[0], "lr_scheduler": eng.lr_scheduler.state_dict(),
            "loader": eng.training_dataloader.state_dict()}


def record_batches(eng):
    """The token batch of each step ``eng`` takes, as the loader gave it."""
    seen = []
    stack = eng._stack_microbatches

    def recorded(micro_batches):
        seen.append(np.stack([np.asarray(mb[0]) for mb in micro_batches]))
        return stack(micro_batches)

    eng._stack_microbatches = recorded
    return seen


class CallTimes:
    """Wall seconds spent in the named functions of ``module`` while the
    ``with`` block runs, summed by name (the functions are wrapped, then
    restored)."""

    def __init__(self, module, names):
        self.module, self.names, self.s = module, names, {n: 0.0 for n in names}

    def __enter__(self):
        self._saved = {n: getattr(self.module, n) for n in self.names}

        def wrap(name, fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.s[name] += time.perf_counter() - t0
            return timed

        for name, fn in self._saved.items():
            setattr(self.module, name, wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)


def same_batches(tag, got, want):
    if len(got) != len(want) or not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{tag}: the steps took other batches")


def checkpoint_resume(dev, card, preset="gpt2-350m", seq=1024, micro=8, steps=3,
                      timed=CKPT_TIMED, new=8):
    """Phase 15: training -> save -> resume -> serve at phase 5's
    configuration with WarmupLR.  Run A trains ``steps`` steps, saves,
    trains ``steps`` more, reloads its own checkpoint and repeats them (the
    repeat difference); run B, from other weights (seed 1), loads the
    checkpoint and trains the same steps.  Returns the phase's figures."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    config = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
                  scheduler={"type": "WarmupLR", "params": {
                      "warmup_num_steps": CKPT_WARMUP_STEPS, "warmup_max_lr": 6e-4}})

    def model():
        return GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                    embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0, remat=False,
                    attention_impl="flash")

    def engine(seed):
        m = model()
        eng = deepspeed_tpu_torch.initialize(config=config, model=m,
                                             params=m.init_numpy(seed=seed),
                                             training_data=(tokens,))[0]
        return eng, record_batches(eng)

    def run(eng):
        return [float(eng.train_batch()) for _ in range(steps)]

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    save_dir = os.path.join(root, "run")
    tag = f"global_step{steps}"
    try:
        # run A: train, save, train on; then reload and repeat the same steps
        a, a_batches = engine(0)
        run(a)
        a.save_checkpoint(save_dir)
        snap = host_snapshot(a)
        counters = ckpt_counters(a)
        ref_params = tree_map(lambda t: t.detach().to("cpu", copy=True), a.params)
        run1 = run(a)
        a.load_checkpoint(save_dir)
        check_restored("checkpoint repeat", a, snap)
        if ckpt_counters(a) != counters:
            raise AssertionError(f"repeat counters {ckpt_counters(a)} != {counters}")
        run2 = run(a)
        same_batches("checkpoint repeat", a_batches[2 * steps:], a_batches[steps:2 * steps])
        if run2[0] != run1[0]:
            raise AssertionError(f"repeat step {steps + 1} loss {run2[0]!r} != {run1[0]!r}")
        repeat_diff = max(abs(x - y) for x, y in zip(run1[1:], run2[1:]))
        head_dim = a.module.config.n_embd // a.module.config.n_head
        n_layer = a.module.config.n_layer
        del a
        gc.collect()
        torch.cuda.empty_cache()

        # run B: other weights, load, train the same steps
        b, b_batches = engine(1)
        if torch.equal(b.params["wte"].cpu(), ref_params["wte"]):
            raise AssertionError("run B starts from run A's weights")
        path, _ = b.load_checkpoint(save_dir)
        if os.path.basename(path) != tag:
            raise AssertionError(f"loaded {path}, expected the tag {tag}")
        n_leaves = check_restored("checkpoint load", b, snap)
        if ckpt_counters(b) != counters:
            raise AssertionError(f"loaded counters {ckpt_counters(b)} != {counters}")
        fa.reset_launches()
        run_b = run(b)
        counts = dict(fa.launches)
        per_step = {name: n_layer for name in (fa.dense_fwd_kernel(torch.bfloat16, head_dim),
                                               *fa.dense_bwd_kernel(torch.bfloat16, head_dim))}
        check_launches(f"checkpoint resume {preset}", counts, per_step, steps)
        same_batches("checkpoint load", b_batches, a_batches[steps:2 * steps])
        if run_b[0] != run1[0]:
            raise AssertionError(f"step {steps + 1} loss after load {run_b[0]!r} != "
                                 f"{run1[0]!r}")
        load_diff = max(abs(x - y) for x, y in zip(run1[1:], run_b[1:]))
        if load_diff > repeat_diff:
            raise AssertionError(f"steps {steps + 2}-{2 * steps} after load differ by "
                                 f"{load_diff!r}, a repeat by {repeat_diff!r}")
        print(f"checkpoint {preset} T={seq} micro {micro} bf16 zero1 WarmupLR: {n_leaves} "
              f"leaves (params, master, exp_avg, exp_avg_sq) torch.equal after load and after "
              f"the repeat's reload; counters, lr {counters['lr']!r}, loader "
              f"{counters['loader']} equal; steps {steps + 1}-{2 * steps} losses A {run1} "
              f"repeat {run2} B {run_b}; step {steps + 1} bit-equal; steps {steps + 2}-"
              f"{2 * steps} max |B - A| {load_diff!r} <= max |repeat - A| {repeat_diff!r}; "
              f"launches per step after load " + ", ".join(
                  f"{n} {counts[n] // steps}" for n in fa.DENSE_KERNELS))

        # serving from the checkpoint against the in-memory weights of step `steps`
        ids = np.random.default_rng(15).integers(0, vocab, (2, 32))
        ref = InferenceEngine(GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16,
                                   device=dev), params=ref_params)
        ck = InferenceEngine(GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16,
                                  device=dev), checkpoint=save_dir)
        for x, y in zip(tree_leaves(ref.params), tree_leaves(ck.params)):
            if not torch.equal(x, y):
                raise AssertionError("InferenceEngine(checkpoint=) params differ")
        want = ref.generate(ids, max_new_tokens=new)
        got = ck.generate(ids, max_new_tokens=new)
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"generate from the checkpoint {got[:, 32:].tolist()} != "
                                 f"{want[:, 32:].tolist()}")
        cfg = ServingConfig(batch_slots=2, block_size=16, max_new_tokens=new)
        prompts = list(ids)
        _, _, toks_ref = run_checked(ServingEngine(engine=ref, config=cfg), ref, prompts,
                                     new, "checkpoint-ref", "auto")
        _, served, toks = run_checked(ServingEngine(engine=ck, config=cfg), ck, prompts,
                                      new, "checkpoint", "auto")
        if toks != toks_ref:
            raise AssertionError(f"served from the checkpoint {toks} != {toks_ref}")
        print(f"checkpoint serve {preset}: generate B=2 T=32 +{new} tokens equal to the "
              f"in-memory step-{steps} weights' {got[:, 32:].tolist()}; served streams equal "
              f"too ({pa.KERNELS['online']} {served[pa.KERNELS['online']]} launches)")
        del ref, ck
        torch.cuda.empty_cache()

        # a torn tag: a save crashed before its commit is never loaded
        fault.configure("crash_at=ckpt.before_commit")
        try:
            b.save_checkpoint(save_dir)
            raise AssertionError("the armed save did not crash")
        except fault.InjectedCrash:
            pass
        finally:
            fault.reset()
        torn = f"global_step{2 * steps}"
        if not os.path.isdir(atomic.stage_path(save_dir, torn)) or \
                os.path.isdir(os.path.join(save_dir, torn)) or \
                atomic.read_latest(save_dir) != tag:
            raise AssertionError(f"torn save left {sorted(os.listdir(save_dir))}, latest "
                                 f"{atomic.read_latest(save_dir)}")
        path, _ = b.load_checkpoint(save_dir)
        if os.path.basename(path) != tag or b.global_steps != steps:
            raise AssertionError(f"after the torn save loaded {path} at {b.global_steps}")
        atomic.clean_stale_staging(save_dir)
        print(f"checkpoint torn tag: {torn}.tmp staged and crashed at ckpt.before_commit; "
              f"latest {tag}, load_checkpoint took {tag}")

        # sizes, save and load times, host memory during a save
        sizes = {name: os.path.getsize(os.path.join(save_dir, tag, name))
                 for name in (MODEL_FILE, OPTIM_FILE)}
        # where a save's and a load's seconds go: the two files' writes (device to
        # host, zip, page cache), the manifest's SHA-256, the commit's fsync and
        # rename; the manifest check, the two files' reads, the rest (the copies
        # to the card)
        save_s, rss, save_parts = [], [], []
        for i in range(timed):
            d = os.path.join(root, f"timed{i}")
            torch.cuda.synchronize()
            with RssPeak() as r, CallTimes(engine_module, ("save_tree",)) as w, \
                    CallTimes(atomic, ("write_manifest", "commit_staged")) as c:
                t0 = time.perf_counter()
                b.save_checkpoint(d)
                save_s.append(time.perf_counter() - t0)
            save_parts.append({**w.s, **c.s})
            rss.append((r.base, r.peak))
            shutil.rmtree(d)
        load_s, load_parts = [], []
        for _ in range(timed):
            torch.cuda.synchronize()
            with CallTimes(engine_module, ("load_tree",)) as rd, \
                    CallTimes(atomic, ("verify_checkpoint",)) as v:
                t0 = time.perf_counter()
                b.load_checkpoint(save_dir)
                torch.cuda.synchronize()
                load_s.append(time.perf_counter() - t0)
            load_parts.append({**v.s, **rd.s})
        base, peak = max(rss, key=lambda bp: bp[1] - bp[0])
        med = lambda parts: {k: statistics.median(p[k] for p in parts) for k in parts[0]}
        figures = {"model_file_bytes": sizes[MODEL_FILE], "optim_file_bytes": sizes[OPTIM_FILE],
                   "save_s": statistics.median(save_s), "save_s_readings": save_s,
                   "save_parts_s": med(save_parts),
                   "load_s": statistics.median(load_s), "load_s_readings": load_s,
                   "load_parts_s": med(load_parts),
                   "save_rss_peak_bytes": peak, "save_rss_base_bytes": base,
                   "repeat_diff": repeat_diff, "load_diff": load_diff,
                   "losses": {"a": run1, "repeat": run2, "b": run_b}}
        parts = lambda d: ", ".join(f"{k} {v:.3f}" for k, v in d.items())
        print(f"checkpoint timing {preset}: model file {sizes[MODEL_FILE]} B, optim file "
              f"{sizes[OPTIM_FILE]} B; save (fsync, sha256 manifest, commit) median "
              f"{figures['save_s']:.3f} s of {[round(x, 3) for x in save_s]} (medians: "
              f"{parts(figures['save_parts_s'])}); load (full verify, warm page cache) median "
              f"{figures['load_s']:.3f} s of {[round(x, 3) for x in load_s]} (medians: "
              f"{parts(figures['load_parts_s'])}); host RSS during a save peaks at "
              f"{peak / 1e9:.3f} GB, {(peak - base) / 1e6:.1f} MB above the "
              f"{base / 1e9:.3f} GB before it ({card})")
        return figures
    finally:
        fault.reset()
        shutil.rmtree(root, ignore_errors=True)


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
    srv16, online, toks16 = serve(engine, prompts, 32, "kv16", 16, "auto")
    srv8, _, _ = serve(engine, prompts, 32, "kv8", 8, "auto")
    _, launches, toks_exact = serve(engine, prompts, 32, "kv16-exact", 16, "exact")
    # the exact run's counts (the split kernel's; the first design's 0), the online run's own
    launches[pa.KERNELS["online"]] = online[pa.KERNELS["online"]]
    same = sum(toks16[u] == toks_exact[u] for u in toks16)
    print(f"exact-kernel streams identical to online-kernel streams: "
          f"{same}/{len(prompts)}")
    model.config.paged_attention_mode = "auto"
    # the captured steps (the default) against the same bodies run eagerly
    ab_serve(engine, prompts, 32, "kv16", 16, toks16)
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
               for name in (*pa.KERNELS.values(), *pa.TEMPLATES.values())]
    print(json.dumps({"int8_pool_timing": {k: t8[k] for k in (
        "kernels_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "shape")}}))
    print(json.dumps({"bf16_pool_shape": t16["shape"]}))
    for tag, srv in (("kv16", srv16), ("kv8", srv8)):
        paged_device_time(profile_steps(srv.step, tag), tag, model.config.n_layer)
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
    ts, density = sparse_timing(dev, gen, bw, card)
    print(json.dumps({"sparse_timing": ts, "density": density}))
    # the kernels line: each kernel at the shape its main-path run gives it
    # (8: the tutorial layout with padding; 8b: without; 8c: dense with padding)
    for name, case, run in (
            ("flash_fwd_biased", "dense+pad", "8c"),                # the template design: 0
            ("flash_bwd_dkdv_biased", "dense+pad", "8c"),           # the template design: 0
            ("flash_bwd_dq_biased", "dense+pad", "8c"),             # the template design: 0
            ("flash_fwd_lut", "tutorial16+pad", "8"),               # the template design: 0
            ("flash_fwd_lut_ring", "tutorial16", "8b"),             # the template design: 0
            ("flash_fwd_lut_sm90", "tutorial16+pad", "8"),
            ("flash_bwd_dkdv_lut", "tutorial16+pad", "8"),         # the template design: 0
            ("flash_bwd_dkdv_lut_sm90", "tutorial16+pad", "8"),
            ("flash_bwd_dq_lut", "tutorial16+pad", "8"),           # the template design: 0
            ("flash_bwd_dq_lut_sm90", "tutorial16+pad", "8")):
        kernels.append({"name": name, "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": bert_launches[run][name],
                        **ts[case][name]})
    # the key-bias instances of the dense sm90 kernels (one launch count per entry: 8c's run)
    for name in fa.DENSE_SM90:
        kernels.append({"name": f"{name} {KEY_BIAS}", "route": "cuda",
                        "source": flash_source(name), "replaces": REPLACES[f"{name} {KEY_BIAS}"],
                        "launches": bert_launches["8c"][name], **ts["dense+pad"][name]})

    # 10. int8 kernels vs plain; 11. int8 serving of GPT-2 1.3B; 12. int8 timing
    int8_err = check_int8_kernels(dev, gen)
    print(json.dumps({"int8_sweep_max_abs_err": int8_err}))
    int8_launches = int8_serving(dev, card, prompts)
    torch.cuda.empty_cache()
    ti = int8_timing(dev, gen, bw)
    for name in im.KERNELS.values():
        kernels.append({"name": name, "route": "cuda", "source": INT8_SOURCES[name],
                        "replaces": REPLACES[name], "launches": int8_launches[name],
                        **ti[name]})
    torch.cuda.empty_cache()

    # 13. banded and merged kernels vs plain, flash_attention_with_lse;
    # 14. the causal block-sparse path at the sparse workload, with timing
    band_err = check_band_merge_kernels(dev, gen)
    print(json.dumps({"band_merge_sweep_max_abs_err": band_err}))
    check_flash_lse(dev, gen)
    torch.cuda.empty_cache()
    print(json.dumps({"band_merge_seeds_largest_share": check_band_merge_seeds(dev)}))
    band_launches, tb = sparse_workload(dev, gen, card, bw)
    for name in BAND_MERGE + BAND_MERGE_SM90:
        kernels.append({"name": name, "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": band_launches[name],
                        **tb[name]})
    torch.cuda.empty_cache()

    # 15. checkpoints: train -> save -> resume -> serve at phase 5's configuration
    print(json.dumps({"checkpoint": checkpoint_resume(dev, card)}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
