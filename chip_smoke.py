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
   S = 1024 (and 320 for bf16), and the two routed kernels with windows
   that cross the table's end (lengths S - W + 1 and S - 1 for W 5 and 8,
   the three pools, their own generator); then the
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
   graphs and the memory of their pool (and what each graph's capture
   added), and a profiled decode step (wall, busy and idle shares, the
   copies' device time: the tied head reads a copy of ``wte`` padded once,
   so no step copies the 77 MB table), then one decode step of each on the
   same seated state (max |delta logits|); one decode step's logits
   through the kernels are held against the ``gather`` path; each serve
   prints its first request's TTFT (its bucket's warm-up and capture
   included) beside the TTFT p50;
4. timing: each paged kernel, its plain version and a library yardstick
   (``scaled_dot_product_attention`` over pre-gathered K/V, which the port
   never calls) with CUDA events at the phase-3 shape, beside the least
   time the card could take (the bytes the call must move over the
   card's memory rate) and its share of it; each mode's two designs in
   turns (first design, split, split, first design), each the least of its
   readings; the same at phase 16's window (W = 5) on the same seated
   state, its q from a generator of its own; the paged kernels' device
   time per decode step from the kv16 and kv8 profiles (and phase 11's);
5. training: GPT-2 350M at full width (T=1024, micro-batch 8, gas 1,
   bf16, ZeRO-1, AdamW 6e-4 / wd 0.1, clip 1.0, dropout 0, no remat)
   through ``deepspeed_tpu_torch.initialize`` -> ``train_batch()`` on
   tokens ``rng(0).integers(0, 50257, (64, 1025))``, through both
   step impls from the same weights and data (``ab_train``): "graph"
   (the whole step one CUDA graph, the default on the card) and "eager"
   (the same body called directly).  Step 1 of the captured run with
   ``attention_impl="flash"`` against an eager ``"jnp"`` one from the same
   weights and batch; for each impl 3 warm-up steps and 3 timed passes of
   10 steps (step time p50/p99, tokens/s, MFU per pass, the readings and
   their spread; peak memory; the graphs, their captures, warm-ups and
   replays and the graph pool's MB); exactly 24 launches of
   ``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90`` per
   kernel run (a replay or the warm-up when captured, a step when eager),
   and none of ``flash_fwd``, ``flash_bwd_dkdv`` and ``flash_bwd_dq``;
   finite losses and no skipped step; a ``torch.profiler`` breakdown of a
   step of each, its busy time against the unprofiled step p50 (the idle
   share); the losses and grad norms of every step bit-equal between the
   impls; on the captured engine, 20 steps on one fixed batch lower its
   loss by at least 0.5, and the flash kernels' device time per step; then
   3 steps each with Lamb and with SGD (Nesterov) in place of AdamW,
   captured and eager (one graph, exact launches, bit-equal losses and
   grad norms);
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
   seed, through both step impls as phase 5 (the dropout masks of
   the captured step drawn from generators registered with the graph and
   re-seeded before each replay, so every loss and grad norm is bit-equal
   to the eager run's): step 1 of the captured run through the kernels
   against an eager step 1 with the plain ``_masked_dense`` attention from
   the same weights and batch; 3 warm-up steps and 3 timed passes of 10
   (tokens/s, step p50/p99, MFU, peak memory, graphs, profiled busy time
   and idle share); exactly 48 / 24 / 24 launches per kernel run of
   ``flash_fwd_lut_sm90`` /
   ``flash_bwd_dkdv_lut_sm90`` / ``flash_bwd_dq_lut_sm90`` (remat runs each
   forward twice) and none of the templates ``flash_fwd_lut``,
   ``flash_bwd_dkdv_lut`` and ``flash_bwd_dq_lut``; finite losses and no
   skipped step; 20 steps on one fixed batch lower its loss by at least
   0.5; a ``torch.profiler`` breakdown of one step, with the forward, dK/dV
   and dQ device time per step; 8b, two captured steps on unpadded batches
   (``flash_fwd_lut_sm90`` without the bias, 0 on ``flash_fwd_lut_ring``;
   the same backward kernels); 8c, padded steps with ``"mode": "dense"``
   (an all-ones layout) through both step impls (2 warm-up steps, 3
   passes of 5): exactly 48 launches per
   kernel run of ``flash_fwd_sm90`` and 24 of each of ``flash_bwd_dkdv_sm90``
   and ``flash_bwd_dq_sm90`` (their key-bias instances), none of the
   templates ``flash_fwd_biased``, ``flash_bwd_dkdv_biased`` and
   ``flash_bwd_dq_biased``, then one profiled captured step with the dense
   biased forward's and backward's device time per step;
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
    generator of its own) and 40 (phase 16's window products, 8 slots x 5
    tokens, from another), per-tensor scales (and per-channel for the
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
    prefill captured, one replay and a warm-up, its token step captured,
    15 replays and a warm-up) against the serving streams (launches per
    prefill run as per serving prefill, per token-step run as per decode
    step), the captured prefill's wall per call against its body run
    eagerly, then three calls on each decode impl, the tokens identical; a
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
    moves every step.  Run A trains 3 steps, saves (``save_checkpoint``) to a
    temporary directory (removed at the end), trains steps 4-6, reloads
    its own checkpoint and repeats steps 4-6 (the repeat difference).  Run
    B, from other weights (seed 1), calls ``load_checkpoint`` and trains
    steps 4-6.  Hard: every restored leaf (params, master, ``exp_avg``,
    ``exp_avg_sq``) ``torch.equal`` to its host snapshot taken at the save,
    after B's load and after A's reload; the counters, lr, lr-schedule and
    loader state equal; the same batches; step 4's loss bit-equal; steps
    5-6 within the measured repeat difference (never a constant); every
    step captured (A's one graph holds across its reload, B captures once
    after its load); 24 launches a kernel run (replays and the warm-up) of
    ``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90``
    after the load, 0 on the templates;
    ``InferenceEngine(model, checkpoint=dir)`` gives the params, greedy
    ``generate`` tokens (B=2, T=32, 8 new, the captured token step) and
    served streams (``paged_attention_online_sm90``, launches checked as
    in phase 3) of an engine built from A's in-memory step-3 weights; a
    save crashed at ``ckpt.before_commit`` (``fault.configure``) leaves a
    ``.tmp`` that ``load_checkpoint`` skips for the step-3 tag.  Prints the
    model and optimizer files' bytes, save and load seconds (median of 3)
    and the peak host RSS during a save.
16. speculative serving (``ServingConfig(speculative={"k": 4, "ngram":
    3})``): GPT-2 125M (bf16, ``init_numpy(seed=0)``) on phase 3's 16
    requests and 8 loopy prompts (a short random sequence tiled, from a
    generator of its own), 32 new tokens, kv16 and kv8: a plain serve that
    keeps each step's top-2 logit gap and a speculative one, each through
    the launch checks (``paged_attention_online_sm90`` = (replays +
    warm-ups) x 12 on the one ``spec4`` decode graph, 0 on every other
    paged kernel), every outcome OK and every block recycled; accepted
    drafts > 0 on the loopy prompts.  Before the serves, one speculative
    step against the 5 plain steps it stands for on the same seated state
    (the window holding the plain steps' own tokens), at kv16 and kv8: max
    |delta logits| d over every slot and position, within LOGIT_TOL; every
    request whose speculative stream parts from its plain one must part at
    a token where the plain step's top-2 gap is within SPEC_GAP_FACTOR x d
    (the share of plain tokens within that limit printed); at kv16 both
    decode impls of the speculative serve (identical streams, one step's
    |delta logits| = 0), three timed passes each (tokens/s, step p50/p99,
    TTFT p50, accept rate, tokens per step, with their spread), a profiled
    step with its copies, and plain decode's passes on the same traffic
    beside them; the decode step's host split (drafter, step call, read),
    speculative and plain.  Then GPT-2 1.3B with int8 weights on phase 11's
    traffic, the same noise reading (within INT8_LOGIT_TOL), plain and
    speculative serves and divergence rule: the window's 40 rows take
    ``int8_mm_nt_prefill`` (96) and ``int8_mm_t_prefill`` (1) per
    speculative replay or warm-up and no decode kernel; a profiled
    speculative step with its int8 products' device time.
17. fp16 training: 17a the dense sm90 fp16 instances against their plain
    versions and the overflow check; 17b phase 5's run in fp16 with the
    dynamic loss scaler on both step impls; 17c GPT-2's remat policy and
    chunked loss; 17a+ every other flash route's fp16 instance (the LUT,
    key-bias, banded and merged sm90 kernels, every template; d 64/96/128)
    against its plain version over seeds 33-35 at BERT's T and H, a fully
    padded ``mul`` row exactly 0, the LUT dK/dV also under C1_BOUND; 17d
    each fp16 instance timed beside its bf16 twin, bound, plain version and
    SDPA / the flash backward op at fp16.
18. BERT-large in fp16 (phase 8's run with ``"fp16": {"enabled": true}``):
    the tutorial's sparse layout and its ``"mode": "dense"`` twin with
    padding, captured and eager, every flash launch on an fp16 instance
    (dtype code 2; 48/24/24 a kernel run), captured = eager in losses, grad
    norms and scaler state, step 1 against plain attention within phase 8's
    limits, the fixed-batch loss fall, a forced overflow skipped
    bit-exactly, the figures beside phase 8's.
19. the imperative API on phase 5's configuration at gas 2
    (``forward`` / ``backward`` / ``step`` bit-equal to ``train_batch`` on
    one graph), a fixed_linear seqlen curriculum 128 -> 1024 with PLD (the
    schedule followed, a graph and its pool bytes a difficulty, the
    reserved memory a step; at micro 4 the past graphs held, at micro 8
    released), PLD's theta beside its formula.
20. graded config 3 (the JAX package's ``bench.py:301-330``): GPT-2 1.3B,
    T=1024, micro 8, gas 8, bf16 with bf16 accumulation, AdamW, clip 1.0,
    remat, ZeRO-3 with ``offload_optimizer`` cpu: the in-device engine of
    the same config (eager) and the same at lr 0 (no update), then the
    synchronous offload engine and the DPU one (warm-up 0), each a warm-up
    step and OFFLOAD_PASSES timed passes of OFFLOAD_TIMED steps (step p50 /
    p99, tokens/s, MFU, the device half alone, the d2h / widening / host
    Adam / h2d split, idle share, peak memory), an eager DPU engine for
    OFFLOAD_RACE_STEPS
    steps; hard: step 1's loss equal to the in-device engine's, steps 2-3
    within OFFLOAD_UPDATE_SHARE of the gap the lr-0 run leaves, the host
    master moved, the device params equal to the payload and the payload
    to the master's bf16 cast (sync step 1, DPU step 4), the DPU master one
    step stale bit for bit, the eager DPU run bit-equal to the captured
    one, exact flash launches (the forward twice a micro-batch with
    remat), no device master or moments; the host's CPU, copy rate, RSS
    peak and pinned bytes, one wire copy against 64 MB chunks.
21. at GPT-2 125M: a client FusedAdamW and WarmupLR captured = eager;
    ``checkpointing.checkpoint`` inside a captured step bit-equal to the
    unwrapped region; an fp16 offload run whose forced 2^40 step is skipped
    with the host master, the moments and the params bit-unchanged.
22. the health ladder at 125M; 23. the NVMe optimizer tier at 350M.
24. ZeRO-3 parameter offload at graded config 3's width (GPT-2 1.3B,
    phase 20's config with ``offload_param`` cpu): the layer blocks
    streamed through two device buffers; step 1 against phase 20's
    in-device step 1, steps 2-3 within its update share, the overlapped
    step bit-equal to the eager-sequential one, a grad_nan step changing
    nothing, exact flash launches (``param_stream``).
25. the NVMe parameter tier at 350M, bit-equal to the CPU parameter tier
    (``param_nvme``).
26. the sparse-gradient wire (an embedding bag at V=50257) and
    ``cpu_checkpointing`` on a 125M block (``sparse_and_cpu_ckpt``).

Prints a ``{"kernels": [...]}`` line (the dense sm90 kernels' key-bias
instances as ``flash_fwd_sm90 (key bias)``, ``flash_bwd_dkdv_sm90 (key
bias)`` and ``flash_bwd_dq_sm90 (key bias)``, with phase 8c's launches and
phase 9's dense+pad figures; ``paged_attention_exact_sm90`` with the
exact-mode serve's launches and the first design ``paged_attention_exact``
beside it with 0; ``paged_attention_online_sm90`` with the kv16 serve's
launches and the first design ``paged_attention_online`` beside it with
0; ``flash_fwd_banded_sm90`` and ``flash_fwd_merged_sm90`` with phase 14's
path launches and their figures at block 64, T=8192, the template
``flash_fwd_banded`` and ``flash_fwd_merged`` beside them with 0; each
fp16 instance as ``<name> fp16``, with phase 17b's (dense), 18's (LUT) or
18c's (key bias) launches and 17d's figures), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device": {...}}``.
Any failure raises and the script exits non-zero without that line; with no
CUDA device it exits 2.
"""

import collections
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
import torch.utils._python_dispatch

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
from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdamW
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as ls
from deepspeed_tpu_torch.runtime.lr_schedules import WarmupLR
from deepspeed_tpu_torch.runtime.utils import tree_leaves, tree_map
from deepspeed_tpu_torch.runtime.zero import wire

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
             torch.float32: (1e-4, 1e-5),
             # fp16 (phase 17), u = 2^-11: r is bf16's 2u, a is 32u (bf16's is 8u).  The
             # kernel's P differs from the plain version's by ~1e-6 relative (exp2 of an
             # fma'd argument against exp), which flips the rounding of P or dS to the input
             # dtype in a share of the row's terms that grows as u shrinks, while each flip
             # is u in size: the flips' sum does not shrink with u.  Readings (H100, B=8
             # H=16 d=64 causal qkv, T 127-1088): bf16's multiples (2^-8, 2^-10) up to 1.52x
             # (seeds 30-32) and 2.16x (dQ, T=1088, seed 30), at |plain| 0.03-0.4, where the
             # kernel's and the plain version's distances from the unrounded fp32 values are
             # of one size; bf16 at 0.74x of its own limit on the same draws
             torch.float16: (2 ** -6, 2 ** -10)}
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
# the element types' names in the kernels' mangled names (the template argument E)
MANGLED_BF16, MANGLED_F16 = "13__nv_bfloat16", "6__half"


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
    # each head dim's instances, once: dense with and without the key bias, banded, merged,
    # each in bf16 and fp16 (mangled <D, kBias, kSched, E>)
    fwd = {(d, bias, sched, ty): sum(f"fwd_sm90_kernelILi{d}ELb{bias}ELi{sched}E{ty}E" in kname
                                     for kname, *_ in sm90)
           for d in fa.SM90_HEAD_DIMS[torch.bfloat16]
           for bias, sched in ((0, 0), (1, 0), (0, 1), (0, 2))
           for ty in (MANGLED_BF16, MANGLED_F16)}
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
    # the dense pair's instances: bf16 and fp16, with and without the key bias (mangled
    # <64, true / false, E>)
    rows = ptxas_summary(builder.build_log[GROUP_SM90_LIB]["ptxas"])
    dense = {f"{kernel}<64, {bias}, {name}>": [
        (regs, spill) for kname, regs, _, spill in rows
        if f"{kernel}ILi64ELb{int(bias == 'true')}E{ty}E" in kname]
        for kernel in ("dense_dkdv_kernel", "dense_dq_kernel")
        for bias, name, ty in (("false", "bf16", MANGLED_BF16), ("true", "bf16", MANGLED_BF16),
                               ("false", "f16", MANGLED_F16), ("true", "f16", MANGLED_F16))}
    print(f"{GROUP_SM90_LIB}.cu dense instances: " + "; ".join(
        f"{name} {found[0][0]} registers, {found[0][1]} spill bytes" if found else
        f"{name} not built" for name, found in dense.items()))
    if not all(len(found) == 1 for found in dense.values()):
        raise AssertionError(f"{GROUP_SM90_LIB}: a dense instance not built once: {dense}")
    # the group kernels' instances: slot rows 16 / 32 / 64 x key bias, in bf16 and in fp16
    for lib, kernels in ((GROUP_SM90_LIB, ("dkdv_sm90_kernel", "dq_sm90_kernel")),
                         (FWD_LUT_SM90_LIB, ("fwd_lut_sm90_kernel",))):
        rows = ptxas_summary(builder.build_log[lib]["ptxas"])
        counts = {(kernel, ty): sum(kernel in kname and ty in kname for kname, *_ in rows)
                  for kernel in kernels for ty in (MANGLED_BF16, MANGLED_F16)}
        print(f"{lib}.cu group instances by element type: " + "; ".join(
            f"{kernel} {'bf16' if ty == MANGLED_BF16 else 'fp16'} {n}"
            for (kernel, ty), n in counts.items()))
        if any(n != 6 for n in counts.values()):
            raise AssertionError(f"{lib}: the group instances (slot rows x key bias) not built "
                                 f"once in each element type: {counts}")
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
    check_window_end(dev, max_err)
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


def check_window_end(dev, max_err, H=12, HD=64, BS=16, nb_max=64, seed=27):
    """Phase 2, windows past the table's end (a speculative window near the
    end of a request): ``paged_attention_online_sm90`` and
    ``paged_attention_exact_sm90`` against the plain version at lengths S -
    W + 1 and S - 1 for W 5 and 8 (rows past S clamped to S by the kernels,
    all S rows live for the window's last queries in the plain version),
    bf16 / int8 / fp32 pools; inputs from a generator of their own."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    S = BS * nb_max
    for kind in ("bf16", "int8", "fp32"):
        for W in (5, 8):
            lengths_list = [S - W + 1, S - 1]
            pool, dt = paged_pool(dev, gen, kind, len(lengths_list), H, HD, BS, nb_max)
            perm = torch.randperm(len(lengths_list) * nb_max, generator=gen, device=dev) + 1
            tables = perm.int().reshape(len(lengths_list), nb_max)     # every block live
            lengths = torch.tensor(lengths_list, dtype=torch.int32, device=dev)
            q = torch.randn((len(lengths_list), W, H, HD), generator=gen, device=dev).to(dt)
            ref = pa.paged_attention_reference(q, pool, tables, lengths, 1)
            errs = {}
            for mode, name in pa.KERNELS.items():
                out = pa.paged_attention(q, pool, tables, lengths, 1, mode=mode)
                torch.cuda.synchronize()
                if out.shape != ref.shape or not torch.isfinite(out).all():
                    raise AssertionError(f"{name} window end W={W}: bad output")
                errs[name] = (out.float() - ref.float()).abs().max().item()
                max_err[name] = max(max_err[name], errs[name])
                if not errs[name] <= TOL[kind]:
                    raise AssertionError(f"{name} window end pool={kind} W={W}: error "
                                         f"{errs[name]} above {TOL[kind]}")
            print(f"window-end-check pool={kind} W={W} S={S} lengths {lengths_list}: "
                  + ", ".join(f"{name} {err:.3e}" for name, err in errs.items())
                  + f" (tol {TOL[kind]:g})")


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



# C1: dK/dV where one rounding flip of P or dS outweighs the rms-scaled limit (ROADMAP.md
# section C).  The kernel's P and dS differ from the plain version's by ~1e-6 relative, so
# each may round to the other neighbour of the same value: a flip moves dV by ulp(P) |dO|
# and dK by ulp(dS) |Q| (ulp in the input dtype at that value).  Their sums over the query
# rows bound what the flips can add, and the plain version gives them: C1_BOUND is
#   |kernel - plain| <= a rms(plain) + r |plain| + U,
#   U_dV = sum_q ulp(P) |dO|, U_dK = sum_q ulp(dS) |Q|,
# with (a, r) phase 2's FLASH_TOL, P and dS from the plain version itself (``_p_ds``).  Beside
# it the plain version run twice, with P and dS rounded to the input dtype and unrounded,
# reads the rounding term one draw realises (printed as "realised"): U bounds it too.
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}
SUBNORMAL_ULP = {torch.bfloat16: 2.0 ** -133, torch.float16: 2.0 ** -24}


def ulp_of(x, dt):
    """The spacing of dtype ``dt`` at each |x| of the fp32 tensor ``x`` (0
    where x is 0: a masked P is exact)."""
    _, e = torch.frexp(x.abs())
    ulp = torch.ldexp(torch.ones_like(x), e - 1 - MANTISSA_BITS[dt])
    return torch.where(x == 0, 0.0, ulp.clamp(min=SUBNORMAL_ULP[dt]))


def c1_close(what, q, k, v, do, lse, delta, causal, lut, kb, ab, outs):
    """``outs``: {kernel: (dk, dv)} fed ``lse`` / ``delta``; each held
    against the plain version under C1_BOUND.  Returns {kernel: [(output,
    max abs error, share of the C1 bound)]} and prints the bound's and the
    realised rounding term's largest values."""
    dt = q.dtype
    a, r = FLASH_TOL[dt]
    p, ds = fa._p_ds(q, k, v, do, lse, delta, causal, fa._scale(q, None), lut, kb, ab)
    terms = {}
    for label, m, x in (("dk", ds, q), ("dv", p, do)):
        prod = lambda mm: torch.einsum("bhqk,bqhd->bkhd", mm, x.float())
        unrounded, rounded = prod(m), prod(m.to(dt).float())
        bound = torch.einsum("bhqk,bqhd->bkhd", ulp_of(m, dt), x.float().abs())
        terms[label] = (rounded.to(dt).float(), bound, (rounded - unrounded).abs())
        del unrounded
    del p, ds
    res = {}
    for name, got in outs.items():
        rows = []
        for label, g in zip(("dk", "dv"), got):
            ref, bound, _ = terms[label]
            err = (g.float() - ref).abs()
            limit = a * ref.pow(2).mean().sqrt() + r * ref.abs() + bound
            share = (err / limit).max().item()
            if not (torch.isfinite(g).all() and share <= 1.0):
                raise AssertionError(f"{name} {what} {label}: error {err.max().item():.3e} is "
                                     f"{share:.2f}x the C1 bound")
            rows.append((label, err.max().item(), share))
        res[name] = rows
    print(f"c1-bound {what}: " + "; ".join(
        f"{label} U max {b.max().item():.2e}, realised max {rz.max().item():.2e}"
        for label, (_, b, rz) in terms.items()) + "; " + "; ".join(
        f"{name} {flash_line({name: rows})}" for name, rows in res.items()))
    return res

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


def graphs_line(srv, per_graph=False):
    g = srv.stats()["graphs"]
    mb = graph_pool_mb(srv)
    line = (f"decode_impl {g['decode_impl']}: {g['graphs']} graphs ({g['captures']} captures; "
            f"decode warm-ups {g['decode_warmups']}, replays {g['decode_replays']}; prefill "
            f"warm-ups {g['prefill_warmups']}, replays {g['prefill_replays']}), graph pool "
            + ("none" if mb is None else f"{mb:.1f} MB"))
    if per_graph and mb is not None:
        line += " (MB its capture added, by graph: " + ", ".join(
            f"{name} {b / 1e6:.1f}" for name, b in g["pool_bytes"].items()) + ")"
    return line


def run_checked(srv, engine, prompts, new, tag, mode):
    """Serve ``prompts`` greedily on ``srv`` with counts reset just before
    and read just after; checks outcomes, tokens, recycling, paged-attention
    launches == decode runs x layers and, for an int8 engine,
    ``int8_mm_nt_decode`` == decode runs x 4 x layers, ``int8_mm_nt_prefill``
    == prefill runs x 4 x layers, the tiled ``int8_mm_nt`` 0, ``int8_mm_t``
    == decode runs and ``int8_mm_t_prefill`` == prefill runs (all 0 for a
    float engine), a run being a replay or a warm-up of the step's graph, or
    an eager step (:func:`step_runs`).  Under speculation (a W = k + 1
    window) whose decode rows exceed ``DECODE_MAX_M`` the decode runs take
    the prefill kernels (``int8_mm_nt_prefill`` x 4 x layers and
    ``int8_mm_t_prefill``) and the decode kernels none.
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
    # the head once per step (int8_mm_t) or prefill (int8_mm_t_prefill); a speculative step
    # of more than DECODE_MAX_M rows (8 slots x 5) on the prefill kernels.  A float engine
    # launches none.
    q = int(engine.quantized)
    W = 1 if srv.spec is None else srv.spec.k + 1
    wide = srv.config.batch_slots * W > im.DECODE_MAX_M
    dec_nt, dec_t = (("int8_mm_nt_prefill", "int8_mm_t_prefill") if wide
                     else ("int8_mm_nt_decode", "int8_mm_t"))
    want8 = {"int8_mm_nt_decode": 0, "int8_mm_nt_prefill": q * pre * 4 * c.n_layer,
             "int8_mm_nt": 0, "int8_mm_t": 0, "int8_mm_t_prefill": q * pre}
    want8[dec_nt] += q * runs * 4 * c.n_layer
    want8[dec_t] += q * runs
    for name, expect in want8.items():
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
    int8_line = ((f"int8_mm_nt_decode {int8_counts['int8_mm_nt_decode']} = decode runs x "
                  f"{4 * c.n_layer}, int8_mm_nt_prefill {int8_counts['int8_mm_nt_prefill']} = "
                  f"prefill runs x {4 * c.n_layer}, int8_mm_nt {int8_counts['int8_mm_nt']}, "
                  f"int8_mm_t {int8_counts['int8_mm_t']} = decode runs, int8_mm_t_prefill "
                  f"{int8_counts['int8_mm_t_prefill']} = prefill runs; " if not wide else
                  f"speculative W={W} x {srv.config.batch_slots} slots > DECODE_MAX_M: "
                  f"int8_mm_nt_prefill {int8_counts['int8_mm_nt_prefill']} = (decode runs + "
                  f"prefill runs) x {4 * c.n_layer}, int8_mm_t_prefill "
                  f"{int8_counts['int8_mm_t_prefill']} = decode runs + prefill runs, "
                  f"int8_mm_nt_decode {int8_counts['int8_mm_nt_decode']}, int8_mm_t "
                  f"{int8_counts['int8_mm_t']}, int8_mm_nt {int8_counts['int8_mm_nt']}; ")
                 if engine.quantized else "")
    spec_line = ""
    if srv.spec is not None:
        sp = st["speculative"]
        spec_line = (f"speculative k={sp['k']}: proposed {sp['proposed']}, accepted "
                     f"{sp['accepted']}, accept rate {sp['accept_rate']}, tokens per step "
                     f"{sp['tokens_per_step']}; ")
    others = ", ".join(f"{name} {n}" for name, n in counts.items() if name != want)
    print(f"serve {tag}: {len(prompts)} requests OK, {steps} decode steps, {runs} decode "
          f"runs, {pre} prefill runs, {want} launches {counts[want]} = decode runs x "
          f"{c.n_layer} ({others}); {int8_line}{spec_line}"
          f"{st['generated_tokens'] / wall:.1f} tokens/s, decode step p50 "
          f"{st['step_ms']['p50']:.3f} ms p99 {st['step_ms']['p99']:.3f} ms, "
          f"TTFT p50 {st['ttft_ms']['p50']:.1f} ms, first request's TTFT "
          f"{(res[0]['t_first'] - res[0]['t_submit']) * 1e3:.1f} ms (its bucket's warm-up and "
          f"capture included), wall {wall:.2f} s (captures included), "
          f"pool {pk.pool_bytes(srv.pool) / 1e6:.1f} MB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB (resident before the run "
          f"{resident / 1e6:.1f} MB); {graphs_line(srv, per_graph=True)}")
    srv.int8_launches = int8_counts
    return srv, counts, {uid: res[uid]["tokens"] for uid in res}


AB_PASSES = 3   # timed passes of each decode impl


def ab_serve(engine, prompts, new, tag, kv_bits, fused_tokens, spec=None,
             impls=("fused", "unroll")):
    """The same traffic through both decode impls, "fused" (each step a
    CUDA graph) and "unroll" (the same step bodies, eager).  For each: a
    first pass through :func:`run_checked` (launches, outcomes, recycling;
    every prefill bucket captured), whose streams must equal
    ``fused_tokens`` request by request; AB_PASSES timed passes (tokens/s,
    decode step p50/p99, TTFT p50; under speculation (``spec``, the
    ``speculative`` block) also each pass's accept rate and tokens per
    step); its graphs and their pool; one decode step profiled.  Then one
    decode step of each on the same seated state: max |delta logits| and
    the argmax (under speculation it must be 0), when ``impls`` holds both.
    Returns {impl:
    [(tokens/s, p50, p99, TTFT p50[, accept rate, tokens per step]),
    ...]}."""
    c = engine.module.config
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=kv_bits, max_new_tokens=new,
                        speculative=spec)
    names = ("tokens/s", "decode step p50 ms", "decode step p99 ms", "TTFT p50 ms")
    if spec:
        names += ("accept rate", "tokens per step")
    readings, logits = {}, {}
    try:
        for impl in impls:
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
                steps0 = srv.stats()["decode_steps"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = srv.run(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if not all(res[q.uid]["outcome"] == OK for q in reqs):
                    raise AssertionError(f"{tag} {impl}: pass {r} not all OK")
                st = srv.stats()
                row = (len(prompts) * new / wall, st["step_ms"]["p50"],
                       st["step_ms"]["p99"], st["ttft_ms"]["p50"])
                if spec:
                    proposed = sum(res[q.uid]["spec"]["proposed"] for q in reqs)
                    accepted = sum(res[q.uid]["spec"]["accepted"] for q in reqs)
                    row += (accepted / proposed,
                            len(prompts) * new / (st["decode_steps"] - steps0))
                rows.append(row)
            readings[impl] = rows
            cols = list(zip(*rows))
            print(f"ab {tag} {impl}: " + ", ".join(
                f"{name} {statistics.median(col):.3f} (readings "
                f"{', '.join(f'{x:.3f}' for x in col)}; spread {max(col) - min(col):.3f})"
                for name, col in zip(names, cols)) + f"; {graphs_line(srv)}")
            for i, p in enumerate(prompts[:8]):
                srv.submit(Request(tokens=p, uid=10 ** 6 + i))
            copy_device_time(profile_steps(srv.step, f"{tag} {impl}"), f"{tag} {impl}")
            del srv
            # one decode step on the same seated state
            one = ServingEngine(engine=engine, config=cfg)
            seat(one, prompts[::2])
            with torch.no_grad():
                logits[impl] = one._decode_graph()(toks=one._window(seated(one)),
                                                   tables=one._tables,
                                                   lengths=one._lengths)[0].clone()
            del one
            gc.collect()
    finally:
        c.decode_impl = "auto"
    if len(logits) < 2:
        return readings
    err = (logits["fused"] - logits["unroll"]).abs().max().item()
    agree = (logits["fused"].argmax(-1) == logits["unroll"].argmax(-1)).sum().item()
    print(f"ab {tag}: one decode step, captured vs eager: max |delta logits| {err:.3e}, "
          f"argmax agree {agree}/{logits['fused'].argmax(-1).numel()}")
    if not torch.isfinite(logits["fused"]).all():
        raise AssertionError(f"{tag}: captured decode logits not finite")
    if spec and err != 0:
        raise AssertionError(f"{tag}: the captured speculative step's logits differ from the "
                             f"eager one's by {err}")
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


def timing(srv, tag, pool_kind, gen, bytes_per_s, W=1):
    """Phase 4 at the seated state of ``srv`` (a window of ``W`` queries a
    slot: 1 is plain decode, k + 1 a speculative step): each kernel, the
    plain version, the SDPA yardstick, and the bound."""
    dev, pool = srv.device, srv.pool
    H, HD = pool["k"].shape[3], pool["k"].shape[4]
    B, S = srv._tables.shape[0], srv.nb_max * srv.config.block_size
    tables = torch.as_tensor(srv._tables, device=dev)
    lengths = torch.as_tensor(srv._lengths, device=dev)
    q = torch.randn((B, W, H, HD), generator=gen, device=dev).to(torch.bfloat16)
    lens = srv._lengths.astype(np.int64)
    rows = int(np.minimum(lens + W, S).sum())               # K/V rows the window reaches
    # query row w attends min(length + w + 1, S) rows
    pairs = int(sum(np.minimum(lens + w + 1, S).sum() for w in range(W)))
    nbytes = (q.numel() * 2 * 2                             # q read, out written
              + rows * H * HD * pool["k"].element_size() * 2   # live K and V
              + tables.numel() * 4 + lengths.numel() * 4)
    if pk.is_quantized_pool(pool):
        nbytes += rows * H * pool["k_scale"].shape[-1] * 4 * 2
    ops = 4 * pairs * H * HD                                # QK and PV
    t_bytes = nbytes / bytes_per_s * 1e3
    t_ops = ops / PEAK_OPS[pool_kind] * 1e3
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                          else (t_ops, "operations"))
    # library yardstick: SDPA over pre-gathered dense K/V (gather untimed)
    dense = []
    for layer in range(L_CYCLE):
        k, v = pk.gather_kv(pool, layer, tables, torch.bfloat16)
        dense.append((k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()))
    mask = (torch.arange(S, device=dev)[None, None, :]
            <= lengths.long()[:, None, None]
            + torch.arange(W, device=dev)[None, :, None])[:, None]     # (B, 1, W, S)
    qh = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = sdpa(qh, *dense[0], attn_mask=mask).transpose(1, 2).reshape(B, W, H * HD)
    lib_err = (lib.float() - pa.paged_attention_reference(
        q, pool, tables, lengths, 0).float()).abs().max().item()
    if not lib_err <= TOL[pool_kind]:
        raise AssertionError(f"SDPA yardstick disagrees by {lib_err}")
    library_ms = time_ms(lambda l: sdpa(qh, *dense[l], attn_mask=mask), 200)
    plain_ms = time_ms(lambda l: pa.paged_attention_reference(
        q, pool, tables, lengths, l), 40)
    out = {"shape": {"slots": B, "mean_length": float(lens.mean()), "window": W,
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
        print(f"timing {tag} W={W} {name}{design}: {ms * 1e3:.2f} us (readings "
              f"{', '.join(f'{r * 1e3:.2f}' for r in rs)}), bound "
              f"{bound_ms * 1e3:.2f} us ({bound_by}, share {bound_ms / ms:.3f}), plain "
              f"{plain_ms * 1e3:.2f} us, library {library_ms * 1e3:.2f} us, "
              f"mean length {lens.mean():.1f}")
    pa.launches.update(saved)          # timing launches are not path launches
    return out


def profile_steps(step, tag, steps=6, unit="decode step", summary=None):
    """Where a step's time goes: ``steps`` calls of ``step()`` (after one
    to reach steady state) under ``torch.profiler``; prints the wall time
    per step, the device's busy and idle shares, the kernel launches per
    step and the kernels that take the most device time.  ``summary``
    (a dict) receives ``busy_us`` and ``wall_us`` per step."""
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
    if summary is not None:
        summary.update(busy_us=busy / steps, wall_us=wall_us / steps)
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


def train_engine(dev, np_params, tokens, impl, preset, seq, micro, step_impl="auto",
                 optimizer=None, dtype=torch.bfloat16, config=None, **model_kw):
    """Phase 5's engine; ``config`` entries replace TRAIN_CONFIG's (an
    ``fp16`` block drops its ``bf16``), ``model_kw`` the model's."""
    kw = dict(dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0, remat=False), **model_kw)
    model = GPT2(preset=preset, max_seq=seq, dtype=dtype, device=dev, attention_impl=impl,
                 **kw)
    base = {k: v for k, v in TRAIN_CONFIG.items() if not (config and "fp16" in config
                                                          and k == "bf16")}
    config = dict(base, train_micro_batch_size_per_gpu=micro,
                  optimizer=optimizer or TRAIN_CONFIG["optimizer"], **(config or {}))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=config, model=model, params=np_params, training_data=(tokens,),
        step_impl=step_impl)
    return engine


TRAIN_PASSES = 3      # timed passes of each step_impl


def kernel_runs(eng):
    """Steps whose kernels ran so far: each graph's replays plus its
    warm-ups when the step is captured (``step_impl`` "graph" on the card),
    else the steps taken (``global_steps``, which a load moves: take
    differences within a run)."""
    g = eng.stats()["graphs"]
    if eng.step_impl == "graph" and eng.device.type == "cuda":
        return g["replays"] + g["warmups"]
    return eng.global_steps


def engine_graphs_line(eng):
    g = eng.stats()["graphs"]
    mb = graph_pool_mb(eng)
    return (f"step_impl {g['step_impl']}: {g['graphs']} graphs ({g['captures']} captures, "
            f"{g['warmups']} warm-ups, {g['replays']} replays, {g['dropout_draws']} dropout "
            f"draws re-seeded a replay), graph pool "
            + ("none" if mb is None else f"{mb:.1f} MB") + " (capture added " + ", ".join(
                f"{b / 1e6:.1f} MB" for b in g["pool_bytes"].values()) + ")")


def ab_train(make, tag, per_step, card, tokens_per_step, flops_per_token, warmup=3,
             timed=10, passes=TRAIN_PASSES, profile_n=2, first=None, after=None,
             extra=None, skips_ok=False):
    """The same training run through both step impls, "graph" (the step
    one CUDA graph) and "eager" (the same body called directly), each from
    ``make(impl)`` (the same params and data): ``warmup`` steps, then
    ``passes`` timed passes of ``timed`` steps.  For each impl: exact
    launches (``per_step`` x the runs: replays and warm-ups when
    captured), step p50 / p99, tokens/s and MFU of each pass, peak device
    memory, the graphs and their pool, and a profiled step's busy time
    against the unprofiled step p50 (the idle share).  ``first(eng, loss,
    grad_norm)`` checks the graph impl's step 1; ``after(eng, by_name)``
    runs on the graph engine before it is dropped (with its profile).
    The losses and grad norms of every step must be bit-equal between the
    impls, and ``extra(eng)`` (a tuple: the loss scaler's state) after every
    step too; skipped steps fail the run unless ``skips_ok``.  Returns
    {impl: {"counts", "p50", "first" (step 1's loss and grad norm), ...}}."""
    out, curves = {}, {}
    for impl in ("graph", "eager"):
        eng = make(impl)
        if eng.step_impl != impl:
            raise AssertionError(f"{tag}: step_impl {eng.step_impl}, asked for {impl}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        runs0 = kernel_runs(eng)
        curve, rows = [], []
        def record(loss):
            curve.append((loss, eng.get_global_grad_norm())
                         + (extra(eng) if extra is not None else ()))
        for i in range(warmup):
            record(float(eng.train_batch()))
            if i == 0:
                check_launches(f"{tag} {impl} step 1", dict(fa.launches), per_step,
                               kernel_runs(eng) - runs0)
                if first is not None and impl == "graph":
                    first(eng, *curve[0][:2])
        for _ in range(passes):
            times = []
            for _ in range(timed):
                t0 = time.perf_counter()
                loss = float(eng.train_batch())
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                record(loss)
            ms = np.asarray(times) * 1e3
            tok_s = timed * tokens_per_step / (ms.sum() / 1e3)
            rows.append((np.percentile(ms, 50), np.percentile(ms, 99), tok_s,
                         tok_s * flops_per_token / PEAK_OPS["bf16"]))
        counts = dict(fa.launches)
        runs = kernel_runs(eng) - runs0
        check_launches(f"{tag} {impl}", counts, per_step, runs)
        peak = torch.cuda.max_memory_allocated()
        losses = [x for x, *_ in curve]
        if not all(math.isfinite(x) for x in losses) or (eng.skipped_steps != 0
                                                          and not skips_ok):
            raise AssertionError(f"{tag} {impl}: losses {losses}, skipped {eng.skipped_steps}")
        graphs = engine_graphs_line(eng)
        summary = {}
        by_name = profile_steps(lambda: eng.train_batch(), f"{tag} {impl}", steps=profile_n,
                                unit="training step", summary=summary)
        cols = list(zip(*rows))
        p50 = statistics.median(cols[0])
        busy_ms = summary.get("busy_us", float("nan")) / 1e3
        print(f"ab {tag} {impl}: " + ", ".join(
            f"{name} {statistics.median(col):.3f} (readings "
            f"{', '.join(f'{x:.3f}' for x in col)}; spread {max(col) - min(col):.3f})"
            for name, col in zip(("step p50 ms", "step p99 ms", "tokens/s", "MFU"), cols))
              + f"; launches per step " + ", ".join(f"{n} {counts[n] // runs}" for n in per_step)
              + f" over {runs} kernel runs; peak device memory {peak / 1e9:.2f} GB; {graphs}; "
              f"profiled step busy {busy_ms:.3f} ms, idle {100 * (1 - busy_ms / p50):.1f}% of "
              f"the unprofiled step p50 ({card})")
        if after is not None and impl == "graph":
            after(eng, by_name)
        out[impl] = {"counts": counts, "p50": p50, "busy_ms": busy_ms, "rows": rows,
                     "peak_gb": peak / 1e9, "graphs": eng.stats()["graphs"],
                     "first": curve[0][:2], "skipped": eng.skipped_steps}
        curves[impl] = curve
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # repr: an overflow step's grad norm is inf or nan on both sides
    if repr(curves["graph"]) != repr(curves["eager"]):
        diff = [i for i, (a, b) in enumerate(zip(curves["graph"], curves["eager"]))
                if repr(a) != repr(b)]
        raise AssertionError(f"{tag}: captured and eager steps differ at steps {diff}: "
                             f"{[(curves['graph'][i], curves['eager'][i]) for i in diff[:3]]}")
    print(f"ab {tag}: losses and grad norms{' and the loss scaler' if extra else ''} "
          f"bit-equal, captured vs eager, at all "
          f"{len(curves['graph'])} steps; step p50 captured {out['graph']['p50']:.3f} ms, eager "
          f"{out['eager']['p50']:.3f} ms, captured busy {out['graph']['busy_ms']:.3f} ms ({card})")
    return out


def train(dev, card, warmup=3, timed=10, fit_steps=20, preset="gpt2-350m", seq=1024,
          micro=8):
    """Phase 5: GPT-2 training through initialize -> train_batch (350M,
    T=1024, micro-batch 8, the JAX headline configuration), captured and eager
    (:func:`ab_train`).  Returns :func:`ab_train`'s results (the captured
    run's flash launches under ``["graph"]["counts"]``)."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    np_params = GPT2(preset=preset, max_seq=seq, device=dev).init_numpy(seed=0)
    eng = train_engine(dev, np_params, tokens, "jnp", preset, seq, micro)
    plain = (float(eng.train_batch()), eng.get_global_grad_norm())
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    model = GPT2(preset=preset, max_seq=seq, device=dev)
    head_dim = model.config.n_embd // model.config.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    per_step = {name: model.config.n_layer
                for name in (fwd, *fa.dense_bwd_kernel(torch.bfloat16, head_dim))}

    def first(eng, loss, gnorm):
        print(f"train step 1 (captured): loss flash {loss:.6f} plain {plain[0]:.6f}; grad "
              f"norm flash {gnorm:.6f} plain {plain[1]:.6f} (tol {STEP1_LOSS_TOL:g} abs, "
              f"{STEP1_GNORM_TOL:g} rel)")
        if not (abs(loss - plain[0]) <= STEP1_LOSS_TOL
                and abs(gnorm - plain[1]) <= STEP1_GNORM_TOL * abs(plain[1])):
            raise AssertionError(f"step 1 flash {(loss, gnorm)} vs plain {plain}")

    def after(eng, by_name):
        fixed = itertools.repeat((tokens[:micro],))
        fit = [float(eng.train_batch(fixed)) for _ in range(fit_steps)]
        print(f"train fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over {fit_steps} steps")
        if not fit[0] - fit[-1] >= 0.5:
            raise AssertionError(f"fixed-batch loss fell only {fit[0] - fit[-1]}")
        flash = {}
        for name, (t, c) in by_name.items():
            m = re.search(r"\b(fwd_sm90_kernel|fwd_kernel|dkdv_kernel|dq_kernel|"
                          r"dense_dkdv_kernel|dense_dq_kernel)\b", name)
            if m:
                t0, c0 = flash.get(m.group(1), (0.0, 0.0))
                flash[m.group(1)] = (t0 + t, c0 + c)
        print(f"profile train {preset}: flash kernels' device time per captured step: " +
              "; ".join(f"{k} {t:.1f} us ({c:.0f} launches)" for k, (t, c) in flash.items()))

    res = ab_train(lambda impl: train_engine(dev, np_params, tokens, "flash", preset, seq,
                                             micro, step_impl=impl),
                   f"train {preset} T={seq} micro {micro} bf16 zero1", per_step, card,
                   micro * seq, model.flops_per_token(), warmup=warmup, timed=timed,
                   first=first, after=after)
    for opt in TRAIN_OPTIMIZERS:
        other_optimizer(dev, np_params, tokens, preset, seq, micro, opt, per_step)
    return res


# the other optimizers the config admits, each through the captured step too
TRAIN_OPTIMIZERS = ({"type": "Lamb", "params": {"lr": 6e-4, "weight_decay": 0.01}},
                    {"type": "SGD", "params": {"lr": 1e-2, "momentum": 0.9,
                                               "nesterov": True, "weight_decay": 1e-4}})


def other_optimizer(dev, np_params, tokens, preset, seq, micro, optimizer, per_step,
                    steps=3):
    """``steps`` steps of phase 5's run with ``optimizer`` in place of
    AdamW, captured and eager from the same weights and data: finite
    losses, no skip, exact launches, the captured step one graph, every
    loss and grad norm bit-equal between the impls."""
    curves = {}
    for impl in ("graph", "eager"):
        eng = train_engine(dev, np_params, tokens, "flash", preset, seq, micro,
                           step_impl=impl, optimizer=optimizer)
        fa.reset_launches()
        runs0 = kernel_runs(eng)
        curves[impl] = [(float(eng.train_batch()), eng.get_global_grad_norm())
                        for _ in range(steps)]
        tag = f"train {preset} {optimizer['type']} {impl}"
        check_launches(tag, dict(fa.launches), per_step, kernel_runs(eng) - runs0)
        captured = impl == "graph" and eng.device.type == "cuda"
        if (not all(math.isfinite(x) for x, _ in curves[impl]) or eng.skipped_steps != 0
                or eng.stats()["graphs"]["graphs"] != captured):
            raise AssertionError(f"{tag}: {curves[impl]}, skipped {eng.skipped_steps}, "
                                 f"{eng.stats()['graphs']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if curves["graph"] != curves["eager"]:
        raise AssertionError(f"train {preset} {optimizer['type']}: captured {curves['graph']} "
                             f"!= eager {curves['eager']}")
    print(f"train {preset} {optimizer['type']} {optimizer['params']}: {steps} steps captured "
          f"(one graph) and eager, losses and grad norms bit-equal "
          f"{[(round(x, 6), round(g, 6)) for x, g in curves['graph']]}, launches per kernel "
          f"run as AdamW's")


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


def check_masked_case(q, k, v, do, lut, kb, ab, causal, what, held=None, c1=False):
    """Each kernel of a biased / LUT case against its plain version on the
    same inputs (the backward ones fed the kernel's own O and lse); where
    the forward, dK/dV or dQ routes to its sm90 kernel, the template too
    (:func:`fwd_templates`, :func:`bwd_templates`).
    ``held``: the kernels whose outputs are held (all by default); with
    ``c1`` the dK/dV kernel's (and its template's) also against C1_BOUND
    (:func:`c1_close`).  On the
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
    dkdv = {names[1]: (dk, dv)}
    for name, (template, call) in bwd_templates(q, k, v, do, lut, kb, ab, causal,
                                                names).items():
        got = call(lse, delta)
        if name == names[1]:
            dkdv[template] = got
        pairs[template] = ([("dk", got[0], rdk), ("dv", got[1], rdv)] if name == names[1]
                           else [("dq", got, rdq)])
    torch.cuda.synchronize()
    if c1:
        c1_close(what, q, k, v, do, lse, delta, causal, lut, kb, ab, dkdv)
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
                                    causal, what, held, c1=held is not None)
            for name, rows in res.items():
                max_err[name] = max([max_err[name]] + [err for _, err, _ in rows])
            note = "" if held is None else " (dK/dV held against the C1 bound instead)"
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
BERT_TIMED = 5                    # phase 8's timed steps a pass, as phase 18's


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
                seq=2048, micro=8, step_impl="auto", dtype=torch.bfloat16, over=None):
    """``build(preset)`` -> ``extend_position_embedding`` (to ``seq``) ->
    ``initialize`` -> ``replace_model_self_attention`` with the layout of
    the engine config's ``sparse_attention`` section (``plain``: the
    ``_masked_dense`` attention instead, eager: it copies the layout to the
    card each call, which a capture refuses).  ``dtype``: the compute dtype;
    ``over``: config keys over BERT_CONFIG (phase 18's fp16 block)."""
    model = build(preset, dtype=dtype, device=dev)
    params, model = extend_position_embedding(base, model, seq)
    config = dict(BERT_CONFIG, train_micro_batch_size_per_gpu=micro,
                  sparse_attention=section, **(over or {}))
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        config=config, model=model, params=params, training_data=data,
        step_impl="eager" if plain else step_impl)
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
    train_batch; 8 and 8c captured and eager (:func:`ab_train`).  Returns
    the launches of each phase's captured run and the :func:`ab_train`
    results of 8 and 8c."""
    vocab = build(preset, device=dev).config.vocab_size
    base = build(preset, device=dev).init(0)          # the 512-row position table
    data = bert_data(0, 64, seq, vocab)
    eng = bert_engine(dev, base, data, plain=True, preset=preset, seq=seq, micro=micro)
    plain = (float(eng.train_batch()), eng.get_global_grad_norm())
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    model = build(preset, device=dev)
    c = model.config
    L = c.n_layer
    # flash_fwd_lut_sm90, flash_bwd_dkdv_lut_sm90 and flash_bwd_dq_lut_sm90 at BERT-large's
    # head dim 64, with the padding bias (8b: without it)
    head_dim = c.hidden_size // c.n_head
    fwd = fa.sparse_fwd_kernel(torch.bfloat16, head_dim, False, True)
    fwd_8b = fa.sparse_fwd_kernel(torch.bfloat16, head_dim, False, False)
    dkdv = fa.sparse_dkdv_kernel(torch.bfloat16, head_dim, False)
    dq = fa.sparse_dq_kernel(torch.bfloat16, head_dim, False)
    per_step = {fwd: 2 * L, dkdv: L, dq: L}
    lut = fa.layout_luts(np.asarray(build_sparsity_config(SPARSE_SECTION, c.n_head)
                                    .make_layout(seq), np.int32), seq, c.n_head, False)
    print(f"train {preset} T={seq} micro {micro} bf16 zero1 remat sparse16, hidden dropout "
          f"{c.hidden_dropout} (captured: each mask from a generator registered with the graph "
          f"and re-seeded before each replay): tile density {lut.tile_density:.3f}, element "
          f"density {lut.element_density:.4f}; tokens/s count padded positions, MFU by "
          f"flops_per_token (dense attention FLOPs at T={seq})")

    def first(eng, loss, gnorm):
        gaps = (abs(loss - plain[0]), abs(gnorm - plain[1]) / abs(plain[1]))
        print(f"train {preset} step 1 (captured): loss kernels {loss:.6f} plain "
              f"{plain[0]:.6f}; grad norm kernels {gnorm:.6f} plain {plain[1]:.6f} (gaps "
              f"{gaps[0]:.3e} abs, {gaps[1]:.3e} rel; tol {BERT_STEP1_LOSS_TOL:g} abs, "
              f"{BERT_STEP1_GNORM_TOL:g} rel)")
        if not (gaps[0] <= BERT_STEP1_LOSS_TOL and gaps[1] <= BERT_STEP1_GNORM_TOL):
            raise AssertionError(f"step 1 kernels {(loss, gnorm)} vs plain {plain}")

    def after(eng, by_name):
        first_batch = {key: val[:micro] for key, val in data.items()}
        fixed = itertools.repeat(first_batch)
        fit = [float(eng.train_batch(fixed)) for _ in range(fit_steps)]
        print(f"train {preset} fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over "
              f"{fit_steps} steps (margin {BERT_FIT_MARGIN})")
        if not fit[0] - fit[-1] >= BERT_FIT_MARGIN:
            raise AssertionError(f"fixed-batch loss fell only {fit[0] - fit[-1]}")
        for what, pattern, name, template in (
                ("forward", r"\bfwd_lut_sm90_kernel", fwd, "flash_fwd_lut took 87.8"),
                ("dK/dV", r"\bdkdv_", dkdv, "flash_bwd_dkdv_lut took 78.40"),
                ("dQ", r"\bdq_", dq, "flash_bwd_dq_lut took ~38.5")):
            spent = [(t, n) for kname, (t, n) in by_name.items() if re.search(pattern, kname)]
            print(f"profile train {preset} sparse16: {what} device time per captured step "
                  f"{sum(t for t, _ in spent) / 1e3:.2f} ms over {sum(n for _, n in spent):.0f} "
                  f"launches ({name}; the template {template} ms a step, PERF.md section 5) "
                  f"({card})")

    results = {"8": ab_train(
        lambda impl: bert_engine(dev, base, data, preset=preset, seq=seq, micro=micro,
                                 step_impl=impl),
        f"train {preset} T={seq} micro {micro} bf16 zero1 remat sparse16", per_step, card,
        micro * seq, model.flops_per_token(), warmup=warmup, timed=timed, profile_n=1,
        first=first, after=after)}
    counts = {"8": results["8"]["graph"]["counts"]}

    # 8b: unpadded batches (packed sequences): the forward with no bias
    eng = bert_engine(dev, base, bert_data(1, 16, seq, vocab, False), preset=preset, seq=seq,
                      micro=micro)
    torch.cuda.synchronize()
    fa.reset_launches()
    run = [float(eng.train_batch()) for _ in range(2)]
    counts["8b"] = dict(fa.launches)
    want = {fwd_8b: 2 * L, dkdv: L, dq: L}
    check_launches(f"train {preset} 8b", counts["8b"], want, kernel_runs(eng))
    if not all(math.isfinite(x) for x in run) or eng.skipped_steps != 0:
        raise AssertionError(f"8b: losses {run}, skipped {eng.skipped_steps}")
    print(f"train {preset} 8b (unpadded, mode fixed): 2 steps, losses "
          f"{[round(x, 4) for x in run]}, launches per kernel run " + ", ".join(
              f"{n} {counts['8b'][n] // kernel_runs(eng)}" for n in want)
          + f"; {engine_graphs_line(eng)}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    # 8c: "mode": "dense" (an all-ones layout) with padding: the key-bias instances of
    # flash_fwd_sm90 (biased_fwd_kernel) and of flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90
    # (biased_bwd_kernel)
    fwd_8c = fa.biased_fwd_kernel(torch.bfloat16, head_dim, False)
    dkdv_8c, dq_8c = fa.biased_bwd_kernel(torch.bfloat16, head_dim, False)
    dense = {"mode": "dense", "block": 16}
    data_8c = bert_data(1, 32, seq, vocab)

    def after_8c(eng, by_name):
        spent = {what: [(t, n) for kname, (t, n) in by_name.items()
                        if re.search(pattern, kname)]
                 for what, pattern in (("forward", r"\bfwd_sm90_kernel"),
                                       ("dK/dV", r"\bdense_dkdv_kernel"),
                                       ("dQ", r"\bdense_dq_kernel"))}
        ms = {what: sum(t for t, _ in v) / 1e3 for what, v in spent.items()}
        print(f"profile train {preset} 8c dense: dense biased forward device time per captured "
              f"step {ms['forward']:.2f} ms over {sum(n for _, n in spent['forward']):.0f} "
              f"launches ({fwd_8c} {KEY_BIAS}; the template design took 83.8 ms a step, "
              f"PERF.md section 5), dense biased backward device time per step "
              f"{ms['dK/dV'] + ms['dQ']:.2f} ms (" +
              ", ".join(f"{what} {ms[what]:.2f} ms over {sum(n for _, n in spent[what]):.0f} "
                        f"launches" for what in ("dK/dV", "dQ"))
              + f"; {dkdv_8c} / {dq_8c}; the template design took 24 x 4.03 ms a step, "
              f"PERF.md section 6) ({card})")

    results["8c"] = ab_train(
        lambda impl: bert_engine(dev, base, data_8c, section=dense, preset=preset, seq=seq,
                                 micro=micro, step_impl=impl),
        f"train {preset} 8c dense padded", {fwd_8c: 2 * L, dkdv_8c: L, dq_8c: L}, card,
        micro * seq, model.flops_per_token(), warmup=2, timed=5, profile_n=1,
        after=after_8c)
    counts["8c"] = results["8c"]["graph"]["counts"]
    return counts, results


# ------------------------------------------- 9. sparse kernels at the shape
def sparse_timing(dev, gen, bytes_per_s, card, B=8, T=2048, H=16, d=64, dtype=torch.bfloat16,
                  cases=None):
    """Phase 9 at the training shape (q, k, v views of one qkv tensor):
    the biased / LUT kernels of four cases, each held against its plain
    version, then timed beside its bound, its plain version and SDPA with
    the expanded boolean layout-and-padding mask (forward, forward+backward
    and the backward alone: ``autograd.grad`` over a retained graph); where
    the forward, dK/dV or dQ takes its sm90 kernel, the template (the
    template design) on the same call beside it; the forwards three
    readings each (median, min, max); then the path's forward+backward
    (``sparse_flash_attention`` under ``autograd.grad``).
    The backward kernels' library time is SDPA's backward alone.  ``dtype``
    (bf16 in phase 9, fp16 in phase 17d) and ``cases`` (a subset of the
    four) select the run.  Returns {case: {kernel: kernels-line fields}} and
    the cases' densities."""
    q, k, v, do = flash_inputs(dev, gen, dtype, B, T, H, d, "qkv")
    keep = torch.arange(T, device=dev)[None, :] < key_lengths(gen, B, T, dev)[:, None]
    kb = torch.where(keep, 0.0, -10000.0).float()
    tutorial = build_sparsity_config(SPARSE_SECTION, H)
    fixed64 = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1, attention="bidirectional")
    lut16 = fa.layout_luts(tutorial.make_layout(T), T, H, False)
    lut64 = fa.layout_luts(fixed64.make_layout(T), T, H, False)
    cases = {name: run for name, run in (("tutorial16+pad", (lut16, kb)),
                                         ("tutorial16", (lut16, None)),
                                         ("fixed64", (lut64, None)),
                                         ("dense+pad", (None, kb)))
             if cases is None or name in cases}
    dname = str(dtype)[6:]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    elem, stat = B * T * H * d * 2, B * H * T * 4
    saved = dict(fa.launches)
    out, density = {}, {}
    for case, (lut, bias) in cases.items():
        what = f"B={B} T={T} H={H} d={d} {dname} qkv views {case}"
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
        print(f"timing SDPA {case} (B, H, T, d) {dname} with the boolean layout-and-padding "
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
INT8_SPEC_M = (8 * (4 + 1),)   # phase 16's window products: 8 slots x (SPEC's k = 4, + 1)
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
    drawn from a generator of its own) and INT8_SPEC_M, the speculative
    step's M, drawn from another (``int8_mm_nt_decode`` takes the
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
    spec_gen = torch.Generator(device=dev).manual_seed(29)
    for preset, shapes in INT8_SHAPES.items():
        for wname, (rows, cols) in shapes.items():
            t = wname == "wte"
            q = torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                              dtype=torch.int8)
            K, N = (cols, rows) if t else (rows, cols)
            for M in INT8_M + (INT8_HEAD_M if t else ()) + INT8_SPEC_M:
                g = head_gen if M in INT8_HEAD_M else spec_gen if M in INT8_SPEC_M else gen
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


def call_ms(fn, n=5, warmup=2):
    """Wall ms of ``fn()`` through a synchronize, ``n`` readings after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


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
    token_step, token_state = engine._token_steps[(4, 80, False)]
    runs = token_step.replays + token_step.warmups      # 15 replays + its warm-up
    prefill_step = token_state["prefills"][64]
    pre_runs = prefill_step.replays + prefill_step.warmups      # 1 replay + its warm-up
    # the captured prefill's runs of 4 x 64 rows, the token step's runs of 4 rows, the head
    # each time
    if gen_launches != {"int8_mm_nt_prefill": pre_runs * 4 * c.n_layer, "int8_mm_nt": 0,
                        "int8_mm_nt_decode": runs * 4 * c.n_layer, "int8_mm_t": runs,
                        "int8_mm_t_prefill": pre_runs} or token_step.replays != 15 \
            or (prefill_step.captures, prefill_step.replays) != (1, 1):
        raise AssertionError(f"generate launches {gen_launches} ({runs} token-step runs, "
                             f"{pre_runs} prefill runs)")
    # generate's prefill: its graph's replay against its body run eagerly, wall per call
    ptoks = torch.as_tensor(np.stack(gp))
    with torch.no_grad():
        pre_ms = {"captured": call_ms(lambda: prefill_step(tokens=ptoks)),
                  "eager": call_ms(lambda: prefill_step.body(
                      tokens=prefill_step.static["tokens"]))}
    print(f"generate prefill B=4 T=64 ({prefill_step.name}: {pre_runs} runs in the generate "
          f"call, launches above), wall ms per call: " + "; ".join(
              f"{k} {statistics.median(w):.3f} (readings {', '.join(f'{x:.3f}' for x in w)}; "
              f"spread {max(w) - min(w):.3f})" for k, w in pre_ms.items()))
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


def copy_device_time(by_name, tag, unit="decode step"):
    """The copies' device time per ``unit`` from a profile: every kernel or
    memcpy whose name says copy (casts, contiguous copies, the static
    buffers' refills and, before the head was padded once, the 77 MB vocab
    pad of ``wte``)."""
    rows = {name: tn for name, tn in by_name.items()
            if any(k in name.lower() for k in ("copy", "memcpy"))}
    t = sum(tn[0] for tn in rows.values())
    n = sum(tn[1] for tn in rows.values())
    print(f"profile {tag}: copies' device time per {unit} {t:.1f} us over {n:.1f} launches: "
          + "; ".join(f"{name[:70]} {tn[0]:.1f} us ({tn[1]:.1f})"
                      for name, tn in sorted(rows.items(), key=lambda kv: -kv[1][0])[:4]))
    return t


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


def check_path_seeds(dev, seeds=(23, 24, 25), B=1, H=8, d=64):
    """Phase 14's backward over three seeds (generators of their own) at its
    shapes up to PLAIN_T_MAX, as :func:`check_band_merge_seeds` holds the
    forwards: the banded path (``SparseSelfAttention``, forward and
    ``backward()``, launches 1/1/1) fed each seed's q/k/v and dO; dQ
    against its plain version with phase 2's limit, dK/dV under C1_BOUND
    (C1's second case: no single draw decides).  Returns the largest share
    of the limit per output."""
    worst = {}
    for block, T in itertools.product(WORKLOAD_BLOCKS, WORKLOAD_T):
        if T > PLAIN_T_MAX:
            continue
        attn = SparseSelfAttention(workload_config(H, block), max_seq_length=T)
        lut = fa.layout_luts(attn.get_layout(T), T, H, True)
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
            do = torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
            leaf = qkv.requires_grad_(True)
            out, _ = path_run("banded", attn, leaf, do, B, T, H, d)
            q, k, v = (t.detach().view(B, T, H, d) for t in leaf.split(H * d, dim=-1))
            dq, dk, dv = (g.view(B, T, H, d) for g in leaf.grad.split(H * d, dim=-1))
            o, lse = fa.flash_fwd_banded(q, k, v, fa.band_lut(
                *fa.banded_structure(lut.layout, True), block, T))
            delta = fa.attention_delta(o, do)
            what = f"B={B} T={T} H={H} d={d} bf16 block {block} seed {seed}"
            rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut)
            rows = [("dq", *flash_close(f"path-seeds {what}", "dq", dq, rdq))]
            del rdq
            rows += c1_close(what, q, k, v, do, lse, delta, True, lut, None, None,
                             {"flash_bwd_dkdv_lut_sm90": (dk, dv)})["flash_bwd_dkdv_lut_sm90"]
            for label, _, share in rows:
                worst[label] = max(worst.get(label, 0.0), share)
            print(f"path-seeds banded {what}: dq (phase 2's limit), dk and dv (the C1 bound) "
                  f"{flash_line({'': rows})}")
            del qkv, do, leaf, out, q, k, v, dq, dk, dv, o, lse, delta
            torch.cuda.empty_cache()
    return worst


CKPT_WARMUP_STEPS = 10      # phase 15's WarmupLR warm-up: the lr moves at every step it runs
CKPT_TIMED = 3              # saves and loads timed in phase 15 (the median is reported)
CKPT_LAYERS = 2             # phase 15's depth: GPT-2 350M's width at 2 of its 24 layers


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
                      timed=CKPT_TIMED, new=8, n_layer=CKPT_LAYERS):
    """Phase 15: training -> save -> resume -> serve at phase 5's
    configuration with WarmupLR, cut to ``n_layer`` layers (full width).  Run A trains ``steps`` steps, saves,
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
                    attention_impl="flash", n_layer=n_layer)

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
        a_graphs = engine_graphs_line(a)
        if a.step_impl != "graph" or a.stats()["graphs"]["captures"] != 1:
            raise AssertionError(f"run A's step is not captured once: {a.stats()['graphs']}")
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
        runs0 = kernel_runs(b)
        run_b = run(b)
        counts = dict(fa.launches)
        runs_b = kernel_runs(b) - runs0
        per_step = {name: n_layer for name in (fa.dense_fwd_kernel(torch.bfloat16, head_dim),
                                               *fa.dense_bwd_kernel(torch.bfloat16, head_dim))}
        check_launches(f"checkpoint resume {preset}", counts, per_step, runs_b)
        if b.step_impl != "graph" or b.stats()["graphs"]["graphs"] != 1:
            raise AssertionError(f"run B's step is not captured: {b.stats()['graphs']}")
        same_batches("checkpoint load", b_batches, a_batches[steps:2 * steps])
        if run_b[0] != run1[0]:
            raise AssertionError(f"step {steps + 1} loss after load {run_b[0]!r} != "
                                 f"{run1[0]!r}")
        load_diff = max(abs(x - y) for x, y in zip(run1[1:], run_b[1:]))
        if load_diff > repeat_diff:
            raise AssertionError(f"steps {steps + 2}-{2 * steps} after load differ by "
                                 f"{load_diff!r}, a repeat by {repeat_diff!r}")
        print(f"checkpoint {preset} ({n_layer} layers) T={seq} micro {micro} bf16 zero1 "
              f"WarmupLR: {n_leaves} "
              f"leaves (params, master, exp_avg, exp_avg_sq) torch.equal after load and after "
              f"the repeat's reload; counters, lr {counters['lr']!r}, loader "
              f"{counters['loader']} equal; steps {steps + 1}-{2 * steps} losses A {run1} "
              f"repeat {run2} B {run_b}; step {steps + 1} bit-equal; steps {steps + 2}-"
              f"{2 * steps} max |B - A| {load_diff!r} <= max |repeat - A| {repeat_diff!r}; "
              f"launches per kernel run after load ({runs_b} runs: {steps} replays and the "
              f"warm-up) " + ", ".join(f"{n} {counts[n] // runs_b}" for n in fa.DENSE_KERNELS)
              + f"; A's graph held across its reload ({a_graphs}); B {engine_graphs_line(b)}")

        # serving from the checkpoint against the in-memory weights of step `steps`
        ids = np.random.default_rng(15).integers(0, vocab, (2, 32))
        ref = InferenceEngine(GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16,
                                   device=dev, n_layer=n_layer), params=ref_params)
        ck = InferenceEngine(GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16,
                                  device=dev, n_layer=n_layer), checkpoint=save_dir)
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
        print(f"checkpoint timing {preset} ({n_layer} layers): model file {sizes[MODEL_FILE]} B, optim file "
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


# ------------------------------------------------ 16. speculative serving
SPEC = {"k": 4, "ngram": 3}
assert INT8_SPEC_M == (8 * (SPEC["k"] + 1),)
# where a bf16 speculative stream may part from plain decode: the W = k + 1 step runs its
# GEMMs at M = 8 x 5 rows where the plain step runs M = 8, so its activations round at other
# places.  Where the two steps' logits differ by at most d, two candidates can swap order
# only where the plain step's top-2 gap is within 2 d.  d is measured in the same run,
# before the serves: the largest |delta logits| of one speculative step against the k + 1
# plain steps it stands for (spec_window_noise), over every kv width of the preset.  Set
# before phase 16's first run with this rule; the first runs (position 0 only) read d
# 2.6e-2 to 2.8e-2 at 125M and 5.7e-2 at 1.3B int8 on an H100 80GB HBM3 at 700 W.
SPEC_GAP_FACTOR = 2.0
SPEC_LOOPY = 8          # loopy prompts: a short random sequence tiled, the drafter's best case


def seated(srv):
    return [i for i, s in enumerate(srv._slots) if s is not None]


class GapServer(ServingEngine):
    """A plain server that keeps the plain step's top-2 logit gap for each
    token it decodes, by (uid, token index)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.gaps = {}

    def _decode_body(self, toks, tables, lengths):
        out = super()._decode_body(toks, tables, lengths)
        self.step_logits = out[0]       # the captured step's static logits, or this call's
        return out

    def _decode(self, active):
        res = super()._decode(active)
        top = self.step_logits.topk(2, dim=-1).values
        gap = (top[:, 0] - top[:, 1]).cpu().numpy()
        for i in active:
            self.gaps[self._slots[i].req.uid, int(self._ngen[i])] = float(gap[i])
        return res


class TimedCall:
    """``step`` whose calls (the static inputs' refill and the replay's
    launch) are timed on the host into ``out`` (ms)."""

    def __init__(self, step, out):
        self.step, self.out = step, out

    def __call__(self, **values):
        t0 = time.perf_counter()
        res = self.step(**values)
        self.out.append((time.perf_counter() - t0) * 1e3)
        return res

    def __getattr__(self, name):
        return getattr(self.step, name)


class SplitServer(ServingEngine):
    """A server that times each decode step's parts on the host (ms):
    ``draft``, building the window (``_window``, the n-gram drafter);
    ``call``, the step call (refill and replay launch); ``decode``, the
    whole of ``_decode``, the step wall the stats read.  What is left of
    ``decode`` is the one read, which waits for the device, and any
    sampling."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.split = {"draft": [], "call": [], "decode": []}

    def _window(self, active):
        t0 = time.perf_counter()
        win = super()._window(active)
        self.split["draft"].append((time.perf_counter() - t0) * 1e3)
        return win

    def _decode_graph(self):
        return TimedCall(super()._decode_graph(), self.split["call"])

    def _decode(self, active):
        t0 = time.perf_counter()
        res = super()._decode(active)
        self.split["decode"].append((time.perf_counter() - t0) * 1e3)
        return res


def host_split(engine, traffic, new, tag, kv_bits):
    """The decode step's host split, speculative and plain, on ``traffic``:
    a first serve (captures), then a timed one whose per-step medians are
    printed and returned as {mode: {part: median ms}}."""
    out = {}
    for mode, spec in (("spec", SPEC), ("plain", None)):
        srv = SplitServer(engine=engine, config=ServingConfig(
            batch_slots=8, block_size=16, kv_bits=kv_bits, max_new_tokens=new, speculative=spec))
        srv.run([Request(tokens=p, uid=i) for i, p in enumerate(traffic)])
        for v in srv.split.values():
            v.clear()
        srv.run([Request(tokens=p, uid=1000 + i) for i, p in enumerate(traffic)])
        sp = srv.split
        rest = [d - w - c for d, w, c in zip(sp["decode"], sp["draft"], sp["call"])]
        out[mode] = {"steps": len(sp["decode"]), "draft": statistics.median(sp["draft"]),
                     "call": statistics.median(sp["call"]), "read": statistics.median(rest),
                     "decode": statistics.median(sp["decode"])}
        print(f"host split {tag} {mode}: per decode step over {out[mode]['steps']} steps, "
              f"medians on the host's clock: window build (drafter) "
              f"{out[mode]['draft']:.3f} ms, step call (refill + replay launch) "
              f"{out[mode]['call']:.3f} ms, the rest (the read, waiting on the device, and "
              f"sampling) {out[mode]['read']:.3f} ms; the whole step "
              f"{out[mode]['decode']:.3f} ms")
        del srv
    return out


def spec_divergence(tag, plain, spec, gaps, limit):
    """Where speculative streams part from the plain ones: each request's
    first differing token index and the plain step's top-2 gap there,
    which must be within ``limit``.  Prints the share of all plain tokens
    whose gap is within it (where the rule would let a stream part)."""
    parted = []
    for u in sorted(plain):
        j = next((j for j, (a, b) in enumerate(zip(plain[u], spec[u])) if a != b), None)
        if j is None:
            continue
        gap = gaps.get((u, j))
        parted.append((u, j, gap))
        if gap is None or not gap <= limit:
            raise AssertionError(f"{tag}: uid {u} parts from plain decode at token {j} where "
                                 f"the plain step's top-2 gap is {gap} (limit {limit})")
    within = sum(g <= limit for g in gaps.values())
    print(f"spec vs plain {tag}: {len(plain) - len(parted)}/{len(plain)} streams identical; "
          f"partings (uid, token, plain top-2 gap): {parted} (limit {limit:.4e}); plain "
          f"tokens with a top-2 gap within the limit: {within}/{len(gaps)} "
          f"({within / len(gaps):.4f})")
    return parted


def spec_serve(engine, traffic, new, tag, kv_bits, limit, loopy=()):
    """A plain serve that records its gaps and a speculative one on the
    same traffic, both through :func:`run_checked` (launches, outcomes,
    recycling); accepted drafts > 0 on the ``loopy`` uids; the divergence
    rule at ``limit``.  Returns (speculative server, its tokens, plain
    tokens)."""
    base = dict(batch_slots=8, block_size=16, kv_bits=kv_bits, max_new_tokens=new)
    plain_srv = GapServer(engine=engine, config=ServingConfig(**base))
    _, _, plain = run_checked(plain_srv, engine, traffic, new, f"{tag} plain", "auto")
    srv, _, spec = run_checked(ServingEngine(engine=engine, config=ServingConfig(
        **base, speculative=SPEC)), engine, traffic, new, f"{tag} spec", "auto")
    if srv._decode_step.name != (f"serving.decode[8x{srv.nb_max}x16,kv{kv_bits},"
                                 f"spec{SPEC['k']}]"):
        raise AssertionError(f"{tag}: decode step {srv._decode_step.name}")
    if loopy:
        accepted = sum(srv.results[u]["spec"]["accepted"] for u in loopy)
        print(f"spec {tag}: accepted drafts on the loopy prompts {accepted} of "
              f"{sum(srv.results[u]['spec']['proposed'] for u in loopy)} proposed")
        if not accepted > 0:
            raise AssertionError(f"{tag}: no draft accepted on the loopy prompts")
    spec_divergence(tag, plain, spec, plain_srv.gaps, limit)
    return srv, spec, plain


def spec_window_noise(engine, prompts, tag, kv_bits, tol):
    """One speculative step against the k + 1 plain steps it stands for,
    on the same seated state: the window holds the current token and the
    plain steps' own next k tokens (a draft accepted whole), so window
    position i sees what plain step i saw.  Max |delta logits| over every
    slot and position, which must be within ``tol``; returns it."""
    W = SPEC["k"] + 1
    cfg = dict(batch_slots=8, block_size=16, kv_bits=kv_bits, max_new_tokens=W + 2)
    plain = GapServer(engine=engine, config=ServingConfig(**cfg))
    spec = ServingEngine(engine=engine, config=ServingConfig(**cfg, speculative=SPEC))
    seat(plain, prompts)
    seat(spec, prompts)
    rows = seated(spec)
    if rows != seated(plain) or not np.array_equal(plain._toks, spec._toks):
        raise AssertionError(f"{tag}: the two servers seated different states")
    lp = []
    for _ in range(W):
        plain.step()
        lp.append(plain.step_logits[rows].clone())
    lp = torch.stack(lp, dim=1)
    win = np.repeat(spec._toks[:, None], W, axis=1)
    for i in rows:
        win[i, 1:] = plain._slots[i].out_tokens[1:W]
    with torch.no_grad():
        ls = spec._decode_graph()(toks=win, tables=spec._tables,
                                  lengths=spec._lengths)[0][rows]
    if not (torch.isfinite(ls).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"{tag}: window logits not finite")
    err = (lp - ls).abs()
    by_pos = err.amax(dim=(0, 2)).tolist()
    err = max(by_pos)
    print(f"spec window noise {tag}: one speculative step vs the {W} plain steps it stands "
          f"for, max |delta logits| {err:.3e} (by window position "
          f"{', '.join(f'{e:.3e}' for e in by_pos)}; tolerance {tol}), argmax agree "
          f"{(lp.argmax(-1) == ls.argmax(-1)).sum().item()}/{len(rows) * W}")
    if not err <= tol:
        raise AssertionError(f"{tag}: the speculative step's logits differ from plain "
                             f"decode's by {err} (tolerance {tol})")
    del plain, spec
    return err


def spec_serving(dev, card, prompts, new=32, presets=("gpt2-125m", "gpt2-1.3b")):
    """Phase 16: speculative serving (k = 4, ngram 3) of GPT-2 125M (bf16,
    ``init_numpy(seed=0)``) on phase 3's 16 requests and SPEC_LOOPY loopy
    prompts, kv16 and kv8, then GPT-2 1.3B with int8 weights on phase 11's
    traffic.  Returns the 1.3B speculative serve's int8 launches."""
    model = GPT2(preset=presets[0], dtype=torch.bfloat16, device=dev)
    engine = InferenceEngine(model, params_from_jax(model.init_numpy(seed=0), dev,
                                                    torch.bfloat16))
    rng = np.random.default_rng(16)
    V = model.config.vocab_size
    loopy = [np.tile(rng.integers(0, V, (int(rng.integers(4, 17)),)), 64)[:int(n)]
             for n in rng.integers(64, 257, (SPEC_LOOPY,))]
    traffic = list(prompts) + loopy
    loopy_uids = range(len(prompts), len(traffic))
    noise = max(spec_window_noise(engine, prompts[::2], f"125M kv{kv_bits}", kv_bits,
                                  LOGIT_TOL) for kv_bits in (16, 8))
    limit = SPEC_GAP_FACTOR * noise
    print(f"spec gap limit 125M: {SPEC_GAP_FACTOR} x {noise:.4e} = {limit:.4e}")
    for kv_bits in (16, 8):
        tag = f"125M kv{kv_bits}"
        srv, spec, plain = spec_serve(engine, traffic, new, tag, kv_bits, limit, loopy_uids)
        del srv
        if kv_bits == 16:
            ab_serve(engine, traffic, new, f"{tag} spec", 16, spec, spec=SPEC)
            ab_serve(engine, traffic, new, f"{tag} plain (phase 16 traffic)", 16, plain,
                     impls=("fused",))
            host_split(engine, traffic, new, tag, 16)
        gc.collect()
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    # GPT-2 1.3B, int8 weights: the window's products take the prefill kernels
    model = GPT2(preset=presets[1], dtype=torch.bfloat16, device=dev)
    engine = deepspeed_tpu_torch.init_inference(model, params=draw_gpt2_params(model, dev, 0),
                                                dtype=torch.int8)
    gc.collect()
    noise = spec_window_noise(engine, prompts[::2], "1.3B int8w kv16", 16, INT8_LOGIT_TOL)
    limit = SPEC_GAP_FACTOR * noise
    print(f"spec gap limit 1.3B int8w: {SPEC_GAP_FACTOR} x {noise:.4e} = {limit:.4e}")
    srv, _, _ = spec_serve(engine, prompts, new, "1.3B int8w kv16", 16, limit)
    launches = dict(srv.int8_launches)
    prof = ServingEngine(engine=engine, config=ServingConfig(
        batch_slots=8, block_size=16, max_new_tokens=new, speculative=SPEC))
    for i, p in enumerate(prompts[:8]):
        prof.submit(Request(tokens=p, uid=i))
    by_name = profile_steps(prof.step, "1.3B int8w spec")
    int8_device_time(by_name, "gpt2-1.3b", "speculative step", "int8_prefill_kernel",
                     "int8_mm_nt_prefill", "int8_t_prefill_kernel", "int8_mm_t_prefill")
    del srv, prof, engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------- 17. fp16 training at full width
FP16 = "fp16"               # the kernels line's name suffix of the fp16 instances
FP16_SEED = 30              # phase 17a's inputs come from a generator of their own
FP16_T = (127, 129, 1024, 1088)
FP16_INF_AT = 65520.0       # the least magnitude fp16's round-to-nearest takes to inf
# phase 17b's configuration: phase 5's with the dynamic loss scaler
FP16_CONFIG = {"fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16,
                        "loss_scale_window": 1000, "hysteresis": 2, "min_loss_scale": 1}}
FP16_SOURCES = ("flash_attention_fwd_sm90.cu", "flash_attention_sparse_bwd_sm90.cu",
                "flash_attention_sparse_fwd_sm90.cu", "flash_attention_sm90.cuh",
                "flash_attention.cuh")


def fp16_rows(q, k, v, do, causal, what, bwd=True):
    """The fp16 instances against their plain versions on one input (the
    routed forward; dK/dV and dQ fed its O and lse when ``bwd``): each
    route must name the sm90 entry.  Returns {kernel: [(output, max abs
    error, share of limit)]}."""
    d = q.shape[-1]
    if fa.dense_fwd_kernel(q.dtype, d) != "flash_fwd_sm90" or (
            bwd and fa.dense_bwd_kernel(q.dtype, d) != fa.DENSE_BWD_SM90):
        raise AssertionError(f"{what}: fp16 does not route to the sm90 entries")
    o, lse = fa.flash_fwd(q, k, v, causal)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, causal)
    pairs = {"flash_fwd_sm90": [("o", o, ro), ("lse", lse, rlse)]}
    if bwd:
        delta = fa.attention_delta(o, do)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, causal)
        rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, causal)
        pairs["flash_bwd_dkdv_sm90"] = [("dk", dk, rdk), ("dv", dv, rdv)]
        pairs["flash_bwd_dq_sm90"] = [("dq", dq, rdq)]
    torch.cuda.synchronize()
    return {name: [(label, *flash_close(f"{name} fp16 {what}", label, got, ref))
                   for label, got, ref in ps] for name, ps in pairs.items()}


def first_fp16_launches(dev, gen):
    """The first fp16 launches: ``flash_fwd_sm90`` at T=64 for each head
    dim, then ``flash_bwd_dkdv_sm90`` / ``flash_bwd_dq_sm90`` at B=2 H=4
    d=64 T 33, 65 and 200, each waited for under SM90_DEADLINE_S and held
    against its plain version with the fp16 limit."""
    for d in fa.SM90_HEAD_DIMS[torch.float16]:
        q, k, v, _ = flash_inputs(dev, gen, torch.float16, 1, 64, 1, d, "dense")
        t0 = time.perf_counter()
        o, lse = fa.flash_fwd_sm90(q, k, v, True)
        ms = wait_first("flash_fwd_sm90 fp16", f"d={d}", t0)
        row = flash_close(f"first launch fp16 d={d}", "o", o,
                          fa.flash_attention_reference_fwd(q, k, v, True)[0])
        print(f"flash_fwd_sm90 fp16 first launch d={d} T=64: completed in {ms:.1f} ms, O max "
              f"abs error {row[0]:.2e} ({row[1]:.2f} of its limit)")
    for T in (33, 65, 200):
        q, k, v, do = flash_inputs(dev, gen, torch.float16, 2, T, 4, 64, "qkv")
        o, lse = fa.flash_attention_reference_fwd(q, k, v, True)
        delta = fa.attention_delta(o, do)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk, dv = fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta, True)
        ms = wait_first("flash_bwd_dkdv_sm90 fp16", f"T={T}", t0)
        t0 = time.perf_counter()
        dq = fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta, True)
        ms_dq = wait_first("flash_bwd_dq_sm90 fp16", f"T={T}", t0)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True)
        rdq = fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, True)
        rows = [(label, *flash_close(f"fp16 first launch T={T}", label, got, ref))
                for label, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq))]
        print(f"flash_bwd_dkdv_sm90 / flash_bwd_dq_sm90 fp16 first launches T={T}: completed "
              f"in {ms:.1f} / {ms_dq:.1f} ms; {flash_line({'': rows})}")


def check_fp16_overflow(dev, gen, B=8, T=1024, H=16, d=64):
    """dO (made positive, so dV sums without cancelling) scaled so that
    the plain fp32 |dV| passes FP16_INF_AT, each dO element kept finite in
    fp16: wherever a
    plain fp32 dK, dV or dQ element passes it by more than the fp16 limit,
    the fp16 kernel's element must be inf or NaN (no conversion
    saturates), and ``has_overflow`` over the three must be true.  The
    largest error among the finite elements, as a share of the limit
    against the unrounded fp32 plain values, is printed."""
    q, k, v, do = flash_inputs(dev, gen, torch.float16, B, T, H, d, "qkv")
    do = do.float().abs().clamp(max=4)
    o, lse = fa.flash_fwd(q, k, v, True)
    f32 = [x.float() for x in (q, k, v)]
    unit_dv = fa.flash_attention_reference_bwd_dkdv(
        *f32, do, lse, fa.attention_delta(o, do), True)[1]
    gain = 1.5 * FP16_INF_AT / unit_dv.abs().max().item()
    do = (do * gain).clamp(max=65504.0).to(torch.float16)
    delta = fa.attention_delta(o, do)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, True)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    rdk, rdv = fa.flash_attention_reference_bwd_dkdv(*f32, do.float(), lse, delta, True)
    rdq = fa.flash_attention_reference_bwd_dq(*f32, do.float(), lse, delta, True)
    a, r = FLASH_TOL[torch.float16]
    notes = []
    for label, got, ref in (("dk", dk, rdk), ("dv", dv, rdv), ("dq", dq, rdq)):
        limit = a * ref.pow(2).mean().sqrt() + r * ref.abs()
        past = ref.abs() > FP16_INF_AT + limit
        finite = torch.isfinite(got)
        if label == "dv" and not bool(past.any()):
            raise AssertionError(f"fp16 overflow: dO x {gain:.1f} took no plain |dV| past "
                                 f"{FP16_INF_AT}")
        if bool((past & finite).any()):
            raise AssertionError(f"fp16 overflow {label}: {int((past & finite).sum())} elements "
                                 f"past {FP16_INF_AT} in fp32 came out finite")
        inside = finite & (ref.abs() < 65504.0 - limit)
        share = torch.where(inside, (got.float() - ref).abs() / limit, 0.0).max().item()
        notes.append(f"{label} {int(past.sum())} past, {int((~finite).sum())} non-finite, "
                     f"largest share of the limit among finite elements {share:.2f}")
    flag = bool(ls.has_overflow({"dk": dk, "dv": dv, "dq": dq}))
    if not flag or not any(not torch.isfinite(x).all() for x in (dk, dv, dq)):
        raise AssertionError(f"fp16 overflow: has_overflow {flag}")
    for name in FP16_SOURCES:
        text = open(os.path.join(builder.CSRC, name)).read()
        if "satfinite" in text:
            raise AssertionError(f"{name}: a saturating conversion (.satfinite)")
    print(f"fp16 overflow B={B} T={T} H={H} d={d} causal, dO x {gain:.1f} (plain fp32 |dV| max "
          f"{rdv.abs().max().item():.1f}): {'; '.join(notes)}; has_overflow {flag}; no "
          f".satfinite in {', '.join(FP16_SOURCES)}")


def check_fp16_kernels(dev, B=8, H=16):
    """Phase 17a: the fp16 instances of rows 1, 3 and 4 against their plain
    versions with the fp16 limit, from a generator of their own (seed
    FP16_SEED): first launches, then the 350M shape (causal, qkv views) at
    T in FP16_T with d=64 (forward and backward) and d=128 (forward), then
    the overflow check.  Returns the max abs error per kernel."""
    gen = torch.Generator(device=dev).manual_seed(FP16_SEED)
    first_fp16_launches(dev, gen)
    max_err = {name: 0.0 for name in fa.DENSE_SM90}
    for T, d in itertools.product(FP16_T, fa.SM90_HEAD_DIMS[torch.float16]):
        what = f"B={B} H={H} d={d} T={T} causal qkv"
        bwd = d in fa.SM90_BWD_HEAD_DIMS[torch.float16]
        res = fp16_rows(*flash_inputs(dev, gen, torch.float16, B, T, H, d, "qkv"), True, what,
                        bwd=bwd)
        for name, rows in res.items():
            max_err[name] = max([max_err[name]] + [err for _, err, _ in rows])
        print(f"fp16-check {what}: {flash_line(res)}")
    check_fp16_overflow(dev, gen)
    return max_err



# ------------------------------------------- 17a+. fp16 on every flash route
FP16_ROUTE_SEEDS = (33, 34, 35)   # phase 17a+'s draws: one generator a seed
# the fp16 instances phase 17a+ adds, each beside the kernels it routes to: the sm90 LUT,
# key-bias, banded and merged kernels and the templates (PR 24's dense three stand in 17a)
FP16_NEW = ("flash_fwd_lut_sm90", "flash_bwd_dkdv_lut_sm90", "flash_bwd_dq_lut_sm90",
            *(f"{name} {KEY_BIAS}" for name in fa.DENSE_SM90), "flash_fwd_banded_sm90",
            "flash_fwd_merged_sm90", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
            *fa.BIASED_KERNELS, "flash_fwd_lut", "flash_fwd_lut_ring", "flash_bwd_dkdv_lut",
            "flash_bwd_dq_lut", "flash_fwd_banded", "flash_fwd_merged")


def fp16_route_cases(H):
    """Phase 17a+'s cases, each (label, config or None, key bias kind, head
    dim, B, causal): BERT's tutorial layout and the dense path with padding
    at d=64 (BERT-large's heads: the sm90 LUT and key-bias instances and the
    templates beside them), a ``mul`` key bias with batch row 1 fully
    padded, a (T, T) score bias (the templates alone), then d 96 and 128
    (the templates, and ``flash_fwd_sm90``'s key-bias instance at 128)."""
    tut = build_sparsity_config(SPARSE_SECTION, H)
    return [("tutorial16+pad", tut, "add", 64, 8, False),
            ("tutorial16", tut, "none", 64, 8, False),
            ("dense+pad", None, "add", 64, 8, False),
            ("tutorial16+mul", tut, "mul", 64, 2, False),
            ("dense+mul", None, "mul", 64, 2, False),
            ("tutorial16 attn", tut, "attn", 64, 2, False),
            ("dense attn", None, "attn", 64, 2, True),
            *((label, cfg, kind, d, 2, False) for d in (96, 128)
              for label, cfg, kind in (("tutorial16+pad", tut, "add"),
                                       ("tutorial16", tut, "none"),
                                       ("dense+pad", None, "add")))]


def fp16_padded_rows_zero(q, k, v, do, lut, kb, what):
    """A fully padded batch row (every key NEG_INF) under the fp16 route:
    O, dQ, dK and dV of that row are exactly 0 (its lse NEG_INF enters the
    backward as +inf, so its P is 0)."""
    names, calls, _ = masked_calls(q, k, v, do, lut, kb, None, False)
    o, lse = calls[0]()
    delta = fa.attention_delta(o, do)
    dk, dv = calls[1](lse, delta)
    dq = calls[2](lse, delta)
    rows = padded_rows(kb)
    if not rows or any(t[b].any() for b in rows for t in (o, dq, dk, dv)):
        raise AssertionError(f"fp16 {what}: fully padded rows {rows} have non-zero outputs "
                             f"or gradients ({names})")
    return rows


def check_fp16_routes(dev, T=2048, H=16):
    """Phase 17a+: every fp16 instance this slice adds against its plain
    version with the fp16 limit, the kernel each route names and the
    template beside an sm90 one (:func:`check_masked_case`,
    :func:`check_flash_case`, :func:`band_merge_runs`): first each case once
    at T=256, B=1, H=2 (a first launch; the sm90 kernels trap on an mbarrier
    wait of 2 s), then at BERT's T and H over FP16_ROUTE_SEEDS, each seed a
    generator of its own: :func:`fp16_route_cases`, the dense path at d 96 and
    128 (the templates; d=128's forward on ``flash_fwd_sm90``), and the causal
    BSLongformer layout at block 64 through the banded and merged forwards
    at d 64, 96 and 128.  A fully padded ``mul`` row must read exact zeros.
    Returns ({kernel fp16: max abs error}, {kernel fp16: largest share of its
    limit})."""
    max_err, worst = {}, {}

    def note(res, keyed=False):
        for name, rows in res.items():
            key = f"{name} {KEY_BIAS} {FP16}" if keyed and name in fa.DENSE_SM90 else \
                f"{name} {FP16}"
            max_err[key] = max([max_err.get(key, 0.0)] + [e for _, e, _ in rows])
            worst[key] = max([worst.get(key, 0.0)] + [sh for *_, sh in rows])

    for seed, (Tc, Hc) in [(FP16_ROUTE_SEEDS[0], (256, 2))] + [
            (sd, (T, H)) for sd in FP16_ROUTE_SEEDS]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        first = Tc != T
        tag = "first launch" if first else f"seed {seed}"
        for label, cfg, kind, d, B, causal in fp16_route_cases(Hc):
            B = 1 if first and kind != "mul" else B
            lut = None if cfg is None else fa.layout_luts(cfg.make_layout(Tc), Tc, Hc, causal)
            kb, ab = bias_inputs(kind, gen, B, Tc, dev)
            what = f"fp16 d={d} B={B} T={Tc} H={Hc} {label} causal={int(causal)} {tag}"
            inputs = flash_inputs(dev, gen, torch.float16, B, Tc, Hc, d, "qkv")
            t0 = time.perf_counter()
            res = check_masked_case(*inputs, lut, kb, ab, causal, what, c1=lut is not None)
            ms = (time.perf_counter() - t0) * 1e3
            if kind == "mul":
                rows = fp16_padded_rows_zero(*inputs, lut, kb, what)
                extra = f"; padded rows {rows} exactly 0 in O, dQ, dK, dV"
            else:
                extra = ""
            note(res, keyed=lut is None and kb is not None and ab is None)
            print(f"fp16-route {what} ({ms:.0f} ms): {flash_line(res)}{extra}")
            del inputs
        for d in (96, 128):
            B = 1 if first else 2
            what = f"fp16 d={d} B={B} T={Tc} H={Hc} dense causal {tag}"
            res = check_flash_case(*flash_inputs(dev, gen, torch.float16, B, Tc, Hc, d, "qkv"),
                                   True, what)
            note(res)
            print(f"fp16-route {what}: {flash_line(res)}")
        layout = np.asarray(longformer(Hc, 64, 3, [0]).make_layout(Tc), np.int32) \
            if Tc >= 512 else np.asarray(longformer(Hc, 32, 3, [0]).make_layout(Tc), np.int32)
        for d in (64, 96, 128):
            q, k, v, _ = flash_inputs(dev, gen, torch.float16, 1, Tc, Hc, d, "qkv")
            res = {}
            for name in BAND_MERGE:
                sched = band_merge_schedule(layout, Tc, Hc, True, name)
                ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True, lut=sched)
                t0 = time.perf_counter()
                runs = band_merge_runs(name, q, k, v, sched)
                if first:
                    wait_first(name, f"fp16 d={d}", t0)
                torch.cuda.synchronize()
                for kernel, (o, lse) in runs.items():
                    res[kernel] = [(lb, *flash_close(f"{kernel} fp16 d={d} {tag}", lb, got, ref))
                                   for lb, got, ref in (("o", o, ro), ("lse", lse, rlse))]
            note(res)
            print(f"fp16-route fp16 d={d} B=1 T={Tc} H={Hc} longformer causal {tag}: " + "; ".join(
                f"{name[10:]} {flash_line({name: rows})}" for name, rows in res.items()))
        torch.cuda.empty_cache()
    missing = [name for name in FP16_NEW if f"{name} {FP16}" not in max_err]
    if missing:
        raise AssertionError(f"phase 17a+ held no fp16 instance of {missing}")
    print(f"fp16-route largest share of the limit per instance over seeds "
          f"{FP16_ROUTE_SEEDS}: " + "; ".join(f"{k} {v:.2f}" for k, v in worst.items()))
    return max_err, worst

def fp16_timing(dev, bytes_per_s, card, B=8, T=1024, H=16, d=64):
    """Phase 17d at the 350M training shape (causal, q/k/v views of one qkv
    tensor, a generator of its own): each fp16 instance of the dense sm90
    kernels and of the templates (by name) and its bf16 twin on the same
    values (three readings each, in turns), beside the plain
    version, the bound and SDPA's forward or the flash-attention backward
    op at fp16.  Returns {kernel: the kernels line's numbers} for the fp16
    instances."""
    gen = torch.Generator(device=dev).manual_seed(FP16_SEED + 1)
    q, k, v, do = flash_inputs(dev, gen, torch.float16, B, T, H, d, "qkv")
    twins = {torch.float16: (q, k, v, do),
             torch.bfloat16: tuple(x.to(torch.bfloat16) for x in (q, k, v, do))}
    calls = {}
    for dt, (tq, tk, tv, tdo) in twins.items():
        o, lse = fa.flash_fwd(tq, tk, tv, True)
        delta = fa.attention_delta(o, tdo)
        calls[dt] = {
            "flash_fwd_sm90": lambda tq=tq, tk=tk, tv=tv: fa.flash_fwd_sm90(tq, tk, tv, True),
            "flash_bwd_dkdv_sm90": lambda tq=tq, tk=tk, tv=tv, tdo=tdo, lse=lse, delta=delta:
                fa.flash_bwd_dkdv_sm90(tq, tk, tv, tdo, lse, delta, True),
            "flash_bwd_dq_sm90": lambda tq=tq, tk=tk, tv=tv, tdo=tdo, lse=lse, delta=delta:
                fa.flash_bwd_dq_sm90(tq, tk, tv, tdo, lse, delta, True),
            # the templates (PR 2's design), by name
            "flash_fwd": lambda tq=tq, tk=tk, tv=tv: fa.flash_fwd_template(tq, tk, tv, True),
            "flash_bwd_dkdv": lambda tq=tq, tk=tk, tv=tv, tdo=tdo, lse=lse, delta=delta:
                fa.flash_bwd_dkdv_template(tq, tk, tv, tdo, lse, delta, True),
            "flash_bwd_dq": lambda tq=tq, tk=tk, tv=tv, tdo=tdo, lse=lse, delta=delta:
                fa.flash_bwd_dq_template(tq, tk, tv, tdo, lse, delta, True)}
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = fa.attention_delta(o, do)
    plain_fwd = lambda: fa.flash_attention_reference_fwd(q, k, v, True)
    plain_dkdv = lambda: fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True)
    plain_dq = lambda: fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, True)
    plain = {"flash_fwd_sm90": plain_fwd, "flash_bwd_dkdv_sm90": plain_dkdv,
             "flash_bwd_dq_sm90": plain_dq, "flash_fwd": plain_fwd,
             "flash_bwd_dkdv": plain_dkdv, "flash_bwd_dq": plain_dq}
    # the routed fp16 instances and the templates beside them, on the timed inputs
    res = check_flash_case(q, k, v, do, True, f"fp16 B={B} T={T} H={H} d={d} (the timed inputs)")
    max_err = {name: max(err for _, err, _ in rows) for name, rows in res.items()}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sdpa_r = repeat_ms(lambda _: sdpa(qh, kh, vh, is_causal=True), 50)
    bwd_call, _ = sdpa_backward(qh, kh, vh, doh)
    sdpa_b = repeat_ms(lambda _: bwd_call(), 50) if bwd_call is not None else None
    work = flash_work(B, T, H, d)
    saved = dict(fa.launches)
    out = {}
    for name in fa.DENSE_KERNELS:
        nbytes, ops = work[name]
        bound, by = bound_ms(nbytes, ops, bytes_per_s)
        r16a = repeat_ms(lambda _: calls[torch.float16][name](), 50)
        rbf = repeat_ms(lambda _: calls[torch.bfloat16][name](), 50)
        r16b = repeat_ms(lambda _: calls[torch.float16][name](), 50)
        r16 = (statistics.median([r16a[0], r16b[0]]), min(r16a[1], r16b[1]),
               max(r16a[2], r16b[2]))
        plain_ms = time_ms(lambda _: plain[name](), 5)
        lib_r = sdpa_r if name in ("flash_fwd_sm90", "flash_fwd") else sdpa_b
        out[name] = {"max_abs_err": max_err[name], "ms": r16[0], "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by,
                     "library_ms": None if lib_r is None else lib_r[0]}
        lib_note = ("SDPA forward fp16" if name in ("flash_fwd_sm90", "flash_fwd")
                    else "the flash-attention backward op fp16 (dq, dk, dv)")
        print(f"timing {name} fp16 B={B} T={T} H={H} d={d} causal ({card}): {spread(r16)} "
              f"(readings before and after the bf16 twin: {spread(r16a)}; {spread(r16b)}); bf16 "
              f"twin {spread(rbf)}; bound {bound * 1e3:.2f} us ({by}; {nbytes / 1e6:.1f} MB, "
              f"{ops / 1e9:.2f} GFLOP at {PEAK_OPS['bf16'] / 1e12:.0f} TFLOP/s fp16 as bf16); "
              f"plain {plain_ms * 1e3:.2f} us; {lib_note} "
              f"{'not available' if lib_r is None else spread(lib_r)}")
    fa.launches.update(saved)          # timing launches are not path launches
    return out



def fp16_band_timing(dev, bytes_per_s, card, B=1, T=8192, H=8, d=64, block=64, seed=36):
    """Phase 17d: the banded and merged fp16 instances (sm90 and the
    template designs) at phase 14's kernels-line shape (the causal
    workload layout, block 64, T=8192), each beside its bf16 twin on the
    same values, in turns (three readings each), with the bound (live
    pairs of the layout), the plain version and SDPA fp16 with the layout
    mask; a generator of its own.  Returns {kernel fp16: kernels-line
    fields}."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    layout = np.asarray(workload_config(H, block).make_layout(T), np.int32)
    lut = fa.layout_luts(layout, T, H, True)
    q, k, v, _ = flash_inputs(dev, gen, torch.float16, B, T, H, d, "qkv")
    twin = [x.to(torch.bfloat16) for x in (q, k, v)]
    pairs = layout_pairs(layout, True, block) * B * (H // layout.shape[0])
    nbytes, ops = 4 * B * T * H * d * 2 + B * H * T * 4, 4 * d * pairs
    bound, by = bound_ms(nbytes, ops, bytes_per_s)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = lut.element_mask(dev)[None]
    lib = repeat_ms(lambda _: sdpa(qh, kh, vh, attn_mask=mask), 5, warmup=2)
    saved = dict(fa.launches)
    out = {}
    for route in ("banded", "merged"):
        sched = band_merge_schedule(layout, T, H, True, f"flash_fwd_{route}")
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, True, lut=sched)
        plain_ms = time_ms(lambda _: fa.flash_attention_reference_fwd(q, k, v, True, lut=sched),
                           2, warmup=1)
        for name, call in ((f"flash_fwd_{route}_sm90", getattr(fa, f"flash_fwd_{route}_sm90")),
                           (f"flash_fwd_{route}", getattr(fa, f"flash_fwd_{route}_template"))):
            o, lse = call(q, k, v, sched)
            torch.cuda.synchronize()
            err = max(flash_close(f"{name} fp16 timed", lb, got, ref)[0]
                      for lb, got, ref in (("o", o, ro), ("lse", lse, rlse)))
            turns = turns_ms({"fp16": lambda _: call(q, k, v, sched),
                              "bf16": lambda _: call(*twin, sched)}, 20)
            out[f"{name} {FP16}"] = {"max_abs_err": err, "ms": turns["fp16"][0],
                                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                                     "library_ms": lib[0]}
            print(f"timing {name} fp16 B={B} T={T} H={H} d={d} block {block} causal ({card}): "
                  f"{spread(turns['fp16'])}, {bound / turns['fp16'][0]:.3f} of the bound; bf16 "
                  f"twin in turns {spread(turns['bf16'])}; bound {bound * 1e3:.2f} us ({by}; "
                  f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, {pairs} live pairs); plain "
                  f"{plain_ms * 1e3:.2f} us; SDPA fp16 with the layout mask {spread(lib)}; "
                  f"max abs error {err:.2e}")
        del ro, rlse
    fa.launches.update(saved)          # timing launches are not path launches
    del mask
    torch.cuda.empty_cache()
    return out

def scaler_state(eng):
    """The loss scaler's state and the skipped steps (host reads)."""
    st = eng.scale
    return (float(st.cur_scale), int(st.cur_hysteresis), int(st.last_overflow_iter),
            int(st.iter_num), eng.skipped_steps)


def train_tensors(eng):
    """Clones of every tensor a step commits: params, master, optimizer state."""
    return [t.clone() for tree in (eng.params, eng.master, eng.opt_state)
            for t in tree_leaves(tree)]


def fp16_forced_overflow(make, steps=2):
    """Phase 17b: ``steps`` steps, then the loss scale set in place to
    2^40 (the captured step reads the same tensor): that step must be
    skipped with params, master and optimizer state bit-unchanged, and the
    scaler must move as in eager (the same state after it on both impls)."""
    rows = {}
    for impl in ("graph", "eager"):
        eng = make(impl)
        for _ in range(steps):
            eng.train_batch()
        before, skipped = train_tensors(eng), eng.skipped_steps
        eng.scale.cur_scale.fill_(2.0 ** 40)
        loss = float(eng.train_batch())
        after = train_tensors(eng)
        same = all(torch.equal(a, b) for a, b in zip(before, after))
        rows[impl] = (loss, eng.get_global_grad_norm(), scaler_state(eng))
        if eng.skipped_steps != skipped + 1 or not same:
            raise AssertionError(f"fp16 forced overflow {impl}: skipped {skipped} -> "
                                 f"{eng.skipped_steps}, state unchanged {same}")
        del eng, before, after
        gc.collect()
        torch.cuda.empty_cache()
    if repr(rows["graph"]) != repr(rows["eager"]):
        raise AssertionError(f"fp16 forced overflow: captured {rows['graph']} != eager "
                             f"{rows['eager']}")
    print(f"fp16 forced overflow (scale set to 2^40 after {steps} steps): the step skipped, "
          f"params, master and optimizer state bit-unchanged, captured and eager alike; loss "
          f"{rows['graph'][0]:.6f}, grad norm {rows['graph'][1]}, scaler (scale, hysteresis, "
          f"last overflow, iter, skipped) {rows['graph'][2]}")


def fp16_train(dev, card, phase5, warmup=3, timed=10, fit_steps=20, preset="gpt2-350m",
               seq=1024, micro=8):
    """Phase 17b: phase 5's run in fp16 with the dynamic loss scaler
    (FP16_CONFIG) through :func:`ab_train`: captured and eager bit-equal in
    losses, grad norms and scaler state at every step; exact launches of the
    fp16 instances (per step: L of each, 0 on the templates); step 1
    against plain attention within phase 5's limits; the fixed-batch loss
    fall over ``fit_steps`` with the skipped steps and the scale
    trajectory; a forced overflow; the timing figures beside phase 5's.
    Returns :func:`ab_train`'s results."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    np_params = GPT2(preset=preset, max_seq=seq, device=dev).init_numpy(seed=0)

    def make(impl, attention="flash", **model_kw):
        return train_engine(dev, np_params, tokens, attention, preset, seq, micro,
                            step_impl=impl, dtype=torch.float16, config=FP16_CONFIG, **model_kw)

    # eager (captured steps equal eager ones, phase 5): plain attention's (B, H, T, T)
    # scores make a capture's warm-up and its own pool too large for a card that ran
    # phases 1-16
    eng = make("eager", attention="jnp")
    plain = (float(eng.train_batch()), eng.get_global_grad_norm())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    head_dim = model.config.n_embd // model.config.n_head
    fwd = fa.dense_fwd_kernel(torch.float16, head_dim)
    per_step = {name: model.config.n_layer
                for name in (fwd, *fa.dense_bwd_kernel(torch.float16, head_dim))}
    if set(per_step) != set(fa.DENSE_SM90):
        raise AssertionError(f"fp16 at head dim {head_dim} routes to {per_step}")

    def first(eng, loss, gnorm):
        print(f"train fp16 step 1 (captured): loss flash {loss:.6f} plain {plain[0]:.6f}; grad "
              f"norm flash {gnorm:.6f} plain {plain[1]:.6f} (tol {STEP1_LOSS_TOL:g} abs, "
              f"{STEP1_GNORM_TOL:g} rel); scaler {scaler_state(eng)}")
        overflowed = not math.isfinite(gnorm), not math.isfinite(plain[1])
        if not (abs(loss - plain[0]) <= STEP1_LOSS_TOL and (
                overflowed == (True, True)
                or abs(gnorm - plain[1]) <= STEP1_GNORM_TOL * abs(plain[1]))):
            raise AssertionError(f"fp16 step 1 flash {(loss, gnorm)} vs plain {plain}")

    def after(eng, by_name):
        fixed = itertools.repeat((tokens[:micro],))
        fit, states = [], []
        for _ in range(fit_steps):
            fit.append(float(eng.train_batch(fixed)))
            states.append(scaler_state(eng))
        print(f"train fp16 fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over {fit_steps} "
              f"steps; skipped steps {states[0][4]} -> {states[-1][4]}; scale trajectory "
              + ", ".join(f"{st[0]:g}" for st in states))
        if not fit[0] - fit[-1] >= 0.5:
            raise AssertionError(f"fp16 fixed-batch loss fell only {fit[0] - fit[-1]}")
        flash = {}
        for name, (t, c) in by_name.items():
            m = re.search(r"\b(fwd_sm90_kernel|dense_dkdv_kernel|dense_dq_kernel)\b", name)
            if m:
                t0, c0 = flash.get(m.group(1), (0.0, 0.0))
                flash[m.group(1)] = (t0 + t, c0 + c)
        print(f"profile train {preset} fp16: flash kernels' device time per captured step: " +
              "; ".join(f"{k} {t:.1f} us ({c:.0f} launches)" for k, (t, c) in flash.items()))

    tag = f"train {preset} T={seq} micro {micro} fp16 zero1"
    res = ab_train(make, tag, per_step, card, micro * seq, model.flops_per_token(),
                   warmup=warmup, timed=timed, first=first, after=after, extra=scaler_state,
                   skips_ok=True)
    for impl in ("graph", "eager"):
        a, b = res[impl], phase5[impl]
        print(f"fp16 vs bf16 {preset} {impl} ({card}): step p50 {a['p50']:.3f} vs "
              f"{b['p50']:.3f} ms; busy {a['busy_ms']:.3f} vs {b['busy_ms']:.3f} ms; idle "
              f"{100 * (1 - a['busy_ms'] / a['p50']):.1f}% vs "
              f"{100 * (1 - b['busy_ms'] / b['p50']):.1f}%; tokens/s "
              f"{statistics.median(r[2] for r in a['rows']):.0f} vs "
              f"{statistics.median(r[2] for r in b['rows']):.0f}; MFU "
              f"{statistics.median(r[3] for r in a['rows']):.4f} vs "
              f"{statistics.median(r[3] for r in b['rows']):.4f}; peak memory "
              f"{a['peak_gb']:.2f} vs {b['peak_gb']:.2f} GB; skipped {a['skipped']}")
    fp16_forced_overflow(make)
    return res


MODEL_OPTIONS = (("remat dots", dict(remat=True, remat_policy="dots")),
                 ("loss_chunk 1024", dict(loss_chunk=1024)))


def model_options(dev, card, phase5, steps=3, preset="gpt2-350m", seq=1024, micro=8):
    """Phase 17c: phase 5's bf16 run with ``remat=True, remat_policy="dots"``
    and with ``loss_chunk=1024``: ``steps`` steps captured and eager, bit-equal,
    exact launches (the forward twice a layer under remat), step 1's loss
    and grad norm against phase 5's within its step-1 limits, peak memory
    beside phase 5's."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    np_params = GPT2(preset=preset, max_seq=seq, device=dev).init_numpy(seed=0)
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    L = model.config.n_layer
    ref_loss, ref_gnorm = phase5["graph"]["first"]
    for label, kw in MODEL_OPTIONS:
        per_step = {"flash_fwd_sm90": 2 * L if kw.get("remat") else L,
                    "flash_bwd_dkdv_sm90": L, "flash_bwd_dq_sm90": L}
        curves, peaks = {}, {}
        for impl in ("graph", "eager"):
            eng = train_engine(dev, np_params, tokens, "flash", preset, seq, micro,
                               step_impl=impl, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            runs0 = kernel_runs(eng)
            curves[impl] = [(float(eng.train_batch()), eng.get_global_grad_norm())
                            for _ in range(steps)]
            check_launches(f"{label} {impl}", dict(fa.launches), per_step,
                           kernel_runs(eng) - runs0)
            peaks[impl] = torch.cuda.max_memory_allocated() / 1e9
            if not all(math.isfinite(x) for x, _ in curves[impl]) or eng.skipped_steps:
                raise AssertionError(f"{label} {impl}: {curves[impl]}, skipped "
                                     f"{eng.skipped_steps}")
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        loss, gnorm = curves["graph"][0]
        if curves["graph"] != curves["eager"]:
            raise AssertionError(f"{label}: captured {curves['graph']} != eager "
                                 f"{curves['eager']}")
        if not (abs(loss - ref_loss) <= STEP1_LOSS_TOL
                and abs(gnorm - ref_gnorm) <= STEP1_GNORM_TOL * abs(ref_gnorm)):
            raise AssertionError(f"{label}: step 1 {(loss, gnorm)} vs phase 5's "
                                 f"{(ref_loss, ref_gnorm)}")
        print(f"train {preset} bf16 {label} {kw}: {steps} steps captured and eager bit-equal "
              f"{[(round(x, 6), round(g, 6)) for x, g in curves['graph']]}; step 1 loss "
              f"{loss:.6f} (phase 5 {ref_loss:.6f}, gap {loss - ref_loss:.3e}), grad norm "
              f"{gnorm:.6f} (phase 5 {ref_gnorm:.6f}, bit-equal {gnorm == ref_gnorm}); launches "
              f"per step {per_step}; peak device memory captured {peaks['graph']:.2f} GB, eager "
              f"{peaks['eager']:.2f} GB (phase 5: {phase5['graph']['peak_gb']:.2f} / "
              f"{phase5['eager']['peak_gb']:.2f} GB) ({card})")



# ------------------------------------------------------ 18. BERT-large in fp16
# phase 18's configuration: phase 8's with phase 17's dynamic loss scaler in place of bf16
BERT_FP16 = {"bf16": {"enabled": False}, **FP16_CONFIG}


def dtype_codes(call):
    """``call()`` with the dtype code of every flash launch recorded (the
    wrappers' ``_run``; a capture's Python runs it too): returns (result,
    {kernel: set of codes})."""
    seen, run = {}, fa._run

    def spy(name, *args, device):
        seen.setdefault(name, set()).add(args[0])
        return run(name, *args, device=device)
    fa._run = spy
    try:
        return call(), seen
    finally:
        fa._run = run


def check_fp16_codes(tag, codes, per_step):
    """Every flash launch of a run (``dtype_codes``) carried dtype code 2
    (fp16), on the kernels of ``per_step`` alone."""
    if set(codes) != set(per_step) or any(v != {2} for v in codes.values()):
        raise AssertionError(f"{tag}: flash launches by dtype code {codes}, expected the fp16 "
                             f"instances (code 2) of {sorted(per_step)} alone")
    print(f"{tag}: every flash launch of the run carried dtype code 2 (fp16): {sorted(codes)}")


def bert_fp16_train(dev, card, phase8, warmup=2, timed=5, fit_steps=20, preset="bert-large",
                    seq=2048, micro=8):
    """Phase 18: phase 8's BERT-large run in fp16 with the dynamic loss
    scaler (BERT_FP16; the fp32 MLM head stays fp32), captured and eager
    (:func:`ab_train`): on the tutorial's sparse layout (18: the fp16
    instances of the sm90 LUT kernels, 48/24/24 a kernel run with remat, 0
    on the templates) and on its ``"mode": "dense"`` twin with padding (18c:
    the key-bias fp16 instances of the dense sm90 kernels).  Each holds:
    every flash launch of the run carries dtype code 2 (fp16); captured =
    eager in losses, grad norms and scaler state at every step; step 1
    against the plain ``_masked_dense`` attention within phase 8's limits;
    the fixed-batch loss falls >= BERT_FIT_MARGIN in ``fit_steps`` steps
    (the skipped steps and the scale trajectory printed); a forced overflow
    skipped with params, master and moments bit-unchanged; the figures
    beside phase 8's bf16 ones from the same call.  Returns (launches of
    each captured run, the :func:`ab_train` results)."""
    vocab = build(preset, device=dev).config.vocab_size
    base = build(preset, device=dev).init(0)
    model = build(preset, device=dev)
    c = model.config
    L, hd = c.n_layer, c.hidden_size // c.n_head
    f16 = torch.float16
    dense = {"mode": "dense", "block": 16}
    runs = {"18": (SPARSE_SECTION, bert_data(0, 64, seq, vocab),
                   {fa.sparse_fwd_kernel(f16, hd, False, True): 2 * L,
                    fa.sparse_dkdv_kernel(f16, hd, False): L,
                    fa.sparse_dq_kernel(f16, hd, False): L}, "sparse16", "8"),
            "18c": (dense, bert_data(1, 32, seq, vocab),
                    {fa.biased_fwd_kernel(f16, hd, False): 2 * L,
                     **{n: L for n in fa.biased_bwd_kernel(f16, hd, False)}},
                    "8c dense padded", "8c")}
    counts, results = {}, {}
    for run, (section, data, per_step, label, twin) in runs.items():
        def make(impl, plain=False, section=section, data=data):
            return bert_engine(dev, base, data, section=section, plain=plain, preset=preset,
                               seq=seq, micro=micro, step_impl=impl, dtype=f16, over=BERT_FP16)

        eng = make("eager", plain=True)
        plain = (float(eng.train_batch()), eng.get_global_grad_norm())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        tag = f"train {preset} T={seq} micro {micro} fp16 zero1 remat {label}"

        def first(eng, loss, gnorm, plain=plain, tag=tag):
            overflowed = not math.isfinite(gnorm), not math.isfinite(plain[1])
            gaps = (abs(loss - plain[0]), abs(gnorm - plain[1]) / abs(plain[1]))
            print(f"{tag} step 1 (captured): loss kernels {loss:.6f} plain {plain[0]:.6f}; "
                  f"grad norm kernels {gnorm:.6f} plain {plain[1]:.6f} (gaps {gaps[0]:.3e} abs, "
                  f"{gaps[1]:.3e} rel; tol {BERT_STEP1_LOSS_TOL:g} abs, "
                  f"{BERT_STEP1_GNORM_TOL:g} rel); scaler {scaler_state(eng)}")
            if not (gaps[0] <= BERT_STEP1_LOSS_TOL and (
                    overflowed == (True, True) or gaps[1] <= BERT_STEP1_GNORM_TOL)):
                raise AssertionError(f"{tag}: step 1 kernels {(loss, gnorm)} vs plain {plain}")

        def after(eng, by_name, data=data, tag=tag):
            fixed = itertools.repeat({key: val[:micro] for key, val in data.items()})
            fit, states = [], []
            for _ in range(fit_steps):
                fit.append(float(eng.train_batch(fixed)))
                states.append(scaler_state(eng))
            print(f"{tag} fixed batch: loss {fit[0]:.4f} -> {fit[-1]:.4f} over {fit_steps} "
                  f"steps (margin {BERT_FIT_MARGIN}); skipped steps {states[0][4]} -> "
                  f"{states[-1][4]}; scale trajectory " + ", ".join(f"{st[0]:g}" for st in states))
            if not fit[0] - fit[-1] >= BERT_FIT_MARGIN:
                raise AssertionError(f"{tag}: fixed-batch loss fell only {fit[0] - fit[-1]}")
            spent = {}
            for kname, (t, n) in by_name.items():
                m = re.search(r"\b(fwd_lut_sm90_kernel|dkdv_sm90_kernel|dq_sm90_kernel|"
                              r"fwd_sm90_kernel|dense_dkdv_kernel|dense_dq_kernel)\b", kname)
                if m and "__half" in kname:
                    t0, n0 = spent.get(m.group(1), (0.0, 0.0))
                    spent[m.group(1)] = (t0 + t, n0 + n)
            print(f"profile {tag}: fp16 flash kernels' device time per captured step: " +
                  "; ".join(f"{k} {t / 1e3:.2f} ms ({n:.0f} launches)"
                            for k, (t, n) in spent.items()) + f" ({card})")

        res, codes = dtype_codes(lambda: ab_train(
            make, tag, per_step, card, micro * seq, model.flops_per_token(), warmup=warmup,
            timed=timed, profile_n=1, first=first, after=after, extra=scaler_state,
            skips_ok=True))
        check_fp16_codes(tag, codes, per_step)
        for impl in ("graph", "eager"):
            a, b = res[impl], phase8[twin][impl]
            print(f"fp16 vs bf16 {preset} {label} {impl} ({card}): step p50 {a['p50']:.3f} vs "
                  f"{b['p50']:.3f} ms; busy {a['busy_ms']:.3f} vs {b['busy_ms']:.3f} ms; idle "
                  f"{100 * (1 - a['busy_ms'] / a['p50']):.1f}% vs "
                  f"{100 * (1 - b['busy_ms'] / b['p50']):.1f}%; tokens/s "
                  f"{statistics.median(r[2] for r in a['rows']):.0f} vs "
                  f"{statistics.median(r[2] for r in b['rows']):.0f}; MFU "
                  f"{statistics.median(r[3] for r in a['rows']):.4f} vs "
                  f"{statistics.median(r[3] for r in b['rows']):.4f}; peak memory "
                  f"{a['peak_gb']:.2f} vs {b['peak_gb']:.2f} GB; skipped {a['skipped']}")
        fp16_forced_overflow(make)
        counts[run], results[run] = res["graph"]["counts"], res
        gc.collect()
        torch.cuda.empty_cache()
    return counts, results


# --------------------------------- 19. the imperative API, curriculum and PLD
LOOP_GAS = 2                # phase 19: phase 5's configuration at gas 2
LOOP_STEPS = 3
CURRICULUM_STEPS = 16
LOOP_CURRICULUM = {"enabled": True, "curriculum_type": "seqlen", "min_difficulty": 128,
                   "max_difficulty": 1024, "schedule_type": "fixed_linear",
                   "schedule_config": {"total_curriculum_step": 14, "difficulty_step": 128}}
LOOP_PLD = {"enabled": True, "theta": 0.5, "gamma": 0.001}
LOOP_LAYERS = 8             # phase 19's depth: GPT-2 350M's width at 8 of its 24 layers


def curriculum_expected(cfg, step):
    """The fixed_linear difficulty of ``step`` (the reference's formula,
    runtime/data_pipeline/curriculum_scheduler.py)."""
    sc, lo, hi = cfg["schedule_config"], cfg["min_difficulty"], cfg["max_difficulty"]
    d = math.floor(step / sc["total_curriculum_step"] * (hi - lo) + lo)
    return min(d - d % sc["difficulty_step"], hi)


def train_loop(dev, card, preset="gpt2-350m", seq=1024, micro=8, n_layer=LOOP_LAYERS):
    """Phase 19 on phase 5's configuration at gas LOOP_GAS, cut to
    ``n_layer`` layers (full width), captured: (a)
    ``forward`` / ``backward`` / ``step`` against ``train_batch`` from the
    same state on the same micro-batches, LOOP_STEPS steps: losses and grad
    norms bit-equal, the shim's engine one graph (one capture, a replay a
    step); (b) a fixed_linear seqlen curriculum 128 -> 1024 in steps of 128
    over CURRICULUM_STEPS steps, with progressive layer drop: the
    difficulty of each step against the schedule, finite losses, a graph
    and its pool bytes a difficulty and the reserved memory after each
    step, first at micro 4 with every graph held in the engine's one pool
    (``_release_graphs`` a no-op: do past graphs pin growing memory?), then
    at micro 8 as the engine runs it (the past graphs released); PLD's
    theta beside its formula."""
    vocab = GPT2(preset=preset, device=dev).config.vocab_size
    tokens = np.random.default_rng(0).integers(0, vocab, (64, seq + 1)).astype(np.int32)
    np_params = GPT2(preset=preset, max_seq=seq, device=dev, n_layer=n_layer).init_numpy(seed=0)
    make = lambda config, m=micro: train_engine(dev, np_params, tokens, "flash", preset, seq, m,
                                                config=dict(config, gradient_accumulation_steps=
                                                            LOOP_GAS), n_layer=n_layer)
    mbs = [(tokens[i * micro:(i + 1) * micro],) for i in range(LOOP_STEPS * LOOP_GAS)]
    feeds = [mbs[s * LOOP_GAS:(s + 1) * LOOP_GAS] for s in range(LOOP_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    ref = make({})                       # one engine at a time: each holds a captured step
    want_rows = [(float(ref.train_batch(iter(feed))), ref.get_global_grad_norm())
                 for feed in feeds]
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    shim, rows = make({}), []
    for feed, (a, ga) in zip(feeds, want_rows):
        evals = []
        for mb in feed:
            if shim.step() is not None:
                raise AssertionError("step() ran before the accumulation boundary")
            evals.append(float(shim.backward(shim.forward(mb))))
        if not shim.is_gradient_accumulation_boundary():
            raise AssertionError("no accumulation boundary after gas micro-batches")
        b = float(shim.step())
        rows.append((a, ga, b, shim.get_global_grad_norm(), evals))
    g = shim.stats()["graphs"]
    want = (1, 1, LOOP_STEPS) if dev.type == "cuda" else (0, 0, 0)   # no graph on the CPU
    if any((a, ga) != (b, gb) for a, ga, b, gb, _ in rows) or (
            g["graphs"], g["captures"], g["replays"]) != want:
        raise AssertionError(f"phase 19 shim: {rows}, graphs {g}")
    print(f"train {preset} ({n_layer} layers) T={seq} micro {micro} gas {LOOP_GAS} bf16: "
          f"forward/backward/step "
          f"vs train_batch from the same state, {LOOP_STEPS} steps: losses and grad norms "
          f"bit-equal {[(round(a, 6), round(ga, 6)) for a, ga, *_ in rows]}; forward's eval "
          f"losses {[[round(x, 4) for x in e] for *_, e in rows]}; the shim's engine "
          f"{g['graphs']} graph, {g['captures']} capture, {g['replays']} replays "
          f"({engine_graphs_line(shim)}) ({card})")
    del shim
    gc.collect()
    torch.cuda.empty_cache()

    out = {}
    config = {"curriculum_learning": dict(LOOP_CURRICULUM),
              "progressive_layer_drop": dict(LOOP_PLD)}
    # first every difficulty's graph held (the release a no-op) at micro 4, which a card
    # holds after the earlier phases; then the engine's own release at phase 5's micro 8
    for label, m, release in (("held", micro // 2, False), ("released", micro, True)):
        restore = engine_module.DeepSpeedEngine._release_graphs
        if not release:
            engine_module.DeepSpeedEngine._release_graphs = lambda self: None
        try:
            torch.cuda.synchronize()
            reserved0 = torch.cuda.memory_reserved()
            eng = make(config, m)
            steps = []
            for s in range(1, CURRICULUM_STEPS + 1):
                loss = float(eng.train_batch())
                want = curriculum_expected(LOOP_CURRICULUM, s)
                if eng.curriculum_seqlen() != want or not math.isfinite(loss):
                    raise AssertionError(f"curriculum step {s}: seqlen {eng.curriculum_seqlen()}"
                                         f" (schedule {want}), loss {loss}")
                torch.cuda.synchronize()
                steps.append((eng.curriculum_seqlen(), loss,
                              (torch.cuda.memory_reserved() - reserved0) / 1e9))
        finally:
            engine_module.DeepSpeedEngine._release_graphs = restore
        g = eng.stats()["graphs"]
        theta = float(eng.progressive_layer_drop.get_theta())
        formula = (1.0 - LOOP_PLD["theta"]) * math.exp(-LOOP_PLD["gamma"] * CURRICULUM_STEPS) \
            + LOOP_PLD["theta"]
        print(f"train {preset} ({n_layer} layers) micro {m} gas {LOOP_GAS} curriculum "
              f"fixed_linear 128 -> 1024 "
              f"step 128 over {CURRICULUM_STEPS} steps, past graphs {label}: (seqlen, loss, "
              f"reserved GB over the start) "
              + ", ".join(f"({q}, {x:.4f}, {r:.2f})" for q, x, r in steps)
              + f"; graphs held {g['graphs']}, released {g['released']}, captures "
              f"{g['captures']}, replays {g['replays']}; pool bytes by graph "
              + ", ".join(f"{n.split('[')[1].split(',')[0]} {b / 1e6:.0f} MB"
                          for n, b in g["pool_bytes"].items())
              + f"; PLD theta after {CURRICULUM_STEPS} steps {theta!r}, formula (1 - 0.5) "
              f"e^(-0.001 x {CURRICULUM_STEPS}) + 0.5 = {formula!r} ({card})")
        if abs(theta - formula) > 1e-12:
            raise AssertionError(f"PLD theta {theta} vs {formula}")
        out[label] = {"steps": steps, "graphs": g}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out

# 20. graded config 3: GPT-2 1.3B at ZeRO-3 with the optimizer offloaded to the host
OFFLOAD_PRESET = "gpt2-1.3b"
OFFLOAD_GAS = 8
OFFLOAD_PASSES, OFFLOAD_TIMED = 2, 2     # timed passes of timed steps, each impl
OFFLOAD_REF_STEPS = 3                    # the in-device reference's steps
OFFLOAD_RACE_STEPS = 4                   # the eager DPU engine's steps, against the captured
CHUNK_BYTES = 64 << 20                   # the JAX package's wire chunk, timed beside one copy
HOST_BYTES_PER_PARAM = 30                # the host Adam's traffic: g, p, m, v in; p, m, v, bf16 out
# steps 2-3 against the in-device engine: within this share of the gap a step with no
# update leaves (the in-device engine at lr 0, read in the same run; PERF.md section 2)
OFFLOAD_UPDATE_SHARE = 1 / 8


def offload_config(dpu=None, gas=OFFLOAD_GAS, micro=8, **over):
    """Graded config 3 as the JAX package's ``bench.py:301-330`` defines it:
    bf16, grad_accum_dtype bf16, AdamW 6e-4 / wd 0.1, clip 1.0, stage 3,
    ``offload_optimizer`` cpu (``dpu``: the DPU warm-up, None for sync)."""
    zero = {"stage": 3, "offload_optimizer": {"device": "cpu"}}
    if dpu is not None:
        zero["offload_optimizer"].update(delayed_param_update=True,
                                         delayed_param_update_warmup=dpu)
    cfg = {"train_micro_batch_size_per_gpu": micro, "gradient_accumulation_steps": gas,
           "steps_per_print": 10 ** 9, "gradient_clipping": 1.0, "bf16": {"enabled": True},
           "data_types": {"grad_accum_dtype": "bf16"},
           "optimizer": {"type": "AdamW", "params": {"lr": 6e-4, "weight_decay": 0.1}},
           "zero_optimization": zero}
    cfg.update(over)
    return cfg


def offload_engine(dev, params, tokens, config, preset, seq, step_impl="auto",
                   dtype=torch.bfloat16, remat=True):
    model = GPT2(preset=preset, max_seq=seq, dtype=dtype, device=dev, attention_impl="flash",
                 remat=remat, embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    return deepspeed_tpu_torch.initialize(config=config, model=model, params=params,
                                          training_data=(tokens,), step_impl=step_impl)[0]


def host_copy_rate(nbytes=2 << 30):
    """The host's copy rate, bytes read + written a second, over one large
    ``ds_memcpy`` (the host library's OpenMP copy) of ``nbytes``; the best
    of three, the buffers first touched."""
    from deepspeed_tpu_torch.ops.adam.cpu_adam import host_memcpy
    src, dst = np.ones(nbytes // 4, np.float32), np.zeros(nbytes // 4, np.float32)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        host_memcpy(dst.ctypes.data, src.ctypes.data, src.nbytes)
        best = min(best, time.perf_counter() - t0)
    return 2 * src.nbytes / best


def device_state_bytes(eng):
    """The bytes of the device tensors the engine holds as state."""
    trees = [eng.params, eng.master, eng.opt_state, eng.scale, eng.health,
             getattr(eng, "_param_stage", None), getattr(eng, "_grad_stage", None)]
    return sum(t.numel() * t.element_size() for tree in trees for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda")


def replay_ms(eng, n=2):
    """The device half alone: its graph replayed ``n`` times with ``commit``
    False (nothing trains), each timed with CUDA events; the median."""
    step = next(iter(eng._steps.values()))
    commit = step.static["commit"]
    commit.fill_(False)
    out = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step._graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    commit.fill_(True)
    return statistics.median(out)


def wire_chunk_timing(eng):
    """One d2h of the flat gradients and one h2d of the payload as one
    copy each (the port's wire), then in the JAX package's 64 MB chunks
    queued back to back on the same copy stream, in turns, each timed with
    the copy stream's events (ms)."""
    off, stream = eng._offload, eng._copies.stream
    flat = next(iter(eng._steps.values()))._outputs["grads"]
    rows = {}
    for chunk in (None, CHUNK_BYTES, None, CHUNK_BYTES):
        row = []
        for dst, src in ((off.landing, flat), (eng._param_stage, off.payload)):
            per = src.numel() if chunk is None else chunk // src.element_size()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(stream):
                stream.wait_stream(torch.cuda.current_stream())
                a.record(stream)
                for i in range(0, src.numel(), per):
                    dst[i:i + per].copy_(src[i:i + per], non_blocking=True)
                b.record(stream)
            b.synchronize()
            row.append(a.elapsed_time(b))
        rows.setdefault(chunk, []).append(tuple(row))
    return {("one copy" if k is None else f"{k >> 20} MB chunks"): v for k, v in rows.items()}


def payload_landed(eng):
    """(device params == the host payload image, payload == the host
    master cast to the compute dtype), each bit for bit: the last update
    reached the model whole."""
    off = eng._offload
    flat = off.payload.to(eng.device)
    params = all(torch.equal(leaf, flat[o:o + leaf.numel()].view(leaf.shape))
                 for leaf, o in zip(tree_leaves(eng.params), off.offsets))
    del flat
    payload = torch.equal(off.payload, torch.from_numpy(off.master).to(off.compute_dtype))
    return params, payload


def offload_run(make, tag, per_step, card, tokens_per_step, flops_per_token, numel,
                after_step=None):
    """One offload engine (``make()``): a warm-up step (the capture), then
    OFFLOAD_PASSES passes of OFFLOAD_TIMED timed steps, each synchronised:
    step wall p50 / p99 per pass, tokens/s and MFU, the host half's split
    averaged over the timed steps (d2h and h2d on the copy stream's events,
    the widening and the host Adam on the host's clock), the exact flash
    launches per kernel run, peak device memory, then the device half alone
    and a profiled step's busy time against the step p50 (idle share).
    ``after_step(eng, i)`` runs after each step (i from 1).  Returns the
    engine and its figures."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    eng = make()
    build_s = time.perf_counter() - t0
    if eng.master is not None or eng.opt_state is not None:
        raise AssertionError(f"{tag}: the device holds a master or moments")
    runs0 = kernel_runs(eng)
    losses, splits, rows, i = [], [], [], 0

    def step():
        nonlocal i
        t = time.perf_counter()
        loss = float(eng.train_batch())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        i += 1
        if after_step is not None:
            after_step(eng, i)
        losses.append((loss, eng.get_global_grad_norm()))
        return dt
    first_s = step()
    check_launches(f"{tag} step 1", dict(fa.launches), per_step, kernel_runs(eng) - runs0)
    for _ in range(OFFLOAD_PASSES):
        ms = []
        for _ in range(OFFLOAD_TIMED):
            ms.append(step() * 1e3)
            t = eng.offload_times
            if "host_step_s" in t:
                nan = lambda x: float("nan") if x is None else x    # noqa: E731 (no events)
                splits.append((nan(t["d2h_s"]), t["widen_s"], t["host_step_s"],
                               nan(wire.seconds(t["upload"])), t["land_wait_s"]))
        ms = np.asarray(ms)
        tok_s = OFFLOAD_TIMED * tokens_per_step / (ms.sum() / 1e3)
        rows.append((np.percentile(ms, 50), np.percentile(ms, 99), tok_s,
                     tok_s * flops_per_token / PEAK_OPS["bf16"]))
    counts, runs = dict(fa.launches), kernel_runs(eng) - runs0
    check_launches(tag, counts, per_step, runs)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x, _ in losses) or eng.skipped_steps:
        raise AssertionError(f"{tag}: losses {losses}, skipped {eng.skipped_steps}")
    device_ms = replay_ms(eng)
    summary = {}
    profile_steps(lambda: float(eng.train_batch()), tag, steps=1, unit="training step",
                  summary=summary)
    cols = list(zip(*rows))
    p50 = statistics.median(cols[0])
    busy_ms = summary.get("busy_us", float("nan")) / 1e3
    split = {k: statistics.mean(v) for k, v in zip(
        ("d2h_s", "widen_s", "host_step_s", "h2d_s", "land_wait_s"), zip(*splits))}
    print(f"offload {tag}: " + ", ".join(
        f"{name} {statistics.median(col):.3f} (readings {', '.join(f'{x:.3f}' for x in col)})"
        for name, col in zip(("step p50 ms", "step p99 ms", "tokens/s", "MFU"), cols))
          + f"; device half alone {device_ms:.3f} ms (a replay); host half a step: d2h "
          f"{split['d2h_s']:.4f} s ({numel * 2 / split['d2h_s'] / 1e9:.1f} GB/s), widen "
          f"{split['widen_s']:.4f} s, host Adam {split['host_step_s']:.4f} s, h2d "
          f"{split['h2d_s']:.4f} s ({numel * 2 / split['h2d_s'] / 1e9:.1f} GB/s), host wait "
          f"for the d2h {split['land_wait_s']:.4f} s; profiled step busy {busy_ms:.3f} ms, "
          f"idle {100 * (1 - busy_ms / p50):.1f}% of the step p50; launches per kernel run "
          + ", ".join(f"{n} {counts[n] // runs}" for n in per_step)
          + f" over {runs} runs; peak device memory {peak / 1e9:.2f} GB, device state "
          f"{device_state_bytes(eng) / 1e9:.2f} GB (no master, no moments); build "
          f"{build_s:.1f} s, first step {first_s:.1f} s ({card})")
    return eng, {"losses": losses, "p50": p50, "rows": rows, "device_ms": device_ms,
                 "split": split, "busy_ms": busy_ms, "peak_gb": peak / 1e9, "counts": counts,
                 "runs": runs}


def graded_offload(dev, card, preset=OFFLOAD_PRESET, seq=1024, micro=8, gas=OFFLOAD_GAS,
                   ref_gas=OFFLOAD_GAS):
    """Phase 20: graded config 3 (``offload_config``) at GPT-2 1.3B, T=1024,
    micro 8, gas 8, remat, on one card and its host.  From one seeded draw
    of the parameters (``draw_gpt2_params``, moved to the host once) and
    one token stream: the in-device engine of the same config without
    offload, eager (``ref_gas``; its steps 1-3 and its peak memory;
    captured = eager holds bit for bit, phases 5 and 20), the same at lr 0
    (the losses of a run whose updates never land), then the synchronous
    offload engine and the DPU one (warm-up 0) each through
    :func:`offload_run`, then an eager DPU engine for OFFLOAD_RACE_STEPS
    steps.  Hard checks: step 1's loss equal to the in-device engine's;
    steps 2-3 within OFFLOAD_UPDATE_SHARE of the gap the lr-0 run leaves;
    the host master moved by step 1; after sync's step 1 and DPU's step
    OFFLOAD_RACE_STEPS the device params equal to the payload image and
    the payload to the master's bf16 cast, bit for bit; the DPU master
    after step 1 bit-equal to the initial master and after step 2 to the
    synchronous master after step 1 (one step stale); the eager DPU run's
    losses, grad norms and host master bit-equal to the captured one's
    over OFFLOAD_RACE_STEPS steps (no race between the uploads, the copies
    into the params and the queued replays); exact flash launches per
    kernel run (with remat: the forward twice a micro-batch) and none on
    the templates; no device master or moments.  Prints the host's CPU,
    cores, threads, copy rate and the host Adam's bound, the host RSS peak
    and the pinned bytes, the wire's one copy against 64 MB chunks, and
    the phase's cost.  Returns the figures."""
    t_phase = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    head_dim = c.n_embd // c.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    dkdv, dq = fa.dense_bwd_kernel(torch.bfloat16, head_dim)
    per_step = {fwd: 2 * c.n_layer * gas, dkdv: c.n_layer * gas, dq: c.n_layer * gas}
    tokens = np.random.default_rng(0).integers(0, c.vocab_size, (micro * gas * 4, seq + 1)
                                               ).astype(np.int32)
    dev_params = draw_gpt2_params(model, dev, seed=0)
    params = tree_map(lambda t: t.cpu().numpy(), dev_params)
    del dev_params
    torch.cuda.empty_cache()
    numel = sum(a.size for a in tree_leaves(params))
    try:        # the OpenMP runtime the host library links: its default thread count
        import ctypes
        threads = ctypes.CDLL("libgomp.so.1").omp_get_max_threads()
    except OSError:
        threads = "unknown"
    rate = host_copy_rate()
    print(f"offload {preset}: {numel} params; host {host_cpu()}, torch threads "
          f"{torch.get_num_threads()}, OpenMP threads {threads} (OMP_NUM_THREADS "
          f"{os.environ.get('OMP_NUM_THREADS', 'unset')}); host copy rate "
          f"{rate / 1e9:.1f} GB/s (read + write, one 2 GiB ds_memcpy), the host Adam's bound "
          f"{HOST_BYTES_PER_PARAM * numel / rate:.3f} s ({HOST_BYTES_PER_PARAM} B a parameter)")
    tokens_per_step = micro * gas * seq
    fpt = model.flops_per_token()
    rss = RssPeak()
    rss.__enter__()

    # the in-device engine of the same config (no offload), eager: a capture's warm-up
    # caches ~35 GB the capture cannot use, more than the card holds beside the engine;
    # then the same engine at lr 0, whose losses are a run's whose updates never land
    print(f"phase 20 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")

    def in_device(lr=None):
        cfg = offload_config(gas=ref_gas, micro=micro)
        cfg["zero_optimization"] = {"stage": 3}
        if lr is not None:
            cfg["optimizer"]["params"]["lr"] = lr
        eng = offload_engine(dev, params, tokens, cfg, preset, seq, step_impl="eager")
        losses = [float(eng.train_batch()) for _ in range(OFFLOAD_REF_STEPS)]
        torch.cuda.synchronize()
        state = device_state_bytes(eng) / 1e9
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return losses, state
    torch.cuda.reset_peak_memory_stats()
    ref_losses, ref_state = in_device()
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    still_losses, _ = in_device(lr=0.0)

    # synchronous offload: the master before and after step 1 (the DPU checks), and
    # after step 1 the device params against the payload and the master
    masters, landed = {}, {}

    def make_sync():
        eng = offload_engine(dev, params, tokens, offload_config(gas=gas, micro=micro), preset,
                             seq)
        masters[0] = eng._offload.master.copy()
        return eng

    def keep(eng, i):
        if i == 1:
            masters[1] = eng._offload.master.copy()
            landed["sync"] = payload_landed(eng)
    sync, rs = offload_run(make_sync, "graded3 sync", per_step, card, tokens_per_step, fpt,
                           numel, after_step=keep)
    chunks = wire_chunk_timing(sync)
    pinned = sync._offload.pinned_bytes
    del sync
    gc.collect()
    torch.cuda.empty_cache()

    # DPU from step 1 (warm-up 0): nothing applied after step 1, step 1's update after
    # step 2; after step OFFLOAD_RACE_STEPS, step 3's update in the params (copied there
    # behind a queued replay) and the master kept for the eager run
    lag, race = {}, {}

    def check_dpu(eng, i):
        if i == 1:
            lag[1] = np.array_equal(eng._offload.master, masters[0])
        elif i == 2:
            lag[2] = np.array_equal(eng._offload.master, masters[1])
        elif i == OFFLOAD_RACE_STEPS:
            race["master"] = eng._offload.master.copy()
            landed["dpu"] = payload_landed(eng)
    dpu, rd = offload_run(lambda: offload_engine(dev, params, tokens,
                                                 offload_config(dpu=0, gas=gas, micro=micro),
                                                 preset, seq),
                          "graded3 dpu", per_step, card, tokens_per_step, fpt, numel,
                          after_step=check_dpu)
    del dpu
    moved = not np.array_equal(masters[0], masters[1])
    masters.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the device half eagerly, under DPU, against the captured run step by step
    eager = offload_engine(dev, params, tokens, offload_config(dpu=0, gas=gas, micro=micro),
                           preset, seq, step_impl="eager")
    e_losses = [(float(eager.train_batch()), eager.get_global_grad_norm())
                for _ in range(OFFLOAD_RACE_STEPS)]
    eager_same = np.array_equal(eager._offload.master, race.pop("master"))
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    rss.__exit__(None, None, None)

    sync_l = [x for x, _ in rs["losses"][:OFFLOAD_REF_STEPS]]
    gaps = [abs(a - b) for a, b in zip(sync_l, ref_losses)]
    still = [abs(a - b) for a, b in zip(still_losses, ref_losses)]
    limit = [OFFLOAD_UPDATE_SHARE * x for x in still]
    captured = rd["losses"][:OFFLOAD_RACE_STEPS]
    print(f"offload graded3 vs the in-device engine (stage 3, no offload, gas {ref_gas}, "
          f"eager): losses {[round(x, 6) for x in sync_l]} vs {[round(x, 6) for x in ref_losses]}"
          f", |diff| {gaps}; the in-device engine at lr 0 (no update) "
          f"{[round(x, 6) for x in still_losses]}, |diff| {still}; steps 2-3 limit "
          f"{OFFLOAD_UPDATE_SHARE:g} of it {limit[1:]}; host master moved by step 1 {moved}; "
          f"device params = payload, payload = bf16(master): sync after step 1 "
          f"{landed.get('sync')}, DPU after step {OFFLOAD_RACE_STEPS} {landed.get('dpu')}; "
          f"in-device peak {ref_peak:.2f} GB, state {ref_state:.2f} GB, offload peak sync "
          f"{rs['peak_gb']:.2f} / dpu {rd['peak_gb']:.2f} GB; DPU lag: master after step 1 = "
          f"initial {lag.get(1)}, after step 2 = sync's after step 1 {lag.get(2)}; eager DPU "
          f"{OFFLOAD_RACE_STEPS} steps {e_losses} vs captured {captured}, master after step "
          f"{OFFLOAD_RACE_STEPS} equal {eager_same}; wire (d2h ms, h2d ms) "
          + "; ".join(f"{k} {[(round(a, 2), round(b, 2)) for a, b in v]}"
                      for k, v in chunks.items())
          + f"; host RSS peak {rss.peak / 1e9:.1f} GB "
          f"(base {rss.base / 1e9:.1f}), pinned {pinned / 1e9:.2f} GB an engine; DPU / sync "
          f"step p50 {rd['p50'] / rs['p50']:.3f}; phase {time.perf_counter() - t_phase:.1f} s "
          f"({card})")
    if ref_gas == gas and sync_l[0] != ref_losses[0]:
        raise AssertionError(f"graded3 step 1 loss {sync_l[0]} != in-device {ref_losses[0]}")
    if ref_gas == gas and any(g > lim for g, lim in zip(gaps[1:], limit[1:])):
        raise AssertionError(f"graded3 steps 2-3 {sync_l} vs in-device {ref_losses} "
                             f"(no update {still_losses})")
    if not moved:
        raise AssertionError("graded3: the host master did not move in step 1")
    if landed != {"sync": (True, True), "dpu": (True, True)}:
        raise AssertionError(f"graded3 params / payload / master {landed}")
    if lag != {1: True, 2: True}:
        raise AssertionError(f"graded3 DPU lag checks {lag}")
    if e_losses != captured or not eager_same:
        raise AssertionError(f"graded3 eager DPU {e_losses} vs captured {captured}, "
                             f"master equal {eager_same}")
    return {"sync": rs, "dpu": rd, "ref_losses": ref_losses, "still_losses": still_losses,
            "ref_peak_gb": ref_peak, "rss_peak_gb": rss.peak / 1e9, "pinned_gb": pinned / 1e9,
            "chunks": chunks, "copy_rate": rate, "numel": numel,
            "seconds": time.perf_counter() - t_phase}


# 21. small checks at GPT-2 125M: client objects, checkpointing under capture, fp16 offload
SMALL_PRESET = "gpt2-125m"


def client_objects(dev, params, tokens, preset, seq, micro, per_step, steps=3):
    """21a: a client FusedAdam and a client WarmupLR (no optimizer or
    scheduler block), captured and eager: losses, grad norms and each
    step's lr (the scheduler's ``lr_fn``) bit-equal, one graph, exact
    launches."""
    rows = {}
    for impl in ("graph", "eager"):
        opt = FusedAdamW(lr=6e-4, weight_decay=0.1)
        sched = WarmupLR(opt, warmup_min_lr=0.0, warmup_max_lr=6e-4, warmup_num_steps=3)
        model = GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                     attention_impl="flash", remat=False, embd_pdrop=0.0, attn_pdrop=0.0,
                     resid_pdrop=0.0)
        cfg = {k: v for k, v in TRAIN_CONFIG.items() if k != "optimizer"}
        eng, o, _, s = deepspeed_tpu_torch.initialize(
            config=dict(cfg, train_micro_batch_size_per_gpu=micro), model=model, params=params,
            training_data=(tokens,), optimizer=opt, lr_scheduler=sched, step_impl=impl)
        if o is not opt or s is not sched:
            raise AssertionError("initialize did not return the client objects")
        fa.reset_launches()
        runs0 = kernel_runs(eng)
        rows[impl] = [(float(eng.train_batch()), eng.get_global_grad_norm(),
                       eng._last_metrics["lr"]) for _ in range(steps)]
        check_launches(f"client objects {impl}", dict(fa.launches), per_step,
                       kernel_runs(eng) - runs0)
        if impl == "graph" and dev.type == "cuda" and eng.stats()["graphs"]["graphs"] != 1:
            raise AssertionError(f"client objects: {eng.stats()['graphs']}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    lrs = [sched.lr_fn(i) for i in range(steps)]
    if rows["graph"] != rows["eager"] or [r[2] for r in rows["graph"]] != lrs:
        raise AssertionError(f"client objects: captured {rows['graph']} eager {rows['eager']}, "
                             f"lr_fn {lrs}")
    print(f"client FusedAdamW + WarmupLR ({preset} bf16, micro {micro}): {steps} steps "
          f"captured and eager bit-equal (loss, grad norm, lr) {rows['graph']}")


def checkpoint_under_capture(dev, gen, B=8, D=1024):
    """21b: ``checkpointing.checkpoint`` over an MLP region, its loss and
    gradients computed inside a captured StepGraph, against the unwrapped
    region run eagerly: bit-equal."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing
    from deepspeed_tpu_torch.runtime.step_graph import GraphPool, StepGraph
    w1 = (torch.randn(D, 4 * D, device=dev, generator=gen) * 0.02).requires_grad_(True)
    w2 = (torch.randn(4 * D, D, device=dev, generator=gen) * 0.02).requires_grad_(True)
    x = torch.randn(B, 256, D, device=dev, generator=gen)

    def region(a, b, h):
        return torch.nn.functional.gelu(h @ a) @ b

    def loss_grads(h, wrap):
        out = checkpointing.checkpoint(region, w1, w2, h) if wrap else region(w1, w2, h)
        loss = (out.float() ** 2).mean()
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
        return {"loss": loss.detach(), "g1": g1, "g2": g2}
    step = StepGraph("checkpoint.region", lambda h: loss_grads(h, True), {"h": x}, dev,
                     GraphPool(dev))
    got = {k: v.clone() for k, v in step(h=x).items()}
    want = loss_grads(x, False)
    same = all(torch.equal(got[k], want[k]) for k in want)
    diff = max(float((got[k].float() - want[k].float()).abs().max()) for k in want)
    print(f"checkpointing.checkpoint under capture (B={B}, T=256, D={D}, fp32): loss and "
          f"grads vs the unwrapped region eagerly: bit-equal {same}, max |diff| {diff:g}; "
          f"{step.captures} capture, {step.replays} replay")
    if not same:
        raise AssertionError(f"checkpoint under capture differs by {diff}")


def fp16_offload_overflow(dev, params, tokens, preset, seq, micro, card, steps=2):
    """21c: an fp16 offload run (stage 3, sync, captured, the fp32 gradient
    wire): ``steps`` steps, then the loss scale set in place to 2^40: that
    step skipped with the host master and moments and the device params
    bit-unchanged, the skip counted; exact launches of the fp16 instances."""
    cfg = offload_config(gas=1, micro=micro, fp16={"enabled": True})
    del cfg["bf16"], cfg["data_types"]
    eng = offload_engine(dev, params, tokens, cfg, preset, seq, dtype=torch.float16,
                         remat=False)
    c = eng.module.config
    fwd = fa.dense_fwd_kernel(torch.float16, c.n_embd // c.n_head)
    per_step = {fwd: c.n_layer, **{k: c.n_layer for k in fa.dense_bwd_kernel(
        torch.float16, c.n_embd // c.n_head)}}
    fa.reset_launches()
    runs0 = kernel_runs(eng)
    losses = [float(eng.train_batch()) for _ in range(steps)]
    st = eng.offload_state()
    before = {k: v.copy() for k, v in st.items()}
    params_before = [t.clone() for t in tree_leaves(eng.params)]
    skipped = eng.skipped_steps
    eng.scale.cur_scale.fill_(2.0 ** 40)
    loss = float(eng.train_batch())
    after = eng.offload_state()
    same = all(np.array_equal(after[k], before[k]) for k in before) and all(
        torch.equal(a, b) for a, b in zip(params_before, tree_leaves(eng.params)))
    check_launches("fp16 offload", dict(fa.launches), per_step, kernel_runs(eng) - runs0)
    print(f"fp16 offload {preset} (stage 3, sync): losses {[round(x, 6) for x in losses]}, "
          f"then the scale set to 2^40: loss {loss:.6f}, skipped {skipped} -> "
          f"{eng.skipped_steps}, host master and moments and device params bit-unchanged "
          f"{same}; wire {eng._offload.wire_dtype}, payload {eng._offload.compute_dtype} "
          f"({card})")
    if (eng.skipped_steps != skipped + 1 or not same
            or eng._offload.wire_dtype != torch.float32):
        raise AssertionError(f"fp16 offload forced overflow: skipped {skipped} -> "
                             f"{eng.skipped_steps}, unchanged {same}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def small_checks(dev, card, preset=SMALL_PRESET, seq=1024, micro=8):
    """Phase 21 at GPT-2 125M, T=1024, micro 8: 21a, 21b, 21c."""
    t0 = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    tokens = np.random.default_rng(0).integers(0, c.vocab_size, (64, seq + 1)).astype(np.int32)
    params = model.init_numpy(seed=0)
    per_step = {name: c.n_layer for name in (
        fa.dense_fwd_kernel(torch.bfloat16, c.n_embd // c.n_head),
        *fa.dense_bwd_kernel(torch.bfloat16, c.n_embd // c.n_head))}
    client_objects(dev, params, tokens, preset, seq, micro, per_step)
    checkpoint_under_capture(dev, torch.Generator(device=dev).manual_seed(38))
    fp16_offload_overflow(dev, params, tokens, preset, seq, micro, card)
    print(f"phase 21: {time.perf_counter() - t0:.1f} s")


# 22. the health ladder: skip -> rewind -> abort at GPT-2 125M, ZeRO-2, captured
LADDER_PRESET = "gpt2-125m"
LADDER_HEALTH = {"consecutive_skip_budget": 2, "rewind_limit": 3}
LADDER_WINDOW = "grad_nan=3:8"     # JAX tests/test_health.py:405-441: 5 poisoned stream steps
LADDER_PASSES, LADDER_TIMED = 3, 10
CHIP_TMP = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".chip_tmp")


def gated_engine(dev, params, data, config, preset, seq=1024, step_impl="auto", remat=False):
    """An engine whose batch is ``(tokens, gate)`` and whose loss is the
    model's times ``mean(gate)``: the gate is ones, so the loss is the
    model's bit for bit, and ``fault.corrupt_batch``'s ``grad_nan`` (which
    poisons float leaves only) makes it NaN."""
    model = GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                 attention_impl="flash", remat=remat, embd_pdrop=0.0, attn_pdrop=0.0,
                 resid_pdrop=0.0)
    return deepspeed_tpu_torch.initialize(
        config=config, model=model, params=params, training_data=data, step_impl=step_impl,
        loss_fn=lambda p, b, r: model.loss(p, b[0], r) * b[1].mean())[0]


def ladder_config(micro, health, ckpt_dir=None, **over):
    cfg = dict(TRAIN_CONFIG, train_micro_batch_size_per_gpu=micro,
               zero_optimization={"stage": 2}, **over)
    if health is not None:
        cfg["health_check"] = health
    if ckpt_dir is not None:
        cfg["checkpoint"] = {"dir": ckpt_dir}
    return cfg


def device_state(eng):
    """Clones of the params and the master, on the card."""
    return [t.clone() for t in tree_leaves(eng.params) + tree_leaves(eng.master)]


def same_state(eng, state):
    return all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.params) + tree_leaves(eng.master), state))


def ladder_run(make, ckpt_dir, per_step):
    """JAX's rewind scenario on ``make()``: 3 steps, a save as "good", the
    grad_nan window over stream steps 3-7 and 9 steps, then 3 clean steps.
    Each skipped step that no rewind followed must leave the params and
    the master bit-unchanged.  Returns the readings."""
    fa.reset_launches()
    eng = make()
    runs0 = kernel_runs(eng)
    times = {"rewind": []}
    rewind = eng.rewind

    def timed_rewind(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rewind(*args, **kwargs)
        torch.cuda.synchronize()
        times["rewind"].append(time.perf_counter() - t0)
        return out
    eng.rewind = timed_rewind
    losses = [float(eng.train_batch()) for _ in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.save_checkpoint(ckpt_dir, tag="good")
    times["save"] = time.perf_counter() - t0
    good = device_state(eng)
    fault.configure(LADDER_WINDOW)
    skipped_same, streams = [], []
    try:
        for _ in range(9):
            before, rewinds = device_state(eng), eng.health_monitor.rewinds
            losses.append(float(eng.train_batch()))
            streams.append(eng._stream_step)
            if bool(eng._last_metrics["skip"]) and eng.health_monitor.rewinds == rewinds:
                skipped_same.append(same_state(eng, before))
            del before
    finally:
        fault.reset()
    mon = eng.health_monitor
    state = {"rewinds": mon.rewinds, "tag": eng.loaded_checkpoint_tag,
             "stream_step": eng._stream_step, "global_steps": eng.global_steps,
             "counters": mon.counters()}
    after = [float(eng.train_batch()) for _ in range(3)]
    skip_after = bool(eng._last_metrics["skip"])
    moved = not same_state(eng, good)
    # eager, a step is a kernel run (global_steps, which the rewinds moved back, is not)
    captured = eng.step_impl == "graph" and eng.device.type == "cuda"
    runs = kernel_runs(eng) - runs0 if captured else len(losses) + len(after)
    check_launches(f"ladder {eng.step_impl}", dict(fa.launches), per_step, runs)
    out = {"losses": losses, "after": after, "state": state, "skipped_same": skipped_same,
           "streams": streams, "moved": moved, "skip_after": skip_after, "times": times,
           "runs": runs, "graphs": eng.stats()["graphs"]}
    del eng, good
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ladder_abort(make, steps):
    """One clean step, then grad_nan from stream step 1 on: the step at
    which ``TrainingHealthError`` comes, its message and its forensic
    payload."""
    eng = make()
    eng.train_batch()
    fault.configure("grad_nan=1:1000")
    try:
        for n in range(1, steps + 1):
            eng.train_batch()
        raise AssertionError(f"ladder: no TrainingHealthError in {steps} poisoned steps")
    except deepspeed_tpu_torch.TrainingHealthError as e:
        path = e.forensic_path
        with open(path) as f:
            payload = json.load(f)
        return {"step": n, "msg": str(e), "path": path, "payload": payload}
    finally:
        fault.reset()
        del eng
        gc.collect()
        torch.cuda.empty_cache()


def ladder_timing(make, dev):
    """LADDER_PASSES passes of LADDER_TIMED steps, synchronised once a pass
    (the monitor's read of step t-1 must not wait on step t): the step p50
    over the passes' mean step times, and the share of steps whose
    ``train_batch`` returned with the card still busy."""
    eng = make()
    for _ in range(3):
        eng.train_batch()
    torch.cuda.synchronize()
    rows, busy = [], 0
    for _ in range(LADDER_PASSES):
        t0 = time.perf_counter()
        for _ in range(LADDER_TIMED):
            eng.train_batch()
            busy += dev.type == "cuda" and not torch.cuda.current_stream(dev).query()
        torch.cuda.synchronize()
        rows.append((time.perf_counter() - t0) * 1e3 / LADDER_TIMED)
    skipped = eng.skipped_steps
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if skipped:
        raise AssertionError(f"ladder timing: {skipped} skipped steps")
    return statistics.median(rows), rows, busy / (LADDER_PASSES * LADDER_TIMED)


def health_ladder(dev, card, preset=LADDER_PRESET, seq=1024, micro=8):
    """Phase 22: the health guardian's ladder at GPT-2 125M (graded config
    2's model), full width and depth, T=1024, micro 8, bf16, ZeRO-2,
    captured, with ``checkpoint.dir`` under ``.chip_tmp/`` and
    ``health_check`` LADDER_HEALTH: JAX's rewind scenario
    (``ladder_run``), captured and eager, bit-equal in losses, rewinds and
    stream positions; ``rewind_limit: 0`` raising ``TrainingHealthError``
    with a forensic file whose history holds the skips; the default
    ``health_check`` (no ladder key, no checkpoint directory) aborting
    with "rewind failed" after 10 consecutive skips, as JAX does; exact
    flash launches (12 of each sm90 kernel a step run, skipped and
    replayed steps included, 0 on the templates); save and rewind
    seconds; the step p50 with the ladder armed (the default) against
    ``consecutive_skip_budget: 0``."""
    t_phase = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    head_dim = c.n_embd // c.n_head
    per_step = {name: c.n_layer for name in (fa.dense_fwd_kernel(torch.bfloat16, head_dim),
                                             *fa.dense_bwd_kernel(torch.bfloat16, head_dim))}
    n = 64
    data = (np.random.default_rng(0).integers(0, c.vocab_size, (n, seq + 1)).astype(np.int32),
            np.ones((n,), np.float32))
    params = model.init_numpy(seed=0)
    os.makedirs(CHIP_TMP, exist_ok=True)       # a fresh checkout has none
    root = tempfile.mkdtemp(prefix="ladder_", dir=CHIP_TMP)
    cwd = os.getcwd()
    try:
        runs = {}
        for impl in ("graph", "eager"):
            d = os.path.join(root, impl)
            runs[impl] = ladder_run(lambda: gated_engine(
                dev, params, data, ladder_config(micro, LADDER_HEALTH, d), preset, seq,
                step_impl=impl), d, per_step)
        g, e = runs["graph"], runs["eager"]
        st = g["state"]
        print(f"ladder {preset} T={seq} micro {micro} bf16 zero2 {LADDER_HEALTH} "
              f"{LADDER_WINDOW}: captured {st}; losses {[round(x, 6) for x in g['losses']]}, "
              f"after {[round(x, 6) for x in g['after']]}; stream steps {g['streams']}; "
              f"skipped steps with no rewind bit-unchanged {g['skipped_same']}; params moved "
              f"from 'good' {g['moved']}; save {g['times']['save']:.3f} s, rewinds "
              f"{[round(x, 3) for x in g['times']['rewind']]} s; launches per kernel run "
              f"{per_step} over {g['runs']} runs ({g['graphs']['replays']} replays, "
              f"{g['graphs']['warmups']} warm-ups); eager: {e['state']}, losses equal "
              f"{np.array_equal(g['losses'] + g['after'], e['losses'] + e['after'], equal_nan=True)}"
              f", stream steps equal {g['streams'] == e['streams']} ({card})")
        if not (st["rewinds"] >= 1 and st["tag"] == "good" and st["stream_step"] > 8
                and st["global_steps"] < st["stream_step"]):
            raise AssertionError(f"ladder: {st}")
        if not g["skipped_same"] or not all(g["skipped_same"]) or not g["moved"] \
                or g["skip_after"] or not all(math.isfinite(x) for x in g["after"]):
            raise AssertionError(f"ladder: skipped same {g['skipped_same']}, moved "
                                 f"{g['moved']}, after {g['after']}")
        if (e["state"] != st or g["streams"] != e["streams"] or not np.array_equal(
                g["losses"] + g["after"], e["losses"] + e["after"], equal_nan=True)):
            raise AssertionError(f"ladder captured {st} {g['losses']} != eager {e['state']} "
                                 f"{e['losses']}")
        if dev.type == "cuda" and g["graphs"]["graphs"] != 1:
            raise AssertionError(f"ladder: the captured run holds {g['graphs']}")

        # rewind_limit 0: abort with forensics
        limit0 = dict(LADDER_HEALTH, rewind_limit=0, forensic_dir=os.path.join(root, "f0"))
        ab = ladder_abort(lambda: gated_engine(dev, params, data,
                                               ladder_config(micro, limit0), preset, seq), 6)
        hist = ab["payload"]["history"]
        # the default health_check: no ladder key, no checkpoint dir; forensics to the cwd
        os.makedirs(os.path.join(root, "cwd"))
        os.chdir(os.path.join(root, "cwd"))
        df = ladder_abort(lambda: gated_engine(dev, params, data, ladder_config(micro, None),
                                               preset, seq), 14)
        os.chdir(cwd)
        print(f"ladder rewind_limit 0: TrainingHealthError at poisoned step {ab['step']} "
              f"({ab['msg'][:90]}...), forensics {os.path.basename(ab['path'])} with "
              f"{sum(r['skip'] for r in hist)} skips in {len(hist)} records; default "
              f"health_check: at poisoned step {df['step']} ({df['msg'][:60]}...), counters "
              f"{df['payload']['counters']}")
        if ab["step"] != 3 or sum(r["skip"] for r in hist) < 2 or \
                "rewind limit spent" not in ab["msg"]:
            raise AssertionError(f"ladder rewind_limit 0: {ab['step']} {ab['msg']} {hist}")
        if df["step"] != 11 or "rewind failed" not in df["msg"] or \
                df["payload"]["policy"]["consecutive_skip_budget"] != 10:
            raise AssertionError(f"ladder default config: {df['step']} {df['msg']}")

        # the ladder armed (the default) against a budget of 0 (never escalates)
        armed = ladder_timing(lambda: gated_engine(dev, params, data,
                                                   ladder_config(micro, None), preset, seq),
                              dev)
        unarmed = ladder_timing(lambda: gated_engine(
            dev, params, data, ladder_config(micro, {"consecutive_skip_budget": 0}), preset,
            seq), dev)
        print(f"ladder step p50 (passes of {LADDER_TIMED} steps, one sync a pass): armed "
              f"{armed[0]:.3f} ms {[round(x, 3) for x in armed[1]]} (card still busy when "
              f"train_batch returned: {armed[2]:.2f} of steps), consecutive_skip_budget 0 "
              f"{unarmed[0]:.3f} ms {[round(x, 3) for x in unarmed[1]]} ({unarmed[2]:.2f}); "
              f"phase 22 {time.perf_counter() - t_phase:.1f} s ({card})")
        return {"state": st, "save_s": g["times"]["save"], "rewind_s": g["times"]["rewind"],
                "armed_ms": armed, "unarmed_ms": unarmed, "counts": dict(fa.launches)}
    finally:
        os.chdir(cwd)
        fault.reset()
        shutil.rmtree(root, ignore_errors=True)


# 23. the NVMe tier: GPT-2 350M at ZeRO-3 with the Adam moments in swap files
NVME_PRESET = "gpt2-350m"
NVME_GAS = 8
NVME_SUB_GROUP = int(5e7)
NVME_CHECK_STEPS = 3                     # steps held bit for bit against the CPU tier
NVME_PASSES, NVME_TIMED = 1, 2           # timed passes of timed steps, sync and DPU
RAW_AIO_BYTES = 1 << 30


def fs_of(path):
    """(device, mount point, filesystem type) of ``path`` from /proc/mounts."""
    path, best = os.path.realpath(path), ("?", "?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, typ = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and \
                    (best[1] == "?" or len(mnt) > len(best[1])):
                best = (dev, mnt, typ)
    return best


def io_setup_works():
    """Whether the kernel AIO syscalls that ``ds_aio.cpp`` uses are allowed
    here (``io_setup`` / ``io_destroy`` through ``syscall``)."""
    import ctypes
    nr = {"x86_64": (206, 207), "aarch64": (0, 1)}.get(platform.machine())
    if nr is None:
        return None
    libc = ctypes.CDLL(None, use_errno=True)
    ctx = ctypes.c_ulong(0)
    if libc.syscall(nr[0], 8, ctypes.byref(ctx)) != 0:
        return False
    libc.syscall(nr[1], ctx)
    return True


def raw_aio_rates(path, aio):
    """One 1 GiB aligned ``AsyncIOHandle`` sync write and read on ``path``,
    twice: [(write GB/s, read GB/s)]; the data read back must equal."""
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    from deepspeed_tpu_torch.runtime.swap_tensor.utils import aligned_empty, is_aligned
    h = AsyncIOHandle(**aio)
    src, dst = aligned_empty(RAW_AIO_BYTES // 4), aligned_empty(RAW_AIO_BYTES // 4)
    src.copy_(torch.arange(src.numel(), dtype=torch.float32))
    if not (is_aligned(src) and is_aligned(dst)):
        raise AssertionError("raw aio buffers are not aligned")
    f = os.path.join(path, "raw_aio.swp")
    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        h.sync_pwrite(src, f)
        w = time.perf_counter() - t0
        t0 = time.perf_counter()
        h.sync_pread(dst, f)
        r = time.perf_counter() - t0
        rates.append((RAW_AIO_BYTES / w / 1e9, RAW_AIO_BYTES / r / 1e9))
    same = torch.equal(src, dst)
    os.remove(f)
    if not same:
        raise AssertionError("raw aio: the data read back differs")
    return rates


def nvme_config(path=None, pipe=False, dpu=None, micro=8, gas=NVME_GAS):
    """Phase 20's configuration (``offload_config``) at the NVMe tier:
    ``offload_optimizer`` nvme under ``path`` (the CPU tier without one),
    ``sub_group_size`` NVME_SUB_GROUP."""
    cfg = offload_config(dpu=dpu, gas=gas, micro=micro)
    off = cfg["zero_optimization"]["offload_optimizer"]
    if path is not None:
        off.update(device="nvme", nvme_path=path, pipeline_read=pipe, pipeline_write=pipe)
    cfg["zero_optimization"]["sub_group_size"] = NVME_SUB_GROUP
    return cfg


def host_tier(eng):
    """Copies of the host master and moments, and the device params on the host."""
    off = eng._offload
    m, v = off.moments()
    return {"master": off.master.copy(), "m": np.array(m), "v": np.array(v),
            "params": [t.detach().to("cpu", copy=True) for t in tree_leaves(eng.params)]}


def same_tier(a, b):
    return {k: (np.array_equal(a[k], b[k]) if k != "params" else
                all(torch.equal(x, y) for x, y in zip(a[k], b[k]))) for k in a}


def swap_stats(eng):
    folder = eng._offload.swapper.swap_folder
    return {f: (os.stat(os.path.join(folder, f)).st_size,
                os.stat(os.path.join(folder, f)).st_mtime_ns) for f in sorted(os.listdir(folder))}


def nvme_tier(dev, card, preset=NVME_PRESET, seq=1024, micro=8, gas=NVME_GAS):
    """Phase 23: the NVMe tier at GPT-2 350M, full width and depth, T=1024,
    micro 8, gas 8, bf16, remat, ZeRO-3 (phase 20's configuration at 350M)
    with ``offload_optimizer`` nvme under ``.chip_tmp/nvme`` and
    ``sub_group_size`` 5e7 (eight groups).  The filesystem under the path,
    whether ``io_setup`` works, and a raw 1 GiB ``AsyncIOHandle`` write and
    read there (the disk's own rate).  Hard checks: NVME_CHECK_STEPS sync
    steps on the NVMe tier equal the CPU tier's bit for bit (losses,
    master, moments, params); the pipelined tier equals the unpipelined
    one bit for bit; a forced grad_nan step leaves the master, the
    moments, the swap files (size and mtime) and the params unchanged;
    DPU's master one step stale; every swap buffer aligned; exact flash
    launches (384 / 192 / 192 a step run with remat).  Readings: sync and
    DPU step p50 / p99 (NVME_PASSES passes of NVME_TIMED steps), tokens/s,
    MFU, the host half's split (swap-in wait, Adam, swap-out submit and
    wait, widening, d2h, h2d), bytes read and written a step and their
    rate, the idle share, device peak and host RSS.  Raises when the disk
    holds less than twice the bytes the phase writes; removes its files."""
    from deepspeed_tpu_torch.runtime.swap_tensor.utils import aligned_numel, is_aligned
    t_phase = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    head_dim = c.n_embd // c.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    dkdv, dq = fa.dense_bwd_kernel(torch.bfloat16, head_dim)
    per_step = {fwd: 2 * c.n_layer * gas, dkdv: c.n_layer * gas, dq: c.n_layer * gas}
    n = micro * gas * 4
    data = (np.random.default_rng(0).integers(0, c.vocab_size, (n, seq + 1)).astype(np.int32),
            np.ones((n,), np.float32))
    dev_params = draw_gpt2_params(model, dev, seed=0)
    params = tree_map(lambda t: t.cpu().numpy(), dev_params)
    del dev_params
    torch.cuda.empty_cache()
    numel = sum(a.size for a in tree_leaves(params))
    groups = -(-numel // NVME_SUB_GROUP)
    swap_bytes = sum(2 * 4 * aligned_numel(min(NVME_SUB_GROUP, numel - g * NVME_SUB_GROUP))
                     for g in range(groups))
    root = os.path.join(CHIP_TMP, "nvme")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    need = 2 * (swap_bytes + RAW_AIO_BYTES)
    fs = fs_of(root)
    io_ok = io_setup_works()
    print(f"nvme {preset}: {numel} params in {groups} groups, {swap_bytes} B of moments on "
          f"disk; nvme_path {root} on {fs[2]} ({fs[0]} at {fs[1]}), {free / 1e9:.1f} GB free "
          f"(need {need / 1e9:.1f}); io_setup {'works' if io_ok else 'refused'}"
          + ("; tmpfs takes no O_DIRECT" if fs[2] == "tmpfs" else ""))
    if free < need:
        raise AssertionError(f"nvme: {free} B free under {root}, the phase needs {need}")
    fpt = model.flops_per_token()
    tokens_per_step = micro * gas * seq
    rss = RssPeak()
    rss.__enter__()
    try:
        from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
        aio = DeepSpeedConfig(nvme_config(root)).aio_config
        raw = raw_aio_rates(root, aio)
        print(f"nvme raw AsyncIOHandle ({aio}) 1 GiB sync write / read GB/s, twice: {raw}")

        def make(cfg, step_impl="auto"):
            return gated_engine(dev, params, data, cfg, preset, seq, step_impl=step_impl,
                                remat=True)

        def steps(eng, k):
            out = [(float(eng.train_batch()), eng.get_global_grad_norm()) for _ in range(k)]
            torch.cuda.synchronize()
            return out

        # the CPU tier, then the NVMe tier unpipelined: bit for bit
        torch.cuda.reset_peak_memory_stats()
        cpu = make(nvme_config())
        cpu_losses, cpu_state = steps(cpu, NVME_CHECK_STEPS), host_tier(cpu)
        del cpu
        gc.collect()
        torch.cuda.empty_cache()
        sync = make(nvme_config(os.path.join(root, "sync")))
        bufs = [b.data for slot in sync._offload.swapper._bufs for b in slot.values()]
        sync_losses, sync_state = steps(sync, NVME_CHECK_STEPS), host_tier(sync)
        same_cpu = same_tier(sync_state, cpu_state)
        aligned = all(is_aligned(b) for b in bufs) and len(bufs) > 0
        # a forced grad_nan step: nothing on the host, the files or the card changes
        files = swap_stats(sync)
        fault.configure(f"grad_nan={NVME_CHECK_STEPS}")
        try:
            nan_loss = float(sync.train_batch())
        finally:
            fault.reset()
        torch.cuda.synchronize()
        nan_same = same_tier(host_tier(sync), sync_state)
        files_same = swap_stats(sync) == files
        nan_skipped = sync.skipped_steps == 1
        del sync, cpu_state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"nvme {preset} sync vs the CPU tier, {NVME_CHECK_STEPS} steps: losses "
              f"{sync_losses} vs {cpu_losses}, equal {sync_losses == cpu_losses}; state "
              f"equal {same_cpu}; swap buffers 4096-aligned {aligned} ({len(bufs)}); a grad_nan "
              f"step: loss {nan_loss}, skipped {nan_skipped}, state unchanged {nan_same}, swap "
              f"files (size, mtime) unchanged {files_same}")
        if sync_losses != cpu_losses or not all(same_cpu.values()) or not aligned:
            raise AssertionError(f"nvme sync vs cpu tier: {same_cpu}, aligned {aligned}")
        if not (nan_skipped and all(nan_same.values()) and files_same):
            raise AssertionError(f"nvme grad_nan step: {nan_same}, files {files_same}")

        # pipelined sync: bit for bit against unpipelined, then timed
        masters = {}

        def keep(eng, i):
            if i == 1:
                masters[1] = eng._offload.master.copy()
        splits = []

        def split(eng, i):
            keep(eng, i)
            off, t = eng._offload, eng.offload_times
            if i > NVME_CHECK_STEPS and "host_step_s" in t:
                nan = lambda x: float("nan") if x is None else x    # noqa: E731 (no events)
                splits.append({**off.swap_times, "widen_s": t["widen_s"],
                               "host_step_s": t["host_step_s"], "d2h_s": nan(t["d2h_s"]),
                               "h2d_s": nan(wire.seconds(t["upload"])),
                               "bytes": off.swap_bytes})
        pipe_state = {}

        def make_pipe():
            eng = make(nvme_config(os.path.join(root, "pipe"), pipe=True))
            masters[0] = eng._offload.master.copy()
            return eng

        def after_pipe(eng, i):
            split(eng, i)
            if i == NVME_CHECK_STEPS:
                pipe_state.update(host_tier(eng))
        rp = nvme_run(make_pipe, "nvme pipelined sync", per_step, card, tokens_per_step, fpt,
                      after_pipe)
        pipe_same = same_tier(pipe_state, sync_state)
        pipe_losses = rp["losses"][:NVME_CHECK_STEPS]
        del sync_state, pipe_state
        gc.collect()
        if pipe_losses != [x for x, _ in sync_losses] or not all(pipe_same.values()):
            raise AssertionError(f"nvme pipelined {pipe_losses} vs sync {sync_losses}: "
                                 f"{pipe_same}")

        # DPU (warm-up 0): the master one step stale
        lag = {}

        def check_dpu(eng, i):
            if i == 1:
                lag[1] = np.array_equal(eng._offload.master, masters[0])
            elif i == 2:
                lag[2] = np.array_equal(eng._offload.master, masters[1])
        rd = nvme_run(lambda: make(nvme_config(os.path.join(root, "dpu"), pipe=True, dpu=0)),
                      "nvme pipelined dpu", per_step, card, tokens_per_step, fpt, check_dpu,
                      check_steps=2)
        masters.clear()
        if lag != {1: True, 2: True}:
            raise AssertionError(f"nvme DPU lag checks {lag}")
        rss.__exit__(None, None, None)
        sp = {k: statistics.mean(s[k] for s in splits) for k in splits[0] if k != "bytes"}
        rb, wb = splits[-1]["bytes"]
        io_s = sp["host_step_s"]
        print(f"nvme host half a sync step (pipelined, mean of {len(splits)}): swap-in wait "
              f"{sp['swap_in_wait_s']:.4f} s, Adam {sp['adam_s']:.4f} s, swap-out submit "
              f"{sp['swap_out_s']:.4f} s and final wait {sp['swap_out_wait_s']:.4f} s (host step "
              f"{io_s:.4f} s), widen {sp['widen_s']:.4f} s, d2h {sp['d2h_s']:.4f} s, h2d "
              f"{sp['h2d_s']:.4f} s; {rb} B read and {wb} B written a step, "
              f"{(rb + wb) / io_s / 1e9:.2f} GB/s over the host step (raw {raw}); DPU lag "
              f"{lag}; DPU / sync step p50 {rd['p50'] / rp['p50']:.3f}; host RSS peak "
              f"{rss.peak / 1e9:.1f} GB (base {rss.base / 1e9:.1f}); phase 23 "
              f"{time.perf_counter() - t_phase:.1f} s ({card})")
        return {"sync": rp, "dpu": rd, "split": sp, "bytes": (rb, wb), "raw": raw,
                "fs": fs, "io_setup": io_ok, "rss_peak_gb": rss.peak / 1e9,
                "seconds": time.perf_counter() - t_phase}
    finally:
        fault.reset()
        shutil.rmtree(root, ignore_errors=True)


def nvme_run(make, tag, per_step, card, tokens_per_step, flops_per_token, after_step,
             check_steps=NVME_CHECK_STEPS):
    """One NVMe engine: ``check_steps`` steps (the first captures), then
    NVME_PASSES passes of NVME_TIMED synchronised steps (p50 / p99,
    tokens/s, MFU), exact launches, peak device memory, a profiled step's
    busy time against the p50.  ``after_step(eng, i)`` runs after each
    step (i from 1).  Returns the engine's figures."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    eng = make()
    build_s = time.perf_counter() - t0
    runs0 = kernel_runs(eng)
    losses, rows, i = [], [], 0

    def step():
        nonlocal i
        t = time.perf_counter()
        loss = float(eng.train_batch())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        i += 1
        after_step(eng, i)
        losses.append((loss, eng.get_global_grad_norm()))
        return dt
    first_s = step()
    for _ in range(check_steps - 1):
        step()
    for _ in range(NVME_PASSES):
        ms = np.asarray([step() * 1e3 for _ in range(NVME_TIMED)])
        tok_s = NVME_TIMED * tokens_per_step / (ms.sum() / 1e3)
        rows.append((np.percentile(ms, 50), np.percentile(ms, 99), tok_s,
                     tok_s * flops_per_token / PEAK_OPS["bf16"]))
    counts, runs = dict(fa.launches), kernel_runs(eng) - runs0
    check_launches(tag, counts, per_step, runs)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x, _ in losses) or eng.skipped_steps:
        raise AssertionError(f"{tag}: losses {losses}, skipped {eng.skipped_steps}")
    summary = {}
    profile_steps(lambda: float(eng.train_batch()), tag, steps=1, unit="training step",
                  summary=summary)
    cols = list(zip(*rows))
    p50 = statistics.median(cols[0])
    busy_ms = summary.get("busy_us", float("nan")) / 1e3
    print(f"{tag}: " + ", ".join(
        f"{name} {statistics.median(col):.3f} (readings {', '.join(f'{x:.3f}' for x in col)})"
        for name, col in zip(("step p50 ms", "step p99 ms", "tokens/s", "MFU"), cols))
          + f"; profiled step busy {busy_ms:.3f} ms, idle {100 * (1 - busy_ms / p50):.1f}% "
          f"of the step p50; launches per kernel run (expected {per_step}) "
          + ", ".join(f"{n} {counts[n] // runs}" for n in per_step)
          + f" over {runs} runs; peak device memory {peak / 1e9:.2f} GB; build {build_s:.1f} s,"
          f" first step {first_s:.1f} s ({card})")
    out = {"losses": [x for x, _ in losses], "p50": p50, "rows": rows, "busy_ms": busy_ms,
           "peak_gb": peak / 1e9, "counts": counts, "runs": runs}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


# 24. parameter streaming at graded config 3's width: GPT-2 1.3B with its layer blocks
# streamed from the host through the card
STREAM_TIMED = 3                         # timed steps after the warm-up (steps 2-4)
STREAM_RAM_PER_PARAM = 30                # host bytes a parameter the phase needs at its peak


class GatedStreamGPT2(GPT2):
    """GPT-2 whose streamed batches are ``(tokens, gate)``: the labels
    carry the gate as their last column and the loss is the model's times
    the gate's mean, ones (the model's loss bit for bit) or NaN inside a
    ``grad_nan`` window (``fault.corrupt_batch`` poisons float leaves only)."""

    def stream_fns(self):
        sf = dict(super().stream_fns())
        split, head = sf["split_batch"], sf["head_loss"]

        def split_batch(b):
            tokens, labels = split(b[0])
            return tokens, torch.cat([labels.float(), b[1].float()[:, None]], 1)

        def head_loss(nb, x, lg):
            T = lg.shape[1] - 1
            return head(nb, x, lg[:, :T].long()) * lg[:, T].mean()
        sf.update(split_batch=split_batch, head_loss=head_loss)
        return sf


def mem_available():
    """The host's MemAvailable, bytes (``/proc/meminfo``)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def stream_engine(dev, params, data, config, preset, seq, cls=GatedStreamGPT2):
    model = cls(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                attention_impl="flash", embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
    return deepspeed_tpu_torch.initialize(config=config, model=model, params=params,
                                          training_data=data)[0]


def stream_restart(eng, master0):
    """Back to the state before step 1: the initial master, zero moments,
    the payload and the card's nonblock params from them, the counters and
    the host EMA reset."""
    off = eng._offload
    np.copyto(off.master, master0)
    off.m.fill(0.0)
    off.v.fill(0.0)
    off.refresh_payload()
    eng._param_stream.reload_from_host()
    eng._param_stream.reset_health_ema()
    eng._host_opt_steps = eng._global_steps = eng.micro_steps = eng.global_samples = 0
    eng._optimizer_steps.fill_(0)
    eng._skipped_steps.fill_(0)
    if eng.health_monitor is not None:
        eng.health_monitor.on_checkpoint_load()


def host_state(eng):
    """Copies of the host master, moments and payload image."""
    off = eng._offload
    return [off.master.copy(), off.m.copy(), off.v.copy(), off.payload.clone()]


def same_host_state(eng, state):
    off = eng._offload
    return [np.array_equal(off.master, state[0]), np.array_equal(off.m, state[1]),
            np.array_equal(off.v, state[2]), torch.equal(off.payload, state[3])]


def param_stream(dev, card, graded, preset=OFFLOAD_PRESET, seq=1024, micro=8,
                 gas=OFFLOAD_GAS):
    """Phase 24: phase 20's configuration (``offload_config``: GPT-2 1.3B,
    T=1024, micro 8, gas 8, bf16, AdamW, clip 1.0, stage 3, the optimizer
    on the host; the same seeded parameters and token stream) with
    ``offload_param: {"device": "cpu"}``: the model is never whole on the
    card.  Its batches are ``(tokens, ones)`` on ``GatedStreamGPT2`` (the
    same loss).  Hard checks: step 1's loss within 1e-5 relative of phase
    20's in-device step 1; steps 2-3 within OFFLOAD_UPDATE_SHARE of phase
    20's lr-0 gap; step 1 overlapped (two layer buffers, uploads and
    landings on copy streams, the land-add thread) equal to step 1 run
    again eager-sequentially from the same state (each copy on the
    compute stream and waited for) bit for bit, in the loss, the host
    gradients and the master; a forced grad_nan step leaves the master,
    the moments and the payload bit-unchanged; two device layer buffers,
    the card holding them and the nonblock params only; exact flash
    launches (384 / 192 / 192 a step: each block's forward twice a
    micro-batch, the second under autograd).  Readings: step p50 / p99
    over STREAM_TIMED steps after the warm-up, tokens/s, MFU,
    ``last_times``' split with the h2d and d2h bytes and GB/s, the idle
    share (a profiled step), the device peak beside phase 20's, the host
    RSS.  Raises before the build when MemAvailable is short of the
    phase's need."""
    t_phase = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    head_dim = c.n_embd // c.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    dkdv, dq = fa.dense_bwd_kernel(torch.bfloat16, head_dim)
    per_step = {fwd: 2 * c.n_layer * gas, dkdv: c.n_layer * gas, dq: c.n_layer * gas}
    n = micro * gas * 4
    data = (np.random.default_rng(0).integers(0, c.vocab_size, (n, seq + 1)).astype(np.int32),
            np.ones((n,), np.float32))
    numel = model.num_params()
    need = STREAM_RAM_PER_PARAM * numel
    avail = mem_available()
    print(f"stream {preset}: {numel} params; expected flash launches a step {per_step}; "
          f"host MemAvailable {avail / 1e9:.1f} GB before the build, the phase needs "
          f"~{need / 1e9:.1f} GB ({STREAM_RAM_PER_PARAM} B a parameter), RSS "
          f"{host_rss_bytes() / 1e9:.1f} GB")
    if avail < need:
        raise AssertionError(f"stream: {avail} B of host memory available, the phase needs "
                             f"{need}")
    cfg = offload_config(gas=gas, micro=micro)
    cfg["zero_optimization"]["offload_param"] = {"device": "cpu"}
    rss = RssPeak()
    rss.__enter__()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_alloc = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dev_params = draw_gpt2_params(model, dev, seed=0)
    params = tree_map(lambda t: t.cpu().numpy(), dev_params)
    del dev_params
    torch.cuda.empty_cache()
    eng = stream_engine(dev, params, data, cfg, preset, seq)
    del params
    gc.collect()
    build_s = time.perf_counter() - t0
    ps, off = eng._param_stream, eng._offload
    layer_bytes = ps.per_layer * 2
    state_bytes = torch.cuda.memory_allocated() - base_alloc
    two_layers = (len(ps.wire.bufs) == 2 and all(
        b.numel() == ps.per_layer and b.device == dev for b in ps.wire.bufs))
    held = 2 * layer_bytes + (ps.nb_hi - ps.nb_lo) * 2
    if eng.params is not None or eng.master is not None or not two_layers or \
            not held <= state_bytes < held + (1 << 20):
        raise AssertionError(f"stream: the card holds {state_bytes} B, expected two layer "
                             f"buffers and the nonblock params ({held} B) and the counters")
    master0 = off.master.copy()
    mbs = [next(eng._data_iterator) for _ in range(gas)]

    def timed_step(data_iter=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(eng.train_batch(data_iter))
        torch.cuda.synchronize()
        return loss, time.perf_counter() - t

    # step 1 overlapped, then again eager-sequentially from the same state
    fa.reset_launches()
    loss_a, first_s = timed_step(iter(mbs))
    check_launches("stream step 1", dict(fa.launches), per_step, 1)
    grads_a, master_a = off.grad32.clone(), off.master.copy()
    stream_restart(eng, master0)
    ps.wire.overlap = False
    loss_b, seq_s = timed_step(iter(mbs))
    seq_same = [loss_a == loss_b, torch.equal(off.grad32, grads_a),
                np.array_equal(off.master, master_a)]
    ps.wire.overlap = True
    del grads_a, master_a, master0
    gc.collect()
    ref = graded["ref_losses"]
    rel1 = abs(loss_a - ref[0]) / abs(ref[0])
    # steps 2-4 from the loader (steps 2-3 against phase 20), timed
    fa.reset_launches()
    losses, ms, splits = [loss_a], [], []
    for _ in range(STREAM_TIMED):
        loss, dt = timed_step()
        losses.append(loss)
        ms.append(dt * 1e3)
        splits.append(dict(eng.offload_times))
    check_launches("stream steps 2-4", dict(fa.launches), per_step, STREAM_TIMED)
    peak = torch.cuda.max_memory_allocated() - base_alloc
    # a forced grad_nan step: nothing on the host changes
    before = host_state(eng)
    fault.configure(f"grad_nan={eng._stream_step}")
    try:
        nan_loss, _ = timed_step()
    finally:
        fault.reset()
    nan_same = same_host_state(eng, before)
    skipped = eng.skipped_steps
    nan_skipped = skipped == 1 and bool(eng._last_metrics["skip"])
    del before
    gc.collect()
    summary = {}
    profile_steps(lambda: float(eng.train_batch()), "stream 1.3B", steps=1,
                  unit="training step", summary=summary)
    rss.__exit__(None, None, None)
    ms = np.asarray(ms)
    p50, p99 = np.percentile(ms, 50), np.percentile(ms, 99)
    tokens_per_step = micro * gas * seq
    tok_s = len(ms) * tokens_per_step / (ms.sum() / 1e3)
    mfu = tok_s * model.flops_per_token() / PEAK_OPS["bf16"]
    busy_ms = summary.get("busy_us", float("nan")) / 1e3
    split = {k: statistics.mean(s[k] for s in splits) for k in (
        "device_plus_wire_s", "grad_d2h_land_s", "land_wait_s", "host_adam_s", "step_wall_s",
        "h2d_s", "d2h_s", "h2d_bytes", "d2h_bytes")}
    still = [abs(a - b) for a, b in zip(graded["still_losses"], ref)]
    gaps = [abs(a - b) for a, b in zip(losses[:OFFLOAD_REF_STEPS], ref)]
    limit = [OFFLOAD_UPDATE_SHARE * x for x in still]
    print(f"stream {preset}: losses {losses} vs phase 20's in-device {ref} (step 1 rel "
          f"{rel1:.3e}, |diff| {gaps}, steps 2-3 limit {limit[1:]}); step 1 overlapped vs "
          f"eager-sequential (loss, host grads, master) equal {seq_same} ({first_s:.2f} s vs "
          f"{seq_s:.2f} s); grad_nan step: loss {nan_loss}, skipped {nan_skipped} (skipped steps "
          f"{skipped}), master / "
          f"moments / payload unchanged {nan_same}; two layer buffers {two_layers}, card state "
          f"{state_bytes / 1e9:.3f} GB ({layer_bytes / 1e6:.1f} MB a layer); step p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} (readings {[round(float(x), 3) for x in ms]}), tokens/s "
          f"{tok_s:.1f}, MFU {mfu:.4f}; split a step: device + wire "
          f"{split['device_plus_wire_s']:.3f} s, land-add (worker) "
          f"{split['grad_d2h_land_s']:.3f} s, calling thread's wait for it "
          f"{split['land_wait_s']:.3f} s, host norm + Adam + nonblock upload "
          f"{split['host_adam_s']:.3f} s, wall {split['step_wall_s']:.3f} s; h2d "
          f"{split['h2d_bytes'] / 1e9:.2f} GB in {split['h2d_s']:.3f} s of copies "
          f"({split['h2d_bytes'] / split['h2d_s'] / 1e9:.1f} GB/s), d2h "
          f"{split['d2h_bytes'] / 1e9:.2f} GB in {split['d2h_s']:.3f} s "
          f"({split['d2h_bytes'] / split['d2h_s'] / 1e9:.1f} GB/s); profiled step busy "
          f"{busy_ms:.3f} ms, idle {100 * (1 - busy_ms / p50):.1f}% of the p50; device peak "
          f"{peak / 1e9:.2f} GB (phase 20 sync {graded['sync']['peak_gb']:.2f}, in-device "
          f"{graded['ref_peak_gb']:.2f}); host RSS peak {rss.peak / 1e9:.1f} GB (base "
          f"{rss.base / 1e9:.1f}); build {build_s:.1f} s; phase "
          f"{time.perf_counter() - t_phase:.1f} s ({card})")
    if rel1 > 1e-5:
        raise AssertionError(f"stream step 1 loss {loss_a} vs in-device {ref[0]}")
    if any(g > lim for g, lim in zip(gaps[1:], limit[1:])):
        raise AssertionError(f"stream steps 2-3 {losses} vs in-device {ref} (limit {limit})")
    if not all(seq_same):
        raise AssertionError(f"stream overlapped vs eager-sequential {seq_same}")
    if not (nan_skipped and all(nan_same)):
        raise AssertionError(f"stream grad_nan step: skipped {nan_skipped}, same {nan_same}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"stream losses {losses}")
    ps.close()
    del eng, ps, off
    gc.collect()
    torch.cuda.empty_cache()
    return {"losses": losses, "p50": p50, "p99": p99, "ms": ms.tolist(), "tokens_s": tok_s,
            "mfu": mfu, "split": split, "busy_ms": busy_ms, "peak_gb": peak / 1e9,
            "rss_peak_gb": rss.peak / 1e9, "seq_s": seq_s,
            "seconds": time.perf_counter() - t_phase}


# 25. the NVMe parameter tier at GPT-2 350M
PARAM_NVME_STEPS = 2                     # steps held bit for bit against the CPU tier
PARAM_NVME_TIMED = 3


def param_nvme(dev, card, preset=NVME_PRESET, seq=1024, micro=8):
    """Phase 25: GPT-2 350M, full width and depth, T=1024, micro 8, gas 1,
    bf16, ZeRO-3, the optimizer on the host, ``offload_param`` nvme under
    ``.chip_tmp/nvme`` (phase 23's path): the 16-bit layer payloads in one
    file a layer, read one layer ahead of the loop and written again after
    each step.  Hard checks: from one init, PARAM_NVME_STEPS steps equal
    the CPU parameter tier's bit for bit (losses, master, moments, and
    every layer's payload read back from its file against the CPU tier's
    image); no 16-bit RAM image kept; every swap buffer 4096-aligned;
    exact flash launches (48 / 24 / 24 a step).  Readings: bytes read and
    written a step and their rate, the host's wait for the reads, the
    write-back's seconds, step p50 over PARAM_NVME_TIMED steps, the
    filesystem under the path.  Raises when the disk holds less than twice
    the payload; removes its files."""
    from deepspeed_tpu_torch.runtime.swap_tensor.utils import is_aligned
    t_phase = time.perf_counter()
    model = GPT2(preset=preset, max_seq=seq, device=dev)
    c = model.config
    head_dim = c.n_embd // c.n_head
    fwd = fa.dense_fwd_kernel(torch.bfloat16, head_dim)
    dkdv, dq = fa.dense_bwd_kernel(torch.bfloat16, head_dim)
    per_step = {fwd: 2 * c.n_layer, dkdv: c.n_layer, dq: c.n_layer}
    n = micro * 8
    data = (np.random.default_rng(0).integers(0, c.vocab_size, (n, seq + 1)).astype(np.int32),)
    dev_params = draw_gpt2_params(model, dev, seed=0)
    params = tree_map(lambda t: t.cpu().numpy(), dev_params)
    del dev_params
    torch.cuda.empty_cache()
    numel = sum(a.size for a in tree_leaves(params))
    root = os.path.join(CHIP_TMP, "nvme")
    os.makedirs(root, exist_ok=True)
    free, need = shutil.disk_usage(root).free, 2 * 2 * numel
    fs = fs_of(root)
    print(f"param nvme {preset}: {numel} params, {2 * numel} B of payload; nvme_path {root} "
          f"on {fs[2]} ({fs[0]} at {fs[1]}), {free / 1e9:.1f} GB free (need {need / 1e9:.1f})")
    if free < need:
        raise AssertionError(f"param nvme: {free} B free under {root}, the phase needs {need}")

    def make(tier):
        cfg = offload_config(gas=1, micro=micro)
        cfg["zero_optimization"]["offload_param"] = (
            {"device": "nvme", "nvme_path": root} if tier == "nvme" else {"device": "cpu"})
        return stream_engine(dev, params, data, cfg, preset, seq, cls=GPT2)

    def state(eng):
        m, v = eng._offload.moments()
        return [eng._offload.master.copy(), np.array(m), np.array(v)]
    try:
        cpu = make("cpu")
        cpu_losses = [float(cpu.train_batch()) for _ in range(PARAM_NVME_STEPS)]
        cpu_state, cpu_payload = state(cpu), cpu._offload.payload.clone()
        cpu._param_stream.close()
        del cpu
        gc.collect()
        fa.reset_launches()
        eng = make("nvme")
        ps = eng._param_stream
        no_image = eng._offload.payload is None
        aligned = all(is_aligned(b.data) for b in ps.swapper._pool.buffers)
        losses = [float(eng.train_batch()) for _ in range(PARAM_NVME_STEPS)]
        check_launches("param nvme", dict(fa.launches), per_step, PARAM_NVME_STEPS)
        same = [losses == cpu_losses] + [np.array_equal(a, b)
                                         for a, b in zip(state(eng), cpu_state)]
        files = []
        for i in range(ps.L):
            ps.swapper.swap_in([i])
            lo, hi = ps.layer_bounds[i]
            files.append(torch.equal(ps.swapper.get_buffer(i), cpu_payload[lo:hi]))
            ps.swapper.release([i])
        ms, io = [], []
        for _ in range(PARAM_NVME_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            float(eng.train_batch())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            io.append(dict(eng.offload_times))
        p50 = float(np.percentile(ms, 50))
        rd = statistics.mean(x["nvme_read_bytes"] for x in io)
        wr = statistics.mean(x["nvme_written_bytes"] for x in io)
        wait = statistics.mean(x["nvme_read_wait_s"] for x in io)
        flush = statistics.mean(x["nvme_flush_s"] for x in io)
        print(f"param nvme {preset}: {PARAM_NVME_STEPS} steps vs the CPU parameter tier: losses "
              f"{losses} vs {cpu_losses}; (losses, master, moments) equal {same}; layer files = "
              f"the CPU tier's image {sum(files)}/{len(files)}; no RAM image {no_image}; swap "
              f"buffers 4096-aligned {aligned} ({len(ps.swapper._pool.buffers)}); step p50 "
              f"{p50:.3f} ms (readings {[round(x, 3) for x in ms]}); a step reads {rd / 1e9:.3f} "
              f"GB (the host waited {wait:.3f} s on reads, {rd / p50 * 1e3 / 1e9:.2f} GB/s over "
              f"the step) and writes {wr / 1e9:.3f} GB in {flush:.3f} s "
              f"({wr / flush / 1e9:.2f} GB/s); filesystem {fs[2]}; phase "
              f"{time.perf_counter() - t_phase:.1f} s ({card})")
        if not (all(same) and all(files) and no_image and aligned):
            raise AssertionError(f"param nvme: equal {same}, files {files}, no image "
                                 f"{no_image}, aligned {aligned}")
        ps.close()
        del eng, ps
        gc.collect()
        torch.cuda.empty_cache()
        return {"p50": p50, "read_bytes": rd, "written_bytes": wr, "read_wait_s": wait,
                "flush_s": flush, "fs": fs, "seconds": time.perf_counter() - t_phase}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# 26. the sparse-gradient wire and cpu_checkpointing
SPARSE_V, SPARSE_D, SPARSE_MICRO, SPARSE_IDS, SPARSE_STEPS = 50257, 1024, 32, 8, 5
# the ops that only feed the ckpt mark of marked_block (tests/test_torch_sparse_offload.py)
CKPT_PRUNED = ["aten.mm.default", "aten._unsafe_view.default", "aten.add.Tensor"]


class EmbedBag:
    """An untied embedding table, mean-pooled, and a linear head: a
    lookup-only table (``tests/test_sparse_gradients.py:25-45``)."""

    def __init__(self, device, bound=None):
        self.device = torch.device(device)
        if bound is not None:
            self.sparse_grad_row_bound = lambda batch: bound

    def loss(self, params, batch, rng=None):
        tokens, target = batch
        h = params["emb"]["table"][tokens.long()].mean(dim=1)
        return (((h @ params["head"]["w"])[:, 0] - target.float()) ** 2).mean()

    def sparse_grad_paths(self):
        return [("emb", "table")]


class OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """The ops dispatched, the checkpoint machinery's ``detach``s aside."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is not torch.ops.aten.detach.default:
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def marked_block(model, B, T):
    """A GPT-2 block whose attention output (after the projection) is
    marked ``ckpt``: ``fn(x, *leaves)``, leaves in sorted key order."""
    from deepspeed_tpu_torch.models.gpt2 import _layer_norm
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
    c = model.config
    D, H, hd = c.n_embd, c.n_head, c.head_dim
    keys = sorted(("ln1_scale", "ln1_bias", "qkv_w", "qkv_b", "proj_w", "proj_b", "ln2_scale",
                   "ln2_bias", "fc_w", "fc_b", "fc_proj_w", "fc_proj_b"))

    def fn(x, *leaves):
        p = dict(zip(keys, leaves))
        h = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], c.layer_norm_eps)
        qkv = h @ p["qkv_w"] + p["qkv_b"]
        q, k, v = (t.reshape(B, T, H, hd) for t in qkv.split(D, dim=-1))
        a = model._attend(q, k, v, None, 0, True).reshape(B, T, D)
        x = x + ck.checkpoint_name(a @ p["proj_w"] + p["proj_b"], ck.CKPT)
        h = _layer_norm(x, p["ln2_scale"], p["ln2_bias"], c.layer_norm_eps)
        h = torch.nn.functional.gelu(h @ p["fc_w"] + p["fc_b"], approximate="tanh")
        return x + h @ p["fc_proj_w"] + p["fc_proj_b"]
    return fn, keys


def sparse_and_cpu_ckpt(dev, card, seq=1024, micro=8, preset=SMALL_PRESET):
    """Phase 26.  (a) The sparse-gradient wire: an embedding-bag model
    (V=50257, D=1024, fp32, Adam lr 1e-2, ZeRO-1, the optimizer on the host,
    micro-batches of 32 x 8 ids): SPARSE_STEPS captured steps with
    ``sparse_gradients`` equal them with it off bit for bit (losses, host
    master, moments, device params), the eager run equals the captured one,
    the d2h bytes a step sparse against dense, and an under-declared
    ``sparse_grad_row_bound`` (2) raises at a reporting step.  (b)
    ``cpu_checkpointing`` on a GPT-2 125M block (B=8, T=1024, bf16, flash)
    whose attention output after the projection is marked ``ckpt``: the
    gradients equal the plain checkpoint's bit for bit, the mark is kept
    in pinned host memory, the backward's op count (a dispatch mode) is
    the plain checkpoint's less exactly CKPT_PRUNED (the CPU test's
    count), and the flash launches of the forward and of the recompute."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ck
    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(26)
    params = {"emb": {"table": (torch.randn(SPARSE_V, SPARSE_D, generator=g) * 0.1).numpy()},
              "head": {"w": (torch.randn(SPARSE_D, 1, generator=g) * 0.1).numpy()}}
    rng = np.random.default_rng(26)
    n = SPARSE_MICRO * SPARSE_STEPS
    data = (rng.integers(0, SPARSE_V, (n, SPARSE_IDS)).astype(np.int32),
            rng.normal(size=(n,)).astype(np.float32))

    def make(sparse, impl="auto", bound=None, spp=10 ** 6):
        cfg = {"train_micro_batch_size_per_gpu": SPARSE_MICRO, "gradient_accumulation_steps": 1,
               "steps_per_print": spp, "sparse_gradients": sparse,
               "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
               "zero_optimization": {"stage": 1, "offload_optimizer": {"device": "cpu"}}}
        return deepspeed_tpu_torch.initialize(config=cfg, model=EmbedBag(dev, bound),
                                              params=params, training_data=data,
                                              step_impl=impl)[0]

    def run(eng):
        losses, ms = [], []
        for _ in range(SPARSE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses.append(float(eng.train_batch()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        m, v = eng._offload.moments()
        return {"losses": losses, "ms": ms, "master": eng._offload.master.copy(),
                "m": np.array(m), "v": np.array(v),
                "params": [t.cpu() for t in tree_leaves(eng.params)],
                "wire": {str(k): b.numel() * b.element_size()
                         for k, b in eng._sparse_host.items()}}

    def same(a, b):
        return [a["losses"] == b["losses"], np.array_equal(a["master"], b["master"]),
                np.array_equal(a["m"], b["m"]), np.array_equal(a["v"], b["v"]),
                all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))]
    sparse, dense, eager = run(make(True)), run(make(False)), run(make(True, "eager"))
    sparse_dense, captured_eager = same(sparse, dense), same(sparse, eager)
    dense_bytes = SPARSE_V * SPARSE_D * 4 + SPARSE_D * 4
    sparse_bytes = sum(sparse["wire"].values())
    lying = make(True, bound=2, spp=1)
    try:
        lying.train_batch()
        raised = None
    except RuntimeError as e:
        raised = str(e)
    del lying
    print(f"sparse wire V={SPARSE_V} D={SPARSE_D} fp32, micro {SPARSE_MICRO} x {SPARSE_IDS} ids, "
          f"{SPARSE_STEPS} captured steps: sparse = dense (losses, master, m, v, params) "
          f"{sparse_dense}; captured = eager {captured_eager}; d2h a step: sparse "
          f"{sparse_bytes} B ({sparse['wire']}) vs dense {dense_bytes} B "
          f"({dense_bytes / sparse_bytes:.0f}x); step p50 sparse "
          f"{statistics.median(sparse['ms']):.3f} ms vs dense "
          f"{statistics.median(dense['ms']):.3f} ms; an under-declared bound raised: "
          f"{raised is not None and 'under-declared' in raised} ({card})")
    if not (all(sparse_dense) and all(captured_eager)):
        raise AssertionError(f"sparse wire: {sparse_dense}, captured = eager {captured_eager}")
    if raised is None or "under-declared" not in raised:
        raise AssertionError(f"sparse wire: the lying bound gave {raised!r}")
    del sparse, dense, eager
    gc.collect()
    torch.cuda.empty_cache()

    # (b) cpu_checkpointing on a 125M block
    model = GPT2(preset=preset, max_seq=seq, dtype=torch.bfloat16, device=dev,
                 attention_impl="flash")
    fn, keys = marked_block(model, micro, seq)
    gen = torch.Generator(device=dev).manual_seed(26)
    blocks = draw_gpt2_params(model, dev, seed=26)["blocks"]
    leaves = [blocks[k][0].to(torch.bfloat16).clone().requires_grad_() for k in keys]
    x0 = torch.randn(micro, seq, model.config.n_embd, generator=gen, device=dev,
                     dtype=torch.bfloat16)

    def grads(cpu):
        ck.configure(None, checkpoint_in_cpu=cpu)
        try:
            x = x0.clone().requires_grad_()
            fa.reset_launches()
            y = ck.checkpoint(fn, x, *leaves)
            fwd_launches = dict(fa.launches)
            loss = y.float().square().mean()
            fa.reset_launches()
            with OpCount() as count:
                out = torch.autograd.grad(loss, [x, *leaves])
            torch.cuda.synchronize()
            return out, count.ops, fwd_launches, dict(fa.launches)
        finally:
            ck.configure(None)
    g_plain, ops_plain, f_plain, b_plain = grads(False)
    g_cpu, ops_cpu, f_cpu, b_cpu = grads(True)
    st = ck.last_stats
    (mark,) = st["marks"]
    equal = all(torch.equal(a, b) for a, b in zip(g_plain, g_cpu))
    diff = ops_plain - ops_cpu
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    print(f"cpu_checkpointing {preset} block (B={micro}, T={seq}, bf16, flash, the attention "
          f"output marked ckpt): grads equal to the plain checkpoint's {equal}; the mark on the "
          f"host: pinned {mark.is_pinned()}, {tuple(mark.shape)} {mark.dtype}; backward ops: "
          f"plain {sum(ops_plain.values())}, cpu_checkpointing {sum(ops_cpu.values())}, not "
          f"recomputed {dict(diff)} (expected {CKPT_PRUNED}), extra {dict(ops_cpu - ops_plain)};"
          f" pruned {st['pruned']}, skipped {st['skipped']}; flash launches forward plain "
          f"{nz(f_plain)} / cpu {nz(f_cpu)}, backward with its recompute plain {nz(b_plain)} / "
          f"cpu {nz(b_cpu)}; phase {time.perf_counter() - t_phase:.1f} s ({card})")
    if not (equal and mark.is_pinned() and diff == collections.Counter(CKPT_PRUNED)
            and not ops_cpu - ops_plain and st["pruned"] == CKPT_PRUNED):
        raise AssertionError(f"cpu_checkpointing: equal {equal}, pinned {mark.is_pinned()}, "
                             f"diff {dict(diff)}, extra {dict(ops_cpu - ops_plain)}, pruned "
                             f"{st['pruned']}")
    return {"sparse_bytes": sparse_bytes, "dense_bytes": dense_bytes,
            "ckpt_ops": (sum(ops_plain.values()), sum(ops_cpu.values())),
            "seconds": time.perf_counter() - t_phase}


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
    seconds = {}
    last = [t_start]

    def phase_done(name):
        """Print and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        seconds[name] = round(now - last[0], 1)
        last[0] = now
        print(f"phase seconds: {name} {seconds[name]} s (at {now - t_start:.1f} s)")
    card = setup()
    phase_done("1 setup and build")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = check_kernels(dev, gen)
    flash_err = check_flash_kernels(dev, gen)
    check_flash_grad(dev, gen)
    phase_done("2 kernels vs plain")

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
    # the speculative step's window (phase 16) at the same seated state; its q from a
    # generator of its own
    spec_gen = torch.Generator(device=dev).manual_seed(28)
    t16w = timing(srv16, "kv16", "bf16", spec_gen, bw, W=SPEC["k"] + 1)
    t8w = timing(srv8, "kv8", "int8", spec_gen, bw, W=SPEC["k"] + 1)
    print(json.dumps({"paged_timing_spec_window": {
        tag: {k: t[k] for k in ("kernels_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                "shape")} for tag, t in (("kv16", t16w), ("kv8", t8w))}}))
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
        by_name = profile_steps(srv.step, tag)
        paged_device_time(by_name, tag, model.config.n_layer)
        copy_device_time(by_name, tag)
    del srv16, srv8, engine
    torch.cuda.empty_cache()
    phase_done("3-4 serving and paged timing")

    # 5. training at full width; 6. flash kernel timing at its shape
    phase5 = train(dev, card)
    train_launches = phase5["graph"]["counts"]
    tf = flash_timing(dev, gen, bw, card)
    print(json.dumps({"flash_sweep_max_abs_err": flash_err}))
    kernels += [{"name": name, "route": "cuda", "source": flash_source(name),
                 "replaces": REPLACES[name], "launches": train_launches[name],
                 **tf[name]} for name in fa.DENSE_KERNELS]
    torch.cuda.empty_cache()
    phase_done("5-6 training and flash timing")

    # 7. sparse kernels vs plain; 8. BERT-large training; 9. sparse timing
    sparse_err = check_sparse_kernels(dev, gen)
    print(json.dumps({"sparse_sweep_max_abs_err": sparse_err}))
    bert_launches, phase8 = bert_train(dev, card, timed=BERT_TIMED)
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
    phase_done("7-9 sparse kernels, BERT-large, sparse timing")

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
    phase_done("10-12 int8")

    # 13. banded and merged kernels vs plain, flash_attention_with_lse;
    # 14. the causal block-sparse path at the sparse workload, with timing
    band_err = check_band_merge_kernels(dev, gen)
    print(json.dumps({"band_merge_sweep_max_abs_err": band_err}))
    check_flash_lse(dev, gen)
    torch.cuda.empty_cache()
    print(json.dumps({"band_merge_seeds_largest_share": check_band_merge_seeds(dev)}))
    print(json.dumps({"path_seeds_largest_share": check_path_seeds(dev)}))
    band_launches, tb = sparse_workload(dev, gen, card, bw)
    for name in BAND_MERGE + BAND_MERGE_SM90:
        kernels.append({"name": name, "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": band_launches[name],
                        **tb[name]})
    torch.cuda.empty_cache()
    phase_done("13-14 banded, merged, sparse workload")

    # 15. checkpoints: train -> save -> resume -> serve at phase 5's configuration
    print(json.dumps({"checkpoint": checkpoint_resume(dev, card)}))
    torch.cuda.empty_cache()
    phase_done("15 checkpoints")

    # 16. speculative serving: 125M bf16 (kv16, kv8), then 1.3B int8 weights
    print(json.dumps({"spec_int8_launches": spec_serving(dev, card, prompts)}))
    torch.cuda.empty_cache()
    phase_done("16 speculative serving")

    # 17. fp16 training: the fp16 instances vs plain, phase 5's run in fp16, the GPT-2
    # model options, the fp16 instances' timing
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 17 starts with {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    print(json.dumps({"fp16_sweep_max_abs_err": check_fp16_kernels(dev)}))
    fp16_res = fp16_train(dev, card, phase5)
    model_options(dev, card, phase5)
    t16 = fp16_timing(dev, bw, card)
    for name in fa.DENSE_KERNELS:            # the dense sm90 instances, and the templates: 0
        kernels.append({"name": f"{name} {FP16}", "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": fp16_res["graph"]["counts"][name],
                        **t16[name]})
    phase_done("17 fp16 training")

    # 17a+. fp16 on every other flash route vs plain, three seeds; its timings (17d)
    route_err, route_share = check_fp16_routes(dev)
    print(json.dumps({"fp16_route_max_abs_err": route_err,
                      "fp16_route_largest_share": route_share}))
    ts16, _ = sparse_timing(dev, torch.Generator(device=dev).manual_seed(37), bw, card,
                            dtype=torch.float16,
                            cases=("tutorial16+pad", "tutorial16", "dense+pad"))
    tb16 = fp16_band_timing(dev, bw, card)
    torch.cuda.empty_cache()
    phase_done("17a+ fp16 routes")

    # 18. BERT-large in fp16: the tutorial's sparse layout and its dense+padding twin
    bert16, _ = bert_fp16_train(dev, card, phase8)
    for name, case, run in (
            ("flash_fwd_lut_sm90", "tutorial16+pad", "18"),
            ("flash_bwd_dkdv_lut_sm90", "tutorial16+pad", "18"),
            ("flash_bwd_dq_lut_sm90", "tutorial16+pad", "18"),
            ("flash_fwd_lut", "tutorial16+pad", "18"),              # the template design: 0
            ("flash_fwd_lut_ring", "tutorial16", "18"),             # the template design: 0
            ("flash_bwd_dkdv_lut", "tutorial16+pad", "18"),         # the template design: 0
            ("flash_bwd_dq_lut", "tutorial16+pad", "18"),           # the template design: 0
            ("flash_fwd_biased", "dense+pad", "18c"),               # the template design: 0
            ("flash_bwd_dkdv_biased", "dense+pad", "18c"),          # the template design: 0
            ("flash_bwd_dq_biased", "dense+pad", "18c")):           # the template design: 0
        kernels.append({"name": f"{name} {FP16}", "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": bert16[run][name],
                        **ts16[case][name]})
    for name in fa.DENSE_SM90:               # the key-bias fp16 instances (18c's run)
        kernels.append({"name": f"{name} {KEY_BIAS} {FP16}", "route": "cuda",
                        "source": flash_source(name), "replaces": REPLACES[f"{name} {KEY_BIAS}"],
                        "launches": bert16["18c"][name], **ts16["dense+pad"][name]})
    for name in BAND_MERGE_SM90 + BAND_MERGE:   # held by 17a+ only: no phase-18 launch
        kernels.append({"name": f"{name} {FP16}", "route": "cuda", "source": flash_source(name),
                        "replaces": REPLACES[name], "launches": bert16["18"][name],
                        **tb16[f"{name} {FP16}"]})
    torch.cuda.empty_cache()
    phase_done("18 BERT-large fp16")

    # 19. the imperative API, a seqlen curriculum and PLD on phase 5's configuration
    train_loop(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("19 loop, curriculum, PLD")

    # 20. graded config 3: GPT-2 1.3B, ZeRO-3, the optimizer on the host, DPU
    graded = graded_offload(dev, card)
    print(json.dumps({"graded_offload": {
        impl: {k: graded[impl][k] for k in ("p50", "device_ms", "split", "busy_ms", "peak_gb")}
        for impl in ("sync", "dpu")}}))
    torch.cuda.empty_cache()
    phase_done("20 graded config 3")

    # 21. client objects, checkpointing under capture, an fp16 offload overflow (125M)
    small_checks(dev, card)
    phase_done("21 small checks")

    # 22. the health ladder at 125M; 23. the NVMe tier at 350M
    ladder = health_ladder(dev, card)
    print(json.dumps({"health_ladder": {k: ladder[k] for k in (
        "state", "save_s", "rewind_s", "armed_ms", "unarmed_ms")}}))
    phase_done("22 health ladder")
    nvme = nvme_tier(dev, card)
    print(json.dumps({"nvme_tier": {"sync": {k: nvme["sync"][k] for k in (
        "p50", "rows", "busy_ms", "peak_gb")}, "dpu": {k: nvme["dpu"][k] for k in (
            "p50", "rows", "busy_ms", "peak_gb")}, **{k: nvme[k] for k in (
                "split", "bytes", "raw", "fs", "io_setup", "rss_peak_gb")}}}))
    phase_done("23 NVMe tier")

    # 24. GPT-2 1.3B with its layer blocks streamed through the card (offload_param cpu)
    gc.collect()
    torch.cuda.empty_cache()
    stream = param_stream(dev, card, graded)
    print(json.dumps({"param_stream": {k: stream[k] for k in (
        "p50", "p99", "tokens_s", "mfu", "split", "busy_ms", "peak_gb", "rss_peak_gb")}}))
    phase_done("24 parameter streaming")
    # 25. the NVMe parameter tier (350M); 26. the sparse wire and cpu_checkpointing
    pn = param_nvme(dev, card)
    print(json.dumps({"param_nvme": {k: pn[k] for k in (
        "p50", "read_bytes", "written_bytes", "read_wait_s", "flush_s", "fs")}}))
    phase_done("25 NVMe parameter tier")
    sc = sparse_and_cpu_ckpt(dev, card)
    print(json.dumps({"sparse_wire_and_cpu_checkpointing": {k: sc[k] for k in (
        "sparse_bytes", "dense_bytes", "ckpt_ops")}}))
    phase_done("26 sparse wire, cpu_checkpointing")
    print(json.dumps({"phase_seconds": seconds}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
