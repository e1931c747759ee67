#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA Hopper GPU.

    python3 chip_smoke.py        # from the repo root; one CUDA card, nvcc

Drives the port only (``deepspeed_tpu_torch``; nothing of JAX or of the
JAX package ``deepspeed_tpu``):

1. setup: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions, and the build of the CUDA kernels from ``csrc/`` with
   its time and ptxas register/spill summary;
2. kernels vs plain: ``paged_attention_online`` and ``paged_attention_exact``
   against ``paged_attention_reference`` at the serving shape (8 slots,
   12 heads, head dim 64, block 16, 64 blocks per slot), lengths
   0..1020, windows 1 and 4, bf16 / int8+scales / fp32 pools;
3. serving: GPT-2 125M at full width (bf16, random weights from
   ``init_numpy(seed=0)``) answers 16 greedy requests with 16-bit KV, with
   int8 KV, and with the exact kernel; every outcome must be OK, every
   block recycled, and the kernel's launch count equal decode steps x 12;
   one decode step's logits through the kernels are held against the
   ``gather`` path;
4. timing: each kernel, its plain version and a library yardstick
   (``scaled_dot_product_attention`` over pre-gathered K/V, which the port
   never calls) with CUDA events at the phase-3 shape, beside the least
   time the card could take (the bytes the call must move over the
   card's memory rate).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure raises and the
script exits non-zero without that line; with no CUDA device it exits 2.
"""

import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from deepspeed_tpu_torch.inference import (InferenceEngine, OK, Request,
                                           ServingConfig, ServingEngine)
from deepspeed_tpu_torch.inference import paged_kv as pk
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax
from deepspeed_tpu_torch.ops.op_builder import cuda as builder
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.runtime.comm.quantized import quantize_blockwise

L_CYCLE = 12          # layers cycled through when timing (cold L2 per launch)
SOURCE = "deepspeed_tpu_torch/csrc/paged_attention.cu"
REPLACES = {"paged_attention_online":
            "deepspeed_tpu/ops/transformer/paged_attention.py:180",
            "paged_attention_exact":
            "deepspeed_tpu/ops/transformer/paged_attention.py:90"}
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
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    builder.build_all()
    build_s = time.perf_counter() - t0
    log = builder.build_log["paged_attention"]
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/ptxas_paged_attention.txt", "w") as f:
        f.write(log["ptxas"])
    print(f"kernel build: {build_s:.2f} s (nvcc {log['seconds']:.2f} s, "
          f"cached={log['cached']})")
    for row in ptxas_summary(log["ptxas"]):
        print("  ptxas", row)
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


def serve(engine, prompts, new, tag, kv_bits, mode):
    """Phase 3 run: serve ``prompts`` greedily with counts reset just
    before and read just after; checks outcomes, tokens, recycling and
    launches == decode steps x layers.  Returns (engine, launches, tokens)."""
    c = engine.module.config
    c.paged_attention_mode = mode
    cfg = ServingConfig(batch_slots=8, block_size=16, kv_bits=kv_bits,
                        max_new_tokens=new)
    ServingEngine(engine=engine, config=cfg).run(
        [Request(tokens=prompts[0][:40], max_new_tokens=4)])   # warm-up
    srv = ServingEngine(engine=engine, config=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launches()
    t0 = time.perf_counter()
    res = srv.run([Request(tokens=p, uid=i) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(pa.launches)
    st = srv.stats()
    steps = st["decode_steps"]
    want = pa.KERNELS["exact" if mode == "exact" else "online"]
    for name, n in counts.items():
        expect = steps * c.n_layer if name == want else 0
        if n != expect:
            raise AssertionError(f"{tag}: {name} launched {n} times, "
                                 f"expected {expect} ({steps} steps)")
    for uid in range(len(prompts)):
        r = res[uid]
        if r["outcome"] != OK or len(r["tokens"]) != new:
            raise AssertionError(f"{tag}: uid {uid} {r['outcome']} {r['tokens']}")
        if not all(0 <= t < c.vocab_size for t in r["tokens"]):
            raise AssertionError(f"{tag}: uid {uid} token out of range")
    if srv.allocator.free_blocks != srv.num_blocks - 1:
        raise AssertionError(f"{tag}: {srv.allocator.free_blocks} free of "
                             f"{srv.num_blocks - 1}: blocks leaked")
    print(f"serve {tag}: {len(prompts)} requests OK, {steps} decode steps, "
          f"{want} launches {counts[want]} = steps x {c.n_layer}; "
          f"{st['generated_tokens'] / wall:.1f} tokens/s, decode step p50 "
          f"{st['step_ms']['p50']:.3f} ms p99 {st['step_ms']['p99']:.3f} ms, "
          f"TTFT p50 {st['ttft_ms']['p50']:.1f} ms, wall {wall:.2f} s, "
          f"pool {pk.pool_bytes(srv.pool) / 1e6:.1f} MB, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")
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


def time_ms(fn, n):
    """Mean device time of ``fn(layer)`` over ``n`` calls cycling the
    layers (CUDA events around a backlogged stream)."""
    for i in range(L_CYCLE):
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


def profile_decode(srv, tag, steps=6):
    """Where a decode step's time goes: ``steps`` scheduler steps of the
    seated ``srv`` under ``torch.profiler``; prints the wall time per
    step, the device's busy and idle shares, the kernel launches per step
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    srv.step()                                  # steady state first
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"profile {tag}: the profiler saw no device events")
        return
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"profile {tag}: {wall_us / steps:.1f} us per decode step, device busy "
          f"{busy / steps:.1f} us ({100 * busy / wall_us:.1f}%), idle "
          f"{100 * (1 - busy / wall_us):.1f}%, {len(kernels) / steps:.1f} kernel "
          f"launches per step")
    for name, (t, n) in top:
        print(f"  {t / steps:8.1f} us/step {n / steps:6.1f} launches/step  {name[:90]}")


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
    profile_decode(srv16, "kv16")
    profile_decode(srv8, "kv8")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
