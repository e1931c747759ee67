#!/usr/bin/env python3
"""Check, time and split ``flash_fwd_banded_sm90`` and ``flash_fwd_merged_sm90``
on one Hopper card.

    python3 examples/band_merge_check.py [--no-check] [--no-timing] [--quick]
                                         [--head-dim 64|128] [--variants "a;b"]

From the repo root, with a CUDA card and nvcc.  Builds
``csrc/flash_attention_fwd_sm90.cu`` (the two schedule instances of
``flash_fwd_sm90``) and the template source ``csrc/flash_attention_band_merge_fwd.cu``,
prints ptxas' registers and spills of every instance (a spill fails) and any
wgmma it serializes, then:

1. ``chip_smoke.py``'s first launches of both kernels under its deadline,
   its phase-13 cases (the routed kernel and
   the template design beside it, O and lse against the plain version, phase 2's
   limits) and its three-seed check at phase 14's shapes;
2. at phase 14's shapes (B=1, H=8, bf16, q/k/v views of one qkv tensor,
   the causal BSLongformer workload at blocks 512 and 64, T 4096, 8192 and
   16384) and at BERT's tutorial shape (merged only: B=8, T=2048, H=16,
   block 16, not causal), at head dim 64 or ``--head-dim``: each kernel
   and the template design in turns, three readings each (median, min,
   max), beside the bound and ``flash_fwd_lut_sm90`` (head dim 64 only,
   the one it is built for) (``--quick``: block 64, T=8192 and the
   tutorial shape only);
3. with ``--variants``: copies of the source, each timed in turns with the
   committed kernels at block 64, T=8192 and the tutorial shape
   (``VARIANTS``; builds under ``.torch_build/band_merge/``), with one part
   taken out, which compute garbage and whose times alone mean anything:
   ``no products`` (neither wgmma), ``no softmax`` (P is S, rounded),
   ``no loads`` (no K/V copy: the ring's barriers alone), ``no stores`` (no
   O store); and ``stages 3`` / ``stages 4``, a deeper K/V ring at head dim
   64 (every schedule of the source).

Writes the log to ``chiprun_out/band_merge_check.txt`` too.  Nothing here
is used by the port.
"""

import argparse
import ctypes
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402  (repo root on the path first)
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    SparseSelfAttention, build_sparsity_config)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402
from flash_fwd_sm90_split import no_products, no_softmax  # noqa: E402
from sparse_dkdv_check import build_variant, patch  # noqa: E402

LIB = fa.ENTRIES["flash_fwd_banded_sm90"][0]
TEMPLATE_LIB = fa.ENTRIES["flash_fwd_banded"][0]
LOG = []

K_LOAD = ("          mbar_expect_tx(&k_full[s], C::kTileBytes);\n#pragma unroll\n"
          "          for (int x = 0; x < kBoxes; ++x)\n"
          "            tma_load(sK + s * C::kTileBytes + x * C::kTileBox, &tk, &k_full[s], "
          "x * kBox, h, k0,\n                     b);\n")
V_LOAD = ("          mbar_expect_tx(&v_full[s], C::kTileBytes);\n#pragma unroll\n"
          "          for (int x = 0; x < kBoxes; ++x)\n"
          "            tma_load(sV + s * C::kTileBytes + x * C::kTileBox, &tv, &v_full[s], "
          "x * kBox, h, k0,\n                     b);\n")
STAGES = "  static constexpr int kStages = 2;"
O_STORE = ("      for (int x = 0; x < kBoxes; ++x) tma_store(&to, myO + x * kBoxBytes, x * kBox, "
           "h, qw, b);\n")


def no_loads(t):
    t = patch(t, K_LOAD, "          mbar_arrive(&k_full[s]);\n")
    return patch(t, V_LOAD, "          mbar_arrive(&v_full[s]);\n")


VARIANTS = {
    "no products": no_products,
    "no softmax": no_softmax,
    "no loads": no_loads,
    "no stores": lambda t: patch(t, O_STORE, "      for (int x = 0; x < 0; ++x) {}\n"),
    "stages 3": lambda t: patch(t, STAGES, STAGES.replace("2;", "D == 64 ? 3 : 2;")),
    "stages 4": lambda t: patch(t, STAGES, STAGES.replace("2;", "D == 64 ? 4 : 2;")),
}


def say(line):
    print(line, flush=True)
    LOG.append(line)


def workload(dev, gen, block, T, B=1, H=8, d=64):
    """q, k, v (views of one qkv tensor) and the band and merged schedules
    of phase 14's layout at ``block`` and ``T``."""
    attn = SparseSelfAttention(cs.workload_config(H, block), max_seq_length=T)
    layout = attn.get_layout(T)
    lut = fa.layout_luts(layout, T, H, True)
    band = fa.band_lut(*fa.banded_structure(layout, True), block, T)
    qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    return q, k, v, layout, band, lut


def tutorial(dev, gen, B=8, T=2048, H=16, d=64):
    layout = np.asarray(build_sparsity_config(cs.SPARSE_SECTION, H).make_layout(T), np.int32)
    lut = fa.layout_luts(layout, T, H, False)
    qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
    return q, k, v, layout, lut


def bound_us(layout, causal, B, T, H, d, bytes_per_s):
    block = T // layout.shape[1]
    pairs = cs.layout_pairs(layout, causal, block) * B * (H // layout.shape[0])
    t_b = (4 * B * T * H * d * 2 + B * H * T * 4) / bytes_per_s * 1e6
    t_o = 4 * d * pairs / cs.PEAK_OPS["bf16"] * 1e6
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def calls(q, k, v, band, merged, lut=None, committed=True):
    """The kernels timed at one shape: {label: fn}."""
    out = {}
    if band is not None:
        out["banded_sm90"] = lambda _: fa.flash_fwd_banded_sm90(q, k, v, band)
        if committed:
            out["banded (template)"] = lambda _: fa.flash_fwd_banded_template(q, k, v, band)
    out["merged_sm90"] = lambda _: fa.flash_fwd_merged_sm90(q, k, v, merged)
    if committed:
        out["merged (template)"] = lambda _: fa.flash_fwd_merged_template(q, k, v, merged)
        if q.shape[-1] in fa.SM90_BWD_HEAD_DIMS[torch.bfloat16]:
            out["flash_fwd_lut_sm90"] = lambda _: fa.flash_fwd_lut_sm90(q, k, v, lut)
    return out


def timing(dev, gen, bytes_per_s, card, shapes, tag="committed", committed=True, d=64):
    for block, T in shapes:
        q, k, v, layout, band, lut = workload(dev, gen, block, T, d=d)
        turns = cs.turns_ms(calls(q, k, v, band, lut.merged, lut, committed=committed), 20)
        b, by = bound_us(layout, True, 1, T, 8, d, bytes_per_s)
        say(f"timing [{tag}] B=1 T={T} H=8 d={d} block {block} causal ({card}): " + "; ".join(
            f"{label} {cs.spread(r)} ({b / (r[0] * 1e3):.3f} of the bound)"
            for label, r in turns.items()) + f"; bound {b:.2f} us ({by})")
        del q, k, v
    q, k, v, layout, lut = tutorial(dev, gen, d=d)
    turns = cs.turns_ms(calls(q, k, v, None, lut.merged, lut, committed=committed), 10)
    b, by = bound_us(layout, False, 8, 2048, 16, d, bytes_per_s)
    say(f"timing [{tag}] tutorial16 B=8 T=2048 H=16 d={d} not causal ({card}): " + "; ".join(
        f"{label} {cs.spread(r)} ({b / (r[0] * 1e3):.3f} of the bound)"
        for label, r in turns.items()) + f"; bound {b:.2f} us ({by})")
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="", help="keys of VARIANTS, separated by semicolons")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--head-dim", type=int, default=64, choices=(64, 128))
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--no-check", action="store_true", help="skip step 1")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("band_merge_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    variants = [(k, build_variant(k, VARIANTS[k], LIB, "band_merge"))
                for k in a.variants.split(";") if k]
    builder.build_all([LIB, TEMPLATE_LIB, "flash_attention_sparse_fwd_sm90"])
    built = []
    for tag, (proc, path) in variants:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed:\n{out}")
        built.append((tag, path))
        if "C7515" in out or "C7512" in out:
            say(f"  variant {tag}: ptxas serializes its wgmmas")
    say(f"build {time.perf_counter() - t0:.2f} s ({LIB}.cu nvcc "
        f"{builder.build_log[LIB]['seconds']:.2f} s)")
    log = builder.build_log[LIB]["ptxas"]
    for kname, regs, smem, spill in cs.ptxas_summary(log):
        say(f"  ptxas {kname[kname.find('fwd_sm90_kernel'):kname.find('EEv')]} {regs} "
            f"registers, {smem} bytes smem, {spill} spill bytes")
        if spill:
            raise AssertionError(f"{LIB}: ptxas spilled in {kname}")
    for line in log.splitlines():
        if any(w in line for w in ("Performance Loss", "warning", "C751")):
            say(f"  ptxas {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(0)
    if not a.no_check:
        cs.check_band_merge_kernels(dev, gen)
        say(f"seeds: largest share of a limit {cs.check_band_merge_seeds(dev)}")
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        quick = [(64, 8192)]
        timing(dev, gen, bw, card, quick if a.quick else [
            (block, T) for block in cs.WORKLOAD_BLOCKS for T in cs.WORKLOAD_T], d=a.head_dim)
        base = builder._loaded[LIB]
        for tag, path in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            timing(dev, gen, bw, card, quick, tag, committed=False, d=a.head_dim)
            builder._loaded[LIB] = base
            timing(dev, gen, bw, card, quick, "committed again", committed=False, d=a.head_dim)
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/band_merge_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
