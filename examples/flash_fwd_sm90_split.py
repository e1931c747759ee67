#!/usr/bin/env python3
"""Split ``flash_fwd_sm90``'s time on one Hopper card.

    python3 examples/flash_fwd_sm90_split.py      # from the repo root; one CUDA card, nvcc

Builds variants of the committed kernel
(``deepspeed_tpu_torch/csrc/flash_attention_fwd_sm90.cu``), each a copy of the
source with one part taken out or changed, and times them in turns beside the
kernel itself (three readings each, CUDA events) at GPT-2 350M's attention
shape (B=8, T=1024, H=16) and at B=1, T=8192, H=16, head dims 64 and 128,
causal, bf16, q/k/v views of one qkv tensor:

- ``no softmax``: P is S, rounded, with no mask, max, exponential or sum;
- ``no products``: neither wgmma runs (S is filled with constants);
- ``loads only``: neither: the TMA ring and its barriers alone;
- ``no exponential``: ``no products`` with each exponential replaced by a
  multiply (what the softmax costs besides the MUFU);
- ``wait back-off``: every failed mbarrier try-wait sleeps 40 ns;
- ``three stages``: a third K/V ring stage at head dim 64.

The variants other than the last two compute garbage; only their times mean
anything.  Nothing here is used by the port.  Prints one line per shape and
the card's name and power limit.
"""

import ctypes
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402

SOURCE = builder.CSRC / "flash_attention_fwd_sm90.cu"
OUT = builder.BUILD_DIR / "sm90_split"
S_PRODUCT = "#pragma unroll\n        for (int kk = 0; kk < D / 16; ++kk) {"
PV_PRODUCT = ("#pragma unroll\n      for (int x = 0; x < kBoxes; ++x)\n#pragma unroll\n"
              "        for (int kk = 0; kk < kBN / 16; ++kk)\n          wgmma_rs_n64_tb")
COMMIT = "      wgmma_commit();"
SOFTMAX = "      // the online softmax in log2 units;"
PACK = "      // P as E A fragments: a 16-column"
EXP = "            const float x = exp2_ftz(fmaf(sc[4 * n + e], scale2, -mn[e >> 1]));"


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE.name} no longer holds one {old[:50]!r}: update the variants")
    return text.replace(old, new)


def cut(text, start, end, new):
    """``text`` with the span from ``start`` up to (not including) the next
    ``end`` replaced by ``new``."""
    i = text.index(start)
    j = text.index(end, i)
    return text[:i] + new + text[j:]


def no_softmax(t):
    return cut(t, SOFTMAX, PACK, "      float alpha[2] = {1.f, 1.f};\n")


def no_products(t):
    t = cut(t, S_PRODUCT, COMMIT, "#pragma unroll\n        for (int e = 0; e < kBN / 2; ++e) "
            "sc[e] = __int_as_float(0x3f800000 + (e << 16) + lane);\n")
    return cut(t, PV_PRODUCT, COMMIT, "#pragma unroll\n      for (int x = 0; x < kBoxes; ++x) "
               "o[x][0] += __uint_as_float(pa[0][0] & 0x3fffffff) * 1e-30f;\n")


VARIANTS = {
    "no softmax": no_softmax,
    "no products": no_products,
    "loads only": lambda t: no_products(no_softmax(t)),
    "no exponential": lambda t: replace_once(
        no_products(t), EXP, "            const float x = fmaf(sc[4 * n + e], scale2, -mn[e >> 1]) * 0.5f;"),
    "wait back-off": lambda t: replace_once(
        t, "  while (!mbar_try(a, parity))\n    if (globaltimer() - t0 > kHangNs) __trap();",
        "  while (!mbar_try(a, parity)) {\n    __nanosleep(40);\n"
        "    if (globaltimer() - t0 > kHangNs) __trap();\n  }"),
    "three stages": lambda t: replace_once(
        t, "  static constexpr int kStages = 2;", "  static constexpr int kStages = D == 64 ? 3 : 2;"),
}


def build():
    """One nvcc per variant, all started together: {name: C entry}."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for k, (name, patch) in enumerate(VARIANTS.items()):
        src = OUT / f"v{k}.cu"
        src.write_text(patch(text))
        procs[name] = (OUT / f"v{k}.so", subprocess.Popen(
            [builder.find_nvcc(), *builder.NVCC_FLAGS, "-o", str(OUT / f"v{k}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{out}")
        fn = ctypes.CDLL(str(lib)).flash_fwd_sm90
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i] + [vp] * 6 + [i] * 4 + [ctypes.c_float, vp, vp]
        entries[name] = fn
    return entries


def launcher(fn, q, k, v):
    B, T, H, d = q.shape
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = fa._strides(q, k, v)

    def call(_):
        rc = fn(1, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                ctypes.addressof(strides), B, T, H, 1, 1 / math.sqrt(d), None,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with code {rc}")
    return call


def main():
    if not torch.cuda.is_available():
        print("flash_fwd_sm90_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = build()
    for B, T, H, d in ((8, 1024, 16, 64), (1, 8192, 16, 64), (8, 1024, 16, 128), (1, 8192, 16, 128)):
        q, k, v, _ = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
        kernel = lambda _: fa.flash_fwd_sm90(q, k, v, True)
        rows = [f"kernel {cs.spread(cs.repeat_ms(kernel, 20))}"]
        rows += [f"{name} {cs.spread(cs.repeat_ms(launcher(fn, q, k, v), 20))}"
                 for name, fn in entries.items()]
        rows.append(f"kernel again {cs.spread(cs.repeat_ms(kernel, 20))}")
        print(f"split B={B} T={T} H={H} d={d} causal bf16: " + "; ".join(rows), flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
