#!/usr/bin/env python3
"""Split ``paged_attention_exact_sm90``'s time on one Hopper card.

    python3 examples/paged_exact_split.py      # from the repo root; one CUDA card, nvcc

Builds variants of the committed kernel (``exact_split_kernel`` in
``deepspeed_tpu_torch/csrc/paged_attention.cu``), each a copy of the source
with one part taken out or changed, and times them in turns beside the kernel
itself and the first design ``paged_attention_exact`` (three readings each,
CUDA events, the layers of a 12-layer pool in turns, so each launch finds
its K/V out of L2, as phase 4 times them) at ``chip_smoke.py``
phase 4's state: 8 slots at lengths 441, 277, 180, 68, 116, 344, 274, 498
(the prompts phase 3 seats), 12 heads, head dim 64, block 16, 64 blocks a
slot, W = 1, bf16 and int8 pools:

- ``empty``: the kernel returns at once (a launch of the cluster grid);
- ``no loads``: no K/V row is copied (the staging buffer's garbage is used);
- ``no cluster``: every cluster barrier a block barrier, every store into a
  peer's shared memory a store into the block's own (each rank alone);
- ``no loads, no cluster``: both;
- ``ranks <= 4`` / ``ranks <= 2``: the split planned for 256 / 512 rows a
  rank (4 and 2 ranks at S = 1024; the host's plan follows the source).

Only the kernel and the ``ranks`` variants compute the right values; the
others' times alone mean anything.  Nothing here is used by the port.
Prints one line per pool and the card's name and power limit.
"""

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa  # noqa: E402

SOURCE = builder.CSRC / "paged_attention.cu"
OUT = builder.BUILD_DIR / "paged_split"
LENGTHS = (441, 277, 180, 68, 116, 344, 274, 498)
KERNEL = "__global__ void __launch_bounds__(kSplitThreads) exact_split_kernel(Args a, Split sp) {\n"
STAGE = ("  auto stage = [&](P* dst, float* dst_s, const P* pool, const float* scale, int s0, "
         "int n) {\n")


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"{SOURCE.name} no longer holds one {old[:50]!r}: update the variants")
    return text.replace(old, new)


def no_loads(t):
    return replace_once(t, STAGE, STAGE + "    if (n >= 0) return;\n")


def no_cluster(t):
    t = replace_once(t, "    if (r < C) *cluster.map_shared_rank(at, r) = v;",
                     "    if (r < C) at[(r - static_cast<int>(cluster.block_rank())) * kMaxW] = v;")
    t = replace_once(t, "    *cluster.map_shared_rank(inbox + rank * per + (i - q * per), q) = o;",
                     "    inbox[rank * per + (i - q * per)] = o;")
    t = replace_once(t, '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: "memory");\n', "")
    t = replace_once(t, '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n', "")
    return t.replace("  cluster.sync();", "  __syncthreads();")


VARIANTS = {
    "empty": lambda t: replace_once(t, KERNEL, KERNEL + "  if (sp.C > 0) return;\n"),
    "no loads": no_loads,
    "no cluster": no_cluster,
    "no loads, no cluster": lambda t: no_cluster(no_loads(t)),
    "ranks <= 4": lambda t: replace_once(t, "constexpr int kRankRows = 128;",
                                         "constexpr int kRankRows = 256;"),
    "ranks <= 2": lambda t: replace_once(t, "constexpr int kRankRows = 128;",
                                         "constexpr int kRankRows = 512;"),
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
    argtypes = pa._entry(pa.KERNELS["exact"]).argtypes
    entries = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{out}")
        fn = ctypes.CDLL(str(lib)).paged_attention_exact_sm90
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
    return entries


def main():
    if not torch.cuda.is_available():
        print("paged_exact_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = build()
    B, H, HD, BS, NB = len(LENGTHS), 12, 64, 16, 64
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    real_entry = pa._entry
    for kind in ("bf16", "int8"):
        pool, dt = cs.paged_pool(dev, gen, kind, B, H, HD, BS, NB, layers=cs.L_CYCLE)
        tables = cs.paged_tables(dev, gen, LENGTHS, 1, BS, NB)
        q = torch.randn((B, 1, H, HD), generator=gen, device=dev).to(dt)
        ref = pa.paged_attention_reference(q, pool, tables, lengths, 1)

        def run(fn=None):
            def call(layer):
                pa._entry = real_entry if fn is None else (lambda _name: fn)
                try:
                    return pa.paged_attention(q, pool, tables, lengths, layer, mode="exact")
                finally:
                    pa._entry = real_entry
            return call

        def first(layer):
            return pa.paged_attention_exact_template(q, pool, tables, lengths, layer)

        rows = [f"first design {cs.spread(cs.repeat_ms(first, 200))}",
                f"kernel {cs.spread(cs.repeat_ms(run(), 200))}"]
        for name, fn in entries.items():
            err = (run(fn)(1).float() - ref.float()).abs().max().item()
            rows.append(f"{name} {cs.spread(cs.repeat_ms(run(fn), 200))} (max abs error "
                        f"{err:.1e})")
        rows.append(f"kernel again {cs.spread(cs.repeat_ms(run(), 200))}")
        print(f"split {kind} pool, lengths {list(LENGTHS)}, H={H} d={HD} W=1: " + "; ".join(rows),
              flush=True)
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
