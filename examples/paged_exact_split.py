#!/usr/bin/env python3
"""Split a cluster-split paged-attention kernel's time on one Hopper card.

    python3 examples/paged_exact_split.py [--kernel exact|online]   # from the repo root;
                                                                      # one CUDA card, nvcc

Builds variants of the committed kernel of the mode ``--kernel`` names
(``exact``: ``exact_split_kernel``, entry ``paged_attention_exact_sm90``;
``online``: ``online_split_kernel``, entry ``paged_attention_online_sm90``;
both in ``deepspeed_tpu_torch/csrc/paged_attention.cu``), each a copy of the
source with one part of that kernel taken out or changed, and times them in
turns beside the kernel itself and the mode's first design
(``paged_attention_exact`` / ``paged_attention_online``; three readings
each, CUDA events, the layers of a 12-layer pool in turns, so each launch
finds its K/V out of L2, as phase 4 times them) at ``chip_smoke.py`` phase
4's state: 8 slots at lengths 441, 277, 180, 68, 116, 344, 274, 498 (the
prompts phase 3 seats), 12 heads, head dim 64, block 16, 64 blocks a slot,
W = 1, bf16 and int8 pools:

- ``empty``: the kernel returns at once (a launch of the cluster grid);
- ``no loads``: no K/V row is copied (the staging buffer's garbage is used);
- ``no cluster``: every cluster barrier a block barrier, every store into a
  peer's shared memory a store into the block's own (each rank alone);
- ``no loads, no cluster``: both;
- ``ranks <= 4`` / ``ranks <= 2``: the split planned for 256 / 512 rows a
  rank (4 and 2 ranks at S = 1024; the host's plan follows the source);
- ``stage ... KB``: another staging budget (the rows a rank stages at once,
  and so the shared memory a block takes and the blocks an SM holds; the
  host's plan follows the source): 8, 16 and 48 KB for exact, 8 and 32 for
  online;
- online only: ``64 threads`` (a block of two warps), ``7 blocks an
  SM`` (the register cap of the tensor-core W = 1 instances at 7 blocks, 73
  registers, not 8), and ``no rows`` (no copies and no row work: the
  set-up, the merge and the exchange alone), with or without the cluster.

Only the kernel and the ``ranks``, ``stage``, ``threads`` and ``blocks``
variants compute the right values; the others' times alone mean anything.
``--trace`` (online) builds, instead, a copy of the kernel that stamps
``%globaltimer`` at each step of every block and prints when the blocks
entered and ended and how long each step took.  The kernel is first held against the
plain version at the state.  Nothing here is used by the port.  Prints one
line per pool and the card's name and power limit.
"""

import argparse
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
LENGTHS = (441, 277, 180, 68, 116, 344, 274, 498)
KERNEL = {"exact": "__global__ void __launch_bounds__(kSplitThreads) "
                   "exact_split_kernel(Args a, Split sp) {\n",
          "online": "__global__ void __launch_bounds__(kOnlineThreads, online_min_blocks<T, HD, "
                    "kW>())\n    online_split_kernel(Args a, Split sp) {\n"}
# where a rank's copies are issued (each occurrence): exact stages its K rows, then its V rows;
# online each group's (or, on the tensor-core path, each warp's) rows of a piece
LOADS = {"exact": ("  auto stage = [&](P* dst, float* dst_s, const P* pool, const float* scale, "
                   "int s0, int n) {\n", "    if (n >= 0) return;\n", 1),
         "online": ("    auto issue = [&](int k) {\n", "      if (k >= 0) return;\n", 2)}
# the store of a rank's partial O into the inbox of the rank that writes it
INBOX = {"exact": ("    *cluster.map_shared_rank(inbox + rank * per + (i - q * per), q) = o;",
                   "    inbox[rank * per + (i - q * per)] = o;"),
         "online": ("    *cluster.map_shared_rank(inbox + rank * per + (i - q_rank * per), "
                    "q_rank) = o;", "    inbox[rank * per + (i - q_rank * per)] = o;")}


# the staging budget: bytes of K + V rows (and their scales) a rank stages at once
STAGE = {"exact": "constexpr int kStageBytes = 24576;",
         "online": "constexpr int kOnlineStageBytes = 16384;"}


def replace_once(text, old, new, count=1):
    """``text`` with ``old`` (found exactly ``count`` times) replaced."""
    if text.count(old) != count:
        raise RuntimeError(f"{SOURCE.name} no longer holds {count} of {old[:50]!r}: update the "
                           f"variants")
    return text.replace(old, new)


def in_kernel(mode, patch):
    """``patch`` applied to the text of ``mode``'s kernel alone."""
    def apply(text):
        start = text.index(KERNEL[mode])
        end = text.index("\n}\n", start) + 3
        return text[:start] + patch(text[start:end]) + text[end:]
    return apply


def variants(mode):
    def no_loads(t):
        old, stop, count = LOADS[mode]
        return in_kernel(mode, lambda k: replace_once(k, old, old + stop, count))(t)

    def no_cluster(t):
        t = replace_once(
            t, "    if (r < C) *cluster.map_shared_rank(at, r) = v;",
            "    if (r < C) at[(r - static_cast<int>(cluster.block_rank())) * kMaxW] = v;")

        def body(k):
            k = replace_once(k, *INBOX[mode])
            k = replace_once(k, '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n" ::: '
                                '"memory");\n', "")
            k = replace_once(
                k, '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n', "")
            return k.replace("  cluster.sync();", "  __syncthreads();")
        return in_kernel(mode, body)(t)

    def ranks(n):
        return lambda t: replace_once(t, "constexpr int kRankRows = 128;",
                                      f"constexpr int kRankRows = {1024 // n};")

    def stage(kb):
        return lambda t: replace_once(t, STAGE[mode], f"{STAGE[mode].split('=')[0]}= {kb * 1024};")

    def both(*patches):
        def apply(t):
            for patch in patches:
                t = patch(t)
            return t
        return apply

    out = {
        "empty": lambda t: replace_once(t, KERNEL[mode],
                                        KERNEL[mode] + "  if (sp.C > 0) return;\n"),
        "no loads": no_loads,
        "no cluster": no_cluster,
        "no loads, no cluster": both(no_loads, no_cluster),
        "ranks <= 4": ranks(4),
        "ranks <= 2": ranks(2),
        **{f"stage {kb} KB": stage(kb) for kb in ((8, 16, 48) if mode == "exact" else (8, 32))},
    }
    if mode == "online":
        # no row work at all: no copies and no piece of the loop (set-up, merge and exchange)
        no_rows = both(no_loads, in_kernel(mode, lambda k: replace_once(
            k, "    for (int k = 0; k < np; ++k) {", "    for (int k = 0; k < 0 * np; ++k) {", 2)))
        out.update({"64 threads": lambda t: replace_once(t, "constexpr int kOnlineThreads = 128;",
                                                         "constexpr int kOnlineThreads = 64;"),
                    "7 blocks an SM": lambda t: replace_once(t, "constexpr int kOnlineBlocks = 8;",
                                                             "constexpr int kOnlineBlocks = 7;"),
                    "no rows": no_rows,
                    "no rows, no cluster": both(no_rows, no_cluster)})
    return out


# --trace: the online kernel with %globaltimer stamps taken by thread 0 of every block, at
# entry and after each step, into a device array that an extra C entry copies out
TRACE_STEPS = ("entry", "table", "first rows landed", "rows", "merge", "exchange", "end")
TRACE_HEAD = """
__device__ unsigned long long g_trace[1 << 17];
__device__ __forceinline__ unsigned long long trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE(k) if (threadIdx.x == 0) g_trace[trace_at + (k)] = trace_now()
"""
TRACE_ANCHORS = (  # (text in online_split_kernel, the same with a stamp)
    ("  __syncthreads();\n\n  // this rank's rows:",
     "  __syncthreads();\n  TRACE(1);\n\n  // this rank's rows:"),
    ("      __syncwarp();                // and the warp's other lanes' too\n",
     "      __syncwarp();                // and the warp's other lanes' too\n"
     "      if (k == 0) { TRACE(2); }\n"),
    ("      __syncwarp();                  // and the group's other lanes' too\n",
     "      __syncwarp();                  // and the group's other lanes' too\n"
     "      if (k == 0) { TRACE(2); }\n"),
    ("    // 4. the warp's partial", "    TRACE(3);\n    // 4. the warp's partial"),
    ("    // 4. the groups of each warp merged",
     "    TRACE(3);\n    // 4. the groups of each warp merged"),
    ("  // 5. the rank's partial (m, l, O)", "  TRACE(4);\n  // 5. the rank's partial (m, l, O)"),
    ("  cluster.sync();                  // every store into every rank has landed\n",
     "  cluster.sync();                  // every store into every rank has landed\n  TRACE(5);\n"))


def trace_source(text):
    """The source with the stamps in ``online_split_kernel`` and the C entry
    ``paged_trace_read(dst, n)``."""
    text = replace_once(text, "namespace {\n", "namespace {\n" + TRACE_HEAD)

    def body(k):
        k = replace_once(k, KERNEL["online"], KERNEL["online"] + (
            "  const unsigned long long trace_t0 = trace_now();\n"
            "  const int trace_at = ((blockIdx.x * gridDim.y + blockIdx.y) * gridDim.z + "
            "blockIdx.z) * 8;\n  TRACE(0) = trace_t0;\n"))
        k = k.replace("TRACE(0) = trace_t0;", "if (threadIdx.x == 0) g_trace[trace_at] = trace_t0;")
        for anchor, stamped in TRACE_ANCHORS:
            k = replace_once(k, anchor, stamped)
        end = k.rindex("\n}\n")
        return k[:end] + (
            "\n  TRACE(6);\n  if (threadIdx.x == 0) {\n    unsigned int sm;\n"
            '    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
            "    g_trace[trace_at + 7] = sm;\n  }") + k[end:]
    text = in_kernel("online", body)(text)
    return text + ('extern "C" int paged_trace_read(void* dst, int n) {\n'
                   "  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, n * 8));\n}\n")


def build(mode, trace=False):
    """One nvcc per variant, all started together: {name: C entry}; with
    ``trace``, the traced kernel alone: {"trace": (C entry, trace reader)}."""
    out = builder.BUILD_DIR / f"paged_split_{mode}"
    out.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    todo = {"trace": trace_source} if trace else variants(mode)
    for k, (name, patch) in enumerate(todo.items()):
        src = out / f"v{k}.cu"
        src.write_text(patch(text))
        procs[name] = (out / f"v{k}.so", subprocess.Popen(
            [builder.find_nvcc(), *builder.NVCC_FLAGS, "-o", str(out / f"v{k}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    argtypes = pa._entry(pa.KERNELS[mode]).argtypes
    entries = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name!r} variant:\n{log}")
        so = ctypes.CDLL(str(lib))
        fn = getattr(so, pa.KERNELS[mode])
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        entries[name] = fn
        if trace:
            so.paged_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
            entries[name] = (fn, so.paged_trace_read)
    return entries


def trace_report(kind, fn, read, call, n_blocks):
    """Launch the traced kernel 20 times (the layers in turns, a device
    backlog first), read the last launch's stamps and print, in
    microseconds from the first block's entry: when the blocks entered
    (their spread says how many waves) and ended, and each step's median
    and largest duration over the blocks."""
    import numpy as np
    pa._entry = lambda _name: fn
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e7))
    for i in range(20):
        call(i % cs.L_CYCLE)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (n_blocks * 8))()
    rc = read(ctypes.addressof(buf), n_blocks * 8)
    if rc != 0:
        raise RuntimeError(f"paged_trace_read failed with code {rc}")
    st = np.frombuffer(buf, dtype=np.uint64).reshape(n_blocks, 8).astype(np.int64)
    sm = st[:, 7]
    st = (st[:, :7] - st[:, 0].min()) / 1e3
    q = lambda x: f"median {np.median(x):.2f} p90 {np.percentile(x, 90):.2f} max {x.max():.2f}"
    steps = "; ".join(f"{TRACE_STEPS[k]} {q(st[:, k] - st[:, k - 1])}" for k in range(1, 7))
    per_sm = np.bincount(sm, minlength=132)
    print(f"trace {kind} pool, {n_blocks} blocks on {int((per_sm > 0).sum())} SMs (at most "
          f"{per_sm.max()} an SM): entries {q(st[:, 0])}; ends {q(st[:, 6])}; steps: {steps}",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("exact", "online"), default="exact")
    ap.add_argument("--trace", action="store_true",
                    help="online only: a timeline of one launch's blocks instead of the variants")
    args = ap.parse_args()
    mode = args.kernel
    if args.trace and mode != "online":
        ap.error("--trace takes --kernel online")
    if not torch.cuda.is_available():
        print("paged_exact_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = build(mode, args.trace)
    B, H, HD, BS, NB = len(LENGTHS), 12, 64, 16, 64
    lengths = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    real_entry = pa._entry
    template = {"exact": pa.paged_attention_exact_template,
                "online": pa.paged_attention_online_template}[mode]
    for kind in ("bf16", "int8"):
        pool, dt = cs.paged_pool(dev, gen, kind, B, H, HD, BS, NB, layers=cs.L_CYCLE)
        tables = cs.paged_tables(dev, gen, LENGTHS, 1, BS, NB)
        q = torch.randn((B, 1, H, HD), generator=gen, device=dev).to(dt)
        ref = pa.paged_attention_reference(q, pool, tables, lengths, 1)

        def run(fn=None):
            def call(layer):
                pa._entry = real_entry if fn is None else (lambda _name: fn)
                try:
                    return pa.paged_attention(q, pool, tables, lengths, layer, mode=mode)
                finally:
                    pa._entry = real_entry
            return call

        def first(layer):
            return template(q, pool, tables, lengths, layer)

        if args.trace:
            fn, read = entries["trace"]
            err = (run(fn)(1).float() - ref.float()).abs().max().item()
            print(f"trace {kind}: the traced kernel's max abs error {err:.1e}")
            C = pa.online_sm90_plan(NB * BS, HD, pool["k"].element_size(),
                                    pool["k_scale"].shape[-1] if kind == "int8" else 0)[0]
            try:
                trace_report(kind, fn, read, run(fn), B * H * C)
            finally:
                pa._entry = real_entry
            continue
        err = (run()(1).float() - ref.float()).abs().max().item()
        if not err <= cs.TOL[kind]:
            raise AssertionError(f"{pa.KERNELS[mode]} {kind}: error {err} above {cs.TOL[kind]}")
        rows = [f"first design {cs.spread(cs.repeat_ms(first, 200))}",
                f"kernel {cs.spread(cs.repeat_ms(run(), 200))} (max abs error {err:.1e})"]
        for name, fn in entries.items():
            err = (run(fn)(1).float() - ref.float()).abs().max().item()
            rows.append(f"{name} {cs.spread(cs.repeat_ms(run(fn), 200))} (max abs error "
                        f"{err:.1e})")
        rows.append(f"kernel again {cs.spread(cs.repeat_ms(run(), 200))}")
        print(f"split {pa.KERNELS[mode]} {kind} pool, lengths {list(LENGTHS)}, H={H} d={HD} "
              f"W=1: " + "; ".join(rows), flush=True)
    if "paged_attention" in builder.build_log:     # the committed kernel, built here
        rows = [(kname[kname.find(f"{mode}_split_kernel"):], regs, spill) for kname, regs, _, spill
                in cs.ptxas_summary(builder.build_log["paged_attention"]["ptxas"])
                if f"{mode}_split_kernel" in kname]
        print(f"ptxas {mode}_split_kernel: " + "; ".join(
            f"{k[:70]} {regs} registers, {spill} spill bytes" for k, regs, spill in rows))
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
