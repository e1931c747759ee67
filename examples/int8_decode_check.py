#!/usr/bin/env python3
"""Check and time ``int8_mm_nt_decode`` alone on one Hopper card.

    python3 examples/int8_decode_check.py [--stages 8,12] [--split] [--streams]
                                          [--grids 96,66] [--sass] [--quick]

From the repo root, with a CUDA card and nvcc.  Builds
``csrc/int8_matmul_decode_sm90.cu`` (and ``int8_matmul.cu``, the tiled
design it is timed beside), prints ptxas' registers and spills, then:

1. one first launch at GPT-2 1.3B's qkv (M = 8), its event polled under a
   10 s deadline;
2. the kernel against ``int8_matmul_reference`` at GPT-2 125M's and 1.3B's
   block weight shapes, M in {1, 8, 16}, bf16 and fp32 outputs, with
   ``chip_smoke.py``'s ``int8_error`` limits, and two calls bit-identical;
3. at 1.3B's four block shapes and M in {1, 8, 16}: the kernel, the tiled
   ``int8_mm_nt`` and cuBLAS over the dequantized bf16 weight (which the
   port never calls), each with CUDA events over 12 weights cycled (L2
   holds none of them), median of three readings with the spread, beside
   the byte bound;
4. with ``--stages``: the same check and timing (M = 8) for a copy of the
   source with each ring depth given, taken in turns in this call (copies
   and their builds go to ``.torch_build/int8_decode/``).

``--split`` times, in turns with the kernel at M = 8, copies of the source
with a part taken out (their outputs are garbage; only their times mean
anything): ``empty`` (no box loaded: launch, barrier set-up, exit), ``one
box`` (each block loads and sums its first box only), ``loads only`` (the
ring and its barriers, no widening or products), ``no reduction`` (every
block stores its part of a tile as if whole: no counter, no workspace),
``loads only, no reduction``, ``compute only`` (no box loaded: the consumers
widen and multiply whatever the ring holds), ``compute only, no
reduction``, ``compute alone`` (that, with no barrier waited on either) and
``compute only, polled waits``.  ``--streams`` times the weight stream alone
(loads only, no reduction) with q's map at L2 promotion none or 256 bytes
in place of 128, and with no swizzle.  ``--grids`` times the kernel with its
persistent grid capped at each size given.  ``--sass`` writes ``cuobjdump
-sass`` of the library to ``chiprun_out/``.  ``--quick`` runs 1 and 2 at the
1.3B shapes only.  Writes the log to ``chiprun_out/int8_decode_check.txt``
too.  Nothing here is used by the port.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (repo root on the path first)
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import int8_matmul as im  # noqa: E402

LIB = "int8_matmul_decode_sm90"
SHAPES = {"qkv": (2048, 6144), "proj": (2048, 2048), "fc": (2048, 8192),
          "fc_proj": (8192, 2048)}
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


# text the variants below change; patch() raises if the source no longer holds it
STAGES = "constexpr int kStages = 8;"
LOOP = "for (int i = lo; i < hi; ++i) {"                 # the producer's and consumers' loops
PRODUCER_LOOP = "      for (int i = lo; i < hi; ++i) {\n        mbar_wait(&empty"
COMPUTE = "    for (int ks = 0; ks < kBK / 16; ++ks) {\n      // product 0"
SPLIT = "    if (!split(nt)) {"
HELPER = "  const bool publish_first = first != (hi - 1) / KB && split(first);"
FULL_WAIT = "    if (!ready) mbar_wait(&full[s], ph);\n"
EMPTY_ARRIVE = "    if (lane == 0) mbar_arrive(&empty[s]);\n"
LOADS = ("        mbar_expect_tx(&full[s], kBoxBytes + kXBytes);\n"
         "        tma_load_2d(ring + s * kBoxBytes, &tq, &full[s], nt * kBN, kb * kBK);\n"
         "        tma_load_2d(xring + s * kXBoxBytes, &tx, &full[s], kb * kBK, 0);\n")
Q_MAP_MODES = ("CU_TENSOR_MAP_SWIZZLE_128B,\n          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, "
               "CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||")


def patch(text, old, new, count=1):
    if text.count(old) != count:
        raise RuntimeError(f"{LIB}.cu no longer holds {count} of {old[:50]!r}: update the split")
    return text.replace(old, new)


def no_reduction(t):      # every tile stored as if its block held it whole
    return patch(patch(t, SPLIT, "    if (true) {"), HELPER, "  const bool publish_first = false;")


def no_compute(t):        # no widening and no products
    return patch(t, COMPUTE, COMPUTE.replace("kBK / 16", "0"))


def no_loads(t):          # the producer arrives on each full barrier without loading a box
    return patch(t, LOADS, "        mbar_arrive(&full[s]);\n")


def no_helper(t):
    return patch(t, HELPER, "  const bool publish_first = false;")


SPLITS = {
    "empty": lambda t: no_helper(patch(t, LOOP, "for (int i = lo; i < lo; ++i) {", 2)),
    "one box": lambda t: no_helper(patch(t, LOOP, "for (int i = lo; i < min(hi, lo + 1); ++i) {",
                                         2)),
    "loads only": no_compute,
    "no reduction": no_reduction,
    "loads only, no reduction": lambda t: no_reduction(no_compute(t)),
    "compute only": no_loads,
    "compute only, no reduction": lambda t: no_reduction(no_loads(t)),
    # the consumers alone: no box loaded, no barrier waited on or arrived at
    "compute alone": lambda t: patch(patch(patch(no_reduction(t), FULL_WAIT, ""), EMPTY_ARRIVE,
                                           ""), PRODUCER_LOOP,
                                     PRODUCER_LOOP.replace("i < hi", "i < lo")),
    # compute only, no reduction, with waits that poll (test_wait) and never suspend
    "compute only, polled waits": lambda t: patch(no_reduction(no_loads(t)),
                                                  "mbarrier.try_wait.parity",
                                                  "mbarrier.test_wait.parity"),
}
# the weight stream alone (loads only, no reduction) under other settings of q's map
STREAMS = {
    "stream, promotion none": lambda t: patch(SPLITS["loads only, no reduction"](t),
                                              "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                                              "CU_TENSOR_MAP_L2_PROMOTION_NONE", 2),
    "stream, promotion 256B": lambda t: patch(SPLITS["loads only, no reduction"](t),
                                              "CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                                              "CU_TENSOR_MAP_L2_PROMOTION_L2_256B", 2),
    "stream, no swizzle": lambda t: patch(SPLITS["loads only, no reduction"](t), Q_MAP_MODES,
                                          Q_MAP_MODES.replace("SWIZZLE_128B", "SWIZZLE_NONE")),
}


def build_variant(tag, text_patch):
    """Start nvcc on a copy of the source changed by ``text_patch``; returns
    (process, library path)."""
    src = builder.CSRC / f"{LIB}.cu"
    out_dir = builder.BUILD_DIR / "int8_decode"
    out_dir.mkdir(parents=True, exist_ok=True)
    name = tag.replace(" ", "_").replace(",", "")
    copy = out_dir / f"{name}.cu"
    copy.write_text(text_patch(src.read_text()))
    out = out_dir / f"{name}.so"
    cmd = [builder.find_nvcc(), *builder.NVCC_FLAGS, "-o", str(out), str(copy)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def first_launch(dev, gen):
    K, N = SHAPES["qkv"]
    x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.full((1,), 1e-2, device=dev)
    ev = torch.cuda.Event()
    t0 = time.perf_counter()
    out = im.int8_matmul(x, q, scale)
    ev.record()
    while not ev.query():
        if time.perf_counter() - t0 > 10.0:
            raise AssertionError("int8_mm_nt_decode first launch did not finish in 10 s")
        time.sleep(0.01)
    err, share = cs.int8_error(out, im.int8_matmul_reference(x, q, scale))
    say(f"first launch qkv M=8: {time.perf_counter() - t0:.3f} s, max_abs_err {err:.3e} "
        f"({share:.2f} of its limit)")


def check(dev, gen, presets):
    for preset in presets:
        for wname, (rows, cols) in cs.INT8_SHAPES[preset].items():
            if wname == "wte":
                continue
            q = torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                              dtype=torch.int8)
            for M in (1, 8, 16):
                x = (torch.randn((M, rows), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                scale = (torch.rand((1,), generator=gen, device=dev) + 0.5) * 1e-2
                res = []
                for od in (torch.bfloat16, torch.float32):
                    im.reset_launches()
                    got = im.int8_matmul(x, q, scale, out_dtype=od)
                    again = im.int8_matmul(x, q, scale, out_dtype=od)
                    ref = im.int8_matmul_reference(x, q, scale, out_dtype=od)
                    torch.cuda.synchronize()
                    if im.launches["int8_mm_nt_decode"] != 2:
                        raise AssertionError(f"not routed to the decode kernel: {im.launches}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{preset} {wname} M={M}: two calls differ")
                    err, share = cs.int8_error(got, ref)
                    if not share <= 1.0:
                        raise AssertionError(f"{preset} {wname} M={M} {od}: {err:.3e} is "
                                             f"{share:.2f}x its limit")
                    res.append(f"{str(od)[6:]} {err:.2e} ({share:.2f})")
                say(f"check {preset} {wname} K={rows} N={cols} M={M}: {', '.join(res)}; "
                    "deterministic")


def timings(dev, gen, bytes_per_s, tag, Ms=(1, 8, 16)):
    rows = {}
    for wname, (K, N) in SHAPES.items():
        qs = [torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(cs.L_CYCLE)]
        scale = torch.full((1,), 1e-2, device=dev)
        deq = [(q.float() * scale).to(torch.bfloat16) for q in qs]
        for M in Ms:
            x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            nbytes = M * K * 2 + K * N + M * N * 2 + 4
            bound = nbytes / bytes_per_s * 1e3
            r = {}
            for name, fn in (
                    ("decode", lambda l: im.int8_matmul(x, qs[l], scale)),
                    ("tiled", lambda l: im.int8_matmul_tiled(x, qs[l], scale)),
                    ("cublas", lambda l: torch.matmul(x, deq[l]))):
                r[name] = sorted(cs.time_ms(fn, 200) for _ in range(3))
            rows[(wname, M)] = r
            med = {k: v[1] for k, v in r.items()}
            say(f"timing {tag} {wname} K={K} N={N} M={M}: decode {med['decode'] * 1e3:.2f} us "
                f"[{r['decode'][0] * 1e3:.2f}, {r['decode'][2] * 1e3:.2f}], tiled "
                f"{med['tiled'] * 1e3:.2f}, cuBLAS over the dequantized {med['cublas'] * 1e3:.2f}, "
                f"bound {bound * 1e3:.2f} us ({nbytes / 1e6:.2f} MB; decode at "
                f"{nbytes / med['decode'] / 1e9:.2f} TB/s, {bound / med['decode']:.2f} of the "
                f"bound)")
        del qs, deq
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--stages", default="", help="ring depths to build beside the default")
    ap.add_argument("--grids", default="", help="persistent grid sizes to time beside the plan's")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--streams", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="write cuobjdump -sass of the library to chiprun_out/")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_decode_check: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    # (tag, checked, build): every build starts at once
    variants = [(f"stages={v}", True, build_variant(
        f"stages{v}", lambda t, v=v: patch(t, STAGES, STAGES.replace("8;", f"{v};"))))
        for v in (int(x) for x in a.stages.split(",") if x)]
    if a.split:
        variants += [(f"split {k}", False, build_variant(k, fn))
                     for k, fn in SPLITS.items()]
    if a.streams:
        variants += [(k, False, build_variant(k, fn)) for k, fn in STREAMS.items()]
    builder.build_all([LIB, "int8_matmul"])
    built = []
    for tag, checked, (proc, path) in variants:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed:\n{out}")
        built.append((tag, checked, path, cs.ptxas_summary(out)))
    say(f"build {time.perf_counter() - t0:.2f} s ({LIB}.cu nvcc "
        f"{builder.build_log[LIB]['seconds']:.2f} s)")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (K, N) in SHAPES.items():
        say(f"plan {name}: (tiles, k boxes, blocks) = {im.int8_decode_plan(N, K, sms)}")
    for row in cs.ptxas_summary(builder.build_log[LIB]["ptxas"]):
        say(f"  ptxas {row}")
        if row[3]:
            raise AssertionError(f"{LIB}: ptxas spilled: {row}")
    for line in builder.build_log[LIB]["ptxas"].splitlines():
        if "stack frame" in line:
            say(f"  ptxas {line.strip()}")
    if a.sass:
        os.makedirs("chiprun_out", exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(builder.find_nvcc()), "cuobjdump")
        with open("chiprun_out/int8_decode.sass", "w") as f:
            subprocess.run([cuobjdump, "-sass", str(builder._library_path(LIB))], stdout=f,
                           check=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    first_launch(dev, gen)
    check(dev, gen, ("1.3b",) if a.quick else ("125m", "1.3b"))
    if not a.quick:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        timings(dev, gen, bw, "committed")
        base = builder._loaded[LIB]
        for tag, checked, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if checked:
                check(dev, gen, ("1.3b",))
            timings(dev, gen, bw, f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})",
                    Ms=(8,))
        builder._loaded[LIB] = base
        plan = im.int8_decode_plan
        for grid in (int(x) for x in a.grids.split(",") if x):
            im.int8_decode_plan = lambda N, K, sms, grid=grid: plan(N, K, min(sms, grid))
            timings(dev, gen, bw, f"grid={grid}", Ms=(8,))
        im.int8_decode_plan = plan
        timings(dev, gen, bw, "committed again", Ms=(8,))
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/int8_decode_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
