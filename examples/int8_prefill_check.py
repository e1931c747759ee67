#!/usr/bin/env python3
"""Check and time ``int8_mm_nt_prefill`` alone on one Hopper card.

    python3 examples/int8_prefill_check.py [--variants "a;b"] [--sass] [--quick]

From the repo root, with a CUDA card and nvcc.  Builds
``csrc/int8_matmul_prefill_sm90.cu`` (and ``int8_matmul.cu``, the tiled
design it is timed beside), prints ptxas' registers, spills and any
"Potential Performance Loss" line, then:

1. one first launch at GPT-2 1.3B's qkv (M = 512), its event polled under
   a 10 s deadline;
2. the kernel against ``int8_matmul_reference`` at GPT-2 125M's and 1.3B's
   block weight shapes, M in {17, 64, 272, 333, 512}, bf16 and fp32
   outputs, with ``chip_smoke.py``'s ``int8_error`` limits, the launch
   counted, and two calls bit-identical;
3. at 1.3B's four block shapes and M in {512, 272}: the kernel, the tiled
   ``int8_mm_nt`` (the earlier design, through ``int8_matmul_tiled``) and
   cuBLAS over the dequantized bf16 weight (which the port never calls),
   each with CUDA events over 12 weights cycled (L2 holds none of them),
   median of three readings with the spread, beside the operation and
   byte bounds;
4. with ``--variants``: the check at 1.3B and the timing for copies of the
   source changed as ``VARIANTS`` names them, taken in turns in this call
   (copies and their builds go to ``.torch_build/int8_prefill/``).

``--sass`` writes ``cuobjdump -sass`` of the library (and of each variant)
to ``chiprun_out/``.
``--quick`` checks the 1.3B shapes only; ``--no-timing`` stops after the
checks.  Writes the log to
``chiprun_out/int8_prefill_check.txt`` too.  Nothing here is used by the
port.
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

LIB = "int8_matmul_prefill_sm90"
SHAPES = {"qkv": (2048, 6144), "proj": (2048, 2048), "fc": (2048, 8192),
          "fc_proj": (8192, 2048)}
CHECK_M = (17, 64, 272, 333, 512)
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


def patch(text, old, new, count=1):
    if text.count(old) != count:
        raise RuntimeError(f"{LIB}.cu no longer holds {count} of {old[:50]!r}: update VARIANTS")
    return text.replace(old, new)


STAGES = "constexpr int kStages = 4;"
Q_LOAD = "        tma_load_2d(qring + s * kQBytes, &tq, &full[s], n0, kb * kBK);\n"
X_LOAD = "        tma_load_2d(xring + s * kXBytes, &tx, &full[s], kb * kBK, m0);\n"
LOADS = "        mbar_expect_tx(&full[s], kQBytes + kXBytes);\n" + Q_LOAD + X_LOAD
WIDEN = ("      a[0] = widen2(v[0], v[1], sel_lo, magic);\n"
         "      a[1] = widen2(v[0], v[1], sel_hi, magic);\n"
         "      a[2] = widen2(v[2], v[3], sel_lo, magic);\n"
         "      a[3] = widen2(v[2], v[3], sel_hi, magic);\n")
RAW = "      a[0] = v[0];\n      a[1] = v[1];\n      a[2] = v[2];\n      a[3] = v[3];\n"
WORDS = "        wd[ks][j] = *reinterpret_cast<const uint32_t*>(qbox + woff[j] + 16 * ks * kBN);\n"
BOUNDS = "__launch_bounds__(kThreads, 2)"
# copies of the source, each with one change (their splits follow the committed plan)
VARIANTS = {
    "stages=3": lambda t: patch(t, STAGES, "constexpr int kStages = 3;"),
    "one block an SM": lambda t: patch(t, BOUNDS, "__launch_bounds__(kThreads, 1)"),
    # every split stores its partial as if it held the whole tile (wrong sums; time only)
    "no reduction": lambda t: patch(t, "  if (p.splits == 1) {", "  if (true) {"),
    # the ring and its barriers, the words read and widened, no wgmma issued
    "no products": lambda t: patch(t, "      wgmma_rs_n128(acc, a, db);\n", ""),
    # nothing loaded: the producer arrives on each full barrier, the consumers compute
    "no loads": lambda t: patch(t, LOADS, "        mbar_arrive(&full[s]);\n"),
    # only the weight box loaded (x's box left as it was)
    "no x loads": lambda t: patch(t, LOADS, LOADS.replace("kQBytes + kXBytes", "kQBytes")
                                  .replace(X_LOAD, "")),
    # only the x box loaded
    "no q loads": lambda t: patch(t, LOADS, LOADS.replace("kQBytes + kXBytes", "kXBytes")
                                  .replace(Q_LOAD, "")),
    # the consumers alone, nothing loaded: no words read or widened (the fragments a lane
    # constant), or no products
    "no loads, no words": lambda t: patch(patch(VARIANTS["no loads"](t), WIDEN, RAW), WORDS,
                                          "        wd[ks][j] = lane * 0x01010101u + j;\n"),
    "no loads, no products": lambda t: VARIANTS["no products"](VARIANTS["no loads"](t)),
    # a whole box (four k steps) per commit group, two boxes' fragments alternating
    "box groups": lambda t: main_loop(t, BOX_GROUPS),
    "box groups, one block an SM": lambda t: patch(main_loop(t, BOX_GROUPS), BOUNDS,
                                                   "__launch_bounds__(kThreads, 1)"),
    "box groups, one block an SM, stages=8": lambda t: patch(
        VARIANTS["box groups, one block an SM"](t), STAGES, "constexpr int kStages = 8;"),
    "box groups, one block an SM, no loads": lambda t: patch(
        VARIANTS["box groups, one block an SM"](t), LOADS, "        mbar_arrive(&full[s]);\n"),
}
UNCHECKED = ("no reduction", "no products", "no loads", "no x loads", "no q loads",
             "no words")   # variants whose outputs are not the product
MAIN_LOOP_START = "  uint32_t frag[2][4];  // [k step parity][register]\n"
MAIN_LOOP_END = "  fence_frags(frag[0]);\n  fence_frags(frag[1]);\n"
BOX_GROUPS = """  uint32_t f0[kBK / 16][4], f1[kBK / 16][4];  // a box's fragments, two boxes alternating
  int s = 0, ph = 0;
  // one box: its words widened while the last box's products run, its four products one
  // commit group; the wait leaves this group in flight and frees the last box's stage
  auto box = [&](int kb, uint32_t (&fb)[kBK / 16][4], uint32_t (&fo)[kBK / 16][4]) {
    mbar_wait(&full[s], ph);
    const unsigned char* qbox = qring + s * kQBytes;
    const unsigned char* xbox = xring + s * kXBytes;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = *reinterpret_cast<const uint32_t*>(qbox + woff[j] + 16 * ks * kBN);
      fb[ks][0] = widen2(v[0], v[1], sel_lo, magic);
      fb[ks][1] = widen2(v[0], v[1], sel_hi, magic);
      fb[ks][2] = widen2(v[2], v[3], sel_lo, magic);
      fb[ks][3] = widen2(v[2], v[3], sel_hi, magic);
    }
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) fence_frags(fb[ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      wgmma_rs_n128(acc, fb[ks], desc_sw128(xbox + 32 * ks, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) fence_frags(fo[ks]);
    if (kb != kb0 && lane == 0) mbar_arrive(&empty[s == 0 ? kStages - 1 : s - 1]);
    if (++s == kStages) s = 0, ph ^= 1;
  };
  int kb = kb0;
  for (; kb + 1 < kb1; kb += 2) {
    box(kb, f0, f1);
    box(kb + 1, f1, f0);
  }
  if (kb < kb1) box(kb, f0, f1);
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    fence_frags(f0[ks]);
    fence_frags(f1[ks]);
  }
"""


def main_loop(t, new):
    i, j = t.index(MAIN_LOOP_START), t.index(MAIN_LOOP_END) + len(MAIN_LOOP_END)
    return t[:i] + new + t[j:]


def build_variant(tag, text_patch):
    """Start nvcc on a copy of the source changed by ``text_patch``; returns
    (process, library path)."""
    src = builder.CSRC / f"{LIB}.cu"
    out_dir = builder.BUILD_DIR / "int8_prefill"
    out_dir.mkdir(parents=True, exist_ok=True)
    name = "".join(c if c.isalnum() else "_" for c in tag)
    copy = out_dir / f"{name}.cu"
    copy.write_text(text_patch(src.read_text()))
    out = out_dir / f"{name}.so"
    cmd = [builder.find_nvcc(), *builder.NVCC_FLAGS, "-o", str(out), str(copy)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def first_launch(dev, gen):
    K, N = SHAPES["qkv"]
    x = torch.randn((512, K), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    scale = torch.full((1,), 1e-2, device=dev)
    ev = torch.cuda.Event()
    t0 = time.perf_counter()
    out = im.int8_matmul(x, q, scale)
    ev.record()
    while not ev.query():
        if time.perf_counter() - t0 > 10.0:
            raise AssertionError("int8_mm_nt_prefill first launch did not finish in 10 s")
        time.sleep(0.01)
    err, share = cs.int8_error(out, im.int8_matmul_reference(x, q, scale))
    say(f"first launch qkv M=512: {time.perf_counter() - t0:.3f} s, max_abs_err {err:.3e} "
        f"({share:.2f} of its limit)")
    if not share <= 1.0:
        raise AssertionError("first launch outside its limit")


def check(dev, gen, presets):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for preset in presets:
        for wname, (rows, cols) in cs.INT8_SHAPES[preset].items():
            if wname == "wte":
                continue
            q = torch.randint(-128, 128, (rows, cols), generator=gen, device=dev,
                              dtype=torch.int8)
            for M in CHECK_M:
                x = (torch.randn((M, rows), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                scale = (torch.rand((1,), generator=gen, device=dev) + 0.5) * 1e-2
                res = []
                for od in (torch.bfloat16, torch.float32):
                    im.reset_launches()
                    got = im.int8_matmul(x, q, scale, out_dtype=od)
                    again = im.int8_matmul(x, q, scale, out_dtype=od)
                    ref = im.int8_matmul_reference(x, q, scale, out_dtype=od)
                    torch.cuda.synchronize()
                    if im.launches["int8_mm_nt_prefill"] != 2:
                        raise AssertionError(f"not routed to the prefill kernel: {im.launches}")
                    if not torch.equal(got, again):
                        raise AssertionError(f"{preset} {wname} M={M}: two calls differ")
                    err, share = cs.int8_error(got, ref)
                    if not share <= 1.0:
                        raise AssertionError(f"{preset} {wname} M={M} {od}: {err:.3e} is "
                                             f"{share:.2f}x its limit")
                    res.append(f"{str(od)[6:]} {err:.2e} ({share:.2f})")
                say(f"check {preset} {wname} K={rows} N={cols} M={M} plan "
                    f"{im.int8_prefill_plan(M, cols, rows, sms)}: {', '.join(res)}; "
                    "deterministic")


def timings(dev, gen, bytes_per_s, tag, Ms=(512, 272), others=True):
    rows = {}
    for wname, (K, N) in SHAPES.items():
        qs = [torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(cs.L_CYCLE)]
        scale = torch.full((1,), 1e-2, device=dev)
        deq = [(q.float() * scale).to(torch.bfloat16) for q in qs]
        for M in Ms:
            x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            nbytes = M * K * 2 + K * N + M * N * 2 + 4
            t_b, t_o = nbytes / bytes_per_s * 1e3, 2 * M * N * K / cs.PEAK_OPS["bf16"] * 1e3
            bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
            fns = [("prefill", lambda l: im.int8_matmul(x, qs[l], scale))]
            if others:
                fns += [("tiled", lambda l: im.int8_matmul_tiled(x, qs[l], scale)),
                        ("cublas", lambda l: torch.matmul(x, deq[l]))]
            r = {name: sorted(cs.time_ms(fn, 50) for _ in range(3)) for name, fn in fns}
            rows[(wname, M)] = r
            med = {k: v[1] for k, v in r.items()}
            rest = (f", tiled {med['tiled'] * 1e3:.2f}, cuBLAS over the dequantized "
                    f"{med['cublas'] * 1e3:.2f} ({med['prefill'] / med['cublas']:.2f}x)"
                    if others else "")
            say(f"timing {tag} {wname} K={K} N={N} M={M}: prefill {med['prefill'] * 1e3:.2f} us "
                f"[{r['prefill'][0] * 1e3:.2f}, {r['prefill'][2] * 1e3:.2f}]{rest}, bound "
                f"{bound * 1e3:.2f} us ({by}; {bound / med['prefill']:.2f} of it)")
        del qs, deq
        torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="", help="keys of VARIANTS, separated by semicolons")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--sass", action="store_true",
                    help="write cuobjdump -sass of the library to chiprun_out/")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_prefill_check: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    variants = [(k, build_variant(k, VARIANTS[k])) for k in a.variants.split(";") if k]
    builder.build_all([LIB, "int8_matmul"])
    built = []
    for tag, (proc, path) in variants:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed:\n{out}")
        built.append((tag, path, cs.ptxas_summary(out)))
        for line in out.splitlines():
            if "Performance Loss" in line:
                say(f"  variant {tag}: {line.strip()[:140]}")
    say(f"build {time.perf_counter() - t0:.2f} s ({LIB}.cu nvcc "
        f"{builder.build_log[LIB]['seconds']:.2f} s)")
    for row in cs.ptxas_summary(builder.build_log[LIB]["ptxas"]):
        say(f"  ptxas {row}")
        if row[3]:
            raise AssertionError(f"{LIB}: ptxas spilled: {row}")
    for line in builder.build_log[LIB]["ptxas"].splitlines():
        if "stack frame" in line or "Performance Loss" in line or "warning" in line:
            say(f"  ptxas {line.strip()}")
    if a.sass:
        os.makedirs("chiprun_out", exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(builder.find_nvcc()), "cuobjdump")
        for tag, path in [("committed", builder._library_path(LIB))] + [
                (tag, path) for tag, path, _ in built]:
            name = "".join(c if c.isalnum() else "_" for c in tag)
            with open(f"chiprun_out/int8_prefill_{name}.sass", "w") as f:
                subprocess.run([cuobjdump, "-sass", str(path)], stdout=f, check=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    first_launch(dev, gen)
    check(dev, gen, ("1.3b",) if a.quick else ("125m", "1.3b"))
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        timings(dev, gen, bw, "committed")
        base = builder._loaded[LIB]
        for tag, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if not any(u in tag for u in UNCHECKED):
                check(dev, gen, ("1.3b",))
            timings(dev, gen, bw, f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})",
                    others=False)
        builder._loaded[LIB] = base
        if built:
            timings(dev, gen, bw, "committed again", others=False)
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/int8_prefill_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
