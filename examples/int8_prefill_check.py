#!/usr/bin/env python3
"""Check and time ``int8_mm_nt_prefill`` (or ``int8_mm_t_prefill``) alone on one
Hopper card.

    python3 examples/int8_prefill_check.py [--variants "a;b"] [--sass] [--quick]
    python3 examples/int8_prefill_check.py --layout t [--tiles 128,136] [--variants "a;b"]

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

With ``--layout t`` the same for ``int8_mm_t_prefill``, the tied head at
prefill ((N, K) weight, N = 50257): a first launch at 1.3B's head, M = 512;
the check at 125M's and 1.3B's head, M in {17, 64, 127, 128, 129, 272, 333,
512}, per-tensor and per-channel scales, and every built token tile forced
at M 17/272/333; then at 1.3B's head and M in {512, 272} the kernel at each
token tile of ``--tiles`` (forced), ``int8_mm_t`` (the earlier design,
through ``int8_matmul_tiled``), cuBLAS over the dequantized weight and the
port's bf16 head call (``torch.mm`` over the vocab-padded weight, fp32 out),
three readings each taken in turns; ``--variants`` from ``VARIANTS_T`` (no
products, no reads or widening, no stores, no loads, 32-bit reads, 4
stages), timed in turns beside the committed kernel.

``--sass`` writes ``cuobjdump -sass`` of the library (and of each variant)
to ``chiprun_out/``.
``--quick`` checks the 1.3B shapes only; ``--no-timing`` stops after the
checks.  Writes the log to
``chiprun_out/int8_prefill_check.txt`` (``int8_t_prefill_check.txt``) too.  Nothing here is used by the
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
from deepspeed_tpu_torch.models.gpt2 import _pad_vocab  # noqa: E402
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


# int8_mm_t_prefill's copies: its own text (the anchors above are int8_mm_nt_prefill's)
T_PRODUCTS = "      t_products<kTM>(acc, a, xb, ks);\n"
T_WIDEN = "      for (int h = 0; h < 4; ++h) a[h] = widen2(qw[h], qw[h], 0x0100u, magic);\n"
T_READ = "*reinterpret_cast<const uint16_t*>(chunk"
T_LOADS = ("        mbar_expect_tx(&filled[s], kQBytes + C::kXBytes);\n"
           "        tma_load_2d(qboxes + s * kQBytes, &tmq, &filled[s], kb * kBK, n0);\n"
           "        tma_load_2d(xboxes + s * C::kXBytes, &tmx, &filled[s], kb * kBK, m0);\n")
T_STORE = "  store_t_tile<OutT, kTM>(acc, tp, m0, c);\n"
T_STAGES = ("  static constexpr int kStages = (200 * 1024) / (kQBytes + kXBytes) < 8\n"
            "                                     ? (200 * 1024) / (kQBytes + kXBytes) : 8;\n")


def t_no_words(t):
    """No q words read or widened: each A register a lane constant."""
    for h, off in enumerate(("", " + 8 * kBK", " + 8", " + 8 * kBK + 8")):
        t = patch(t, f"      qw[{h}] = {T_READ}{off});\n",
                  f"      qw[{h}] = lane * 0x01010101u + {h};\n")
    return patch(t, T_WIDEN, "      for (int h = 0; h < 4; ++h) a[h] = qw[h];\n")


VARIANTS_T = {
    # the ring, reads and widening, no wgmma issued
    "no products": lambda t: patch(t, T_PRODUCTS, ""),
    # products on constant fragments: no q words read or widened
    "no words": t_no_words,
    # the sums kept (a branch the data never takes), no stores
    "no stores": lambda t: patch(t, T_STORE, "  if (acc[0] == 1.25e-38f) " + T_STORE.lstrip()),
    # nothing loaded: the producer arrives on each full barrier
    "no loads": lambda t: patch(t, T_LOADS, "        mbar_arrive(&filled[s]);\n"),
    # each A register from a 32-bit read holding its two bytes, chosen in the permute
    "32-bit reads": lambda t: patch(patch(patch(
        t, "* kBK + 2 * t;\n", "* kBK + 4 * (t >> 1);\n"),
        T_WIDEN, T_WIDEN.replace("0x0100u", "(t & 1) ? 0x0302u : 0x0100u")),
        T_READ, "*reinterpret_cast<const uint32_t*>(chunk", count=4),
    # a ring of 4 stages instead of as many as 200 KB hold (at most 8)
    "stages=4": lambda t: patch(t, T_STAGES, "  static constexpr int kStages = 4;\n"),
}
UNCHECKED_T = ("no products", "no words", "no stores", "no loads")
HEAD = {"125m": (768, 50257), "1.3b": (2048, 50257)}       # (K, N) of wte
T_CHECK_M = (17, 64, 127, 128, 129, 272, 333, 512)


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


class forced_tile:
    """Within the block, ``int8_mm_t_prefill`` takes token tile ``tile``
    (None: its plan's)."""

    def __init__(self, tile):
        self.tile = tile

    def __enter__(self):
        self.saved = im.int8_t_tile
        if self.tile:
            im.int8_t_tile = lambda M: self.tile

    def __exit__(self, *exc):
        im.int8_t_tile = self.saved


def t_call(x, q, scale, od, tiled=False):
    fn = im.int8_matmul_tiled if tiled else im.int8_matmul
    return fn(x, q, scale, w_transposed=True, out_dtype=od)


def t_first_launch(dev, gen):
    K, N = HEAD["1.3b"]
    x = (torch.randn((512, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    q = torch.randint(-128, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
    scale = (torch.rand((N,), generator=gen, device=dev) + 0.5) * 1e-2
    torch.cuda.synchronize()
    im.reset_launches()
    t0 = time.perf_counter()
    out = t_call(x, q, scale, torch.float32)
    ms = cs.wait_first("int8_mm_t_prefill", "head M=512", t0)
    if im.launches["int8_mm_t_prefill"] != 1:
        raise AssertionError(f"not routed to int8_mm_t_prefill: {im.launches}")
    err, share = cs.int8_error(out, im.int8_matmul_reference(x, q, scale, w_transposed=True,
                                                             out_dtype=torch.float32))
    say(f"first launch head M=512: {ms:.1f} ms, max_abs_err {err:.3e} ({share:.2f} of its "
        "limit)")
    if not share <= 1.0:
        raise AssertionError("first launch outside its limit")


def t_check(dev, gen, presets, Ms=T_CHECK_M, tiles=(None,)):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for preset in presets:
        K, N = HEAD[preset]
        q = torch.randint(-128, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
        for tm in tiles:
            for M in Ms:
                x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
                for kind in ("tensor", "channel"):
                    scale = (torch.rand((N if kind == "channel" else 1,), generator=gen,
                                        device=dev) + 0.5) * 1e-2
                    res = []
                    with forced_tile(tm):
                        plan = im.int8_t_prefill_plan(M, N, K, sms)
                        for od in (torch.bfloat16, torch.float32):
                            im.reset_launches()
                            got = t_call(x, q, scale, od)
                            again = t_call(x, q, scale, od)
                            ref = im.int8_matmul_reference(x, q, scale, w_transposed=True,
                                                           out_dtype=od)
                            torch.cuda.synchronize()
                            if im.launches["int8_mm_t_prefill"] != 2:
                                raise AssertionError(f"not routed: {im.launches}")
                            if not torch.equal(got, again):
                                raise AssertionError(f"{preset} M={M} tm={tm}: two calls differ")
                            err, share = cs.int8_error(got, ref)
                            if not share <= 1.0:
                                raise AssertionError(f"{preset} M={M} tm={tm} {kind} {od}: "
                                                     f"{err:.3e} is {share:.2f}x its limit")
                            res.append(f"{str(od)[6:]} {err:.2e} ({share:.2f})")
                    say(f"check head {preset} K={K} N={N} M={M} scale={kind} plan {plan}: "
                        f"{', '.join(res)}; deterministic")


def t_timings(dev, gen, bytes_per_s, tag, tiles, Ms=(512, 272), others=True):
    """Three readings of each call, taken in turns (round r times every call
    once), at 1.3B's head with per-channel scales and fp32 out."""
    K, N = HEAD["1.3b"]
    qs = [torch.randint(-128, 128, (N, K), generator=gen, device=dev, dtype=torch.int8)
          for _ in range(2)]
    scale = (torch.rand((N,), generator=gen, device=dev) + 0.5) * 1e-2
    deq = [(q.float() * scale[:, None]).to(torch.bfloat16) for q in qs]
    od = torch.float32
    rows = {}
    for M in Ms:
        x = (torch.randn((M, K), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        nbytes = M * K * 2 + K * N + M * N * 4 + N * 4
        t_b, t_o = nbytes / bytes_per_s * 1e3, 2 * M * N * K / cs.PEAK_OPS["bf16"] * 1e3
        bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

        def kernel(tm):
            def run(l):
                with forced_tile(tm):
                    return t_call(x, qs[l % 2], scale, od)
            return run

        fns = [(f"tile {tm}" if tm else "planned", kernel(tm)) for tm in tiles]
        if others:
            fns += [("int8_mm_t", lambda l: t_call(x, qs[l % 2], scale, od, tiled=True)),
                    ("cuBLAS over the dequantized", lambda l: torch.matmul(x, deq[l % 2].t())),
                    ("the port's bf16 head", lambda l: torch.mm(
                        x, _pad_vocab(deq[l % 2], 0).t(), out_dtype=torch.float32))]
        r = {name: [] for name, _ in fns}
        for _ in range(3):
            for name, fn in fns:
                r[name].append(cs.time_ms(fn, 20, warmup=2))
        rows[M] = {name: sorted(v) for name, v in r.items()}
        text = "; ".join(f"{name} {v[1] * 1e3:.2f} us [{v[0] * 1e3:.2f}, {v[2] * 1e3:.2f}] "
                         f"({bound / v[1]:.3f} of the bound)"
                         for name, v in rows[M].items())
        say(f"timing {tag} head 1.3b K={K} N={N} M={M} fp32 out, per-channel: bound "
            f"{bound * 1e3:.2f} us ({by}); {text}")
    del qs, deq
    torch.cuda.empty_cache()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="",
                    help="keys of VARIANTS (VARIANTS_T with --layout t), separated by semicolons")
    ap.add_argument("--layout", choices=("nt", "t"), default="nt")
    ap.add_argument("--tiles", default="",
                    help="--layout t: token tiles to time forced, comma-separated (136,256)")
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
    table = VARIANTS_T if a.layout == "t" else VARIANTS
    variants = [(k, build_variant(k, table[k])) for k in a.variants.split(";") if k]
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
    if a.layout == "t":
        return t_main(a, dev, gen, card, built)
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


def t_main(a, dev, gen, card, built):
    t_first_launch(dev, gen)
    t_check(dev, gen, ("1.3b",) if a.quick else ("125m", "1.3b"))
    t_check(dev, gen, ("125m",), Ms=(17, 272, 333), tiles=im.T_PREFILL_TILES)
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        tiles = [None] + [int(v) for v in a.tiles.split(",") if v]
        t_timings(dev, gen, bw, "committed", tiles)
        base = builder._loaded[LIB]
        for tag, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if not any(u in tag for u in UNCHECKED_T):
                t_check(dev, gen, ("1.3b",), Ms=(17, 272, 512))
            t_timings(dev, gen, bw, f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})",
                      [None], others=False)
            builder._loaded[LIB] = base
            t_timings(dev, gen, bw, "committed again", [None], others=False)
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/int8_t_prefill_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
