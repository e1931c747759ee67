#!/usr/bin/env python3
"""Check and time ``flash_bwd_dkdv_sm90`` and ``flash_bwd_dq_sm90`` alone on
one Hopper card.

    python3 examples/dense_bwd_check.py [--quick] [--no-check] [--no-timing]
                                        [--variants "a;b"] [--bias]

From the repo root, with a CUDA card and nvcc.  Both kernels live in
``csrc/flash_attention_sparse_bwd_sm90.cu``.  Builds it (and the template
and forward sources they are checked and timed beside), prints ptxas'
registers, spills and stack frames (a spill or a serialized wgmma fails),
then:

1. the first launches of ``chip_smoke.first_sm90_launch`` (the forward at
   T=64, the backward at T 33, 65 and 200), each under a 10 s deadline;
2. ``chip_smoke.py`` phase 2's bf16 head-dim-64 cases (T 64, 96, 1000,
   1024, 1088, 4096 and here also 65, causal and not, q/k/v views of
   one qkv tensor and contiguous; ``--quick``: T <= 1024) through
   ``check_flash_case``: the routed kernels and the templates against the
   plain versions with phase 2's limits, each launch counted, two calls
   bit-identical;
3. at GPT-2 350M's attention shape (B=8, T=1024, H=16, d=64, bf16, q/k/v
   views, causal and not): each kernel, the templates (the template design)
   and the flash-attention backward op (dQ, dK and dV in one call, which the
   port never calls), median of three readings with the spread, beside the
   operation and byte bounds;
4. with ``--variants``: step 3's causal timing (and, for the variants that
   compute dK, dV and dQ, the first step-2 cases) for copies of the source
   changed as ``VARIANTS`` names them (``pingpong 128``: the 128-row
   ping-pong kernels of ``examples/dense_bwd_pingpong.cuh``), or
   ``file:<path>`` for another
   source of the same entries and arguments, in turns with the committed
   kernels in this call (copies and builds under ``.torch_build/
   sparse_dkdv/``);
5. with ``--bias``: at BERT-large's ``"mode": "dense"`` attention shape
   (B=8, T=2048, H=16, d=64, bf16, q/k/v views, not causal, the padding
   key bias of ``chip_smoke.py`` phase 9) the pair's key-bias instances
   beside its instances without the bias and the biased templates
   ``flash_bwd_dkdv_biased`` / ``flash_bwd_dq_biased``, median of three
   readings with the spread, beside the bounds.

Writes the log to ``chiprun_out/dense_bwd_check.txt`` too.  Nothing here is
used by the port.
"""

import argparse
import ctypes
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402  (repo root on the path first)
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402
from sparse_dkdv_check import build_variant, no_products, patch  # noqa: E402

LIB = fa.ENTRIES["flash_bwd_dkdv_sm90"][0]
NAMES = list(fa.DENSE_BWD_SM90)
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


# the dense kernels' loads: dK/dV's K, V (and key bias) per item, Q, dO, lse, delta per visit;
# dQ's the other way round (lines of the source, each present once); the copies of lse, delta
# and the key bias give way to bare arrivals, which the barriers count
DENSE_TX = (("        mbar_expect_tx(&kv_full[kb], 2 * kTile);\n",
             "        mbar_arrive(&kv_full[kb]);\n"),
            ("          mbar_expect_tx(&full[st], kVisitTx);\n",
             "          mbar_arrive(&full[st]);\n"),
            ("        mbar_expect_tx(&q_full[qb], kItemTx);\n",
             "        mbar_arrive(&q_full[qb]);\n"),
            ("        mbar_expect_tx(&full[st], 2 * kTile);\n",
             "        mbar_arrive(&full[st]);\n"),
            ("        load_stats(sLse + st * kRows, sDelta + st * kRows, p, "
             "static_cast<long long>(bh) * T,\n                   qt * kRows, lane, &full[st]);\n",
             "        cp_async_arrive(&full[st]);\n"),
            ("      load_stats(sLse + qb * kRows, sDelta + qb * kRows, p, "
             "static_cast<long long>(bh) * T,\n                 qt * kRows, lane, &q_full[qb]);\n",
             "      cp_async_arrive(&q_full[qb]);\n"),
            ("      if (kBias) load_kbias(sKb + kb * kRows, p, b, kt * kRows, lane, "
             "&kv_full[kb]);\n",
             "      if (kBias) cp_async_arrive(&kv_full[kb]);\n"),
            ("        if (kBias) load_kbias(sKb + st * kRows, p, b, kt * kRows, lane, "
             "&full[st]);\n",
             "        if (kBias) cp_async_arrive(&full[st]);\n"))
DENSE_LOADS = (
    "          tma_load4(sK + off, &tk, &kv_full[kb], x * kBox, h, kt * kRows, b);\n",
    "          tma_load4(sV + off, &tv, &kv_full[kb], x * kBox, h, kt * kRows, b);\n",
    "            tma_load4(sQ + off, &tq, &full[st], x * kBox, h, qt * kRows, b);\n",
    "            tma_load4(sdO + off, &tdo, &full[st], x * kBox, h, qt * kRows, b);\n",
    "          tma_load4(sQ + off, &tq, &q_full[qb], x * kBox, h, qt * kRows, b);\n",
    "          tma_load4(sdO + off, &tdo, &q_full[qb], x * kBox, h, qt * kRows, b);\n",
    "          tma_load4(sK + off, &tk, &full[st], x * kBox, h, kt * kRows, b);\n",
    "          tma_load4(sV + off, &tv, &full[st], x * kBox, h, kt * kRows, b);\n")
DENSE_MASKED = ("      if ((p.causal && qt == kt) || (ragged && qt == nt - 1))\n",
                "      if ((p.causal && kt == qt) || (ragged && kt == nt - 1))\n")


def no_dense_loads(t):
    """Every barrier of the dense kernels arrived on instead of loaded."""
    for old, new in DENSE_TX:
        t = patch(t, old, new)
    for line in DENSE_LOADS:
        t = patch(t, line, "")
    return t


def always_masked(t):
    for line in DENSE_MASKED:
        t = patch(t, line, "      if (true)\n")
    return t


LAUNCH_DENSE = (
    "  if constexpr (kDq) {\n"
    "    if (kbias != nullptr)\n"
    "      return launch_pipes(dense_dq_kernel<D, true, E>, smem, n_work, stream, mq, mk, mv, mdo, "
    "p);\n"
    "    return launch_pipes(dense_dq_kernel<D, false, E>, smem, n_work, stream, mq, mk, mv, mdo, "
    "p);\n"
    "  } else {\n"
    "    if (kbias != nullptr)\n"
    "      return launch_pipes(dense_dkdv_kernel<D, true, E>, smem, n_work, stream, mq, mk, mv, "
    "mdo,\n                          p);\n"
    "    return launch_pipes(dense_dkdv_kernel<D, false, E>, smem, n_work, stream, mq, mk, mv, "
    "mdo,\n                        p);\n"
    "  }\n")
PINGPONG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dense_bwd_pingpong.cuh")


def pingpong(t):
    """The 128-row ping-pong kernels of ``dense_bwd_pingpong.cuh`` in place
    of the dense ones (no key bias)."""
    anchor = ("// dK/dV (kDq false: out0 dK, out1 dV) or dQ (kDq true: out0 dQ) of a dense call of "
              "element\n")
    t = patch(t, anchor, f'#include "{PINGPONG}"\n\n{anchor}')
    return patch(t, LAUNCH_DENSE, "  return launch_pp<kDq>(mq, mk, mv, mdo, p, stream);\n")


def regs_24_240(t):
    """setmaxnreg: producers 24 registers, consumers 240 (from 56 / 224)."""
    return patch(t, "kProducerRegs = 56, kConsumerRegs = 224;",
                 "kProducerRegs = 24, kConsumerRegs = 240;")


VARIANTS = {
    "pingpong 128": pingpong,
    "pingpong 128, registers 24/240": lambda t: regs_24_240(pingpong(t)),
    "registers 24/240": regs_24_240,
    "stages=3": lambda t: patch(t, "constexpr int kStages = 4;", "constexpr int kStages = 3;"),
    "no loads": no_dense_loads,
    "no products": no_products,
    "no loads, no products": lambda t: no_products(no_dense_loads(t)),
    "always masked": always_masked,
}
UNCHECKED = ("no loads", "no products")   # variants whose outputs are not the gradients


def check(dev, gen, quick, limit=None):
    """Phase 2's bf16 d=64 cases and T=65; returns the cases past a limit."""
    failed, n = [], 0
    Ts = (64, 96, 65, 1000, 1024) + (() if quick else (1088, 4096))
    for T in Ts:
        for causal in (True, False):
            for layout in ("qkv", "dense"):
                n += 1
                if limit is not None and n > limit:
                    return failed
                what = f"bf16 d=64 T={T} causal={int(causal)} {layout}"
                q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, 2, T, 4, 64, layout)
                before = [fa.launches[x] for x in NAMES]
                try:
                    res = cs.check_flash_case(q, k, v, do, causal, what)
                except AssertionError as e:
                    failed.append(str(e))
                    say(f"check {what}: PAST ITS LIMIT: {e}")
                    continue
                o, lse = fa.flash_fwd(q, k, v, causal)
                delta = fa.attention_delta(o, do)
                a = [(fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                      *fa.flash_bwd_dkdv(q, k, v, do, lse, delta, causal)) for _ in range(2)]
                torch.cuda.synchronize()
                got = [fa.launches[x] - b for x, b in zip(NAMES, before)]
                if got != [3, 3]:
                    raise AssertionError(f"{what}: launches {got}, expected 3 each")
                if not all(torch.equal(x, y) for x, y in zip(*a)):
                    raise AssertionError(f"{what}: two calls differ")
                say(f"check {what}: {cs.flash_line(res)}; deterministic")
    return failed


def timing(dev, gen, bytes_per_s, card, tag, others=True, causals=(True, False), B=8, T=1024,
           H=16, d=64):
    q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    for causal in causals:
        o, lse = fa.flash_fwd(q, k, v, causal)
        delta = fa.attention_delta(o, do)
        work = cs.flash_work(B, T, H, d)
        if not causal:               # every pair: twice the causal pairs less the diagonal
            pairs, cp = B * H * T * T, B * H * T * (T + 1) // 2
            work = {n: (b, ops * pairs // cp) for n, (b, ops) in work.items()}
        fns = {"flash_bwd_dkdv_sm90": lambda _: fa.flash_bwd_dkdv_sm90(q, k, v, do, lse, delta,
                                                                        causal),
               "flash_bwd_dq_sm90": lambda _: fa.flash_bwd_dq_sm90(q, k, v, do, lse, delta,
                                                                    causal)}
        if others:
            fns["flash_bwd_dkdv"] = lambda _: fa.flash_bwd_dkdv_template(q, k, v, do, lse, delta,
                                                                          causal)
            fns["flash_bwd_dq"] = lambda _: fa.flash_bwd_dq_template(q, k, v, do, lse, delta,
                                                                      causal)
        r = {name: cs.repeat_ms(fn, 50) for name, fn in fns.items()}
        op = ""
        if others and causal:
            qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
            call, _ = cs.sdpa_backward(qh, kh, vh, doh)
            if call is not None:
                op_r = cs.repeat_ms(lambda _: call(), 50)
                op = f"; the flash-attention backward op {cs.spread(op_r)}"
            del qh, kh, vh, doh
        parts = []
        for name, rr in r.items():
            bound, by = cs.bound_ms(*work[name], bytes_per_s)
            parts.append(f"{name} {cs.spread(rr)} ({bound / rr[0]:.3f} of its {by} bound "
                         f"{bound * 1e3:.2f} us)")
        total = r["flash_bwd_dkdv_sm90"][0] + r["flash_bwd_dq_sm90"][0]
        say(f"timing {tag} B={B} T={T} H={H} d={d} causal={int(causal)} ({card}): "
            + "; ".join(parts) + f"; sm90 dkdv + dq {total * 1e3:.2f} us{op}")
    torch.cuda.empty_cache()


def bias_timing(dev, gen, bytes_per_s, card, B=8, T=2048, H=16, d=64):
    """Step 5: the key-bias instances beside the unbiased ones and the
    biased templates on the same inputs."""
    q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    keep = torch.arange(T, device=dev)[None, :] < cs.key_lengths(gen, B, T, dev)[:, None]
    kb = torch.where(keep, 0.0, -10000.0).float()
    o, lse = fa.flash_fwd_biased(q, k, v, kb, None, False)
    delta = fa.attention_delta(o, do)
    work = cs.flash_work(B, T, H, d)
    pairs, cp = B * H * T * T, B * H * T * (T + 1) // 2       # every pair, not causal
    work = {n: (b + B * T * 4, ops * pairs // cp) for n, (b, ops) in work.items()}
    fns = {"flash_bwd_dkdv_sm90 (key bias)": lambda _: fa.flash_bwd_dkdv_sm90(
               q, k, v, do, lse, delta, False, key_padding_bias=kb),
           "flash_bwd_dkdv_sm90 (no bias)": lambda _: fa.flash_bwd_dkdv_sm90(
               q, k, v, do, lse, delta, False),
           "flash_bwd_dkdv_biased": lambda _: fa.flash_bwd_dkdv_biased_template(
               q, k, v, do, lse, delta, kb, None, False),
           "flash_bwd_dq_sm90 (key bias)": lambda _: fa.flash_bwd_dq_sm90(
               q, k, v, do, lse, delta, False, key_padding_bias=kb),
           "flash_bwd_dq_sm90 (no bias)": lambda _: fa.flash_bwd_dq_sm90(
               q, k, v, do, lse, delta, False),
           "flash_bwd_dq_biased": lambda _: fa.flash_bwd_dq_biased_template(
               q, k, v, do, lse, delta, kb, None, False)}
    parts = []
    for name, fn in fns.items():
        r = cs.repeat_ms(fn, 20)
        bound, by = cs.bound_ms(*work["flash_bwd_dkdv_sm90" if "dkdv" in name
                                      else "flash_bwd_dq_sm90"], bytes_per_s)
        parts.append(f"{name} {cs.spread(r)} ({bound / r[0]:.3f} of its {by} bound "
                     f"{bound * 1e3:.2f} us)")
    say(f"timing key bias B={B} T={T} H={H} d={d} causal=0 qkv, padding bias ({card}): "
        + "; ".join(parts))
    torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="", help="keys of VARIANTS, separated by semicolons")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--no-check", action="store_true", help="skip step 2")
    ap.add_argument("--bias", action="store_true", help="step 5: the key-bias instances")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    variants = [(k, build_variant(k, (lambda t, f=k[5:]: open(f).read()) if k.startswith("file:")
                                  else VARIANTS[k])) for k in a.variants.split(";") if k]
    builder.build_all([LIB, "flash_attention", "flash_attention_fwd_sm90",
                       "flash_attention_sparse_fwd", "flash_attention_sparse_bwd"])
    built = []
    for tag, (proc, path) in variants:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed:\n{out}")
        built.append((tag, path, cs.ptxas_summary(out)))
        for line in out.splitlines():
            if "C7515" in line or "C7512" in line:
                say(f"  variant {tag}: ptxas serializes its wgmmas: {line.strip()[:400]}")
    say(f"build {time.perf_counter() - t0:.2f} s ({LIB}.cu nvcc "
        f"{builder.build_log[LIB]['seconds']:.2f} s)")
    log = builder.build_log[LIB]["ptxas"]
    for row in cs.ptxas_summary(log):
        say(f"  ptxas {row}")
        if row[3]:
            raise AssertionError(f"{LIB}: ptxas spilled: {row}")
    for line in log.splitlines():
        if "stack frame" in line or "Performance Loss" in line or "warning" in line:
            say(f"  ptxas {line.strip()}")
    if "C7515" in log or "C7512" in log:
        raise AssertionError(f"{LIB}: ptxas serialized wgmmas")
    gen = torch.Generator(device=dev).manual_seed(0)
    cs.first_sm90_launch(dev, gen)
    failed = [] if a.no_check else check(dev, gen, a.quick)
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        timing(dev, gen, bw, card, "committed")
        base = builder._loaded[LIB]
        for tag, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if not any(u in tag for u in UNCHECKED):
                failed += check(dev, gen, True, 6)
            timing(dev, gen, bw, card, f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})",
                   others=False, causals=(True,))
        builder._loaded[LIB] = base
        if built:
            timing(dev, gen, bw, card, "committed again", others=False, causals=(True,))
        if a.bias:
            bias_timing(dev, gen, bw, card)
    for line in failed:
        say(f"past its limit: {line}")
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/dense_bwd_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
