#!/usr/bin/env python3
"""Check and time ``flash_fwd_lut_sm90`` alone on one Hopper card.

    python3 examples/sparse_fwd_check.py [--quick] [--no-check] [--no-timing]
                                         [--variants "a;b"]

From the repo root, with a CUDA card and nvcc.  Builds
``csrc/flash_attention_sparse_fwd_sm90.cu`` (and the template source it is
checked and timed beside), prints ptxas' registers, spills and stack frames
(a spill fails) and any wgmma it serializes, then:

1. one first launch (the tutorial layout, T=256, a key bias), its event
   polled under a 10 s deadline, O and lse held against the plain version;
2. every ``chip_smoke.py`` phase-7 case the route sends to the kernel (bf16
   at head dim 64, no score bias: the ``sparse_cases`` and ``dq_cases``
   with a layout): O and lse of the kernel and of the template beside it
   (``flash_fwd_lut_ring`` without a bias, ``flash_fwd_lut`` with one)
   against the plain version with phase 2's limits, the launches counted,
   two calls bit-identical (``--quick``: the first 12); every case runs, and
   the ones past a limit are listed at the end, which then fails;
3. at BERT-large's attention shape (B=8, T=2048, H=16, d=64, bf16, q/k/v
   views of one qkv tensor) for ``tutorial16+pad``, ``tutorial16`` and
   ``fixed64``: the kernel, the template design and SDPA's forward with the
   boolean mask (which the port never calls), median of three readings
   with the spread, beside the operation and byte bounds and the visits per
   head;
4. with ``--variants``: the first check cases and the timing for copies of
   the source changed as ``VARIANTS`` names them, in turns with the
   committed kernel in this call (copies, with
   ``csrc/flash_attention_sm90.cuh`` pasted in, and builds under
   ``.torch_build/sparse_fwd/``).

Writes the log to ``chiprun_out/sparse_fwd_check.txt`` too.  Nothing here is
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
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    FixedSparsityConfig, build_sparsity_config)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402
from sparse_dkdv_check import build_variant, patch  # noqa: E402

NAME = "flash_fwd_lut_sm90"
LIB = fa.ENTRIES[NAME][0]
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


# the kernel's loads: Q per item, K, V and the key bias per visit (lines of the source)
Q_TX = "      mbar_expect_tx(&q_full[qb], kTile);\n"
Q_LOAD = ("          tma_load4(sQ + qb * kTile + x * kBoxBytes + s * U * 128, &tq, &q_full[qb], "
          "x * kBox, h,\n                    r0, b);\n")
VISIT_TX = "        mbar_expect_tx(&full[st], 2 * kTile + (kBias ? kRows * 4 : 0));\n"
VISIT_LOADS = ("            tma_load4(sK + off, &tk, &full[st], x * kBox, h, r0, b);\n"
               "            tma_load4(sV + off, &tv, &full[st], x * kBox, h, r0, b);\n")
KB_LOAD = ("          if (kBias) tma_load2(sKb + (st * 4 + s) * kStatSlot, &tkb, &full[st], r0, "
           "b);\n")
# S = Q K^T (issue_s), then O += P V (issue_dq of the shared header)
PRODUCTS = (
    "    wgmma_ss_n64<E>(s, desc_sw128(tQ + off, 16, 1024), desc_sw128(vK + off, 16, 1024), "
    "kk > 0);\n",
    "      wgmma_rs_n64_tb<E>(dq[x], da[kk], desc_sw128(tK + x * kBoxBytes + kk * 16 * 128,\n"
    "                                                   kBoxBytes, 1024));\n")


def no_loads(t):
    """Every barrier arrived on instead of loaded: nothing is copied."""
    t = patch(patch(t, Q_TX, "      mbar_arrive(&q_full[qb]);\n"), Q_LOAD, "          ;\n")
    t = patch(patch(t, VISIT_TX, "        mbar_arrive(&full[st]);\n"), VISIT_LOADS, "")
    return patch(t, KB_LOAD, "")


def no_products(t):
    for text in PRODUCTS:
        t = patch(t, text, "")
    return t


# the online softmax's two steps beyond dQ's: the rescale of O by alpha, and the row maximum
RESCALE = "    for (int e = 0; e < 32; ++e) o[xb][e] *= alpha[(e >> 1) & 1];\n"
ROW_MAX = "    const float mn = fmaxf(m[r], quad_max(fmaxf(mx[r][0], mx[r][1])));\n"


def no_rescale(t):
    return patch(t, RESCALE, "    for (int e = 0; e < 32; ++e) {}\n")


def no_max(t):
    """The running maximum never moves (the scores' maximum is not taken)."""
    return patch(t, ROW_MAX, "    const float mn = m[r];\n")


# copies of the source, each with one change
VARIANTS = {
    "no loads": no_loads,
    "no products": no_products,
    "no loads, no products": lambda t: no_products(no_loads(t)),
    "always masked": lambda t: patch(t, "        if (vm[0] != 0)\n", "        if (true)\n"),
    "stages=2": lambda t: patch(t, "constexpr int kStages = 4;", "constexpr int kStages = 2;"),
    "stages=5": lambda t: patch(t, "constexpr int kStages = 4;", "constexpr int kStages = 5;"),
    "registers 24/240": lambda t: patch(t, "kProducerRegs = 56, kConsumerRegs = 224;",
                                        "kProducerRegs = 24, kConsumerRegs = 240;"),
    "no rescale": no_rescale,
    "no max": no_max,
    "no rescale, no max": lambda t: no_max(no_rescale(t)),
}
# variants whose outputs are not attention
UNCHECKED = ("no loads", "no products", "no rescale", "no max")


def template(q, k, v, lut, kb):
    """The template design on the same call: the ring without a bias, the biased
    LUT kernel with one."""
    return fa.sparse_fwd(cs.fwd_template(kb), q, k, v, lut, kb)


def first_launch(dev, gen, T=256, H=2):
    lut = fa.layout_luts(build_sparsity_config(cs.SPARSE_SECTION, H).make_layout(T), T, H, False)
    q, k, v, _ = cs.flash_inputs(dev, gen, torch.bfloat16, 1, T, H, 64, "dense")
    kb, _ = cs.bias_inputs("add", gen, 1, T, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o, lse = fa.flash_fwd_lut_sm90(q, k, v, lut, kb)
    ms = cs.wait_first(NAME, "first launch", t0)
    ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    rows = [(label, *cs.flash_close(f"{NAME} first", label, a, r))
            for label, a, r in (("o", o, ro), ("lse", lse, rlse))]
    say(f"first launch {NAME} tutorial16 T={T}: {ms:.1f} ms; {cs.flash_line({NAME: rows})}")


def cases(H):
    """Phase 7's cases the route sends to the kernel, each once."""
    out, seen = [], set()
    for c in cs.sparse_cases(H) + cs.dq_cases(H):
        T, label, cfg, dt, causal, kind, d, view = c
        key = (T, label, causal, kind, view)
        if cfg is None or fa.sparse_fwd_kernel(dt, d, kind == "attn", kind != "none") != NAME \
                or key in seen:
            continue
        seen.add(key)
        out.append(c)
    return out


def check(dev, gen, limit=None, H=4):
    """O and lse of the kernel and of the template at every case; returns
    the cases past a limit (each with its error)."""
    failed = []
    for T, label, cfg, dt, causal, kind, d, view in cases(H)[:limit]:
        lut = fa.layout_luts(cfg.make_layout(T), T, H, causal)
        kb, _ = cs.bias_inputs(kind, gen, 2, T, dev)
        what = f"bf16 d={d} T={T} {label} bias={kind} causal={int(causal)} {view}"
        q, k, v, _ = cs.flash_inputs(dev, gen, dt, 2, T, H, d, view)
        before = fa.launches[NAME]
        a, b = (fa.flash_fwd_lut_sm90(q, k, v, lut, kb) for _ in range(2))
        t = template(q, k, v, lut, kb)
        ro, rlse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
        torch.cuda.synchronize()
        if fa.launches[NAME] != before + 2:
            raise AssertionError(f"{what}: launches {fa.launches[NAME] - before}, expected 2")
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"{what}: two calls differ")
        try:
            res = {name: [(label_, *cs.flash_close(f"{name} {what}", label_, got, ref))
                          for label_, got, ref in (("o", o, ro), ("lse", lse, rlse))]
                   for name, (o, lse) in ((NAME, a), ("template", t))}
        except AssertionError as e:
            failed.append(str(e))
            say(f"check {what}: PAST ITS LIMIT: {e}")
            continue
        say(f"check {what}: {cs.flash_line(res)}; deterministic")
    return failed


def timing(dev, gen, bytes_per_s, card, tag, others=True, B=8, T=2048, H=16, d=64):
    q, k, v, _ = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    keep = torch.arange(T, device=dev)[None, :] < cs.key_lengths(gen, B, T, dev)[:, None]
    kb = torch.where(keep, 0.0, -10000.0).float()
    tutorial = build_sparsity_config(cs.SPARSE_SECTION, H)
    fixed64 = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1, attention="bidirectional")
    lut16 = fa.layout_luts(tutorial.make_layout(T), T, H, False)
    lut64 = fa.layout_luts(fixed64.make_layout(T), T, H, False)
    elem, stat = B * T * H * d * 2, B * H * T * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    saved = dict(fa.launches)
    for case, (lut, bias) in {"tutorial16+pad": (lut16, kb), "tutorial16": (lut16, None),
                              "fixed64": (lut64, None)}.items():
        layout_mask = lut.element_mask(dev)
        pairs = B * int(layout_mask.sum().item()) * (H // layout_mask.shape[0])
        nbytes = 4 * elem + stat + (0 if bias is None else B * T * 4)   # q, k, v in; O, lse out
        bound, by = cs.bound_ms(nbytes, 4 * d * pairs, bytes_per_s)
        fns = [("sm90", lambda _: fa.flash_fwd_lut_sm90(q, k, v, lut, bias))]
        if others:
            fns.append(("template", lambda _: template(q, k, v, lut, bias)))
            mask = layout_mask[None] & keep[:, None, None, :] if bias is not None else \
                layout_mask[None]
            mask = mask.expand(B, H, T, T)
            fns.append(("SDPA", lambda _: sdpa(qh, kh, vh, attn_mask=mask)))
        r = {name: cs.repeat_ms(fn, 20 if name == "sm90" else 5, warmup=2) for name, fn in fns}
        g = lut.groups("q")
        rest = ""
        if others:
            rest = (f"; the template design {cs.spread(r['template'])}; SDPA forward with the "
                    f"mask {cs.spread(r['SDPA'])} ({r['sm90'][0] / r['SDPA'][0]:.3f}x)")
            del mask
        say(f"timing {NAME} {tag} {case} B={B} T={T} H={H} d={d} ({card}): sm90 "
            f"{cs.spread(r['sm90'])}{rest}; bound {bound * 1e3:.2f} us ({by}; "
            f"{bound / r['sm90'][0]:.3f} of it); visits per head {g.visits_per_head.mean():.0f} "
            f"on {g.tiles_per_head.mean():.0f} tiles (template "
            f"{lut.klen.sum() / lut.heads:.0f})")
        torch.cuda.empty_cache()
    fa.launches.update(saved)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="", help="keys of VARIANTS, separated by semicolons")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--no-check", action="store_true", help="skip step 2")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    # a key of VARIANTS, or file:<path> for another source of the same entry
    variants = [(k, build_variant(k, (lambda t, f=k[5:]: open(f).read()) if k.startswith("file:")
                                  else VARIANTS[k], LIB, "sparse_fwd"))
                for k in a.variants.split(";") if k]
    builder.build_all([LIB, "flash_attention_sparse_fwd"])
    built = []
    for tag, (proc, path) in variants:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {tag} failed:\n{out}")
        built.append((tag, path, cs.ptxas_summary(out)))
        if "C7515" in out or "C7512" in out:
            say(f"  variant {tag}: ptxas serializes its wgmmas")
    say(f"build {time.perf_counter() - t0:.2f} s ({LIB}.cu nvcc "
        f"{builder.build_log[LIB]['seconds']:.2f} s)")
    log = builder.build_log[LIB]["ptxas"]
    for row in cs.ptxas_summary(log):
        say(f"  ptxas {row}")
        if row[3]:
            raise AssertionError(f"{LIB}: ptxas spilled: {row}")
    for line in log.splitlines():
        if any(w in line for w in ("stack frame", "Performance Loss", "warning", "C751")):
            say(f"  ptxas {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(0)
    first_launch(dev, gen)
    failed = [] if a.no_check else check(dev, gen, 12 if a.quick else None)
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        timing(dev, gen, bw, card, "committed")
        base = builder._loaded[LIB]
        for tag, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if not any(u in tag for u in UNCHECKED):
                failed += check(dev, gen, 6)
            timing(dev, gen, bw, card,
                   f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})", others=False)
        builder._loaded[LIB] = base
        if built:
            timing(dev, gen, bw, card, "committed again", others=False)
    for line in failed:
        say(f"past its limit: {line}")
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/sparse_fwd_check.txt", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
