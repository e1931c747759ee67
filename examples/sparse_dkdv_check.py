#!/usr/bin/env python3
"""Check and time ``flash_bwd_dkdv_lut_sm90`` or ``flash_bwd_dq_lut_sm90``
alone on one Hopper card.

    python3 examples/sparse_dkdv_check.py [--side k|q] [--quick] [--no-check]
                                          [--no-timing] [--variants "a;b"]

From the repo root, with a CUDA card and nvcc.  ``--side k`` (the default)
takes the dK/dV kernel, ``--side q`` the dQ kernel; both live in
``csrc/flash_attention_sparse_bwd_sm90.cu``.  Builds it (and the template
sources it is checked and timed beside), prints ptxas' registers, spills
and stack frames (a spill fails), then:

1. one first launch (the tutorial layout, T=256, a key bias), its event
   polled under a 10 s deadline;
2. every ``chip_smoke.py`` phase-7 case the route sends to the kernel (bf16
   at head dim 64, no score bias; for dQ also ``dq_cases``, ``mul`` with
   causal masking), through ``check_masked_case``: the kernel and its
   template (``flash_bwd_dkdv_lut``, ``flash_bwd_dq_lut``) against the plain
   version with phase 2's limits, the launch counted, two calls
   bit-identical (``--quick``: the first 12); every case runs, and the
   ones past a limit are listed at the end, which then fails;
3. at BERT-large's attention shape (B=8, T=2048, H=16, d=64, bf16, q/k/v
   views of one qkv tensor) for ``tutorial16+pad``, ``tutorial16`` and
   ``fixed64``: the kernel, the template design and SDPA's
   masked backward alone (``autograd.grad`` over a retained graph, which
   the port never calls), median of three readings with the spread, beside
   the operation and byte bounds and the visits per head;
4. with ``--variants``: the first check cases and the timing for copies of
   the source changed as ``VARIANTS`` names them (each change made in both
   kernels where it applies to both), in turns with the committed kernel in
   this call (copies, with ``csrc/flash_attention_sm90.cuh`` pasted in, and
   builds under ``.torch_build/sparse_dkdv/``).

Writes the log to ``chiprun_out/sparse_dkdv_check.txt`` (``--side q``:
``sparse_dq_check.txt``) too.  Nothing here is used by the port.
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
from deepspeed_tpu_torch.ops.sparse_attention import (  # noqa: E402
    FixedSparsityConfig, build_sparsity_config)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402

NAMES = {"k": "flash_bwd_dkdv_lut_sm90", "q": "flash_bwd_dq_lut_sm90"}
LIB = fa.ENTRIES[NAMES["k"]][0]
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


def patch(text, old, new, count=1):
    if text.count(old) != count:
        raise RuntimeError(f"the source no longer holds {count} of {old[:50]!r}: update "
                           "VARIANTS")
    return text.replace(old, new)


# the dK/dV kernel's loads: K, V and the key bias per tile, Q, dO, lse and delta per visit

KV_TX = "      mbar_expect_tx(&kv_full[kb], 2 * kTile + (kBias ? kRows * 4 : 0));\n"
KV_LOADS = ("          tma_load4(sK + off, &tk, &kv_full[kb], x * kBox, h, r0, b);\n"
            "          tma_load4(sV + off, &tv, &kv_full[kb], x * kBox, h, r0, b);\n")
KB_LOAD = ("        if (kBias) tma_load2(sKb + (kb * 4 + s) * kStatSlot, &tkb, &kv_full[kb], "
           "r0, b);\n")
VISIT_TX = "        mbar_expect_tx(&full[st], 2 * kTile + 2 * kRows * 4);\n"
VISIT_LOADS = ("            tma_load4(sQ + off, &tq, &full[st], x * kBox, h, r0, b);\n"
               "            tma_load4(sdO + off, &tdo, &full[st], x * kBox, h, r0, b);\n")
STAT_LOADS = (
    "          tma_load3(sLse + (st * 4 + s) * kStatSlot, &tlse, &full[st], r0, h, b);\n"
    "          tma_load3(sDelta + (st * 4 + s) * kStatSlot, &tdelta, &full[st], r0, h, b);\n")
# the dQ kernel's: Q, dO, lse and delta per tile, K, V and the key bias per visit
Q_TX = "      mbar_expect_tx(&q_full[qb], 2 * kTile + 2 * kRows * 4);\n"
Q_LOADS = ("          tma_load4(sQ + off, &tq, &q_full[qb], x * kBox, h, r0, b);\n"
           "          tma_load4(sdO + off, &tdo, &q_full[qb], x * kBox, h, r0, b);\n")
Q_STATS = (
    "        tma_load3(sLse + (qb * 4 + s) * kStatSlot, &tlse, &q_full[qb], r0, h, b);\n"
    "        tma_load3(sDelta + (qb * 4 + s) * kStatSlot, &tdelta, &q_full[qb], r0, h, b);\n")
KV_VISIT_TX = "        mbar_expect_tx(&full[st], 2 * kTile + (kBias ? kRows * 4 : 0));\n"
KV_VISIT_LOADS = ("            tma_load4(sK + off, &tk, &full[st], x * kBox, h, r0, b);\n"
                  "            tma_load4(sV + off, &tv, &full[st], x * kBox, h, r0, b);\n")
KB_VISIT_LOAD = ("          if (kBias) tma_load2(sKb + (st * 4 + s) * kStatSlot, &tkb, &full[st], "
                 "r0, b);\n")
# S and dP (shared by every kernel of the source), then dV and dK (issue_dvdk), then dQ
# (issue_dq)
PRODUCTS = (
    "    wgmma_ss_n64<E>(s, desc_sw128(tS + off, 16, 1024), desc_sw128(vS + off, 16, 1024), "
    "kk > 0);\n",
    "    wgmma_ss_n64<E>(dp, desc_sw128(tP + off, 16, 1024), desc_sw128(vP + off, 16, 1024),\n"
    "                    kk > 0);\n",
    "      wgmma_rs_n64_tb<E>(dv[x], pa[kk], desc_sw128(tdO + x * kBoxBytes + kk * 16 * 128,\n"
    "                                                   kBoxBytes, 1024));\n",
    "      wgmma_rs_n64_tb<E>(dk[x], da[kk], desc_sw128(tQ + x * kBoxBytes + kk * 16 * 128,\n"
    "                                                   kBoxBytes, 1024));\n",
    "      wgmma_rs_n64_tb<E>(dq[x], da[kk], desc_sw128(tK + x * kBoxBytes + kk * 16 * 128,\n"
    "                                                   kBoxBytes, 1024));\n")


def no_tma(t, keep_reads):
    """Every barrier arrived on instead of loaded (nothing copied), in both
    kernels; with ``keep_reads`` the slot ids are still read and waited
    for."""
    use = "          if (r0 < -1) __trap();\n" if keep_reads else ""
    t = patch(patch(t, KV_TX, "      mbar_arrive(&kv_full[kb]);\n"), KV_LOADS, use)
    t = patch(t, KB_LOAD, "")
    t = patch(patch(t, VISIT_TX, "        mbar_arrive(&full[st]);\n"), VISIT_LOADS, use)
    t = patch(t, STAT_LOADS, "")
    t = patch(patch(t, Q_TX, "      mbar_arrive(&q_full[qb]);\n"), Q_LOADS, use)
    t = patch(t, Q_STATS, "")
    t = patch(patch(t, KV_VISIT_TX, "        mbar_arrive(&full[st]);\n"), KV_VISIT_LOADS, use)
    return patch(t, KB_VISIT_LOAD, "")


def no_products(t):
    for text in PRODUCTS:
        t = patch(t, text, "")
    return t


# copies of the source, each with one change
VARIANTS = {
    "stages=2": lambda t: patch(t, "constexpr int kStages = 4;", "constexpr int kStages = 2;"),
    "stages=3": lambda t: patch(t, "constexpr int kStages = 4;", "constexpr int kStages = 3;"),
    # one register split of the two pipes: producers 24, consumers 240
    "registers 24/240": lambda t: patch(t, "kProducerRegs = 56, kConsumerRegs = 224;",
                                        "kProducerRegs = 24, kConsumerRegs = 240;"),
    "no loads": lambda t: no_tma(t, False),
    "no TMA, slot reads kept": lambda t: no_tma(t, True),
    "no products": no_products,
    "no loads, no products": lambda t: no_products(no_tma(t, False)),
}
def no_overlap(t):
    """Each visit's S and dP issued at its top, after the last visit's
    output products have ended, in both kernels."""
    for issue, comment in (
            ("issue_sdp<D, E>(s, dp, tK, tV, sQ + st * kTile, sdO + st * kTile);",
             "S^T and dP^T of this visit are done, and the last visit's dV and dK"),
            ("issue_sdp<D, E>(s, dp, tQ, tdO, sK + st * kTile, sV + st * kTile);",
             "S and dP of this visit are done, and the last visit's dQ")):
        pipelined = (f"      {issue}\n"
                     "      for (int j = 0; j < nv; ++j, ++vt) {\n"
                     f"        // {comment}\n"
                     "        wgmma_wait<0>();\n")
        serial = ("      for (int j = 0; j < nv; ++j, ++vt) {\n"
                  "        if (j > 0) {\n"
                  "          st = vt % kS;\n"
                  "          mbar_wait(&full[st], (vt / kS) & 1);\n"
                  "        }\n"
                  f"        {issue}\n"
                  "        wgmma_wait<0>();\n")
        next_issue = ("        if (j + 1 < nv) {\n"
                      "          st = (vt + 1) % kS;\n"
                      "          mbar_wait(&full[st], ((vt + 1) / kS) & 1);\n"
                      "        }\n"
                      f"        {issue}\n")
        t = patch(patch(t, pipelined, serial), next_issue, "")
    return t


VARIANTS.update({
    # every visit through the masked softmax step
    "always masked": lambda t: patch(t, "        if (vm[0] != 0)\n", "        if (true)\n", 2),
    "no overlap": no_overlap,
})
UNCHECKED = ("no loads", "no TMA", "no products")   # variants whose outputs are not dK/dV


SHARED = "flash_attention_sm90.cuh"   # the helpers the sm90 group sources include


def standalone(text):
    """A source with the shared header pasted in place of its include, so
    a patch sees (and may change) the helpers too."""
    include = f'#include "{SHARED}"\n'
    return text.replace(include, (builder.CSRC / SHARED).read_text() + "\n") if include in text \
        else text


def build_variant(tag, text_patch, lib=LIB, subdir="sparse_dkdv"):
    """Start nvcc on a copy of ``csrc/<lib>.cu`` (the shared header pasted
    in) changed by ``text_patch``; returns (process, library path)."""
    src = builder.CSRC / f"{lib}.cu"
    out_dir = builder.BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    name = "".join(c if c.isalnum() else "_" for c in tag)
    copy = out_dir / f"{name}.cu"
    copy.write_text(text_patch(standalone(src.read_text())))
    out = out_dir / f"{name}.so"
    cmd = [builder.find_nvcc(), *builder.NVCC_FLAGS, "-I", str(builder.CSRC), "-o", str(out),
           str(copy)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def first_launch(dev, gen, side, T=256, H=2):
    name = NAMES[side]
    lut = fa.layout_luts(build_sparsity_config(cs.SPARSE_SECTION, H).make_layout(T), T, H, False)
    q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, 1, T, H, 64, "dense")
    kb, _ = cs.bias_inputs("add", gen, 1, T, dev)
    o, lse = fa.flash_attention_reference_fwd(q, k, v, lut=lut, key_padding_bias=kb)
    delta = fa.attention_delta(o, do)
    kernel = fa.flash_bwd_dkdv_lut_sm90 if side == "k" else fa.flash_bwd_dq_lut_sm90
    ev = torch.cuda.Event()
    t0 = time.perf_counter()
    got = kernel(q, k, v, do, lse, delta, lut, kb)
    ev.record()
    while not ev.query():
        if time.perf_counter() - t0 > 10.0:
            raise AssertionError(f"{name} first launch did not finish in 10 s")
        time.sleep(0.01)
    if side == "k":
        labels = ("dk", "dv")
        want = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, lut=lut,
                                                     key_padding_bias=kb)
    else:
        labels, got = ("dq",), (got,)
        want = (fa.flash_attention_reference_bwd_dq(q, k, v, do, lse, delta, lut=lut,
                                                    key_padding_bias=kb),)
    rows = [(label, *cs.flash_close(f"{name} first", label, a, r))
            for label, a, r in zip(labels, got, want)]
    say(f"first launch {name} tutorial16 T={T}: {time.perf_counter() - t0:.3f} s; "
        f"{cs.flash_line({name: rows})}")


def check(dev, gen, side, limit=None, H=4):
    """Every phase-7 case of the side's kernel; returns the cases past a
    limit (each with its error)."""
    name = NAMES[side]
    route = fa.sparse_dkdv_kernel if side == "k" else fa.sparse_dq_kernel
    cases = [(c, None) for c in cs.sparse_cases(H)
             if c[2] is not None and route(c[3], c[6], c[5] == "attn") == name]
    if side == "q":
        cases += [(c, ("flash_fwd_lut", name, cs.SM90_TEMPLATES[name])) for c in cs.dq_cases(H)]
    failed = []
    for (T, label, cfg, dt, causal, kind, d, view), held in cases[:limit]:
        lut = fa.layout_luts(cfg.make_layout(T), T, H, causal)
        kb, ab = cs.bias_inputs(kind, gen, 2, T, dev)
        what = f"bf16 d={d} T={T} {label} bias={kind} causal={int(causal)} {view}"
        q, k, v, do = cs.flash_inputs(dev, gen, dt, 2, T, H, d, view)
        before = fa.launches[name]
        try:
            res = cs.check_masked_case(q, k, v, do, lut, kb, ab, causal, what, held)
        except AssertionError as e:
            failed.append(str(e))
            say(f"check {what}: PAST ITS LIMIT: {e}")
            continue
        o, lse = fa.flash_fwd_lut(q, k, v, lut, kb, ab)
        delta = fa.attention_delta(o, do)
        call = fa.flash_bwd_dkdv_lut if side == "k" else fa.flash_bwd_dq_lut
        a, b = (call(q, k, v, do, lse, delta, lut, kb) for _ in range(2))
        torch.cuda.synchronize()
        if fa.launches[name] != before + 3:
            raise AssertionError(f"{what}: launches {fa.launches[name] - before}, expected 3")
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: two calls differ")
        say(f"check {what}{'' if held is None else ' (dK/dV not held)'}: "
            f"{cs.flash_line(res)}; deterministic")
    return failed


def timing(dev, gen, bytes_per_s, card, tag, side, others=True, B=8, T=2048, H=16, d=64):
    q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
    keep = torch.arange(T, device=dev)[None, :] < cs.key_lengths(gen, B, T, dev)[:, None]
    kb = torch.where(keep, 0.0, -10000.0).float()
    tutorial = build_sparsity_config(cs.SPARSE_SECTION, H)
    fixed64 = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                  num_global_blocks=1, attention="bidirectional")
    lut16 = fa.layout_luts(tutorial.make_layout(T), T, H, False)
    lut64 = fa.layout_luts(fixed64.make_layout(T), T, H, False)
    elem, stat = B * T * H * d * 2, B * H * T * 4
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    sm90, tiled = ((fa.flash_bwd_dkdv_lut_sm90, fa.flash_bwd_dkdv_lut_tiled) if side == "k"
                   else (fa.flash_bwd_dq_lut_sm90, fa.flash_bwd_dq_lut_tiled))
    for case, (lut, bias) in {"tutorial16+pad": (lut16, kb), "tutorial16": (lut16, None),
                              "fixed64": (lut64, None)}.items():
        o, lse = fa.flash_fwd_lut(q, k, v, lut, bias)
        delta = fa.attention_delta(o, do)
        layout_mask = lut.element_mask(dev)
        pairs = B * int(layout_mask.sum().item()) * (H // layout_mask.shape[0])
        # dK/dV: q, k, v, dO in, dK, dV out, S dP dV dK; dQ: q, k, v, dO in, dQ out, S dP dQ
        n_elem, flops = (6, 8) if side == "k" else (5, 6)
        nbytes = n_elem * elem + 2 * stat + (0 if bias is None else B * T * 4)
        bound, by = cs.bound_ms(nbytes, flops * d * pairs, bytes_per_s)
        fns = [("sm90", lambda _: sm90(q, k, v, do, lse, delta, lut, bias))]
        if others:
            fns.append(("template", lambda _: tiled(q, k, v, do, lse, delta, lut, bias)))
            mask = layout_mask[None] & keep[:, None, None, :] if bias is not None else \
                layout_mask[None]
            mask = mask.expand(B, H, T, T)
            leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
            out = sdpa(*leaves, attn_mask=mask)
            fns.append(("SDPA backward", lambda _: torch.autograd.grad(out, leaves, doh,
                                                                       retain_graph=True)))
        r = {name: cs.repeat_ms(fn, 20 if name != "SDPA backward" else 5, warmup=2)
             for name, fn in fns}
        g = lut.groups(side)
        rest = ""
        if others:
            rest = (f"; the template design {cs.spread(r['template'])}; SDPA masked "
                    f"backward alone {cs.spread(r['SDPA backward'])} "
                    f"({r['sm90'][0] / r['SDPA backward'][0]:.3f}x)")
            del out, leaves, mask
        template_tiles = (lut.qlen if side == "k" else lut.klen).sum() / lut.heads
        say(f"timing {NAMES[side]} {tag} {case} B={B} T={T} H={H} d={d} ({card}): sm90 "
            f"{cs.spread(r['sm90'])}{rest}; bound {bound * 1e3:.2f} us ({by}; "
            f"{bound / r['sm90'][0]:.3f} of it); visits per head {g.visits_per_head.mean():.0f} "
            f"on {g.tiles_per_head.mean():.0f} tiles (template {template_tiles:.0f})")
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("k", "q"), default="k",
                    help="k: flash_bwd_dkdv_lut_sm90, q: flash_bwd_dq_lut_sm90")
    ap.add_argument("--variants", default="", help="keys of VARIANTS, separated by semicolons")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-timing", action="store_true")
    ap.add_argument("--no-check", action="store_true", help="skip step 2")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("sparse_dkdv_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    say(card)
    t0 = time.perf_counter()
    # a key of VARIANTS, or file:<path> for another source of the same entries
    variants = [(k, build_variant(k, (lambda t, f=k[5:]: open(f).read()) if k.startswith("file:")
                                  else VARIANTS[k])) for k in a.variants.split(";") if k]
    builder.build_all([LIB, "flash_attention_sparse_fwd", "flash_attention_sparse_bwd"])
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
    for row in cs.ptxas_summary(builder.build_log[LIB]["ptxas"]):
        say(f"  ptxas {row}")
        if row[3]:
            raise AssertionError(f"{LIB}: ptxas spilled: {row}")
    for line in builder.build_log[LIB]["ptxas"].splitlines():
        if "stack frame" in line or "Performance Loss" in line or "warning" in line:
            say(f"  ptxas {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(0)
    first_launch(dev, gen, a.side)
    failed = [] if a.no_check else check(dev, gen, a.side, 12 if a.quick else None)
    if not a.no_timing:
        bw = cs.peak_bytes_per_s(torch.cuda.get_device_name(0))
        timing(dev, gen, bw, card, "committed", a.side)
        base = builder._loaded[LIB]
        for tag, path, regs in built:
            builder._loaded[LIB] = ctypes.CDLL(str(path))
            if not any(u in tag for u in UNCHECKED):
                failed += check(dev, gen, a.side, 6)
            timing(dev, gen, bw, card, f"{tag} (regs/spill {sorted({(r[1], r[3]) for r in regs})})",
                   a.side, others=False)
        builder._loaded[LIB] = base
        if built:
            timing(dev, gen, bw, card, "committed again", a.side, others=False)
    for line in failed:
        say(f"past its limit: {line}")
    say(card)
    os.makedirs("chiprun_out", exist_ok=True)
    log = "sparse_dkdv_check.txt" if a.side == "k" else "sparse_dq_check.txt"
    with open(f"chiprun_out/{log}", "w") as f:
        f.write("\n".join(LOG) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
