#!/usr/bin/env python3
"""A seed sweep of a ``chip_smoke.py`` case where dK/dV's bf16 limit is
tight, on one Hopper card.

    python3 examples/biased_dkdv_seeds.py [--seeds 12] [--case dense-mul|banded]

From the repo root, with a CUDA card and nvcc.  The cases:

- ``dense-mul`` (phase 7): the dense biased backward at T=1000 with a
  ``mul`` key bias (batch row 1 fully padded), causal, bf16, d=64, B=2,
  H=4, q/k/v views of one qkv tensor: ``flash_fwd_biased``, then the dK/dV
  route of this case (the key-bias instance of ``flash_bwd_dkdv_sm90``)
  and beside it the template ``flash_bwd_dkdv_biased``;
- ``banded`` (phase 14): the causal BSLongformer workload at T=8192, layout
  block 512, B=1, H=8, d=64: ``flash_fwd_banded``, then
  ``flash_bwd_dkdv_lut_sm90`` and beside it the template
  ``flash_bwd_dkdv_lut``.

For each seed (a fresh generator) both kernels against
``flash_attention_reference_bwd_dkdv`` fed the same (O, lse), dK and dV
each element within phase 2's bf16 limit (2^-5 of the rms plus 2^-7 of the
element): the largest share of the limit, the element it is at, the share
of exact zeros in the plain output, how far the kernel and the plain
version each lie from the output with P and dS left unrounded (fp32
products), whether the two kernels agree bit for bit; at the end the
largest share over the seeds of each kernel and output.  Writes the log to
``chiprun_out/biased_dkdv_seeds.txt`` (``banded``:
``chiprun_out/banded_dkdv_seeds.txt``) too.  Nothing here is used by the
port.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (repo root on the path first)
from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402


def dense_mul(dev, d=64):
    """The phase-7 case: (inputs of a seed, {kernel: dK/dV call}, plain keywords)."""
    B, T, H = 2, 1000, 4

    def inputs(gen):
        kb, _ = cs.bias_inputs("mul", gen, B, T, dev)
        q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
        o, lse = fa.flash_fwd_biased(q, k, v, kb, None, True)
        return q, k, v, do, lse, fa.attention_delta(o, do), {"key_padding_bias": kb}

    route = fa.biased_bwd_kernel(torch.bfloat16, d, False)[0]
    kernels = {route: lambda *x, kw: fa.flash_bwd_dkdv_biased(*x, kw["key_padding_bias"],
                                                               None, True),
               "flash_bwd_dkdv_biased": lambda *x, kw: fa.flash_bwd_dkdv_biased_template(
                   *x, kw["key_padding_bias"], None, True)}
    return inputs, kernels


def banded(dev, d=64):
    """The phase-14 case, as :func:`dense_mul`."""
    B, T, H, block = 1, 8192, 8, 512
    attn = SparseSelfAttention(cs.workload_config(H, block), max_seq_length=T)
    lut = fa.layout_luts(attn.get_layout(T), T, H, True)
    band = fa.band_lut(*fa.banded_structure(lut.layout, True), block, T)

    def inputs(gen):
        qkv = torch.randn((B, T, 3 * H * d), generator=gen, device=dev).to(torch.bfloat16)
        do = torch.randn((B, T, H, d), generator=gen, device=dev).to(torch.bfloat16)
        q, k, v = (t.view(B, T, H, d) for t in qkv.split(H * d, dim=-1))
        o, lse = fa.flash_fwd_banded(q, k, v, band)
        return q, k, v, do, lse, fa.attention_delta(o, do), {"lut": lut}

    kernels = {"flash_bwd_dkdv_lut_sm90": lambda *x, kw: fa.flash_bwd_dkdv_lut_sm90(
                   *x, kw["lut"]),
               "flash_bwd_dkdv_lut": lambda *x, kw: fa.flash_bwd_dkdv_lut_tiled(*x, kw["lut"])}
    return inputs, kernels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--case", choices=("dense-mul", "banded"), default="dense-mul")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("biased_dkdv_seeds: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    d = 64
    tol = cs.FLASH_TOL[torch.bfloat16]
    log = [cs.nvidia_smi()]

    def say(line):
        log.append(line)
        print(line, flush=True)

    inputs, kernels = (dense_mul if a.case == "dense-mul" else banded)(dev, d)
    worst = {(name, out): 0.0 for name in kernels for out in ("dk", "dv")}
    for seed in range(a.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v, do, lse, delta, kw = inputs(gen)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True, **kw)
        kb, lut = kw.get("key_padding_bias"), kw.get("lut")
        p, ds = fa._p_ds(q, k, v, do, lse, delta, True, 1 / d ** 0.5, lut, kb, None)
        exact = {"dk": torch.einsum("bhqk,bqhd->bkhd", ds, q.float()),
                 "dv": torch.einsum("bhqk,bqhd->bkhd", p, do.float())}
        del p, ds
        outs = {}
        for kname, call in kernels.items():
            outs[kname] = dk, dv = call(q, k, v, do, lse, delta, kw=kw)
            for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv)):
                got, ref = got.float(), ref.float()
                err = (got - ref).abs()
                share = err / (tol[0] * ref.pow(2).mean().sqrt() + tol[1] * ref.abs())
                i = share.argmax()
                worst[kname, name] = max(worst[kname, name], share.max().item())
                say(f"seed {seed} {kname} {name}: share {share.max().item():.3f} of the "
                    f"limit at plain {ref.flatten()[i].item():.4f} kernel "
                    f"{got.flatten()[i].item():.4f} (error {err.flatten()[i].item():.3e}); "
                    f"rms {ref.pow(2).mean().sqrt().item():.4f}, exact zeros "
                    f"{(ref == 0).float().mean().item():.3f}; from {name} with P and dS "
                    f"unrounded: kernel {(got - exact[name]).abs().max().item():.3e}, plain "
                    f"{(ref - exact[name]).abs().max().item():.3e}")
        (a_dk, a_dv), (b_dk, b_dv) = outs.values()
        say(f"seed {seed}: the two kernels bit-identical: dk {torch.equal(a_dk, b_dk)}, "
            f"dv {torch.equal(a_dv, b_dv)}")
        del exact, outs
        torch.cuda.empty_cache()
    say(f"{a.case}: largest share of the limit over {a.seeds} seeds: " + ", ".join(
        f"{kname} {name} {share:.3f}" for (kname, name), share in worst.items()))
    say(log[0])
    os.makedirs("chiprun_out", exist_ok=True)
    stem = "biased_dkdv_seeds" if a.case == "dense-mul" else "banded_dkdv_seeds"
    with open(f"chiprun_out/{stem}.txt", "w") as f:
        f.write("\n".join(log) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
