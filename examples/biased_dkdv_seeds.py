#!/usr/bin/env python3
"""A seed sweep of one ``chip_smoke.py`` phase-7 case on one Hopper card:
the dense biased backward at T=1000 with a ``mul`` key bias (batch row 1
fully padded), causal, bf16, d=64, B=2, H=4, q/k/v views of one qkv tensor.

    python3 examples/biased_dkdv_seeds.py [--seeds 12]

From the repo root, with a CUDA card and nvcc.  For each seed (a fresh
generator): ``flash_fwd_biased`` -> ``flash_bwd_dkdv_biased`` against
``flash_attention_reference_bwd_dkdv`` fed the same (O, lse), dK and dV
each element within phase 2's bf16 limit (2^-5 of the rms plus 2^-7 of the
element); prints the largest share of the limit, the element it is at, the
share of exact zeros in the plain dK, and how far the kernel and the plain
version each lie from dK with dS left unrounded (fp32 products).  Writes
the log to ``chiprun_out/biased_dkdv_seeds.txt`` too.  Nothing here is used
by the port.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (repo root on the path first)
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=12)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("biased_dkdv_seeds: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    B, T, H, d = 2, 1000, 4, 64
    tol = cs.FLASH_TOL[torch.bfloat16]
    log = [cs.nvidia_smi()]
    for seed in range(a.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        kb, _ = cs.bias_inputs("mul", gen, B, T, dev)
        q, k, v, do = cs.flash_inputs(dev, gen, torch.bfloat16, B, T, H, d, "qkv")
        o, lse = fa.flash_fwd_biased(q, k, v, kb, None, True)
        delta = fa.attention_delta(o, do)
        dk, dv = fa.flash_bwd_dkdv_biased(q, k, v, do, lse, delta, kb, None, True)
        rdk, rdv = fa.flash_attention_reference_bwd_dkdv(q, k, v, do, lse, delta, True,
                                                         key_padding_bias=kb)
        _, ds = fa._p_ds(q, k, v, do, lse, delta, True, 1 / d ** 0.5, None, kb, None)
        exact_dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
        for name, got, ref in (("dk", dk, rdk), ("dv", dv, rdv)):
            got, ref = got.float(), ref.float()
            err = (got - ref).abs()
            share = err / (tol[0] * ref.pow(2).mean().sqrt() + tol[1] * ref.abs())
            i = share.argmax()
            line = (f"seed {seed} {name}: share {share.max().item():.3f} of the limit at "
                    f"plain {ref.flatten()[i].item():.4f} kernel {got.flatten()[i].item():.4f} "
                    f"(error {err.flatten()[i].item():.3e}); rms {ref.pow(2).mean().sqrt().item():.4f}, "
                    f"exact zeros {(ref == 0).float().mean().item():.3f}")
            if name == "dk":
                line += (f"; from dK with dS unrounded: kernel "
                         f"{(got - exact_dk).abs().max().item():.3e}, plain "
                         f"{(ref - exact_dk).abs().max().item():.3e}")
            log.append(line)
            print(line, flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/biased_dkdv_seeds.txt", "w") as f:
        f.write("\n".join(log) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
