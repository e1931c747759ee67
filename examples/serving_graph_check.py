#!/usr/bin/env python3
"""The serving and generate steps as CUDA graphs, alone on one card.

    python3 examples/serving_graph_check.py [--skip-1p3b]

Builds the paged-attention and int8 libraries (one nvcc each, started
together), then runs ``chip_smoke.py``'s serving phases without the
rest: phase 3 at GPT-2 125M (the kv16 serve on the captured steps, with
exact launch counts over the graphs' replays and warm-ups, then both
decode impls on the same traffic through ``chip_smoke.ab_serve``: streams
identical request by request, three timed passes each, a profiled decode
step each, one step's logits) and, unless ``--skip-1p3b``, phase 11 at
GPT-2 1.3B with int8 weights (``chip_smoke.int8_serving``: its serve,
both paths, the bf16 oracle, ``generate`` on both paths, the profiles).
Prints the card's name and power limit; the log is also written to
``chiprun_out/serving_graph_check.txt``.
"""

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.inference import InferenceEngine  # noqa: E402
from deepspeed_tpu_torch.models.gpt2 import GPT2, params_from_jax  # noqa: E402
from deepspeed_tpu_torch.ops.op_builder import cuda as builder  # noqa: E402
from deepspeed_tpu_torch.ops.transformer import int8_matmul as im  # noqa: E402

LIBRARIES = ("paged_attention", *sorted(set(im.LIBRARIES.values())))


class Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for f in self.streams:
            f.write(s)
            f.flush()
        return len(s)


def run(skip_1p3b):
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    print(card)
    t0 = time.perf_counter()
    builder.build_all(list(LIBRARIES))
    print(f"kernel build ({', '.join(LIBRARIES)}): {time.perf_counter() - t0:.2f} s")
    model = GPT2(preset="gpt2-125m", dtype=torch.bfloat16, device=dev)
    engine = InferenceEngine(model, params_from_jax(model.init_numpy(seed=0), dev,
                                                    torch.bfloat16))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.config.vocab_size, (int(n),))
               for n in rng.integers(32, 513, (16,))]
    _, _, toks16 = cs.serve(engine, prompts, 32, "kv16", 16, "auto")
    cs.ab_serve(engine, prompts, 32, "kv16", 16, toks16)
    del engine
    torch.cuda.empty_cache()
    if not skip_1p3b:
        cs.int8_serving(dev, card, prompts)
    print(card)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-1p3b", action="store_true", help="phase 3 only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_graph_check: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/serving_graph_check.txt", "w") as log, \
            contextlib.redirect_stdout(Tee(sys.stdout, log)):
        run(args.skip_1p3b)
    return 0


if __name__ == "__main__":
    sys.exit(main())
