#!/usr/bin/env python3
"""Build the cached decode attention (B8) and run the decode phase alone.

    python3 tools/torch_b8_check.py

Builds ``bigdl_torch/csrc/decode_attention.cu`` alone (its seconds and,
by kernel instance, its registers and spilled bytes), then runs
``chip_smoke.py``'s ``decode`` phase on the TransformerLM bench width with
seeded random weights: B8's cases against ``decode_attention_reference``
(``decode_kernels``: the append checked bit for bit, each case with its
cluster size and the launch floor ``floor_ms``),
``DecodeEngine(slots=8, page=128)`` under continuous
and batch admission, cold and warm, with every row held to
``cached_generate`` under the tie rule, graph replays held to eager steps,
the tick costs (graph and eager) and their profiles, and the small float32
LM on the card against the CPU.  One JSON line each, then the ``kernels`` entry of
B8 and the card's name and power limit.  The quick check for work on the
decode path alone; exits non-zero if a check fails or no CUDA device is
present.
"""

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from bigdl_torch.common import DTypePolicy, set_policy  # noqa: E402
from bigdl_torch.utils import cuda_build  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_b8_check: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    path = cuda_build.build(["decode_attention"])["decode_attention"]
    with open(path[:-3] + ".log") as f:
        ptxas = cs.ptxas_functions(f.read().splitlines())
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "ptxas": ptxas}), flush=True)
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    model = cs.TransformerLM(**cs.LM).build(
        "cuda", torch.Generator().manual_seed(cs.SEED))
    try:
        row = cs.phase_decode(model)
    except cs.SmokeFailure as e:
        print(f"decode check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [row]}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
