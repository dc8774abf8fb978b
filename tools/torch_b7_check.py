#!/usr/bin/env python3
"""Build the port's CUDA sources and hold the flash-attention backward (B7)
against its plain version on the card.

    python3 tools/torch_b7_check.py

Runs ``chip_smoke.py``'s ``build`` phase, its B6 cases that write the
log-sum-exp (``LSE_SHAPES``, held to ``flash_lse_reference``) and its B7
cases (``phase_b7``: the TransformerLM step's shape [16, 8, 512, 64] bf16
causal, and float32 and bf16 ragged shapes), each checked within
``B7_TOL`` and timed beside the plain version and the backward of
PyTorch's ``scaled_dot_product_attention``; one JSON line each, then the
card's name and power limit.  The quick check for work on B6's
log-sum-exp and B7 alone; exits non-zero if a case disagrees or no CUDA
device is present.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_b7_check: no CUDA device", file=sys.stderr)
        return 2
    cs.phase_build()
    try:
        gen = torch.Generator().manual_seed(cs.SEED)
        lse = [cs.flash_case(*s, gen, with_lse=True) for s in cs.LSE_SHAPES]
        print(json.dumps({"phase": "b6_lse", "cases": lse}), flush=True)
        bad = [c for c in lse if not c["ok"]]
        cs.check(not bad, f"B6 with its log-sum-exp disagrees: {bad}")
        rep = cs.phase_b7()
    except cs.SmokeFailure as e:
        print(f"B7 check failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"b7_step_case": rep}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
