#!/usr/bin/env python3
"""Time the flash-attention forward (B6) of one checkout on the card.

    python3 tools/torch_b6_ab.py [--tree DIR]

Imports ``chip_smoke`` and ``bigdl_torch`` from DIR (default: this
checkout), builds ``flash_attention.cu`` and times B6 in bf16, causal, at
the serving path's largest call [8, 8, 512, 64], the LM step's
[16, 8, 512, 64] and at [32, 8, 512, 64], each through
``chip_smoke.flash_case`` (checked against the plain version, the card's
time alone).  Where DIR's port has ``flash_attention_with_lse`` the case
also times the call that writes the log-sum-exp for the backward.  Prints
one JSON line, then the card's name and power limit.  To compare two
checkouts, run them as separate processes in one call, A, B, B, A.  Exits
2 without CUDA, 1 if a case disagrees with its plain version.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose chip_smoke and bigdl_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b6_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from bigdl_torch.ops import attention
    from bigdl_torch.utils import cuda_build

    cuda_build.build(["flash_attention"])
    has_lse = hasattr(attention, "flash_attention_with_lse")
    cases = []
    for batch in (8, 16, 32):
        kw = {"with_lse": True} if has_lse else {}
        c = cs.flash_case(batch, 8, 512, 512, 64, torch.bfloat16, True,
                          torch.Generator().manual_seed(cs.SEED), **kw)
        cases.append({"shape": c["shape"], "ok": c["ok"],
                      "ms": c.get("ms_without_lse", c["ms"]),
                      "ms_with_lse": c["ms"] if has_lse else None,
                      "library_ms": c["library_ms"]})
    print(json.dumps({"tree": os.path.abspath(args.tree), "cases": cases}),
          flush=True)
    print(cs.gpu_line(), flush=True)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
