#!/usr/bin/env python3
"""The port's input pipeline on the card: prefetch depth 0 against 2, and
a tree without the pipeline (an older checkout) against both.

    python3 tools/torch_input_ab.py [--tree DIR] [--depths 0,2,2,0]

Trains ResNet-50 as ``chip_smoke.py``'s ``train`` phase does (bf16, fused,
batch 256, 5 batches an epoch of seeded synthetic images from
``default_rng(0)``) through ``Optimizer``, with ``chip_smoke.py`` and
``bigdl_torch`` imported from ``DIR`` (default: the checkout holding this
script).  After one warm-up step, each entry of ``--depths`` is one timed
run of 5 steps from a fresh pipeline at that
``BIGDL_TORCH_PREFETCH_DEPTH``; a tree without the pipeline has no such
knob and runs its synchronous path every time (``"depth": null``).  One
JSON line per run: the wall time a step (host clock, synchronized at both
ends) and, where the tree's Optimizer keeps them, the loop's wait for its
batch ("get batch time average") and the rest of each iteration
("computing time average").  To compare two trees on one card, run them
in one call as separate processes, in the order A, B, B, A.  Exits 2
with no output where CUDA is missing.
"""

import argparse
import json
import os
import sys
import time

IMAGES = 1280  # 5 batches of 256
STEPS = 5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--depths", default="0,2,2,0")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("torch_input_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bigdl_torch.common import DTypePolicy, set_policy

    pipeline = os.path.exists(os.path.join(tree, "bigdl_torch", "dataset",
                                           "prefetch.py"))
    cs.phase_build()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    samples = cs.synthetic_imagenet(IMAGES, 0)
    model = cs.resnet50(fuse=True)
    cs.train(model, samples, 1, 256)  # warm-up
    try:
        for depth in args.depths.split(","):
            os.environ["BIGDL_TORCH_PREFETCH_DEPTH"] = depth
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cs.train(model, samples, STEPS, 256)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row = {"tree": tree, "depth": int(depth) if pipeline else None,
                   "step_ms": wall / STEPS * 1e3}
            metrics = getattr(cs.train, "metrics", None)
            if metrics is not None:
                wait, _ = metrics.get("get batch time average")
                comp, _ = metrics.get("computing time average")
                row.update({"data_wait_ms": wait / STEPS * 1e3,
                            "data_wait_fraction": wait / wall,
                            "computing_ms": comp / STEPS * 1e3})
            print(json.dumps(row), flush=True)
    finally:
        os.environ.pop("BIGDL_TORCH_PREFETCH_DEPTH", None)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
