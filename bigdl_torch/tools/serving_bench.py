"""Serving microbench: KV-cache decode against full re-forward, float
against int8.

Counterpart of ``bigdl_tpu/tools/serving_bench.py``.  One JSON line for
the run, with tokens a second for each path:

- ``full_fwd``: ``greedy_generate``, one full [B, max_len] forward a token
  (B6 in each layer on the card);
- ``kv_cache``: ``cached_generate``, one [B, 1] step a token against the
  cache (B8 in each layer);
- ``kv_int8``: the same on ``quantize(model)``.

The model is ``TransformerLM`` with seeded random weights in bf16 compute;
the prompt is one token, so each path runs exactly ``--num-tokens`` steps.
Each path runs once to warm, then three times; the best time counts (the
device is drained before and after each run).  It runs on the CUDA
device unless given ``--device cpu``::

    python -m bigdl_torch.tools.serving_bench [--d-model 512 \\
        --num-layers 8 --max-len 1024 --batch 8 --num-tokens 64]
"""

from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m bigdl_torch.tools."
                                     "serving_bench")
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--num-layers", type=int, default=8)
    p.add_argument("--vocab", type=int, default=32000)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--num-tokens", type=int, default=64)
    p.add_argument("--skip-full", action="store_true",
                   help="full re-forward costs O(L^2) a token: skip it")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ..common import DTypePolicy, get_policy, resolve_device, set_policy
    from ..models import TransformerLM, cached_generate
    from ..models.transformer_lm import greedy_generate
    from ..quantize import quantize

    device = resolve_device(args.device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prev_policy = get_policy()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    try:
        model = TransformerLM(
            vocab_size=args.vocab, max_len=args.max_len,
            d_model=args.d_model, num_heads=args.num_heads,
            num_layers=args.num_layers).build(
                device, torch.Generator().manual_seed(0))
        prompt = np.ones((args.batch, 1), np.int32)

        def bench(name, fn):
            fn()  # warm: builds the kernels on first use
            times = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times.append(time.perf_counter() - t0)
            dt = min(times)
            toks = args.batch * args.num_tokens
            return {"path": name, "tokens_per_sec": round(toks / dt, 1),
                    "seconds": round(dt, 4)}

        results = []
        if not args.skip_full:
            results.append(bench("full_fwd", lambda: greedy_generate(
                model, prompt, args.num_tokens, args.max_len)))
        results.append(bench("kv_cache", lambda: cached_generate(
            model, prompt, args.num_tokens, args.max_len)))
        qmodel = quantize(model)
        results.append(bench("kv_int8", lambda: cached_generate(
            qmodel, prompt, args.num_tokens, args.max_len)))
    finally:
        set_policy(prev_policy)

    out = {"metric": "serving_decode_tokens_per_sec",
           "config": {k: getattr(args, k)
                      for k in ("d_model", "num_heads", "num_layers",
                                "vocab", "max_len", "batch", "num_tokens")},
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"),
           "results": results}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
