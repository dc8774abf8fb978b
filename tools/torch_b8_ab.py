#!/usr/bin/env python3
"""Time the cached decode attention (B8) of one checkout on the card.

    python3 tools/torch_b8_ab.py [--tree DIR]

Imports ``chip_smoke`` and ``bigdl_torch`` from DIR (default: this
checkout), builds ``decode_attention.cu`` and times B8 in bf16 at the
decode path's calls: the engine's tick [8, 8, L, 64] and a prefill
position [1, 8, L, 64] for L = 128, 256, 512 with mixed positions (0 and
L - 1 among them), [8, 8, 512, 64] with every position at 511, and
[8, 8, 512, 128].  Each case gives ``kernel_ms``, B8's launch alone, and
``path_ms``, what one attention of ``models/decode.py`` costs the card:
where DIR's ``decode_attention`` appends k and v itself (it takes
``q, k_new, v_new, k_cache, v_cache, pos``) that is the same launch; where
it takes ``q, k_cache, v_cache, pos``, the path is that checkout's append
first (the int64 index and two ``scatter_``), then the launch.  Every call
is checked against a float32 plain version of the append and the
attention written here, within ``chip_smoke.DECODE_TOL``; times are the
card's alone (``chip_smoke.graph_ms``).  Prints one JSON line, then the
card's name and power limit.  To compare two checkouts, run them as
separate processes in one call, A, B, B, A.  Exits 2 without CUDA, 1 if a
case disagrees with the plain version.
"""

import argparse
import inspect
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 8, 128, 64, False), (8, 8, 256, 64, False),
          (8, 8, 512, 64, False), (1, 8, 128, 64, False),
          (1, 8, 256, 64, False), (1, 8, 512, 64, False),
          (8, 8, 512, 64, True), (8, 8, 512, 128, False))


def plain(q, k_new, v_new, k, v, pos):
    """The append and the attention in float32, on copies."""
    S, H, L, D = k.shape
    k, v = k.float().clone(), v.float().clone()
    at = torch.arange(L, device=q.device)[None, None, :, None] == \
        pos.long()[:, None, None, None]
    k = torch.where(at, k_new.to(torch.bfloat16).float(), k)
    v = torch.where(at, v_new.to(torch.bfloat16).float(), v)
    scores = torch.einsum("bhqd,bhld->bhql", q.float(), k) / (D ** 0.5)
    live = torch.arange(L, device=q.device) <= pos.long()[:, None, None,
                                                           None]
    w = torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhql,bhld->bhqd", w, v)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose chip_smoke and bigdl_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_b8_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import chip_smoke as cs
    from bigdl_torch.ops import decode_attention as dec
    from bigdl_torch.utils import cuda_build

    cuda_build.build(["decode_attention"])
    appends = len(inspect.signature(dec.decode_attention).parameters) == 6
    gen = torch.Generator().manual_seed(cs.SEED)
    atol, rtol = cs.DECODE_TOL[torch.bfloat16]
    cases = []
    for S, H, L, D, full in SHAPES:
        q, k_new, v_new = (torch.randn((S, 1, H, D), generator=gen)
                           .to("cuda", torch.bfloat16).transpose(1, 2)
                           for _ in range(3))
        k, v = (torch.randn((S, H, L, D), generator=gen)
                .to("cuda", torch.bfloat16) for _ in range(2))
        if full:
            pos = torch.full((S,), L - 1, dtype=torch.int32)
        else:
            pos = torch.randint(0, L, (S,), generator=gen, dtype=torch.int32)
            pos[0] = L - 1
            if S > 1:
                pos[1] = 0
        pos = pos.cuda()
        want = plain(q, k_new, v_new, k, v, pos)

        if appends:
            def kernel():
                return dec.decode_attention(q, k_new, v_new, k, v, pos)
            path = kernel
        else:
            def kernel():
                return dec.decode_attention(q, k, v, pos)

            def path():
                idx = pos.long().view(S, 1, 1, 1).expand(S, H, 1, D)
                k.scatter_(2, idx, k_new.to(k.dtype))
                v.scatter_(2, idx, v_new.to(v.dtype))
                return dec.decode_attention(q, k, v, pos)

        with torch.inference_mode():
            out = path().float()
            torch.cuda.synchronize()
            ok = bool(((out - want).abs() <= atol + rtol * want.abs()).all())
            kernel_ms = cs.graph_ms(kernel)
            path_ms = cs.graph_ms(path)
        cases.append({"shape": [S, H, L, D],
                      "positions": "every L - 1" if full else "mixed",
                      "ok": ok, "max_abs_err": float((out - want).abs().max()),
                      "kernel_ms": kernel_ms, "path_ms": path_ms})
    print(json.dumps({"tree": os.path.abspath(args.tree), "appends": appends,
                      "cases": cases}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0 if all(c["ok"] for c in cases) else 1


if __name__ == "__main__":
    sys.exit(main())
