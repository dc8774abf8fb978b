#!/usr/bin/env python3
"""Time variants of the cached decode attention kernel (B8) in one process.

    python3 tools/torch_b8_variants.py NAME=EDIT [NAME=EDIT ...]

Each argument builds one variant of ``bigdl_torch/csrc/decode_attention.cu``
into ``chip_tmp/b8_variants/`` (gitignored): EDIT is a list of text
replacements ``OLD->NEW`` joined by ``;;``, applied to the source in order
(an empty EDIT is the source as it stands), e.g.

    python3 tools/torch_b8_variants.py base= \\
        "rows64=STEP > 32 ? STEP : 32;->STEP > 64 ? STEP : 64;"

Every variant is checked against ``decode_attention_reference`` (within
``chip_smoke.DECODE_TOL``) and timed, the card's time alone (20 launches in
a CUDA graph), at the decode path's calls and the other head dimensions, in
bf16 and float32, with the cluster size ``splits`` gives; variants take
turns, A, B, B, A, twice, and each gets the least of its four times.
Prints one JSON line per case, then the card's name and power limit.  A
tool for trying a change to the kernel before making it; exits 2 without
CUDA, 1 if a variant fails to build or disagrees with the plain version.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from bigdl_torch.ops import decode_attention as dec  # noqa: E402
from bigdl_torch.utils import cuda_build  # noqa: E402

OUT = os.path.join(ROOT, "chip_tmp", "b8_variants")
# (S, H, L, D, every position at L - 1)
SHAPES = ((8, 8, 128, 64, False), (8, 8, 256, 64, False),
          (8, 8, 512, 64, False), (8, 8, 512, 64, True),
          (1, 8, 128, 64, False), (1, 8, 256, 64, False),
          (1, 8, 512, 64, False), (8, 8, 512, 16, False),
          (8, 8, 512, 32, False), (8, 8, 512, 128, False),
          (8, 8, 4096, 64, False))


def build(variants):
    """name -> the variant's bigdl_decode_attention, all built at once."""
    os.makedirs(OUT, exist_ok=True)
    src = open(cuda_build.source_path("decode_attention")).read().replace(
        '#include "hopper.cuh"',
        f'#include "{os.path.join(cuda_build.CSRC_DIR, "hopper.cuh")}"')
    procs = {}
    for name, edit in variants:
        text = src
        for sub in filter(None, edit.split(";;")):
            old, new = sub.split("->")
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
            raise SystemExit(1)
        fn = ctypes.CDLL(lib).bigdl_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def caller(fn, q, k_new, v_new, k, v, pos, C):
    S, H, L, D = k.shape
    o = torch.empty((S, H, 1, D), dtype=q.dtype, device="cuda")
    bf16 = int(q.dtype == torch.bfloat16)

    def call():
        err = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                 k.data_ptr(), v.data_ptr(), o.data_ptr(), pos.data_ptr(),
                 bf16, bf16, S, H, L, D, C, q.stride(0), q.stride(1),
                 k_new.stride(0), k_new.stride(1), v_new.stride(0),
                 v_new.stride(1), k.stride(0), k.stride(1), v.stride(0),
                 v.stride(1), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return o
    return call


def main():
    if not torch.cuda.is_available():
        print("torch_b8_variants: no CUDA device", file=sys.stderr)
        return 2
    fns = build([a.partition("=")[::2] for a in sys.argv[1:]])
    gen = torch.Generator().manual_seed(cs.SEED)
    ok = True
    for S, H, L, D, full in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k_new, v_new = (torch.randn((S, 1, H, D), generator=gen)
                               .to("cuda", dtype).transpose(1, 2)
                               for _ in range(3))
            k, v = (torch.randn((S, H, L, D), generator=gen)
                    .to("cuda", dtype) for _ in range(2))
            if full:
                pos = torch.full((S,), L - 1, dtype=torch.int32)
            else:
                pos = torch.randint(0, L, (S,), generator=gen,
                                    dtype=torch.int32)
                pos[0] = L - 1
                if S > 1:
                    pos[1] = 0
            pos = pos.cuda()
            C = dec.splits(S, H, L, dec.sm_count(q.device))
            want = dec.decode_attention_reference(
                q, k_new, v_new, k.clone(), v.clone(), pos).float()
            atol, rtol = cs.DECODE_TOL[dtype]
            row = {"shape": [S, H, L, D], "dtype": str(dtype)[6:],
                   "positions": "every L - 1" if full else "mixed",
                   "splits": C}
            calls = {n: caller(f, q, k_new, v_new, k, v, pos, C)
                     for n, f in fns.items()}
            times = {n: [] for n in calls}
            for n, call in calls.items():
                got = call().float()
                torch.cuda.synchronize()
                good = bool(((got - want).abs()
                             <= atol + rtol * want.abs()).all())
                row[f"{n}_ok"] = good
                ok = ok and good
            turns = list(calls) + list(calls)[::-1]
            for n in turns * 2:
                times[n].append(cs.graph_ms(calls[n]))
            for n in calls:
                row[f"{n}_ms"] = min(times[n])
            print(json.dumps(row), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
