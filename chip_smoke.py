#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``build``: compile every CUDA source of the port with ``nvcc`` (one
   process per source, all started together) and report the seconds and
   each kernel's registers and spills.
2. ``kernels``: hold every kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, and time the kernel, the
   plain version and one PyTorch library call computing the same function
   (a yardstick only; the port never calls it), beside the least time the
   card could take (``bound_ms``).
3. ``serve``: TransformerLM at the bench width (vocab 32000, max_len 512,
   d_model 512, 8 heads, 8 layers, bf16 compute) with seeded random weights,
   served through ``InferenceServer(seq_buckets=(128, 256, 512),
   max_batch=8)``: warm-up, then 16 requests of lengths spread over 1..512.
   Every answer is checked against the port's own ``Predictor`` on the same
   padded row, and the kernel's launch count against 8 launches (one per
   layer) per device batch.  A small float32 model is also checked on the
   card against the same model's plain-PyTorch forward on the CPU.
4. ``generate``: ``greedy_generate`` extends a short prompt on the same
   model.

Then a ``kernels`` line (one entry per kernel, with its launches on the
serving path), the card's name and power limit as ``nvidia-smi`` gives
them, and last ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line; so does a machine without CUDA.
"""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

from bigdl_torch.common import DTypePolicy, set_policy
from bigdl_torch.models import TransformerLM, greedy_generate
from bigdl_torch.ops import attention as attn_ops
from bigdl_torch.optim import Predictor
from bigdl_torch.optim.optimizer import to_host
from bigdl_torch.serve import InferenceServer, fit_bucket, pad_tail
from bigdl_torch.utils import cuda_build

SEED = 0
LM = dict(vocab_size=32000, max_len=512, d_model=512, num_heads=8,
          num_layers=8)
SEQ_BUCKETS = (128, 256, 512)
MAX_BATCH = 8
N_REQUESTS = 16

# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by the
# operands' type (bf16 on the tensor cores, float32 on the CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|:
# float32 (TF32 off): the two differ in summation order only.
# bfloat16: both round the output to bf16 (one step is 2^-8 relative), and
# the plain version also rounds p to bf16 before P.V, which moves a
# convex sum of |v| <= 5 by up to 5 * 2^-9 = 0.01.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# served answer vs Predictor on the same padded row, bf16 log-probs of
# magnitude <= ~16: one bf16 step there is 2^-4; a device batch of 8 rows
# and one of 1 may take different cuBLAS kernels, so allow 4 steps
SERVE_ATOL = 0.25
# float32 model on the card vs on the CPU (log-probs): summation order only
REF_ATOL = 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device milliseconds per call, by CUDA events over ``iters``
    back-to-back calls (inputs stay warm in L2, as inside a forward)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- 1. build ---------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.SOURCES)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in libs.items():
        log = open(path[:-3] + ".log").read().splitlines()
        regs = [l.split("Used ")[1].split(" registers")[0]
                for l in log if "registers" in l]
        spills = [l.strip() for l in log if "spill stores" in l]
        ptxas[name] = {"registers": regs, "spills": sorted(set(spills))}
    emit({"phase": "build", "gpu": gpu_line(), "seconds": seconds,
          "sources": list(libs), "ptxas": ptxas})


# -- 2. kernels -------------------------------------------------------------

def attention_bound(B, H, Tq, Tk, D, dtype, causal):
    """Least device time for the call: q, k, v read once and o written
    once, against the products these inputs need (masked pairs skipped)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * B * H * D * (2 * Tq + 2 * Tk)
    pairs = sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk
    flops = 4 * D * B * H * pairs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def flash_case(B, H, Tq, Tk, D, dtype, causal, gen):
    q = torch.randn((B, H, Tq, D), generator=gen).to("cuda", dtype)
    k = torch.randn((B, H, Tk, D), generator=gen).to("cuda", dtype)
    v = torch.randn((B, H, Tk, D), generator=gen).to("cuda", dtype)
    with torch.inference_mode():
        out = attn_ops.flash_attention(q, k, v, causal=causal)
        plain = attn_ops.mha_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs()
        atol, rtol = KERNEL_TOL[dtype]
        ok = bool((err <= atol + rtol * plain.float().abs()).all())
        ms = cuda_ms(lambda: attn_ops.flash_attention(q, k, v, causal=causal))
        plain_ms = cuda_ms(
            lambda: attn_ops.mha_reference(q, k, v, causal=causal))
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
    bound_ms, bound_by, nbytes, flops = attention_bound(B, H, Tq, Tk, D,
                                                        dtype, causal)
    return {"shape": [B, H, Tq, Tk, D], "dtype": str(dtype)[6:],
            "causal": causal, "max_abs_err": float(err.max()),
            "tol": [atol, rtol], "ok": ok, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops}


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    shapes = [(8, 8, t, t, 64) for t in (128, 256, 512)]
    shapes += [(8, 8, 200, 200, 64), (8, 8, 128, 512, 64)]
    cases = [flash_case(*s, dtype, causal, gen) for s in shapes
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True)]
    emit({"phase": "kernels", "gpu": gpu_line(), "kernel": "flash_attention",
          "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version: {bad}")
    # the serving path's largest call: [8, 8, 512, 64] bf16 causal
    return next(c for c in cases if c["shape"] == [8, 8, 512, 512, 64]
                and c["dtype"] == "bfloat16" and c["causal"])


# -- 3. serve ---------------------------------------------------------------

def reference_check():
    """A small float32 model on the card (through the kernel) against the
    same weights' plain forward on the CPU."""
    set_policy(DTypePolicy())
    cfg = dict(vocab_size=97, max_len=64, d_model=64, num_heads=2,
               num_layers=2)
    cpu = TransformerLM(**cfg).build(
        "cpu", torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    x = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, 97, (3, 50)))
    with torch.inference_mode():
        ref = cpu.eval()(x)
        out = gpu.eval()(x.cuda()).cpu()
    err = float((out - ref).abs().max())
    check(err <= REF_ATOL, f"float32 model on the card vs CPU: {err}")
    return err


def batch_split(model):
    """Where a full device batch's time goes: the eval forward of
    [MAX_BATCH, max_len] tokens on the card (CUDA events), its flash
    calls alone, and bringing its log-probs to the host as the server
    does (host clock around a synchronized copy)."""
    x = torch.zeros((MAX_BATCH, LM["max_len"]), dtype=torch.int64,
                    device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        out = model(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            to_host(out)
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
    return {"batch_shape": list(x.shape), "batch_forward_ms": fwd_ms,
            "batch_to_host_ms": host_ms,
            "batch_answer_bytes": out.numel() * 4}


def phase_serve():
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    model = TransformerLM(**LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    rs = np.random.RandomState(SEED)
    lengths = np.linspace(1, LM["max_len"], N_REQUESTS).astype(int)
    xs = [rs.randint(0, LM["vocab_size"], (n,)).astype(np.int64)
          for n in lengths]

    attn_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    server = InferenceServer(model, seq_buckets=SEQ_BUCKETS,
                             max_batch=MAX_BATCH, max_wait_ms=5,
                             example=np.zeros((SEQ_BUCKETS[0],), np.int64))
    server.start()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    handles = [server.submit(x) for x in xs]
    outs = [h.result(300) for h in handles]
    wall = time.perf_counter() - t1
    server.stop()
    launches = attn_ops.flash_attention.launches
    stats = server.stats()

    device_batches = stats["batches"] + stats["warmup_batches"]
    expected = LM["num_layers"] * device_batches
    check(launches == expected,
          f"flash launches {launches} != 8 x {device_batches} batches")
    check(stats["batch_rows"] == N_REQUESTS and stats["batch_errors"] == 0,
          f"served {stats}")
    predictor = Predictor(model)
    worst = 0.0
    for x, out in zip(xs, outs):
        seq = fit_bucket(len(x), SEQ_BUCKETS)
        check(out.shape == (seq, LM["vocab_size"]),
              f"answer shape {out.shape} for length {len(x)}")
        check(np.isfinite(out).all(), f"non-finite answer, length {len(x)}")
        mass = np.exp(out.astype(np.float64)).sum(-1)
        check(np.abs(mass - 1).max() < 0.05,
              f"log-probs do not normalize: {np.abs(mass - 1).max()}")
        ref = predictor.predict(pad_tail(x, seq)[None, :])[0]
        worst = max(worst, float(np.abs(out - ref).max()))
    check(worst <= SERVE_ATOL, f"served vs Predictor: {worst}")
    lat = np.array([h.latency_s for h in handles]) * 1e3
    split = batch_split(model)
    ref_err = reference_check()
    emit({"phase": "serve", "gpu": gpu_line(), "requests": N_REQUESTS,
          "lengths": lengths.tolist(), "warmup_s": warm_s,
          "wall_s": wall, "requests_per_s": N_REQUESTS / wall,
          "p50_ms": float(np.percentile(lat, 50)),
          "p99_ms": float(np.percentile(lat, 99)),
          "batches": stats["batches"],
          "warmup_batches": stats["warmup_batches"],
          "batch_fill": stats["batch_fill"], "flash_launches": launches,
          **split, "max_abs_err_vs_predictor": worst, "tol": SERVE_ATOL,
          "f32_reference_max_abs_err": ref_err, "ref_tol": REF_ATOL})
    return model, launches


# -- 4. generate ------------------------------------------------------------

def phase_generate(model):
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    prompt = np.random.RandomState(SEED + 1).randint(
        0, LM["vocab_size"], (8,))
    n_new = 4
    attn_ops.flash_attention.launches = 0
    t0 = time.perf_counter()
    out = greedy_generate(model, prompt, n_new, LM["max_len"])
    seconds = time.perf_counter() - t0
    launches = attn_ops.flash_attention.launches
    check(out.shape == (len(prompt) + n_new,), f"generated {out.shape}")
    check(np.array_equal(out[:len(prompt)], prompt), "prompt not kept")
    check(((out >= 0) & (out < LM["vocab_size"])).all(), "token range")
    check(launches == LM["num_layers"] * n_new,
          f"generate launched flash {launches} times")
    emit({"phase": "generate", "gpu": gpu_line(), "tokens": out.tolist(),
          "seconds": seconds,
          "flash_launches": launches})


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase_build()
    rep = phase_kernels()
    model, launches = phase_serve()
    phase_generate(model)
    emit({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "bigdl_torch/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/attention.py:59",
        "launches": launches, "max_abs_err": rep["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"]}]})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
