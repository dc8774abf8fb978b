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
5. ``train``: ResNet-50 at the width of the repo's ``resnet50_bf16`` bench
   config (ImageNet, 1000 classes, NHWC 224x224x3, batch 256, bf16 compute
   over float32 params, ``CrossEntropyCriterion``, ``SGD(0.1)``,
   ``fuse_conv_bn`` before ``build``), weights random from the seed, on
   seeded synthetic images, trained through ``DataSet.array`` ->
   ``Optimizer``: one warm-up step, which also records every shape the
   step gives the BatchNorm and conv-BN kernels, then ``bn_kernels`` (next
   item), then ``TRAIN_STEPS`` timed steps.  Every loss must be finite, the
   launch counts exactly 20 B1, 20 B2, 33 B5 and 33 B4 per step, and the
   running statistics must move.  Then the unfused model from the same
   seed takes its first step on the same batch (all 53 BatchNorms on
   B1/B2) and must give the fused model's first loss within
   ``UNFUSED_ATOL``; and a small bottleneck ResNet in float32 (TF32 off)
   takes 3 steps on the card and on the CPU, losses within ``F32_TRAIN_ATOL``.
6. ``bn_kernels`` (inside ``train``): B1 ``bn_forward``, B2 ``bn_backward``,
   B4 ``bn_grad_stats`` and B5 ``matmul_stats`` against their plain
   versions at every distinct shape the step gave them (bf16), plus
   float32 and ragged cases, each timed beside its plain version, a
   PyTorch yardstick call and its bound.

Then a ``kernels`` line (one entry per kernel, with its launches on its
path: B6 on the serving path, the others per timed training run), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without that line; so does a machine without CUDA.
"""

import collections
import copy
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import bigdl_torch.nn as nn
from bigdl_torch.common import DTypePolicy, set_policy
from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_torch.models import ResNet, TransformerLM, greedy_generate
from bigdl_torch.models import resnet as resnet_mod
from bigdl_torch.ops import attention as attn_ops
from bigdl_torch.ops import batchnorm as bn_ops
from bigdl_torch.ops import convbn as cb_ops
from bigdl_torch.optim import SGD, Optimizer, Predictor, Trigger
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

# the training path: bench.py's resnet50_bf16 config
TRAIN_BATCH = 256
TRAIN_STEPS = 5
BN_EPS = 1e-5
# launches per training step of the fused ResNet-50: 20 unfused BatchNorms
# (stem, 16 3x3 convs, 3 strided shortcuts) on B1/B2, 33 fused 1x1 sites
# (17 ConvBN, 16 ConvBNAddReLU) on B5 forward and B4 backward
STEP_LAUNCHES = {"bn_forward": 20, "bn_backward": 20, "matmul_stats": 33,
                 "bn_grad_stats": 33}
# distinct shapes one step gives each kernel at batch 256
STEP_SHAPES = {"bn_forward": 8, "bn_backward": 8, "bn_grad_stats": 11,
               "matmul_stats": 12}
# BatchNorm / conv-BN kernel vs plain version, as a bound on
# max|kernel - plain| / max(1, max|plain|): float32 outputs and every
# float32 statistic differ in summation order only (blocked sums against
# one reduction): 1e-5.  bf16 outputs are rounded once each from float32
# values that may differ in the last bits (a fused multiply-add against
# two roundings): one bf16 step, 2^-8 relative, so 2^-7.
BN_TOL = {"f32": 1e-5, "bf16_out": 2.0 ** -7}
# fused vs unfused ResNet-50, first-step loss (a bf16 scalar near ln(1000)
# = 6.9, where one bf16 step is 2^-5 = 0.031): the fused path takes the BN
# statistics from the float32 accumulator and normalizes in bf16 ops, the
# unfused one from the bf16 conv output in float32; logits move by a few
# bf16 steps, the batch mean of the loss by less: allow 3 loss steps
UNFUSED_ATOL = 0.1
# small float32 ResNet, 3 steps on the card (kernels, cuDNN, TF32 off) vs
# the CPU (plain versions): summation order only, amplified by 3 SGD steps
F32_TRAIN_ATOL = 1e-3


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

# -- 5. train, with 6. bn_kernels inside --------------------------------------

#: training-path kernels: wrapper, source, the TPU kernel it replaces
TRAIN_KERNELS = {
    "bn_forward": (bn_ops.bn_forward, "bigdl_torch/csrc/batchnorm.cu",
                   "bigdl_tpu/ops/batchnorm.py:75"),
    "bn_backward": (bn_ops.bn_backward, "bigdl_torch/csrc/batchnorm.cu",
                    "bigdl_tpu/ops/batchnorm.py:165"),
    "bn_grad_stats": (bn_ops.bn_grad_stats, "bigdl_torch/csrc/batchnorm.cu",
                      "bigdl_tpu/ops/batchnorm.py:353"),
    "matmul_stats": (cb_ops.matmul_stats, "bigdl_torch/csrc/matmul_stats.cu",
                     "bigdl_tpu/ops/convbn.py:66"),
}
# float32 operations per element of the BatchNorm kernels (an FMA is 2):
# B1 Σx, Σx² and the normalize; B2 x̂, Σdy, Σdy·x̂ and dx; B4 x̂ and sums
BN_FLOPS_PER_ELEM = {"bn_forward": 5, "bn_backward": 12,
                     "bn_grad_stats": 6}


def zero_counts():
    for fn, _, _ in TRAIN_KERNELS.values():
        fn.launches = 0


def counts():
    return {k: fn.launches for k, (fn, _, _) in TRAIN_KERNELS.items()}


def record_shapes(model):
    """Forward hooks that count, per kernel, the operand shapes one
    training step gives it: B1/B2 at every BatchNorm left unfused, B5 at
    every fused site (and B4, in the backward, at its output).  Returns
    (shape counters, hook handles)."""
    seen = {k: collections.Counter() for k in STEP_SHAPES}
    handles, fused_bns = [], set()

    def site(conv):
        def hook(mod, inp, out=None):
            x = inp[0] if out is None else out
            rk = (x.numel() // x.shape[-1], x.shape[-1])
            seen["matmul_stats"][rk + (conv.n_output_plane,)] += 1
            seen["bn_grad_stats"][(rk[0], conv.n_output_plane)] += 1
        return hook

    for m in model.modules():
        if type(m) is nn.ConvBN:
            fused_bns.add(id(m.layers[1]))
            handles.append(m.register_forward_pre_hook(site(m.layers[0])))
        elif type(m) is nn.ConvBNAddReLU:
            fused_bns.add(id(m.layers[2]))
            handles.append(m.layers[0].register_forward_hook(
                site(m.layers[1])))

    def bn_hook(mod, inp):
        x = inp[0]
        rc = (x.numel() // x.shape[-1], x.shape[-1])
        seen["bn_forward"][rc] += 1
        seen["bn_backward"][rc] += 1

    for m in model.modules():
        if isinstance(m, nn.BatchNormalization) and id(m) not in fused_bns:
            handles.append(m.register_forward_pre_hook(bn_hook))
    return seen, handles


def rel_err(out, ref):
    """max|out - ref| and that over max(1, max|ref|)."""
    err = float((out.float() - ref.float()).abs().max())
    return err, err / max(1.0, float(ref.float().abs().max()))


def bound(nbytes, flops, peak):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def maybe_ms(fn):
    """A yardstick's time, or None with the reason where PyTorch does not
    take the call (it is a measurement aid, never the port's path)."""
    try:
        return cuda_ms(fn), None
    except (RuntimeError, TypeError) as e:
        return None, str(e).splitlines()[0][:200]


def bn_case(kind, shape, dtype, gen, calls=0):
    """One kernel against its plain version on the card, and its times."""
    dev = dict(device="cuda", generator=gen)
    item = torch.empty((), dtype=dtype).element_size()
    fn = TRAIN_KERNELS[kind][0]
    if kind == "matmul_stats":
        R, K, C = shape
        x = torch.randn((R, K), **dev).to(dtype)
        w = (torch.randn((K, C), **dev) / K ** 0.5).to(dtype)
        b = torch.randn((C,), **dev)
        args = (x, w, b)

        def lib():  # computes no statistics: a floor, not an equal
            return torch.matmul(x, w)
        nbytes = item * (R * K + K * C + R * C) + 4 * 3 * C
        flops, peak = 2 * R * K * C, PEAK_FLOPS[dtype]
        out_idx = (0,)
    else:
        R, C = shape
        x = (torch.randn((R, C), **dev) * 2 + 0.5).to(dtype)
        w = torch.rand((C,), **dev) + 0.5
        b = torch.randn((C,), **dev)
        mean = x.float().mean(0)
        inv = torch.rsqrt(x.float().var(0, unbiased=False) + BN_EPS)
        flops = BN_FLOPS_PER_ELEM[kind] * R * C
        peak = PEAK_FLOPS[torch.float32]
        dy = torch.randn((R, C), **dev).to(dtype)
        if kind == "bn_forward":
            args = (x, w, b, BN_EPS)

            def lib():
                return F.batch_norm(x, None, None, w, b, training=True,
                                    eps=BN_EPS)
            nbytes = 2 * item * R * C + 4 * 4 * C
        elif kind == "bn_backward":
            args = (x, dy, mean, inv, w)

            def lib():
                return torch.ops.aten.native_batch_norm_backward(
                    dy, x, w, None, None, mean, inv, True, BN_EPS,
                    [True, True, True])
            nbytes = 3 * item * R * C + 4 * 5 * C
        else:
            args = (x, dy, mean, inv)

            def lib():
                return torch.batch_norm_backward_reduce(
                    dy, x, mean, inv, w, True, False, False)
            nbytes = 2 * item * R * C + 4 * 4 * C
        out_idx = (0,) if kind != "bn_grad_stats" else ()
    plain = {"bn_forward": bn_ops.bn_forward_reference,
             "bn_backward": bn_ops.bn_backward_reference,
             "bn_grad_stats": bn_ops.bn_grad_stats_reference,
             "matmul_stats": cb_ops.matmul_stats_reference}[kind]
    got, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    ok, worst_abs, worst_rel = True, 0.0, 0.0
    for i, (o, r) in enumerate(zip(got, ref)):
        a, rel = rel_err(o, r)
        tol = (BN_TOL["bf16_out"] if i in out_idx and dtype == torch.bfloat16
               else BN_TOL["f32"])
        ok = ok and rel <= tol and o.dtype == r.dtype and o.shape == r.shape
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, rel)
    lib_ms, lib_note = maybe_ms(lib)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    case = {"kernel": kind, "shape": list(shape), "dtype": str(dtype)[6:],
            "calls_per_step": calls, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "ok": ok,
            "ms": cuda_ms(lambda: fn(*args)), "plain_ms": cuda_ms(
                lambda: plain(*args), iters=5, warmup=1),
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "flops": flops}
    if lib_note:
        case["library_note"] = lib_note
    return case


def phase_bn_kernels(seen):
    """Every training-path kernel at every distinct shape the step gave
    it (bf16), plus float32 and ragged cases; returns, per kernel, its
    cases and the case of its largest call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    extra = {"matmul_stats": [(1000, 64, 64), (37, 19, 70), (300, 130, 2048)],
             "other": [(1000, 3), (1000, 130), (12544, 2048)]}
    reps = {}
    for kind in TRAIN_KERNELS:
        shapes = sorted(seen[kind].items())
        cases = [bn_case(kind, sh, torch.bfloat16, gen, n)
                 for sh, n in shapes]
        for sh in extra["matmul_stats" if kind == "matmul_stats"
                       else "other"]:
            cases += [bn_case(kind, sh, dt, gen)
                      for dt in (torch.float32, torch.bfloat16)]
        emit({"phase": "bn_kernels", "gpu": gpu_line(), "kernel": kind,
              "cases": cases})
        bad = [c for c in cases if not c["ok"]]
        check(not bad, f"{kind} disagrees with its plain version: {bad}")
        step = [c for c in cases if c["calls_per_step"]]
        # the step's largest call: the most bytes to move
        reps[kind] = (max(step, key=lambda c: (c["bytes"], c["flops"])),
                      sum(c["calls_per_step"] * c["ms"] for c in step))
        torch.cuda.empty_cache()
    return reps


def profile_step(model, samples):
    """One training step under ``torch.profiler``: device time by kernel
    name (top 25) and the share of the step's wall time the device was
    idle.  A measurement aid: a profiler that cannot trace the card is
    reported in the result, not fatal."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train(model, samples, 1, TRAIN_BATCH)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3, e.count, e.key[:120]))
    except (RuntimeError, AttributeError) as e:
        return {"profile_error": str(e).splitlines()[0][:200]}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"profiled_step_wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
            "top_kernels": [{"ms": ms, "count": n, "name": k}
                            for ms, n, k in rows[:25]]}


def synthetic_imagenet(n, seed):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = rs.integers(0, 1000, n).astype(np.int32)
    return [Sample(x[i], y[i]) for i in range(n)]


def train(model, samples, steps, batch, device=None):
    """``steps`` Optimizer steps on a fresh ``DataSet.array(samples)``
    (seeded: every call visits the same batches); returns the loss the
    driver observed after each step."""
    losses = {}

    def end(state):
        if state["neval"] > 1:
            losses[state["neval"] - 1] = state["loss"]
        return state["neval"] > steps

    opt = Optimizer(model, DataSet.array(samples, seed=SEED),
                    nn.CrossEntropyCriterion(), batch_size=batch,
                    device=device)
    opt.set_optim_method(SGD(0.1)).set_end_when(Trigger(end, "steps"))
    opt.optimize()
    return [losses[k] for k in sorted(losses)]


def resnet50(fuse):
    model = ResNet(50, class_num=1000, dataset="imagenet")
    if fuse:
        nn.fuse_conv_bn(model)
    return model.build("cuda", torch.Generator().manual_seed(SEED))


def small_resnet():
    """The small bottleneck ResNet of tests/test_torch_port_resnet.py."""
    m = nn.Sequential()
    m.add(resnet_mod._conv(3, 16, 7, 7, 2, 2, 3, 3))
    m.add(nn.SpatialBatchNormalization(16)).add(nn.ReLU())
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1))
    b1, ch = resnet_mod._bottleneck(16, 4, 1, "B")
    b2, ch = resnet_mod._bottleneck(ch, 8, 2, "B")
    m.add(nn.Sequential().add(b1)).add(nn.Sequential().add(b2))
    m.add(nn.SpatialAveragePooling(4, 4, 1, 1))
    m.add(nn.Reshape((ch,))).add(nn.Linear(ch, 10))
    return nn.fuse_conv_bn(m)


def f32_card_vs_cpu():
    """The small ResNet in float32 (TF32 off), 3 steps on the card through
    the kernels and on the CPU through their plain versions."""
    set_policy(DTypePolicy())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = small_resnet().build("cpu", torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    rs = np.random.default_rng(SEED + 2)
    x = rs.standard_normal((32, 32, 32, 3), dtype=np.float32)
    y = rs.integers(0, 10, 32).astype(np.int32)
    samples = [Sample(x[i], y[i]) for i in range(32)]
    zero_counts()
    card = train(gpu, samples, 3, 8)
    launched = counts()
    host = train(cpu, samples, 3, 8, device="cpu")
    err = max(abs(a - b) for a, b in zip(card, host))
    check(all(v > 0 for v in launched.values()),
          f"the float32 run skipped a kernel: {launched}")
    check(err <= F32_TRAIN_ATOL, f"float32 ResNet card vs CPU: {card} vs "
          f"{host}")
    return {"f32_losses_card": card, "f32_losses_cpu": host,
            "f32_max_loss_diff": err, "f32_tol": F32_TRAIN_ATOL,
            "f32_launches": launched}


def phase_train():
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    samples = synthetic_imagenet(TRAIN_BATCH, SEED)
    model = resnet50(fuse=True)
    setup_s = time.perf_counter() - t0
    # cuDNN takes the NHWC input as a channels_last view; its output,
    # permuted back, must be contiguous NHWC, or every fused site's
    # reshape to [rows, K] would copy
    with torch.no_grad():
        stem = model.layers[0](torch.from_numpy(np.stack(
            [s.feature for s in samples[:2]])).cuda())
    check(stem.is_contiguous() and stem.dtype == torch.bfloat16,
          f"stem conv output {stem.dtype} strides {stem.stride()}")

    # warm-up step, recording every kernel's shapes
    seen, handles = record_shapes(model)
    zero_counts()
    t0 = time.perf_counter()
    first = train(model, samples, 1, TRAIN_BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for h in handles:
        h.remove()
    check(counts() == STEP_LAUNCHES, f"warm-up launches {counts()}")
    for kind, n in STEP_SHAPES.items():
        check(len(seen[kind]) == n and sum(seen[kind].values())
              == STEP_LAUNCHES[kind], f"{kind} shapes {dict(seen[kind])}")

    reps = phase_bn_kernels(seen)

    # the timed steps
    stats_before = torch.cat([b.float().flatten()
                              for b in model.buffers()]).clone()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    losses = train(model, samples, TRAIN_STEPS, TRAIN_BATCH)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counts()
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    stats_after = torch.cat([b.float().flatten() for b in model.buffers()])
    check(launched == {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()},
          f"launches over {TRAIN_STEPS} steps: {launched}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    moved = float((stats_after - stats_before).abs().max())
    check(moved > 0 and bool(torch.isfinite(stats_after).all()),
          f"running statistics did not move: {moved}")

    prof = profile_step(model, samples)

    # host side of one step: batch assembly and the copy to the card
    t0 = time.perf_counter()
    batch = next(iter(DataSet.array(samples, seed=SEED).transform(
        SampleToMiniBatch(TRAIN_BATCH, drop_last=True)).data(train=True)))
    torch.as_tensor(batch.get_input()).to("cuda")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3

    # the unfused model from the same seed, on the same first batch
    del model
    torch.cuda.empty_cache()
    fresh = [p.detach().cpu() for p in resnet50(fuse=True).parameters()]
    unfused = resnet50(fuse=False)
    same = all(torch.equal(a, b.detach().cpu())
               for a, b in zip(fresh, unfused.parameters()))
    check(same and len(fresh) == len(list(unfused.parameters())),
          "the unfused model's weights differ from the fused model's")
    zero_counts()
    unfused_first = train(unfused, samples, 1, TRAIN_BATCH)
    unfused_launches = counts()
    del unfused
    torch.cuda.empty_cache()
    check(unfused_launches == {"bn_forward": 53, "bn_backward": 53,
                               "matmul_stats": 0, "bn_grad_stats": 0},
          f"unfused launches {unfused_launches}")
    diff = abs(unfused_first[0] - first[0])
    check(diff <= UNFUSED_ATOL, f"fused vs unfused first loss: {first} vs "
          f"{unfused_first}")

    f32 = f32_card_vs_cpu()
    shares = {k: total / step_ms for k, (_, total) in reps.items()}
    emit({"phase": "train", "gpu": gpu_line(), "model": "ResNet-50",
          "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "setup_s": setup_s,
          "warmup_s": warm_s, "wall_s": wall_s, "step_ms": step_ms,
          "images_per_s": TRAIN_BATCH / (step_ms / 1e3),
          "host_batch_ms": host_ms, "max_memory_allocated": peak,
          "losses": losses, "first_loss_fused": first[0],
          "first_loss_unfused": unfused_first[0], "fused_vs_unfused": diff,
          "unfused_tol": UNFUSED_ATOL, "launches": launched,
          "unfused_launches": unfused_launches,
          "running_stats_max_move": moved,
          "kernel_ms_per_step": {k: t for k, (_, t) in reps.items()},
          "kernel_share_of_step": shares, **prof, **f32})
    rows = []
    for kind, (rep, _) in reps.items():
        _, source, replaces = TRAIN_KERNELS[kind]
        rows.append({"name": kind, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched[kind],
                     "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                     "plain_ms": rep["plain_ms"],
                     "bound_ms": rep["bound_ms"],
                     "bound_by": rep["bound_by"],
                     "library_ms": rep["library_ms"]})
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase_build()
    rep = phase_kernels()
    model, launches = phase_serve()
    phase_generate(model)
    del model
    torch.cuda.empty_cache()
    rows = [{
        "name": "flash_attention", "route": "cuda",
        "source": "bigdl_torch/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/attention.py:59",
        "launches": launches, "max_abs_err": rep["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"]}]
    rows += phase_train()
    emit({"kernels": rows})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
