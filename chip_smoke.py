#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bigdl_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

(``python3 chip_smoke.py --dp-child DIR`` is one rank of phase 10, started
by the script itself.)

Phases, each printing one JSON line:

1. ``build``: compile every CUDA source of the port with ``nvcc`` (one
   process per source, all started together) and report the seconds and,
   by source and kernel, its registers and spilled bytes.
2. ``kernels``: hold the flash-attention kernels (B6) against their plain
   PyTorch version on the card, at the shapes the serving path gives them
   (D = 64) and at D = 32 and 128, each in bf16 (the ``"tc"`` route:
   wgmma fed by TMA) and float32 (the ``"f32"`` route: CUDA cores), causal
   and not, ragged T included; and time the kernel, the plain version and
   one PyTorch library call computing the same function (a yardstick only;
   the port never calls it; ``ms_over_library`` is their ratio), beside
   the least time the card could take (``bound_ms``).  A kernel's and a
   library call's ``ms`` is the card's time alone (20 calls captured in a
   CUDA graph and replayed); ``eager_ms`` is the same call issued back to
   back from the host, which a call of a few microseconds cannot keep up
   with.  Five more cases ask for the log-sum-exp that training saves
   (``flash_attention_with_lse``: the serving call and the LM step's call,
   bf16 causal, and ragged cases on both routes); it must agree with
   ``flash_lse_reference`` within ``LSE_ATOL``, and the call is timed as
   such and beside the same call without it (``ms_without_lse``).
3. ``serve``: TransformerLM at the bench width (vocab 32000, max_len 512,
   d_model 512, 8 heads, 8 layers, bf16 compute) with seeded random weights,
   served through ``InferenceServer(seq_buckets=(128, 256, 512),
   max_batch=8)``: warm-up, then 16 requests of lengths spread over 1..512.
   Every answer is checked against the port's own ``Predictor`` on the same
   padded row, and the kernel's launch count against 8 launches (one per
   layer) per device batch, every one on the ``"tc"`` route.  A full
   [8, 512] batch's answer comes to the host as the server brings it
   (``HostCopy``: a pinned buffer kept across calls, a side stream's copy)
   and must equal the pageable route it replaced (``to_host``) bit for
   bit; both are timed (``batch_to_host_ms``, ``_pageable_ms``).  A small
   float32 model is also checked on the card (on the ``"f32"`` route)
   against the same model's plain-PyTorch forward on the CPU.
4. ``generate``: ``greedy_generate`` extends a short prompt on the same
   model, every flash launch on ``"tc"``.
5. ``decode``: the same model served through ``DecodeEngine(slots=8,
   page=128)``: ``decode_kernels`` (next item), then one workload queued
   before ``start()`` (12 short sequences, prompts of 8 to 64 tokens and
   budgets of 8 to 32, and 4 long ones, prompts of 64 to 128 and budgets
   of 128; random tokens from ``default_rng(SEED)``; greedy), run through
   one engine with ``admission="continuous"`` and one with ``"batch"``,
   each twice: cold (every bucket's first call captures its CUDA graph)
   and warm (no new capture allowed, rows bit-equal to the cold run's).
   Every sequence must equal ``cached_generate`` of its prompt on the card
   under the tie rule (``tie_rule``: where two rows part, the two tokens'
   log-probs under the full forward must differ by less than
   ``TIE_TOL``), continuous must take fewer decode ticks than batch, B8's
   launches must be exactly 8 x (prompt positions + decode ticks) on its
   ``"bf16"`` route in every run (a graph replay counts the launches its
   capture recorded) with no flash launch, ``cache_bytes_per_slot``
   exact, no sequence failed.  At every rung of the ladder a prefill and a
   tick replayed from their graphs must equal eager ``decode_step`` calls
   on cloned caches bit for bit, log-probs and every cache row up to each
   slot's position (``graph_vs_eager``).  Reports tokens/s and time to
   last token per run, the host-timed cost of a decode tick and of a
   prefill position through the graphs and eagerly, the graph tick's
   device time, and the device's busy time and idle share over a profile
   of 20 ticks of each, which must show no ``scatter`` kernel (B8 appends
   k and v itself); and a small float32 LM (TF32 off, B8 on ``"f32"``)
   whose engine and ``cached_generate`` rows on the card must equal
   ``cached_generate`` on the CPU under the tie rule at 1e-4.
6. ``decode_kernels`` (inside ``decode``): B8 ``decode_attention`` (the
   append of k and v and the attention, one launch) against
   ``decode_attention_reference`` at the engine's shapes [8, 8, L, 64] and
   the prefill's [1, 8, L, 64] for L = 128, 256, 512, at D = 16, 32 and
   128, and at [8, 8, 4096, 64] (the copy ring wraps), in bf16 and
   float32, each with mixed positions (0 and L - 1 among them) and large
   garbage at and past them, called twice (the same bits), within
   ``DECODE_TOL``, the caches after the call bit-equal to the plain
   version's (row pos[s] written, no other row touched); plus
   [8, 8, 512, 64] bf16 with every position at 511.  Each case gives the
   cluster size C (``splits``) and is timed beside the plain version,
   ``scaled_dot_product_attention`` with a boolean [S, 1, 1, L] mask, an
   empty kernel of the same grid and cluster (``floor_ms``) and, at S = 1,
   clusters of 16 (``c16_ms``).
7. ``train``: ResNet-50 at the width of the repo's ``resnet50_bf16`` bench
   config (ImageNet, 1000 classes, NHWC 224x224x3, batch 256, bf16 compute
   over float32 params, ``CrossEntropyCriterion``, ``SGD(0.1)``,
   ``fuse_conv_bn`` before ``build``), weights random from the seed, on
   seeded synthetic images, trained through ``DataSet.array`` ->
   ``Optimizer``: one warm-up step, which also records every shape the
   step gives the BatchNorm and conv-BN kernels, then ``bn_kernels`` (next
   item), then ``TRAIN_STEPS`` timed steps at the default prefetch depth
   (2: a worker thread assembles each batch and stages it through a pinned
   buffer on a side stream), then the same steps from the same state at
   ``BIGDL_TORCH_PREFETCH_DEPTH=0`` (the synchronous path), whose inputs
   must be bit-identical and whose first loss within ``UNFUSED_ATOL``;
   both report ``step_ms`` and the data wait (the Optimizer's "get batch
   time average") per step and as a share of the wall time.  A profile of
   ``1 + PROFILE_STEPS`` steps (device busy and idle over the first step,
   the steady state after it and the whole run) must show no pageable
   host-to-device copy and a pinned one.  Every loss must be finite, the
   launch counts exactly 20 B1, 20 B2, 33 B5 (all on B5's ``"tc"`` route:
   wgmma fed by TMA) and 33 B4 per step, every B1, B2 and B4 launch on
   their ``"vec"`` route (16-byte pieces a thread, the sums finished in the
   same launch, B1's normalize and B2's dx pass walking the rows back
   through L2), and the running statistics must move.  Then the unfused
   model from the same seed takes its first step on the same batch (all 53
   BatchNorms on B1/B2, every launch on ``"vec"``) and must give the fused
   model's first loss within ``UNFUSED_ATOL``; and a small bottleneck
   ResNet in float32 (TF32 off, B5 on its ``"f32"`` route) takes 3 steps
   on the card and on the CPU, losses within ``F32_TRAIN_ATOL``.
8. ``bn_kernels`` (inside ``train``): B1 ``bn_forward``, B2 ``bn_backward``,
   B4 ``bn_grad_stats`` and B5 ``matmul_stats`` against their plain
   versions at every distinct shape the step gave them (bf16), plus
   float32 and ragged cases, each timed beside its plain version, a
   PyTorch yardstick call and its bound (``fits_l2`` marks a case whose
   operands fit the 50 MB L2: graph replays re-read the same buffers, so
   a share of the HBM bound above 100% there is L2, not a fault).  Each
   case names the route it took (every step shape of B1, B2, B3 and B4
   must take ``"vec"``; the ragged bf16 (37, 19, 70) of B5, which no
   tensor map can describe, ``"mma_sync"``; the ragged bf16 (1000, 130) of
   B1 to B4 ``"scalar"``) and is called twice on the same inputs: the
   sums (Σy and Σy²; Σx and Σx²; Σdy and Σdy·x̂) and B1's mean and var
   must come out bit-identical, and B2's sums must equal B4's on the same
   inputs bit for bit.  B1 and B2 also report ``floor_ms``, the two-pass
   floor: x (and dy) read twice and the output written once, what they pay
   where x exceeds L2 (``bound_ms`` counts one read).
9. ``dp_train``: the same ResNet-50, weights and images trained
   data-parallel: ``Engine.init()`` (NCCL, a world of one rank), a
   ``DistributedDataSet`` and ``Optimizer``'s ``DataParallel`` strategy,
   with every BatchNorm synced over the group.  One warm-up step records
   the shapes the step gives B3 ``bn_stats`` and B4, which then go through
   ``bn_kernels`` as above (and B3's sums must give B1's mean and var bit
   for bit at every B3 step shape on ``"vec"`` and at the ragged bf16
   (1000, 130) on ``"scalar"``), then ``TRAIN_STEPS`` timed steps.
   Launches per step exactly 20 B3 and 53 B4 (all ``"vec"``), 33 B5 and
   no B1 or B2; all-reduces per step exactly 53 of BN statistics, 53 of
   gradient statistics and one of the gradients (with the loss); the first
   loss within ``UNFUSED_ATOL`` of the ``train`` phase's; one profiled
   step gives the collectives' share.
10. ``dp_two_process``: two processes on the one card in a gloo group (NCCL
   refuses two ranks on one GPU) train the small bottleneck ResNet in
   float32 (TF32 off, no gradient wire, B5 on ``"f32"``) for 3 steps at
   local batch 8;
   one process trains it at batch 16 on the same rows.  Losses, params and
   running statistics within ``DP_F32_ATOL``, both ranks bit-identical,
   and each rank's B3, B4 and B5 launch counts non-zero.
11. ``train_lm``: TransformerLM at the bench width (as ``serve``) trained
   as bench.py trains ``transformer_lm``: batch 16 x T 512 of random
   tokens from ``default_rng(SEED)``, ``TimeDistributedCriterion(
   ClassNLLCriterion(), size_average=True)``, ``SGD(0.01, momentum=0.9)``,
   through ``DataSet.array`` -> ``Optimizer``: one warm-up step, then
   ``b7_kernels`` (next item) and B6 at the step's call, one untimed
   step, then ``TRAIN_STEPS`` timed steps and a profile.  Every loss
   finite; exactly 8 B6 launches a step, all ``"tc"``, and 16 of B7 (the
   flash backward, two launches a layer), all on its ``"tc"`` route
   (wgmma fed by TMA, taking the log-sum-exp B6 saved).  Then a small float32 LM (2 layers, d_model 64, T 64, TF32 off,
   B6 and B7 on ``"f32"``) trains 3 steps on the card and on the CPU,
   losses within ``F32_TRAIN_ATOL``, and one step with ``dropout=0.1``,
   twice from the same seed, gives the same finite loss, unlike the step
   without.
12. ``b7_kernels`` (inside ``train_lm``): B7 against
   ``flash_bwd_reference`` at the step's shape [16, 8, 512, 64] bf16
   causal (and not causal, and at D = 32 and 128) and at float32 and bf16
   ragged shapes (D = 32, 128; Tq != Tk), each given the output and
   log-sum-exp of B6 on the same operands, within ``B7_TOL`` and
   bit-identical over two calls, timed beside the plain version and the
   backward of ``scaled_dot_product_attention``.

Then a ``kernels`` line (one entry per kernel and path, with its launches
on that path: B6 on the serving path and per timed LM run, B7 per timed
LM run, B8 per warm continuous decode run (and per batch run beside it), B3 and B4 per timed data-parallel run, B1, B2, B4 and B5 per
timed training run; each also per route), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero without that line; so does a machine
without CUDA.
"""

import collections
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import bigdl_torch.nn as nn
from bigdl_torch import Engine
from bigdl_torch.common import DTypePolicy, set_policy
from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
from bigdl_torch.models import (ResNet, TransformerLM, cached_generate,
                                greedy_generate)
from bigdl_torch.models import decode as dec_mod
from bigdl_torch.models import resnet as resnet_mod
from bigdl_torch.ops import attention as attn_ops
from bigdl_torch.ops import batchnorm as bn_ops
from bigdl_torch.ops import convbn as cb_ops
from bigdl_torch.ops import decode_attention as dec_ops
from bigdl_torch.optim import SGD, Optimizer, Predictor, Trigger
from bigdl_torch.optim.optimizer import HostCopy, to_host
from bigdl_torch.serve import (DecodeEngine, InferenceServer, fit_bucket,
                               pad_tail)
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
# the L2 cache: a case whose operands fit is marked ``fits_l2``
L2_BYTES = 50 * 2 ** 20

# kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|:
# float32 (TF32 off): the two differ in summation order only.
# bfloat16: both round the output to bf16 (one step is 2^-8 relative), and
# the plain version also rounds p to bf16 before P.V, which moves a
# convex sum of |v| <= 5 by up to 5 * 2^-9 = 0.01.
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-2)}
# B6's log-sum-exp vs flash_lse_reference, absolute: both take the scores
# in float32 from the same bf16 (or float32) operands, in another order;
# the "tc" kernel sums exp2 and takes log2 by the MUFU approximations
# (relative error ~1e-7 a term, absolute ~2^-22): a few ulps of a value
# near ln(512) = 6.2, far below 1e-3
LSE_ATOL = 1e-3
# B6 cases that ask for it: the serving call and the LM step's call, and
# ragged cases on both routes
LSE_SHAPES = ((8, 8, 512, 512, 64, torch.bfloat16, True),
              (16, 8, 512, 512, 64, torch.bfloat16, True),
              (2, 4, 37, 200, 64, torch.float32, False),
              (2, 4, 200, 37, 32, torch.bfloat16, True),
              (2, 4, 200, 200, 128, torch.bfloat16, False))
# served answer vs Predictor on the same padded row, bf16 log-probs of
# magnitude <= ~16: one bf16 step there is 2^-4; a device batch of 8 rows
# and one of 1 may take different cuBLAS kernels, so allow 4 steps
SERVE_ATOL = 0.25
# float32 model on the card vs on the CPU (log-probs): summation order only
REF_ATOL = 1e-4

# the training path: bench.py's resnet50_bf16 config
TRAIN_BATCH = 256
TRAIN_STEPS = 5
# images in the training set: one epoch is TRAIN_STEPS batches, so the
# input worker can assemble the next batch while a step runs (the pipe is
# closed at every epoch's end)
TRAIN_IMAGES = TRAIN_BATCH * TRAIN_STEPS
BN_EPS = 1e-5
# launches per training step of the fused ResNet-50: 20 unfused BatchNorms
# (stem, 16 3x3 convs, 3 strided shortcuts) on B1/B2, 33 fused 1x1 sites
# (17 ConvBN, 16 ConvBNAddReLU) on B5 forward and B4 backward
STEP_LAUNCHES = {"bn_forward": 20, "bn_backward": 20, "bn_stats": 0,
                 "matmul_stats": 33, "bn_grad_stats": 33}
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

# the data-parallel path (NCCL, a world of one) at batch 256 per process:
# every unfused BatchNorm is sync-BN (B3 forward, B4 backward), every
# fused site B5 forward and B4 backward
DP_STEP_LAUNCHES = {"bn_forward": 0, "bn_backward": 0, "bn_stats": 20,
                    "matmul_stats": 33, "bn_grad_stats": 53}
DP_STEP_SHAPES = {"bn_stats": 8, "bn_grad_stats": 12, "matmul_stats": 12}
# all-reduces per data-parallel step: BN statistics at 53 sites forward and
# backward, and one of every gradient with the loss
DP_STEP_ALL_REDUCES = {"bn_stats": 53, "bn_grad_stats": 53, "grads": 1}
# two ranks at batch 8 vs one process at batch 16 on the same rows, float32
# (TF32 off, no wire): the ranks see the rows in another order and the
# convolutions run at another batch size, so sums differ in order only,
# amplified by 3 SGD steps; the same bound as F32_TRAIN_ATOL
DP_F32_ATOL = 1e-3
DP_CHILD_TIMEOUT = 300

# the LM training path: bench.py's transformer_lm config (LM above) at
# batch 16 x T 512, TimeDistributedCriterion(ClassNLLCriterion(),
# size_average=True), SGD(0.01, momentum=0.9)
LM_BATCH = 16
LM_LR = 0.01
# B7 vs flash_bwd_reference, |kernel - plain| <= atol + rtol * |plain|:
# float32 (TF32 off): summation order, p taken as exp(s - lse) against
# exp(s - m) / l, and rowsum(do * o) against rowsum(dP * P) (equal in exact
# arithmetic), over up to 200 keys: 1e-4.  bfloat16: each output rounded
# once to bf16 (2^-8 relative) from float32 values that differ as above,
# and rowsum(do * o) taken from the bf16 o: the forward's (2e-2, 1e-2).
B7_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}


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
    """Mean milliseconds per call, by CUDA events over ``iters``
    back-to-back calls from the host (inputs stay warm in L2, as inside a
    forward).  A call shorter than its host-side launch path measures the
    host: see :func:`graph_ms`."""
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


def graph_ms(fn, iters=20, replays=3):
    """Mean device milliseconds per call with the host out of the way:
    ``iters`` calls captured once in a CUDA graph, the graph replayed
    ``replays`` times between CUDA events.  Every launch of the calls is
    in the graph, so the time is the card's alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


# -- 1. build ---------------------------------------------------------------

def ptxas_functions(log):
    """Registers and spilled bytes of each kernel in an ``-Xptxas -v``
    report, by its name and template arguments (``bwd_dkv_tc_kernel<128>``).
    ptxas prints a function's spills, then its registers."""
    out, spill, fn = {}, None, None
    for line in log:
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d((?:[a-z]+_)*[a-z]*kernel)I(\w+?)EE",
                          m.group(1))
            args = k and re.sub(r"L[a-z](\d+)E?", r",\1", k.group(2))
            fn = f"{k.group(1)}<{args.strip(',')}>" if k else m.group(1)
            spill = None
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn] = {"registers": int(m.group(1)), "spill_bytes": spill}
    return out


def phase_build():
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.SOURCES)
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in libs.items():
        with open(path[:-3] + ".log") as f:
            ptxas[name] = ptxas_functions(f.read().splitlines())
    emit({"phase": "build", "gpu": gpu_line(), "seconds": seconds,
          "sources": list(libs), "ptxas": ptxas})


# -- 2. kernels -------------------------------------------------------------

def attention_bound(B, H, Tq, Tk, D, dtype, causal, with_lse=False):
    """Least device time for the call: q, k, v read once and o (and the
    float32 log-sum-exp, where asked) written once, against the products
    these inputs need (masked pairs skipped)."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * B * H * D * (2 * Tq + 2 * Tk) + 4 * B * H * Tq * with_lse
    pairs = sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk
    flops = 4 * D * B * H * pairs
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def ratio(ms, lib_ms):
    return ms / lib_ms if lib_ms else None


def flash_case(B, H, Tq, Tk, D, dtype, causal, gen, with_lse=False):
    """B6 against mha_reference; ``with_lse``: the call that also writes
    the log-sum-exp (training's), held to flash_lse_reference too and
    timed as such."""
    q = torch.randn((B, H, Tq, D), generator=gen).to("cuda", dtype)
    k = torch.randn((B, H, Tk, D), generator=gen).to("cuda", dtype)
    v = torch.randn((B, H, Tk, D), generator=gen).to("cuda", dtype)
    route = attn_ops.route(dtype)
    if with_lse:
        def call():
            return attn_ops.flash_attention_with_lse(q, k, v, causal=causal)
    else:
        def call():
            return attn_ops.flash_attention(q, k, v, causal=causal)
    with torch.inference_mode():
        zero_routes(attn_ops.flash_attention)
        got = call()
        out = got[0] if with_lse else got
        routed = only_route(attn_ops.flash_attention, route, 1)
        plain = attn_ops.mha_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs()
        atol, rtol = KERNEL_TOL[dtype]
        ok = routed and bool((err <= atol + rtol * plain.float().abs()).all())
        lse = {}
        if with_lse:
            lse_err = float((got[1] - attn_ops.flash_lse_reference(
                q, k, causal=causal)).abs().max())
            # the same call without the log-sum-exp, for its cost
            lse = {"lse_max_abs_err": lse_err, "lse_tol": LSE_ATOL,
                   "ms_without_lse": graph_ms(
                       lambda: attn_ops.flash_attention(q, k, v,
                                                        causal=causal))}
            ok = ok and got[1].shape == (B, H, Tq) and lse_err <= LSE_ATOL
        ms = graph_ms(call)
        eager_ms = cuda_ms(call)
        plain_ms = cuda_ms(
            lambda: attn_ops.mha_reference(q, k, v, causal=causal))
        lib_ms = graph_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
        lib_eager_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))
    bound_ms, bound_by, nbytes, flops = attention_bound(
        B, H, Tq, Tk, D, dtype, causal, with_lse)
    return {"shape": [B, H, Tq, Tk, D], "dtype": str(dtype)[6:],
            "causal": causal, "route": route, "with_lse": with_lse,
            "max_abs_err": float(err.max()), "tol": [atol, rtol], "ok": ok,
            **lse,
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_eager_ms": lib_eager_ms,
            "ms_over_library": ratio(ms, lib_ms), "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": nbytes, "flops": flops}


def phase_kernels():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    # the serving path's calls (D = 64), then the other head dimensions
    shapes = [(8, 8, t, t, 64) for t in (128, 256, 512)]
    shapes += [(8, 8, 200, 200, 64), (8, 8, 128, 512, 64)]
    shapes += [(8, 8, 512, 512, d) for d in (32, 128)]
    shapes += [(8, 8, 200, 200, d) for d in (32, 128)]
    cases = [flash_case(*s, dtype, causal, gen) for s in shapes
             for dtype in (torch.float32, torch.bfloat16)
             for causal in (False, True)]
    cases += [flash_case(*s, gen, with_lse=True) for s in LSE_SHAPES]
    emit({"phase": "kernels", "gpu": gpu_line(), "kernel": "flash_attention",
          "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"flash_attention disagrees with its plain version: {bad}")
    # the serving path's largest call: [8, 8, 512, 64] bf16 causal
    return next(c for c in cases if c["shape"] == [8, 8, 512, 512, 64]
                and c["dtype"] == "bfloat16" and c["causal"]
                and not c["with_lse"])


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
    zero_routes(attn_ops.flash_attention)
    with torch.inference_mode():
        ref = cpu.eval()(x)
        out = gpu.eval()(x.cuda()).cpu()
    err = float((out - ref).abs().max())
    check(err <= REF_ATOL, f"float32 model on the card vs CPU: {err}")
    check(only_route(attn_ops.flash_attention, "f32", cfg["num_layers"]),
          f"float32 model's flash routes "
          f"{attn_ops.flash_attention.route_launches}")
    return err


def host_ms(fn, reps=3):
    """Mean host-clock milliseconds of ``fn`` over ``reps`` calls."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def batch_split(model):
    """Where a full device batch's time goes: the eval forward of
    [MAX_BATCH, max_len] tokens on the card (CUDA events), and bringing
    its log-probs to the host as the server does (``HostCopy``: a side
    stream's copy into a pinned buffer kept across calls, then into the
    answer's own memory; host clock around it), beside the pageable route
    it replaced (``to_host``), whose answer it must equal bit for bit.
    ``to_pinned_ms`` and ``pinned_to_answer_ms`` time its two copies
    alone."""
    x = torch.zeros((MAX_BATCH, LM["max_len"]), dtype=torch.int64,
                    device="cuda")
    copy = HostCopy()
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model(x), iters=5, warmup=1)
        out = model(x)
        torch.cuda.synchronize()
        answer = copy(out)                      # the pinned buffer's first
        before = to_host(out)
        same = answer.dtype == before.dtype and np.array_equal(
            answer.view(np.uint32), before.view(np.uint32))
        new_ms = host_ms(lambda: copy(out))
        old_ms = host_ms(lambda: to_host(out))
        wide = out.float()
        pinned = torch.empty(wide.shape, dtype=wide.dtype, pin_memory=True)

        def to_pinned():
            pinned.copy_(wide, non_blocking=True)
            torch.cuda.synchronize()

        pin_ms = host_ms(to_pinned)
        out_ms = host_ms(lambda: torch.empty(wide.shape).copy_(pinned))
    check(same, "the answer through HostCopy differs from to_host's")
    return {"batch_shape": list(x.shape), "batch_forward_ms": fwd_ms,
            "batch_to_host_ms": new_ms,
            "batch_to_host_pageable_ms": old_ms, "to_pinned_ms": pin_ms,
            "pinned_to_answer_ms": out_ms,
            "answer_bit_equal_to_pageable": same,
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
    zero_routes(attn_ops.flash_attention)
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
    routes = dict(attn_ops.flash_attention.route_launches)
    stats = server.stats()

    device_batches = stats["batches"] + stats["warmup_batches"]
    expected = LM["num_layers"] * device_batches
    check(launches == expected,
          f"flash launches {launches} != 8 x {device_batches} batches")
    check(only_route(attn_ops.flash_attention, "tc", launches),
          f"served flash launches by route {routes}")
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
          "flash_route_launches": routes,
          **split, "max_abs_err_vs_predictor": worst, "tol": SERVE_ATOL,
          "f32_reference_max_abs_err": ref_err, "ref_tol": REF_ATOL})
    return model, launches, routes


# -- 4. generate ------------------------------------------------------------

def phase_generate(model):
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    prompt = np.random.RandomState(SEED + 1).randint(
        0, LM["vocab_size"], (8,))
    n_new = 4
    attn_ops.flash_attention.launches = 0
    zero_routes(attn_ops.flash_attention)
    t0 = time.perf_counter()
    out = greedy_generate(model, prompt, n_new, LM["max_len"])
    seconds = time.perf_counter() - t0
    launches = attn_ops.flash_attention.launches
    check(only_route(attn_ops.flash_attention, "tc", launches),
          f"generate's flash launches by route "
          f"{attn_ops.flash_attention.route_launches}")
    check(out.shape == (len(prompt) + n_new,), f"generated {out.shape}")
    check(np.array_equal(out[:len(prompt)], prompt), "prompt not kept")
    check(((out >= 0) & (out < LM["vocab_size"])).all(), "token range")
    check(launches == LM["num_layers"] * n_new,
          f"generate launched flash {launches} times")
    emit({"phase": "generate", "gpu": gpu_line(), "tokens": out.tolist(),
          "seconds": seconds, "flash_launches": launches,
          "flash_route_launches": dict(
              attn_ops.flash_attention.route_launches)})

# -- 5. decode, with 6. decode_kernels inside --------------------------------

# B8 vs decode_attention_reference, |kernel - plain| <= atol + rtol * |plain|:
# both take the scores, softmax and P.V in float32 from the same operands,
# in another order.  float32: summation order only, 1e-5.  bfloat16: the
# output is rounded once to bf16 from float32 values that may differ in
# the last bits, one bf16 step (2^-8 relative) either way: rtol 2^-7, and
# 1e-3 absolute for outputs near 0.
DECODE_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-3, 2.0 ** -7)}
# garbage written into the cache rows at and past each slot's position
# (the append replaces the row at it): large and finite, so a kernel that
# read them would be far off
DECODE_GARBAGE = 1e4
# the decode workload, shaped like tools/decode_smoke.py's mix: 12 short
# sequences (prompts of 8 to 64 tokens, budgets of 8 to 32) and 4 long ones
# (prompts of 64 to 128 tokens, budgets of 128), greedy
DECODE_SLOTS = 8
DECODE_PAGE = 128
DECODE_SHORT = 12
DECODE_LONG = 4
# the tie rule (tie_rule): where two greedy rows part, the two tokens'
# log-probs under the model's full forward on the card must differ by less
# than this.  float32: summation order only, as REF_ATOL.  bf16: log-probs
# of magnitude 8..16, where one bf16 step is 2^-4; a decode tick's product
# of M = 8 rows and a prefill's of M = 1 may take different cuBLAS kernels
# and the full forward a third, so allow 4 steps, as SERVE_ATOL does
TIE_TOL = {torch.float32: REF_ATOL, torch.bfloat16: SERVE_ATOL}
# decode ticks in the profiled window
DECODE_PROFILE_TICKS = 20


def decode_bound(S, H, L, D, dtype, pos):
    """Least device time for the call: q, k_new and v_new read and o
    written once, the K and V rows 0..pos[s] - 1 of every (slot, head) read
    once and row pos[s] written once, against the 4 * D operations per
    live key (the dot product and the P.V term)."""
    item = torch.empty((), dtype=dtype).element_size()
    live = int(pos.long().sum()) + S
    nbytes = item * H * D * (2 * live + 4 * S)
    flops = 4 * D * H * live
    return (*bound(nbytes, flops, PEAK_FLOPS[dtype]), nbytes, flops)


def decode_case(S, H, L, D, dtype, gen, full=False):
    """B8 against decode_attention_reference at [S, H, L, D]: mixed
    positions (0 and L - 1 among them) or, with ``full``, every position
    at L - 1; garbage at and past each position (the append replaces the
    row at it); called twice (the same bits).  The caches after the call
    must equal the plain version's bit for bit (row pos[s] written, every
    other row untouched).  Timed beside the empty kernel of the same grid
    and cluster (``floor_ms``) and, at S = 1, clusters of 16 (``c16_ms``:
    the splits stop at the portable 8)."""
    q, k_new, v_new = (torch.randn((S, 1, H, D), generator=gen)
                       .to("cuda", dtype).transpose(1, 2) for _ in range(3))
    k = torch.randn((S, H, L, D), generator=gen).to("cuda", dtype)
    v = torch.randn((S, H, L, D), generator=gen).to("cuda", dtype)
    if full:
        pos = torch.full((S,), L - 1, dtype=torch.int32)
    else:
        pos = torch.randint(0, L, (S,), generator=gen, dtype=torch.int32)
        pos[0] = L - 1
        if S > 1:
            pos[1] = 0
    rows = torch.arange(L)[None, None, :, None]
    stale = (rows >= pos.long()[:, None, None, None]).to("cuda")
    at = (rows == pos.long()[:, None, None, None]).to("cuda")
    live = (rows <= pos.long()[:, None, None, None]).to("cuda")
    k.masked_fill_(stale, DECODE_GARBAGE)
    v.masked_fill_(stale, -DECODE_GARBAGE)
    pos = pos.to("cuda")
    rt = dec_ops.route(dtype)
    C = dec_ops.splits(S, H, L)
    fn = dec_ops.decode_attention
    with torch.inference_mode():
        k0, v0 = k.clone(), v.clone()
        kp, vp = k.clone(), v.clone()
        zero_routes(fn)
        out = fn(q, k_new, v_new, k, v, pos)
        again = fn(q, k_new, v_new, k, v, pos)
        routed = only_route(fn, rt, 2)
        plain = dec_ops.decode_attention_reference(q, k_new, v_new, kp, vp,
                                                   pos)
        torch.cuda.synchronize()
        appended = torch.equal(k, kp) and torch.equal(v, vp)
        untouched = all(torch.equal(a.masked_fill(at, 0),
                                    b.masked_fill(at, 0))
                        for a, b in ((k, k0), (v, v0)))
        err = (out.float() - plain.float()).abs()
        atol, rtol = DECODE_TOL[dtype]
        repeat = torch.equal(out, again)
        ok = (routed and repeat and appended and untouched and bool(
            (err <= atol + rtol * plain.float().abs()).all()))
        ms = graph_ms(lambda: fn(q, k_new, v_new, k, v, pos))
        floor_ms = graph_ms(lambda: dec_ops._floor(S, H, D, C, dtype,
                                                   q.device))
        c16_ms = None
        if S == 1 and L // 16 >= dec_ops.MIN_ROWS:
            c16_ms = graph_ms(lambda: dec_ops._launch(q, k_new, v_new, k, v,
                                                      pos, 16))
        plain_ms = cuda_ms(lambda: dec_ops.decode_attention_reference(
            q, k_new, v_new, kp, vp, pos))
        mask = live[:, :1, :, 0][:, :, None, :]        # [S, 1, 1, L]
        lib_ms, lib_error = maybe_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask))
    bound_ms, bound_by, nbytes, flops = decode_bound(S, H, L, D, dtype, pos)
    return {"shape": [S, H, L, D], "dtype": str(dtype)[6:],
            "positions": "every L - 1" if full else "mixed",
            "route": rt, "splits": C, "max_abs_err": float(err.max()),
            "tol": [atol, rtol], "repeat_bit_identical": repeat,
            "append_bit_equal": appended, "other_rows_untouched": untouched,
            "ok": ok, "ms": ms, "floor_ms": floor_ms, "c16_ms": c16_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_error": lib_error, "ms_over_library": ratio(ms, lib_ms),
            "ms_over_plain": ms / plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": nbytes, "flops": flops}


def phase_decode_kernels():
    """B8's cases: the engine's shapes [8, 8, L, 64] at every cache page
    (bf16 and float32), the prefill's and cached_generate's S = 1 at every
    page, the other head dimensions, and a long cache whose copy ring
    wraps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    shapes = [(S, H, L, D) for S in (DECODE_SLOTS, 1) for L in (128, 256, 512)]
    shapes += [(DECODE_SLOTS, H, 512, 32), (DECODE_SLOTS, H, 512, 128),
               (DECODE_SLOTS, H, 512, 16), (DECODE_SLOTS, H, 4096, D)]
    cases = [decode_case(*s, dtype, gen) for s in shapes
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(decode_case(DECODE_SLOTS, H, 512, D, torch.bfloat16, gen,
                             full=True))
    emit({"phase": "decode_kernels", "gpu": gpu_line(),
          "kernel": "decode_attention", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"decode_attention disagrees with its plain version, "
          f"does not repeat or appends wrongly: {bad}")
    # the engine's largest call: [8, 8, 512, 64] bf16, mixed positions
    return next(c for c in cases if c["shape"] == [DECODE_SLOTS, H, 512, D]
                and c["dtype"] == "bfloat16" and c["positions"] == "mixed")


def tie_rule(model, a, b, t0, tol):
    """Compare two token rows from the prompt's end.  Where they first part,
    score the agreed prefix with the model's full forward on the card; the
    divergence is a near-tie, and accepted, only if the two tokens'
    log-probs there differ by less than ``tol``.  Returns (length of the
    agreeing prefix, log-prob gap at the parting or None)."""
    check(len(a) == len(b) and np.array_equal(a[:t0], b[:t0]),
          f"rows of different lengths or prompts: {a} {b}")
    apart = np.flatnonzero(a[t0:] != b[t0:])
    if apart.size == 0:
        return len(a), None
    i = t0 + int(apart[0])
    with torch.inference_mode():
        lp = model.eval()(torch.from_numpy(a[:i].astype(np.int64))[None]
                          .cuda())[0, -1].float()
    gap = abs(float(lp[int(a[i])]) - float(lp[int(b[i])]))
    check(gap < tol, f"rows part at {i} on tokens {a[i]} vs {b[i]} with a "
          f"log-prob gap {gap} >= {tol}: not a near-tie")
    return i, gap


def decode_workload(vocab):
    rng = np.random.default_rng(SEED)
    seqs = [(int(rng.integers(8, 65)), int(rng.integers(8, 33)))
            for _ in range(DECODE_SHORT)]
    seqs += [(int(rng.integers(64, 129)), 128) for _ in range(DECODE_LONG)]
    order = rng.permutation(len(seqs))
    return [(rng.integers(0, vocab, seqs[i][0]).astype(np.int32),
             seqs[i][1]) for i in order]


def run_engine(model, work, admission, **kw):
    """Run ``work`` twice through one engine, cold (queued before start(),
    so every bucket's first call captures its CUDA graph) then warm
    (queued at once into the running engine, whose graphs exist).  For
    each run: the outputs, the engine's counters over the run, the wall
    seconds, each sequence's time to last token, B8's launches by route
    and the peak memory."""
    eng = DecodeEngine(model, admission=admission, **kw)
    fn = dec_ops.decode_attention
    runs = {}
    for run in ("cold", "warm"):
        before = eng.stats()
        fn.launches = 0
        zero_routes(fn)
        zero_flash()
        torch.cuda.reset_peak_memory_stats()
        if run == "cold":
            handles = [eng.submit(p, n) for p, n in work]
            t0 = time.perf_counter()
            eng.start()
        else:
            # the loop takes the whole mix at once, as it did cold: it
            # cannot take from the queue while the queue's lock is held
            with eng.queue._cond:
                handles = [eng.submit(p, n) for p, n in work]
                t0 = time.perf_counter()
        outs = [h.result(600) for h in handles]
        wall = time.perf_counter() - t0
        after = eng.stats()
        check(flash_counts() == (0, 0),
              f"decode ({admission}, {run}) launched flash {flash_counts()}")
        delta = {k: after[k] - before[k] for k in (
            "decode_steps", "prefill_steps", "tokens_out", "seqs_done",
            "seqs_failed", "cache_grows")}
        delta.update({f"graph_{k}": after["graphs"][k] - before["graphs"][k]
                      for k in ("captures", "replays")})
        runs[run] = {
            "outs": outs, "stats": after, "delta": delta, "wall": wall,
            "ttlt": np.array([h.latency_s for h in handles]) * 1e3,
            "launches": fn.launches, "routes": dict(fn.route_launches),
            "peak": torch.cuda.max_memory_allocated()}
    eng.stop()
    return runs


def slot_prompts(rng, vocab, lengths):
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lengths]


def rows_equal(a, b, upto):
    """Every layer's K and V rows [0, upto[s]) of every slot s, bit for
    bit."""
    return all(torch.equal(x[n][s, :, :k], y[n][s, :, :k])
               for x, y in zip(a, b) for n in x
               for s, k in enumerate(upto))


def graph_vs_eager(model):
    """At every rung of the bench ladder, on an engine that is not
    started: fill every slot through the engine's prefill (the rung's
    first prefill and commit capture their graphs), then one more prefill
    (a replay of both) against the eager prefill on the slot's views of
    cloned caches, and one tick replay against an eager ``decode_step`` on
    cloned caches: the log-probs and every cache row up to each slot's
    position bit for bit."""
    S, V = DECODE_SLOTS, LM["vocab_size"]
    rng = np.random.default_rng(SEED + 5)
    eng = DecodeEngine(model, slots=S, page=DECODE_PAGE)
    out = []
    with torch.inference_mode(), eng._on_device():
        for L in eng.ladder:
            eng._ensure_cache(L, idle=True)
            t0s = rng.integers(1, L // 2, S)
            for s, p in enumerate(slot_prompts(rng, V, t0s)):
                eng._prefill(s, p)
            s = int(rng.integers(S))
            p = slot_prompts(rng, V, [t0s[s]])[0]
            ref = [{n: t.clone() for n, t in c.items()} for c in eng._caches]
            sub = [{n: t[s:s + 1] for n, t in c.items()} for c in ref]
            toks = torch.from_numpy(p).cuda()
            at = torch.arange(len(p), dtype=torch.int32, device="cuda")
            for i in range(len(p)):
                want = dec_mod.decode_step(model, sub, toks[i:i + 1],
                                           at[i:i + 1])
            want = want[0].float().cpu()
            replays = eng.graph_replays
            got = eng._prefill(s, p).clone()
            prefill_replays = eng.graph_replays - replays
            prefill_ok = torch.equal(got, want) and rows_equal(
                eng._caches, ref, t0s)
            tp = np.stack([rng.integers(0, V, S), t0s]).astype(np.int32)
            eng._step_all(tp)                   # the rung's first: captures
            tp = np.stack([rng.integers(0, V, S), t0s + 1]).astype(np.int32)
            ref = [{n: t.clone() for n, t in c.items()} for c in eng._caches]
            tpd = torch.from_numpy(tp).cuda()
            want = dec_mod.decode_step(model, ref, tpd[0], tpd[1])
            want = want.float().cpu()
            replays = eng.graph_replays
            got = eng._step_all(tp).clone()
            tick_replays = eng.graph_replays - replays
            tick_ok = torch.equal(got, want) and rows_equal(
                eng._caches, ref, t0s + 2)
            out.append({"cache_len": L, "prefill_positions": len(p),
                        "prefill_replays": prefill_replays,
                        "prefill_bit_equal": prefill_ok,
                        "tick_replays": tick_replays,
                        "tick_bit_equal": tick_ok})
    st = eng.stats()["graphs"]
    want_buckets = sorted(f"{k}/{L}" for k in ("commit", "prefill", "tick")
                          for L in eng.ladder)
    check(all(r["prefill_bit_equal"] and r["tick_bit_equal"]
              and r["prefill_replays"] == r["prefill_positions"] + 1
              and r["tick_replays"] == 1 for r in out)
          and st["buckets"] == want_buckets
          and st["captures"] == len(want_buckets),
          f"graph replays against eager steps: {out}, graphs {st}")
    return {"graph_vs_eager": out, "graph_vs_eager_graphs": st}


def profile_ticks(tick):
    """DECODE_PROFILE_TICKS calls of ``tick`` under torch.profiler: the
    device's busy time a tick, its idle share of the wall time, the top
    kernels and any ``scatter`` kernel."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DECODE_PROFILE_TICKS):
                tick()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = e.self_cuda_time_total
                rows.append((us / 1e3, e.count, e.key[:100]))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        return {
            "scatter_kernels": [k for _, _, k in rows
                                if "scatter" in k.lower()],
            "profiled_ticks": DECODE_PROFILE_TICKS,
            "profiled_wall_ms": wall_ms,
            "device_busy_ms_per_tick": busy / DECODE_PROFILE_TICKS,
            "device_idle_share": 1 - busy / wall_ms,
            "top_kernels": [{"ms": ms, "count": c, "name": k}
                            for ms, c, k in rows[:10]]}
    except (RuntimeError, AttributeError) as e:
        return {"profile_error": str(e).splitlines()[0][:200]}


def tick_costs(model, cache_len):
    """Host-clock milliseconds of one decode tick (all slots, with the
    log-prob row brought to the host) and of one prefill position, on
    caches of ``cache_len``, eagerly (``decode_step`` calls issued from
    the host; a prefill position with no sync) and as the engine runs them
    (a replay of the bucket's graph, the static inputs copied in from
    pinned buffers, the output out through one; a prefill of 50 positions
    with its commit and the host trip, per position); the graph tick's
    device time alone (CUDA events around back-to-back replays); and a
    profile of DECODE_PROFILE_TICKS ticks of each: the device's busy time
    and idle share."""
    S, n = DECODE_SLOTS, 50
    dev = torch.device("cuda")
    with torch.inference_mode():
        caches = dec_mod.init_kv_cache(model, S, cache_len, torch.bfloat16)
        tok = torch.randint(0, LM["vocab_size"], (S,), dtype=torch.int32,
                            device=dev)
        pos = torch.randint(0, cache_len, (S,), dtype=torch.int32,
                            device=dev)

        def tick():
            return dec_mod.decode_step(model, caches, tok, pos).float().cpu()

        sub = [{n: t[:1] for n, t in c.items()} for c in caches]

        def prefill(k):
            for i in range(k):
                dec_mod.decode_step(model, sub, tok[:1], pos[:1])
            torch.cuda.synchronize()

        for _ in range(3):
            tick()
        prefill(3)
        tick_ms = host_ms(tick, n)
        prefill_ms = host_ms(lambda: prefill(n)) / n
        eager_prof = profile_ticks(tick)

        eng = DecodeEngine(model, slots=S, page=DECODE_PAGE)
        with eng._on_device():
            eng._ensure_cache(cache_len, idle=True)
            tp = np.stack([tok.cpu().numpy(), pos.cpu().numpy()])
            prompt = np.random.default_rng(SEED + 6).integers(
                0, LM["vocab_size"], n).astype(np.int32)
            for _ in range(3):
                eng._step_all(tp)
                eng._prefill(0, prompt[:3])
            graph_tick_ms = host_ms(lambda: eng._step_all(tp), n)
            graph_prefill_ms = host_ms(lambda: eng._prefill(0, prompt)) / n
            graph = eng._graphs[("tick", cache_len)].graph
            device_ms = cuda_ms(graph.replay, iters=n)
            graph_prof = profile_ticks(lambda: eng._step_all(tp))
    return {"tick_cache_len": cache_len, "eager_tick_ms": tick_ms,
            "eager_prefill_position_ms": prefill_ms,
            "tick_ms": graph_tick_ms,
            "prefill_position_ms": graph_prefill_ms,
            "graph_tick_device_ms": device_ms,
            "eager_profile": eager_prof, "profile": graph_prof}


def decode_f32_card_vs_cpu():
    """A small float32 LM (TF32 off, B8 on "f32"): the engine's and
    cached_generate's tokens on the card against cached_generate on the
    CPU (the plain path), under the tie rule at the float32 tolerance."""
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = TransformerLM(**LM_SMALL).build(
        "cpu", torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(SEED + 3)
    work = [(rng.integers(0, LM_SMALL["vocab_size"], int(t)).astype(np.int32),
             int(n)) for t, n in zip(rng.integers(1, 20, 6),
                                     rng.integers(4, 24, 6))]
    fn = dec_ops.decode_attention
    zero_routes(fn)
    with DecodeEngine(gpu, slots=4, page=16) as eng:
        outs = [eng.submit(p, n) for p, n in work]
        outs = [h.result(300) for h in outs]
    card = [cached_generate(gpu, p, n, len(p) + n) for p, n in work]
    check(fn.route_launches["bf16"] == 0 and fn.route_launches["f32"] > 0,
          f"float32 decode's B8 routes {fn.route_launches}")
    agree, gaps = [], []
    for (p, n), o, c in zip(work, outs, card):
        ref = cached_generate(cpu, p, n, len(p) + n)
        for row in (o, c):
            i, gap = tie_rule(gpu, row, ref, len(p), TIE_TOL[torch.float32])
            agree.append(i - len(p))
            if gap is not None:
                gaps.append(gap)
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    return {"f32_sequences": len(work), "f32_agreeing_tokens": agree,
            "f32_tie_gaps": gaps, "f32_tie_tol": TIE_TOL[torch.float32]}


def phase_decode(model):
    """The bench-width model served through DecodeEngine(slots=8,
    page=128), continuous and batch admission, each cold then warm
    through one engine, every row held to cached_generate on the card
    under the tie rule; graph replays held to eager steps."""
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    rep = phase_decode_kernels()
    work = decode_workload(LM["vocab_size"])
    prompt_positions = sum(len(p) for p, _ in work)
    budget = sum(n for _, n in work)
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    runs, launched, route_launches = {}, {}, {}
    for admission in ("continuous", "batch"):
        both = run_engine(model, work, admission, slots=DECODE_SLOTS,
                          page=DECODE_PAGE)
        for run, r in both.items():
            what = f"decode ({admission}, {run})"
            d, st = r["delta"], r["stats"]
            check(d["seqs_done"] == len(work) and d["seqs_failed"] == 0,
                  f"{what}: {d}")
            check(d["prefill_steps"] == len(work) and
                  d["tokens_out"] == budget, f"{what}: prefills and tokens "
                  f"{d}")
            want = LM["num_layers"] * (prompt_positions + d["decode_steps"])
            check(r["launches"] == want, f"{what}: B8 launches "
                  f"{r['launches']} != 8 x ({prompt_positions} prompt "
                  f"positions + {d['decode_steps']} decode ticks)")
            check(r["routes"] == {"bf16": r["launches"], "f32": 0},
                  f"{what}: B8 routes {r['routes']}")
            per_slot = LM["num_layers"] * 2 * H * st["cache_len"] * D * 2
            check(st["cache_bytes_per_slot"] == per_slot,
                  f"{what}: cache bytes per slot "
                  f"{st['cache_bytes_per_slot']} != {per_slot}")
            check(d["graph_replays"] > 0, f"{what}: no graph replayed {d}")
        check(both["warm"]["delta"]["graph_captures"] == 0,
              f"decode ({admission}): the warm run captured "
              f"{both['warm']['delta']['graph_captures']} graphs")
        check(all(np.array_equal(a, b) for a, b in zip(
            both["cold"]["outs"], both["warm"]["outs"])),
            f"decode ({admission}): warm rows differ from cold rows")
        for run, r in both.items():
            runs[f"{admission}_{run}"] = {
                "wall_s": r["wall"], "tokens_per_s_wall": budget / r["wall"],
                "decode_ticks": r["delta"]["decode_steps"],
                "prefill_positions": prompt_positions,
                "ttlt_p50_ms": float(np.percentile(r["ttlt"], 50)),
                "ttlt_p99_ms": float(np.percentile(r["ttlt"], 99)),
                "cache_len": r["stats"]["cache_len"],
                "cache_grows": r["delta"]["cache_grows"],
                "cache_bytes_per_slot": r["stats"]["cache_bytes_per_slot"],
                "graph_captures": r["delta"]["graph_captures"],
                "graph_replays": r["delta"]["graph_replays"],
                "graph_buckets": r["stats"]["graphs"]["buckets"],
                "max_memory_allocated": r["peak"],
                "b8_launches": r["launches"],
                "b8_route_launches": r["routes"]}
        runs[admission] = both["cold"]["outs"]
        launched[admission] = both["warm"]["launches"]
        route_launches[admission] = both["warm"]["routes"]
    check(runs["continuous_warm"]["decode_ticks"] <
          runs["batch_warm"]["decode_ticks"],
          f"continuous admission took "
          f"{runs['continuous_warm']['decode_ticks']} decode ticks, batch "
          f"{runs['batch_warm']['decode_ticks']}")
    agree, gaps = [], []
    for k, (p, n) in enumerate(work):
        oracle = cached_generate(model, p, n, len(p) + n)
        for admission in ("continuous", "batch"):
            i, gap = tie_rule(model, runs[admission][k], oracle, len(p),
                              TIE_TOL[torch.bfloat16])
            agree.append(i - len(p))
            if gap is not None:
                gaps.append(gap)
    del runs["continuous"], runs["batch"]
    graphs = graph_vs_eager(model)
    costs = tick_costs(model, runs["continuous_warm"]["cache_len"])
    for name in ("eager_profile", "profile"):
        prof = costs[name]
        check("profile_error" not in prof and not prof["scatter_kernels"],
              f"decode {name}: {prof.get('profile_error')}, scatter kernels "
              f"{prof.get('scatter_kernels')} (B8 appends k and v itself)")
    small = decode_f32_card_vs_cpu()
    emit({"phase": "decode", "gpu": gpu_line(), "model": "TransformerLM",
          "config": LM, "slots": DECODE_SLOTS, "page": DECODE_PAGE,
          "sequences": len(work), "token_budget": budget, "runs": runs,
          "agreeing_tokens": agree, "tie_gaps": gaps,
          "tie_tol": TIE_TOL[torch.bfloat16], **graphs, **costs, **small})
    return {"name": "decode_attention", "route": "cuda",
            "source": "bigdl_torch/csrc/decode_attention.cu",
            "replaces": "bigdl_tpu/serve/decode.py:129",
            "launches": launched["continuous"], "path": "decode",
            "launches_batch_admission": launched["batch"],
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
            "ms_over_library": rep["ms_over_library"],
            "floor_ms": rep["floor_ms"], "splits": rep["splits"],
            "kernel_route": rep["route"],
            "route_launches": route_launches["continuous"]}


# -- 7. train, with 8. bn_kernels inside --------------------------------------

#: training-path kernels: wrapper, source, the TPU kernel it replaces
TRAIN_KERNELS = {
    "bn_forward": (bn_ops.bn_forward, "bigdl_torch/csrc/batchnorm.cu",
                   "bigdl_tpu/ops/batchnorm.py:75"),
    "bn_backward": (bn_ops.bn_backward, "bigdl_torch/csrc/batchnorm.cu",
                    "bigdl_tpu/ops/batchnorm.py:165"),
    "bn_stats": (bn_ops.bn_stats, "bigdl_torch/csrc/batchnorm.cu",
                 "bigdl_tpu/ops/batchnorm.py:300"),
    "bn_grad_stats": (bn_ops.bn_grad_stats, "bigdl_torch/csrc/batchnorm.cu",
                      "bigdl_tpu/ops/batchnorm.py:353"),
    "matmul_stats": (cb_ops.matmul_stats, "bigdl_torch/csrc/matmul_stats.cu",
                     "bigdl_tpu/ops/convbn.py:66"),
}
# float32 operations per element of the BatchNorm kernels (an FMA is 2):
# B1 Σx, Σx² and the normalize; B2 x̂, Σdy, Σdy·x̂ and dx; B3 Σx, Σx²;
# B4 x̂ and sums
BN_FLOPS_PER_ELEM = {"bn_forward": 5, "bn_backward": 12, "bn_stats": 3,
                     "bn_grad_stats": 6}


def zero_counts():
    for fn, _, _ in TRAIN_KERNELS.values():
        fn.launches = 0
        zero_routes(fn)


def counts():
    return {k: fn.launches for k, (fn, _, _) in TRAIN_KERNELS.items()}


def zero_routes(fn):
    fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def b5_routes():
    return dict(cb_ops.matmul_stats.route_launches)


def route_counts():
    """Launches by route of every training-path kernel."""
    return {k: dict(fn.route_launches)
            for k, (fn, _, _) in TRAIN_KERNELS.items()}


#: the route every bf16 launch of a training step must take
STEP_ROUTES = {"matmul_stats": "tc", "bn_forward": "vec",
               "bn_backward": "vec", "bn_stats": "vec",
               "bn_grad_stats": "vec"}


def check_step_routes(launched, what):
    """Every launch in ``launched`` on its kernel's step route."""
    for kind, rt in STEP_ROUTES.items():
        fn = TRAIN_KERNELS[kind][0]
        check(only_route(fn, rt, launched[kind]),
              f"{what}: {kind} launches by route {fn.route_launches}")


def only_route(fn, route, n):
    """``fn``'s launches since its counts were zeroed: ``n`` on ``route``
    and none on the others."""
    want = dict.fromkeys(fn.route_launches, 0)
    want[route] = n
    return fn.route_launches == want


def record_shapes(model, sync=False):
    """Forward hooks that count, per kernel, the operand shapes one
    training step gives it: at every BatchNorm left unfused B1/B2 (or,
    with ``sync``, B3 forward and B4 backward), at every fused site B5
    (and B4, in the backward, at its output).  Returns (shape counters,
    hook handles)."""
    seen = {k: collections.Counter() for k in TRAIN_KERNELS}
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
        for kind in (("bn_stats", "bn_grad_stats") if sync else
                     ("bn_forward", "bn_backward")):
            seen[kind][rc] += 1

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
    """A yardstick's device time, or None with the reason where PyTorch
    does not take the call (it is a measurement aid, never the port's
    path)."""
    try:
        return graph_ms(fn), None
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
            # x read twice: what B1 pays where it exceeds L2
            floor_bytes = 3 * item * R * C + 4 * 4 * C
        elif kind == "bn_backward":
            args = (x, dy, mean, inv, w)

            def lib():
                return torch.ops.aten.native_batch_norm_backward(
                    dy, x, w, None, None, mean, inv, True, BN_EPS,
                    [True, True, True])
            nbytes = 3 * item * R * C + 4 * 5 * C
            # x and dy read twice: what B2 pays where they exceed L2
            floor_bytes = 5 * item * R * C + 4 * 5 * C
        elif kind == "bn_stats":
            args = (x,)

            def lib():  # mean and invstd by Welford: a yardstick only
                return torch.batch_norm_stats(x, BN_EPS)
            nbytes = item * R * C + 4 * 2 * C
        else:
            args = (x, dy, mean, inv)

            def lib():
                return torch.batch_norm_backward_reduce(
                    dy, x, mean, inv, w, True, False, False)
            nbytes = 2 * item * R * C + 4 * 4 * C
        out_idx = (0,) if kind in ("bn_forward", "bn_backward") else ()
    plain = {"bn_forward": bn_ops.bn_forward_reference,
             "bn_backward": bn_ops.bn_backward_reference,
             "bn_stats": bn_ops.bn_stats_reference,
             "bn_grad_stats": bn_ops.bn_grad_stats_reference,
             "matmul_stats": cb_ops.matmul_stats_reference}[kind]
    if kind == "matmul_stats":
        extra = {"route": cb_ops.route(x, w)}
    elif kind in ("bn_backward", "bn_grad_stats"):
        extra = {"route": bn_ops.route(x, dy)}
    else:  # B1 and B3 route on x alone
        extra = {"route": bn_ops.route(x)}
    zero_routes(fn)
    got, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    # the route was chosen before the launch, and the sums (B1's mean and
    # var) are bit-reproducible: a second call on the same inputs
    again = fn(*args)
    sums = (0, 1) if kind in ("bn_stats", "bn_grad_stats") else (1, 2)
    extra["repeatable"] = all(torch.equal(got[i], again[i]) for i in sums)
    ok = only_route(fn, extra["route"], 2) and extra["repeatable"]
    del again
    worst_abs, worst_rel = 0.0, 0.0
    if kind == "bn_backward":
        b4 = bn_ops.bn_grad_stats(x, dy, mean, inv)
        extra["sums_equal_b4"] = (torch.equal(got[1], b4[0])
                                  and torch.equal(got[2], b4[1]))
        ok = ok and extra["sums_equal_b4"]
    for i, (o, r) in enumerate(zip(got, ref)):
        a, rel = rel_err(o, r)
        tol = (BN_TOL["bf16_out"] if i in out_idx and dtype == torch.bfloat16
               else BN_TOL["f32"])
        ok = ok and rel <= tol and o.dtype == r.dtype and o.shape == r.shape
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, rel)
    lib_ms, lib_note = maybe_ms(lib)
    bound_ms, bound_by = bound(nbytes, flops, peak)
    ms = graph_ms(lambda: fn(*args))
    case = {"kernel": kind, "shape": list(shape), "dtype": str(dtype)[6:],
            "calls_per_step": calls, **extra, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "ok": ok, "ms": ms,
            "eager_ms": cuda_ms(lambda: fn(*args)),
            "plain_ms": cuda_ms(lambda: plain(*args), iters=5, warmup=1),
            "library_ms": lib_ms, "ms_over_library": ratio(ms, lib_ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "bytes": nbytes, "flops": flops,
            "fits_l2": nbytes <= L2_BYTES}
    if kind in ("bn_forward", "bn_backward"):
        case["floor_ms"] = floor_bytes / PEAK_BYTES * 1e3
        case["floor_share"] = case["floor_ms"] / ms
    if lib_note:
        case["library_note"] = lib_note
    return case


def phase_bn_kernels(seen, kinds, path):
    """Each of ``kinds`` at every distinct shape the step of ``path`` gave
    it (bf16), plus float32 and ragged cases; returns, per kernel, the
    case of its largest call and its device ms per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    extra = {"matmul_stats": [(1000, 64, 64), (37, 19, 70), (300, 130, 2048)],
             "other": [(1000, 3), (1000, 130), (12544, 2048)]}
    reps = {}
    for kind in kinds:
        shapes = sorted(seen[kind].items())
        cases = [bn_case(kind, sh, torch.bfloat16, gen, n)
                 for sh, n in shapes]
        for sh in extra["matmul_stats" if kind == "matmul_stats"
                       else "other"]:
            cases += [bn_case(kind, sh, dt, gen)
                      for dt in (torch.float32, torch.bfloat16)]
        emit({"phase": "bn_kernels", "path": path, "gpu": gpu_line(),
              "kernel": kind, "cases": cases})
        bad = [c for c in cases if not c["ok"]]
        check(not bad, f"{kind} disagrees with its plain version: {bad}")
        if kind == "matmul_stats":
            # every step shape on the wgmma kernel; a bf16 shape no tensor
            # map can describe on the mma.sync one
            routes = {(tuple(c["shape"]), c["dtype"]): c["route"]
                      for c in cases}
            check(all(c["route"] == "tc" for c in cases
                      if c["calls_per_step"]), f"B5 step routes {routes}")
            check(routes[(37, 19, 70), "bfloat16"] == "mma_sync",
                  f"B5 ragged bf16 route {routes}")
        else:
            # every step shape on the streaming kernel; a ragged C on the
            # one-element-a-thread one
            routes = {(tuple(c["shape"]), c["dtype"]): c["route"]
                      for c in cases}
            check(all(c["route"] == "vec" for c in cases
                      if c["calls_per_step"]), f"{kind} step routes {routes}")
            check(routes[(1000, 130), "bfloat16"] == "scalar",
                  f"{kind} ragged bf16 route {routes}")
        step = [c for c in cases if c["calls_per_step"]]
        # the step's largest call: the most bytes to move
        reps[kind] = (max(step, key=lambda c: (c["bytes"], c["flops"])),
                      sum(c["calls_per_step"] * c["ms"] for c in step))
        torch.cuda.empty_cache()
    return reps


def _is_all_reduce(name):
    return "allreduce" in name.lower().replace("_", "")


#: the profiled run: one step from a fresh pipeline, then these steps
PROFILE_STEPS = 3


def _mark(name):
    """A zero-length event named ``name`` on the profiler's timeline."""
    with torch.profiler.record_function(name):
        pass


def _device_ms(events, lo, hi):
    """Device time (kernels and copies, summed) inside [lo, hi] µs."""
    return sum(max(0.0, min(e.time_range.end, hi) - max(e.time_range.start,
                                                          lo))
               for e in events) / 1e3


def profile_step(run, distributed=False):
    """``run(mark)`` under ``torch.profiler``: ``1 + PROFILE_STEPS``
    Optimizer steps from a fresh pipeline, calling ``mark(n)`` as step n
    starts.  Reports device time by kernel name (top 25), the host-to-
    device copies by kind, and the device's busy time per step and idle
    share of the wall time over three windows of one trace:
    ``first_step`` (from the call to step 2's start: the pipeline's fill,
    one step, the next batch's wait; the one-step profile of earlier
    runs), ``steady`` (step 2's start to the end: the pipeline once
    filled), and the whole run (the top-level keys).  Under
    ``distributed``, also the all-reduces' device time and host time (the
    host time of each all-reduce op on the CPU side of the trace).  A
    measurement aid: a profiler that cannot trace the card is reported in
    the result, not fatal."""
    from torch.profiler import ProfilerActivity, profile
    steps = 1 + PROFILE_STEPS
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _mark("chip_smoke.start")
            run(lambda n: _mark(f"chip_smoke.step{n}"))
            torch.cuda.synchronize()
            _mark("chip_smoke.end")
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows, host_ar = [], {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                if _is_all_reduce(e.key):
                    host_ar[e.key[:80]] = {"ms": e.cpu_time_total / 1e3,
                                           "count": e.count}
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us / 1e3, e.count, e.key[:120]))
        marks, device = {}, []
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device.append(e)
            elif e.name.startswith("chip_smoke."):
                marks.setdefault(e.name[len("chip_smoke."):],
                                 e.time_range.start)
        lo, mid, hi = marks["start"], marks["step2"], marks["end"]
    except (RuntimeError, AttributeError, KeyError) as e:
        return {"profile_error": str(e).splitlines()[0][:200]}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    ar_device = sum(ms for ms, _, k in rows if _is_all_reduce(k))
    htod = {k: {"ms": ms, "count": n} for ms, n, k in rows
            if "HtoD" in k}

    def window(a, b, n):
        ms = (b - a) / 1e3
        dev = _device_ms(device, a, b)
        return {"steps": n, "wall_ms": ms, "device_busy_ms": dev / n,
                "device_idle_share": 1 - dev / ms if ms else None}

    out = {"profiled_steps": steps,
           "profiled_wall_ms": wall_ms,
           "device_busy_ms": busy / steps,
           "device_idle_share": 1 - busy / wall_ms if wall_ms else None,
           "first_step": window(lo, mid, 1),
           "steady": window(mid, hi, PROFILE_STEPS),
           "htod_copies": htod,
           "top_kernels": [{"ms": ms, "count": n, "name": k}
                           for ms, n, k in rows[:25]]}
    if distributed:
        host_ms = max((v["ms"] for v in host_ar.values()), default=0.0)
        out.update({
            "all_reduce_device_ms": ar_device,
            "all_reduce_host_ops": host_ar,
            "all_reduce_share_of_step": max(ar_device, host_ms) / wall_ms})
    return out


def pageable_htod(prof):
    """The profiled run's host-to-device copies out of pageable memory."""
    return {k: v for k, v in prof.get("htod_copies", {}).items()
            if "Pageable" in k}


def synthetic_imagenet(n, seed):
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, 224, 224, 3), dtype=np.float32)
    y = rs.integers(0, 1000, n).astype(np.int32)
    return [Sample(x[i], y[i]) for i in range(n)]


def train(model, samples, steps, batch, device=None, distributed=False,
          criterion=None, method=None, on_step=None):
    """``steps`` Optimizer steps on a fresh ``DataSet.array(samples,
    distributed=distributed)`` (seeded: every call visits the same
    batches); returns the loss the driver observed after each step, and
    leaves the Optimizer's counters in ``train.metrics``.  Under the
    Engine's group the Optimizer trains data-parallel.  The default
    criterion and method are the ResNet path's.  ``on_step(n)``, if
    given, is called as step n starts (at the loop's first trigger check
    for it, once its batch is in hand)."""
    losses, started = {}, set()

    def end(state):
        n = state["neval"]
        if n > 1:
            losses[n - 1] = state["loss"]
        if on_step is not None and n <= steps and n not in started:
            started.add(n)
            on_step(n)
        return n > steps

    opt = Optimizer(model, DataSet.array(samples, distributed=distributed,
                                         seed=SEED),
                    criterion or nn.CrossEntropyCriterion(),
                    batch_size=batch, device=device)
    opt.set_optim_method(method or SGD(0.1))
    opt.set_end_when(Trigger(end, "steps"))
    opt.optimize()
    train.metrics = opt.metrics
    return [losses[k] for k in sorted(losses)]


@contextlib.contextmanager
def prefetch_depth(depth):
    """``BIGDL_TORCH_PREFETCH_DEPTH`` set to ``depth`` inside the block."""
    old = os.environ.get("BIGDL_TORCH_PREFETCH_DEPTH")
    os.environ["BIGDL_TORCH_PREFETCH_DEPTH"] = str(depth)
    try:
        yield
    finally:
        if old is None:
            del os.environ["BIGDL_TORCH_PREFETCH_DEPTH"]
        else:
            os.environ["BIGDL_TORCH_PREFETCH_DEPTH"] = old


def record_inputs(model):
    """A forward pre-hook keeping a copy of every input batch the model
    is given; returns (the list, the hook handle)."""
    seen = []
    handle = model.register_forward_pre_hook(
        lambda mod, inp: seen.append(inp[0].detach().clone()))
    return seen, handle


def timed_run(run):
    """``run()`` between CUDA events, ending synchronized; returns (its
    result, device-clock ms, host wall s, the data wait's total s, the
    get-batch counter's count, the computing counter's total s)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = run()
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    wait_s, n = train.metrics.get("get batch time average")
    comp_s, _ = train.metrics.get("computing time average")
    return out, start.elapsed_time(end), wall_s, wait_s, n, comp_s


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
    routes = b5_routes()
    host = train(cpu, samples, 3, 8, device="cpu")
    err = max(abs(a - b) for a, b in zip(card, host))
    check(all(launched[k] > 0 for k, n in STEP_LAUNCHES.items() if n),
          f"the float32 run skipped a kernel: {launched}")
    check(only_route(cb_ops.matmul_stats, "f32", launched["matmul_stats"]),
          f"the float32 run's B5 routes {routes}")
    check(err <= F32_TRAIN_ATOL, f"float32 ResNet card vs CPU: {card} vs "
          f"{host}")
    return {"f32_losses_card": card, "f32_losses_cpu": host,
            "f32_max_loss_diff": err, "f32_tol": F32_TRAIN_ATOL,
            "f32_launches": launched, "f32_b5_route_launches": routes}


def phase_train():
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    samples = synthetic_imagenet(TRAIN_IMAGES, SEED)
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
    check_step_routes(STEP_LAUNCHES, "warm-up")
    for kind, n in STEP_SHAPES.items():
        check(len(seen[kind]) == n and sum(seen[kind].values())
              == STEP_LAUNCHES[kind], f"{kind} shapes {dict(seen[kind])}")

    reps = phase_bn_kernels(seen, STEP_SHAPES, "train")
    # bn_kernels emptied the allocator's cache: one step refills it
    train(model, samples, 1, TRAIN_BATCH)

    # the timed steps at the default prefetch depth (2), staged through
    # pinned buffers on a side stream, from a saved state
    saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
    stats_before = torch.cat([b.float().flatten()
                              for b in model.buffers()]).clone()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    inputs, hook = record_inputs(model)
    losses, run_ms, wall_s, wait_s, n_wait, comp_s = timed_run(
        lambda: train(model, samples, TRAIN_STEPS, TRAIN_BATCH))
    hook.remove()
    launched = counts()
    routes = route_counts()
    step_ms = run_ms / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    stats_after = torch.cat([b.float().flatten() for b in model.buffers()])
    check(launched == {k: v * TRAIN_STEPS for k, v in STEP_LAUNCHES.items()},
          f"launches over {TRAIN_STEPS} steps: {launched}")
    check_step_routes(launched, f"{TRAIN_STEPS} steps")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    moved = float((stats_after - stats_before).abs().max())
    check(moved > 0 and bool(torch.isfinite(stats_after).all()),
          f"running statistics did not move: {moved}")

    # the same batches from the same state, synchronous: depth 0 assembles
    # each batch on the main thread and copies it from pageable memory
    model.load_state_dict(saved)
    del saved
    inputs0, hook = record_inputs(model)
    with prefetch_depth(0):
        losses0, run0_ms, wall0_s, wait0_s, _, comp0_s = timed_run(
            lambda: train(model, samples, TRAIN_STEPS, TRAIN_BATCH))
    hook.remove()
    same_inputs = (len(inputs) == len(inputs0) == TRAIN_STEPS
                   and all(torch.equal(a, b) for a, b in zip(inputs, inputs0)))
    del inputs, inputs0
    check(same_inputs, "depth 0 and depth 2 gave the steps other inputs")
    depth_diff = abs(losses0[0] - losses[0])
    check(depth_diff <= UNFUSED_ATOL and all(map(math.isfinite, losses0)),
          f"depth 0 vs depth 2 losses: {losses0} vs {losses}")
    # two more timed runs in the other order (depth 0, then 2): the host
    # side of a step varies from run to run
    again = {}
    for depth in (0, 2):
        with prefetch_depth(depth):
            again[depth] = timed_run(lambda: train(
                model, samples, TRAIN_STEPS, TRAIN_BATCH))[1] / TRAIN_STEPS
    pipeline = {
        "prefetch_depth": 2, "step_ms_depth0": run0_ms / TRAIN_STEPS,
        "step_ms_runs": {"depth2": [step_ms, again[2]],
                         "depth0": [run0_ms / TRAIN_STEPS, again[0]]},
        "losses_depth0": losses0, "first_loss_depth_diff": depth_diff,
        "inputs_bit_identical": same_inputs,
        "data_wait_ms": wait_s / n_wait * 1e3,
        "data_wait_fraction": wait_s / wall_s,
        "computing_ms": comp_s / TRAIN_STEPS * 1e3,
        "data_wait_ms_depth0": wait0_s / TRAIN_STEPS * 1e3,
        "data_wait_fraction_depth0": wait0_s / wall0_s,
        "computing_ms_depth0": comp0_s / TRAIN_STEPS * 1e3}

    prof = profile_step(lambda mark: train(
        model, samples, 1 + PROFILE_STEPS, TRAIN_BATCH, on_step=mark))
    check("profile_error" not in prof, f"profile: {prof}")
    check(not pageable_htod(prof)
          and any("Pinned" in k for k in prof["htod_copies"]),
          f"the profiled steps' host-to-device copies "
          f"{prof['htod_copies']}: the batch must come from pinned memory")

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
    check_step_routes(unfused_launches, "unfused step")
    del unfused
    torch.cuda.empty_cache()
    check(unfused_launches == {"bn_forward": 53, "bn_backward": 53,
                               "bn_stats": 0, "matmul_stats": 0,
                               "bn_grad_stats": 0},
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
          "host_batch_ms": host_ms, **pipeline,
          "max_memory_allocated": peak,
          "losses": losses, "first_loss_fused": first[0],
          "first_loss_unfused": unfused_first[0], "fused_vs_unfused": diff,
          "unfused_tol": UNFUSED_ATOL, "launches": launched,
          "route_launches": routes, "unfused_launches": unfused_launches,
          "running_stats_max_move": moved,
          "kernel_ms_per_step": {k: t for k, (_, t) in reps.items()},
          "kernel_share_of_step": shares, **prof, **f32})
    return kernel_rows(reps, launched, "train", routes), first[0]


def kernel_rows(reps, launched, path, routes):
    """The ``kernels`` line's entries of the kernels in ``reps``, with
    their launches in the timed run of ``path``, also by route (from
    ``routes``)."""
    rows = []
    for kind, (rep, _) in reps.items():
        _, source, replaces = TRAIN_KERNELS[kind]
        row = {"name": kind, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launched[kind],
               "path": path, "max_abs_err": rep["max_abs_err"],
               "ms": rep["ms"], "plain_ms": rep["plain_ms"],
               "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
               "library_ms": rep["library_ms"],
               "ms_over_library": rep["ms_over_library"],
               "kernel_route": rep["route"], "route_launches": routes[kind]}
        rows.append(row)
    return rows


# -- 9. dp_train, with bn_kernels for B3 and B4 inside ---------------------

def b3_gives_b1_statistics(shapes):
    """At each shape (bf16): B3 and B1 take the same route, and the mean
    and var from B3's sums (Σx/R, Σx²/R − mean², true divisions) equal
    B1's bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = []
    for R, C in shapes:
        x = (torch.randn((R, C), device="cuda", generator=gen) * 2
             + 0.5).to(torch.bfloat16)
        zero_routes(bn_ops.bn_stats)
        zero_routes(bn_ops.bn_forward)
        s, ss = bn_ops.bn_stats(x)
        _, mean, var = bn_ops.bn_forward(x, torch.ones(C, device="cuda"),
                                         torch.zeros(C, device="cuda"),
                                         BN_EPS)
        rt = bn_ops.route(x)
        n = torch.full_like(s, R)
        m = s / n
        equal = (only_route(bn_ops.bn_stats, rt, 1)
                 and only_route(bn_ops.bn_forward, rt, 1)
                 and torch.equal(m, mean)
                 and torch.equal(ss / n - m * m, var))
        cases.append({"shape": [R, C], "route": rt, "bit_equal": equal})
        del x
    check(all(c["bit_equal"] for c in cases),
          f"B3's statistics differ from B1's: {cases}")
    return {"b3_b1_cases": cases,
            "b3_b1_bit_equal": all(c["bit_equal"] for c in cases)}


def all_reduce_host_us(n=200):
    """Mean host microseconds of one all-reduce of a [2, 64] float32 buffer
    (the size of a BN statistics all-reduce) over the group, back to back
    and synchronized at the end: the fixed cost of each of the step's 107
    all-reduces.  Counted under its own kind, after the step's counts were
    read."""
    t = torch.zeros(128, device="cuda")
    for _ in range(10):
        Engine.all_reduce(t, "probe")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        Engine.all_reduce(t, "probe")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def phase_dp_train(single_first_loss):
    """ResNet-50 as in ``train``, data-parallel over a world of one under
    NCCL: every collective of a larger group runs."""
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    Engine.init()
    backend = torch.distributed.get_backend(Engine.group())
    check(Engine.world() == 1 and backend == "nccl",
          f"group of {Engine.world()} over {backend}")
    samples = synthetic_imagenet(TRAIN_IMAGES, SEED)
    model = resnet50(fuse=True)

    seen, handles = record_shapes(model, sync=True)
    zero_counts()
    Engine.all_reduces.clear()
    first = train(model, samples, 1, TRAIN_BATCH, distributed=True)
    for h in handles:
        h.remove()
    check(counts() == DP_STEP_LAUNCHES, f"warm-up launches {counts()}")
    check_step_routes(DP_STEP_LAUNCHES, "data-parallel warm-up")
    check(Engine.all_reduces == DP_STEP_ALL_REDUCES,
          f"warm-up all-reduces {dict(Engine.all_reduces)}")
    for kind, n in DP_STEP_SHAPES.items():
        check(len(seen[kind]) == n and sum(seen[kind].values())
              == DP_STEP_LAUNCHES[kind], f"{kind} shapes {dict(seen[kind])}")
    diff = abs(first[0] - single_first_loss)
    check(diff <= UNFUSED_ATOL, f"data-parallel vs single-device first "
          f"loss: {first[0]} vs {single_first_loss}")

    reps = phase_bn_kernels(seen, ("bn_stats", "bn_grad_stats"), "dp_train")
    # every B3 step shape on "vec", and a ragged C on "scalar"
    bit = b3_gives_b1_statistics(sorted(seen["bn_stats"]) + [(1000, 130)])
    routes = {tuple(c["shape"]): c["route"] for c in bit["b3_b1_cases"]}
    check(routes.pop((1000, 130)) == "scalar"
          and set(routes.values()) == {"vec"}, f"B3 / B1 routes {routes}")

    stats_before = torch.cat([b.float().flatten()
                              for b in model.buffers()]).clone()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    Engine.all_reduces.clear()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    losses = train(model, samples, TRAIN_STEPS, TRAIN_BATCH, distributed=True)
    end.record()
    torch.cuda.synchronize()
    launched = counts()
    routes = route_counts()
    all_reduces = dict(Engine.all_reduces)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    stats_after = torch.cat([b.float().flatten() for b in model.buffers()])
    check(launched == {k: v * TRAIN_STEPS
                       for k, v in DP_STEP_LAUNCHES.items()},
          f"launches over {TRAIN_STEPS} steps: {launched}")
    check_step_routes(launched, f"{TRAIN_STEPS} data-parallel steps")
    check(all_reduces == {k: v * TRAIN_STEPS
                          for k, v in DP_STEP_ALL_REDUCES.items()},
          f"all-reduces over {TRAIN_STEPS} steps: {all_reduces}")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    moved = float((stats_after - stats_before).abs().max())
    check(moved > 0 and bool(torch.isfinite(stats_after).all()),
          f"running statistics did not move: {moved}")

    prof = profile_step(lambda mark: train(
        model, samples, 1 + PROFILE_STEPS, TRAIN_BATCH, distributed=True,
        on_step=mark), distributed=True)
    probe_us = all_reduce_host_us()
    del model
    Engine.reset()
    torch.cuda.empty_cache()
    emit({"phase": "dp_train", "gpu": gpu_line(), "model": "ResNet-50",
          "backend": backend, "world": 1, "batch_per_process": TRAIN_BATCH,
          "steps": TRAIN_STEPS, "step_ms": step_ms,
          "images_per_s": TRAIN_BATCH / (step_ms / 1e3),
          "max_memory_allocated": peak, "losses": losses,
          "first_loss": first[0], "first_loss_single_device":
          single_first_loss, "vs_single_device": diff,
          "tol": UNFUSED_ATOL, "launches": launched,
          "route_launches": routes,
          "all_reduces": all_reduces, "all_reduce_host_us": probe_us,
          "running_stats_max_move": moved,
          "kernel_ms_per_step": {k: t for k, (_, t) in reps.items()},
          **bit, **prof})
    return kernel_rows(reps, launched, "dp_train", routes)


# -- 10. dp_two_process -----------------------------------------------------

DP_LOCAL_BATCH = 8
DP_STEPS = 3


def small_samples():
    rs = np.random.default_rng(SEED + 2)
    x = rs.standard_normal((32, 32, 32, 3), dtype=np.float32)
    y = rs.integers(0, 10, 32).astype(np.int32)
    return [Sample(x[i], y[i]) for i in range(32)]


def float32_exact():
    set_policy(DTypePolicy(wire_dtype=None))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def dp_child(out_dir):
    """One rank of ``dp_two_process``: the rank, world and rendezvous come
    from the ``BIGDL_TORCH_*`` env contract."""
    float32_exact()
    Engine.init(device="cuda:0", backend="gloo")
    model = small_resnet().build("cuda", torch.Generator().manual_seed(SEED))
    zero_counts()
    losses = train(model, small_samples(), DP_STEPS, DP_LOCAL_BATCH,
                   distributed=True)
    rank = Engine.rank()
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(out_dir, f"rank{rank}.pt"))
    emit({"rank": rank, "world": Engine.world(), "losses": losses,
          "launches": counts(), "b5_route_launches": b5_routes(),
          "all_reduces": dict(Engine.all_reduces)})
    Engine.reset()
    return 0


def phase_dp_two_process():
    float32_exact()
    ref = small_resnet().build("cuda", torch.Generator().manual_seed(SEED))
    ref_losses = train(ref, small_samples(), DP_STEPS, 2 * DP_LOCAL_BATCH)
    ref_state = {k: v.cpu() for k, v in ref.state_dict().items()}
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ,
               "PYTHONPATH": os.path.dirname(os.path.abspath(__file__)),
               "BIGDL_TORCH_COORDINATOR": f"file://{tmp}/store",
               "BIGDL_TORCH_NUM_PROCESSES": "2"}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-child", tmp],
            env={**env, "BIGDL_TORCH_PROCESS_ID": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(2)]
        try:
            outs = [p.communicate(timeout=DP_CHILD_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        wall = time.perf_counter() - t0
        for p, (out, err) in zip(procs, outs):
            check(p.returncode == 0, f"rank failed ({p.returncode}):\n"
                  f"{out[-2000:]}\n{err[-4000:]}")
        ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
        states = [torch.load(os.path.join(tmp, f"rank{i}.pt"))
                  for i in range(2)]
    check([r["rank"] for r in ranks] == [0, 1]
          and all(r["world"] == 2 for r in ranks), f"ranks {ranks}")
    for r in ranks:
        check(all(r["launches"][k] > 0 for k in
                  ("bn_stats", "bn_grad_stats", "matmul_stats")),
              f"rank {r['rank']} skipped a kernel: {r['launches']}")
        b5 = r["b5_route_launches"]
        check(b5["f32"] == r["launches"]["matmul_stats"]
              and b5["tc"] == b5["mma_sync"] == 0,
              f"rank {r['rank']}'s float32 B5 routes {b5}")
    check(ranks[0]["losses"] == ranks[1]["losses"]
          and all(torch.equal(states[0][k], states[1][k])
                  for k in states[0]), "the two ranks diverged")
    loss_err = max(abs(a - b) for a, b in zip(ranks[0]["losses"],
                                             ref_losses))
    state_err = max(rel_err(states[0][k], v)[1] for k, v in ref_state.items())
    check(len(ref_losses) == DP_STEPS and loss_err <= DP_F32_ATOL
          and state_err <= DP_F32_ATOL,
          f"two ranks vs one process: losses {ranks[0]['losses']} vs "
          f"{ref_losses}, params/stats {state_err}")
    emit({"phase": "dp_two_process", "gpu": gpu_line(), "backend": "gloo",
          "world": 2, "batch_per_process": DP_LOCAL_BATCH,
          "steps": DP_STEPS, "wall_s": wall, "losses": ranks[0]["losses"],
          "losses_one_process": ref_losses, "max_loss_diff": loss_err,
          "max_state_rel_err": state_err, "tol": DP_F32_ATOL,
          "rank_launches": [r["launches"] for r in ranks],
          "rank_b5_route_launches": [r["b5_route_launches"] for r in ranks],
          "rank_all_reduces": [r["all_reduces"] for r in ranks]})


# -- 11. train_lm, with B7's cases inside ------------------------------------

def attention_bwd_bound(B, H, Tq, Tk, D, dtype, causal):
    """Least device time of the backward: q, o, do (Tq rows), k, v (Tk
    rows) and the float32 log-sum-exp read once, dq, dk, dv written once,
    against its five products (S, dP, dv, dq, dk: 10 * D FLOPs a pair)
    over the unmasked pairs."""
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = item * B * H * D * (4 * Tq + 4 * Tk) + 4 * B * H * Tq
    pairs = sum(min(i + 1, Tk) for i in range(Tq)) if causal else Tq * Tk
    flops = 10 * D * B * H * pairs
    return (*bound(nbytes, flops, PEAK_FLOPS[dtype]), nbytes, flops)


def b7_case(B, H, Tq, Tk, D, dtype, causal, gen):
    """B7 against flash_bwd_reference on the card, twice (the result must
    repeat bit for bit: no atomics), timed beside the plain version and the
    backward of PyTorch's scaled_dot_product_attention (a yardstick)."""
    q, k, v = (torch.randn((B, H, T, D), device="cuda", generator=gen)
               .to(dtype) for T in (Tq, Tk, Tk))
    do = torch.randn((B, H, Tq, D), device="cuda", generator=gen).to(dtype)
    fn = attn_ops.flash_attention_bwd
    rt = attn_ops.bwd_route(dtype)
    with torch.no_grad():
        # the forward's output and log-sum-exp, from B6, as FlashAttention
        # saves them
        o, lse = attn_ops.flash_attention_with_lse(q, k, v, causal=causal)
        zero_routes(fn)
        got = fn(q, k, v, o, do, lse=lse, causal=causal)
        again = fn(q, k, v, o, do, lse=lse, causal=causal)
        routed = only_route(fn, rt, 4)
        plain = attn_ops.flash_bwd_reference(q, k, v, do, causal=causal)
        torch.cuda.synchronize()
        atol, rtol = B7_TOL[dtype]
        errs = [float((g.float() - p.float()).abs().max())
                for g, p in zip(got, plain)]
        ok = routed and all(
            g.dtype == p.dtype and g.shape == p.shape and bool(
                ((g.float() - p.float()).abs()
                 <= atol + rtol * p.float().abs()).all())
            for g, p in zip(got, plain))
        repeatable = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, plain
        ms = graph_ms(lambda: fn(q, k, v, o, do, lse=lse, causal=causal))
        plain_ms = cuda_ms(lambda: attn_ops.flash_bwd_reference(
            q, k, v, do, causal=causal), iters=5, warmup=1)
    # the yardstick: SDPA's forward and backward captured together (the
    # backward runs on its forward's stream), less its forward alone
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(lq, lk, lv, is_causal=causal)

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), (lq, lk, lv), do)
    both_ms, lib_note = maybe_ms(lib_fwd_bwd)
    fwd_ms, fwd_note = maybe_ms(lib_fwd)
    lib_ms = both_ms - fwd_ms if both_ms and fwd_ms else None
    lib_note = lib_note or fwd_note
    bound_ms, bound_by, nbytes, flops = attention_bwd_bound(
        B, H, Tq, Tk, D, dtype, causal)
    case = {"shape": [B, H, Tq, Tk, D], "dtype": str(dtype)[6:],
            "causal": causal, "route": rt, "max_abs_err": max(errs),
            "max_abs_err_dq_dk_dv": errs, "tol": [atol, rtol],
            "repeatable": repeatable, "ok": ok and repeatable, "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "ms_over_library": ratio(ms, lib_ms), "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / ms,
            "bytes": nbytes, "flops": flops}
    if lib_note:
        case["library_note"] = lib_note
    return case


def phase_b7():
    """B7 at the LM step's shape and at float32 ragged shapes; returns the
    step shape's case."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    H, D = LM["num_heads"], LM["d_model"] // LM["num_heads"]
    T = LM["max_len"]
    shapes = [(LM_BATCH, H, T, T, D, torch.bfloat16, True),
              (4, 4, 200, 200, 64, torch.bfloat16, False),
              (LM_BATCH, H, T, T, D, torch.bfloat16, False)]
    for d in (32, 128):
        shapes += [(2, 4, 37, 200, d, torch.float32, False),
                   (2, 4, 200, 37, d, torch.float32, False),
                   (2, 4, 200, 200, d, torch.float32, True),
                   (2, 4, 200, 200, d, torch.bfloat16, True),
                   (2, 4, 37, 200, d, torch.bfloat16, False),
                   (2, 4, 200, 37, d, torch.bfloat16, True),
                   (LM_BATCH, H, T, T, d, torch.bfloat16, True)]
    cases = [b7_case(*sh, gen) for sh in shapes]
    emit({"phase": "b7_kernels", "gpu": gpu_line(),
          "kernel": "flash_attention_bwd", "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"flash_attention_bwd disagrees with its plain version "
          f"or does not repeat: {bad}")
    return cases[0]


def lm_samples(n, seq, vocab, seed):
    """Next-token pairs over random tokens from ``default_rng(seed)``."""
    toks = np.random.default_rng(seed).integers(0, vocab, (n, seq + 1))
    toks = toks.astype(np.int32)
    return [Sample(toks[i, :-1], toks[i, 1:]) for i in range(n)]


def train_lm(model, samples, steps, batch, device=None, on_step=None):
    """The LM path: TimeDistributedCriterion(ClassNLLCriterion()) and
    SGD(0.01, momentum=0.9), as bench.py trains transformer_lm."""
    return train(model, samples, steps, batch, device=device,
                 criterion=nn.TimeDistributedCriterion(
                     nn.ClassNLLCriterion(), size_average=True),
                 method=SGD(LM_LR, momentum=0.9), on_step=on_step)


def flash_counts():
    return (attn_ops.flash_attention.launches,
            attn_ops.flash_attention_bwd.launches)


def zero_flash():
    for fn in (attn_ops.flash_attention, attn_ops.flash_attention_bwd):
        fn.launches = 0
        zero_routes(fn)


def check_lm_launches(steps, what, fwd_route="tc", bwd_route="tc",
                      layers=LM["num_layers"]):
    fwd, bwd = flash_counts()
    want = (layers * steps, 2 * layers * steps)
    check((fwd, bwd) == want, f"{what}: flash launches (forward, backward) "
          f"{(fwd, bwd)} != {want}")
    check(only_route(attn_ops.flash_attention, fwd_route, fwd)
          and only_route(attn_ops.flash_attention_bwd, bwd_route, bwd),
          f"{what}: flash routes {attn_ops.flash_attention.route_launches} "
          f"{attn_ops.flash_attention_bwd.route_launches}")


LM_SMALL = dict(vocab_size=97, max_len=64, d_model=64, num_heads=2,
                num_layers=2)


def lm_f32_card_vs_cpu():
    """A small float32 LM (TF32 off) trained 3 steps on the card (B6 and
    B7 on "f32") and on the CPU (their plain versions)."""
    set_policy(DTypePolicy())
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = TransformerLM(**LM_SMALL).build(
        "cpu", torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    samples = lm_samples(24, LM_SMALL["max_len"], LM_SMALL["vocab_size"],
                         SEED + 5)
    zero_flash()
    card = train_lm(gpu, samples, 3, 8)
    check_lm_launches(3, "float32 LM", "f32", "f32", LM_SMALL["num_layers"])
    host = train_lm(cpu, samples, 3, 8, device="cpu")
    err = max(abs(a - b) for a, b in zip(card, host))
    check(len(card) == 3 and err <= F32_TRAIN_ATOL,
          f"float32 LM card vs CPU: {card} vs {host}")

    # dropout 0.1: one step, twice from the same seed (the Optimizer's
    # generator is seeded from BIGDL_TORCH_SEED): the same finite loss
    def dropout_step():
        m = TransformerLM(**LM_SMALL, dropout=0.1).build(
            "cuda", torch.Generator().manual_seed(SEED))
        return train_lm(m, samples, 1, 8)[0]
    drop = [dropout_step(), dropout_step()]
    # the same weights and batch as the first step above, so a loss that
    # differs from it shows the masks were applied
    check(math.isfinite(drop[0]) and drop[0] == drop[1] != card[0],
          f"dropout steps from one seed: {drop}, without dropout {card[0]}")
    return {"f32_losses_card": card, "f32_losses_cpu": host,
            "f32_max_loss_diff": err, "f32_tol": F32_TRAIN_ATOL,
            "dropout_first_losses": drop}


def phase_train_lm():
    """TransformerLM at the transformer_lm bench width trained through
    DataSet.array -> Optimizer; B7's cases; the float32 and dropout
    checks."""
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    t0 = time.perf_counter()
    T, V = LM["max_len"], LM["vocab_size"]
    samples = lm_samples(LM_BATCH * TRAIN_STEPS, T, V, SEED)
    model = TransformerLM(**LM).build(
        "cuda", torch.Generator().manual_seed(SEED))
    setup_s = time.perf_counter() - t0

    zero_flash()
    t0 = time.perf_counter()
    first = train_lm(model, samples, 1, LM_BATCH)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check_lm_launches(1, "LM warm-up")
    check(math.isfinite(first[0]), f"LM warm-up loss {first}")

    rep = phase_b7()
    # B6 at the step's call: [16, 8, 512, 64] bf16 causal
    b6 = flash_case(LM_BATCH, LM["num_heads"], T, T,
                    LM["d_model"] // LM["num_heads"], torch.bfloat16, True,
                    torch.Generator().manual_seed(SEED), with_lse=True)
    check(b6["ok"], f"flash_attention at the LM step's call: {b6}")
    # as in train: the kernel cases' graphs and plain versions left the
    # allocator's cache in another shape; one step refills it
    train_lm(model, samples, 1, LM_BATCH)

    torch.cuda.reset_peak_memory_stats()
    zero_flash()
    losses, run_ms, wall_s, wait_s, n_wait, comp_s = timed_run(
        lambda: train_lm(model, samples, TRAIN_STEPS, LM_BATCH))
    fwd, bwd = flash_counts()
    fwd_routes = dict(attn_ops.flash_attention.route_launches)
    bwd_routes = dict(attn_ops.flash_attention_bwd.route_launches)
    check_lm_launches(TRAIN_STEPS, f"{TRAIN_STEPS} LM steps")
    check(len(losses) == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"LM losses {losses}")
    step_ms = run_ms / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    prof = profile_step(lambda mark: train_lm(
        model, samples, 1 + PROFILE_STEPS, LM_BATCH, on_step=mark))
    del model
    torch.cuda.empty_cache()
    small = lm_f32_card_vs_cpu()
    set_policy(DTypePolicy(compute_dtype=torch.bfloat16))
    emit({"phase": "train_lm", "gpu": gpu_line(), "model": "TransformerLM",
          "config": LM, "batch": LM_BATCH, "seq": T, "steps": TRAIN_STEPS,
          "setup_s": setup_s, "warmup_s": warm_s, "wall_s": wall_s,
          "step_ms": step_ms, "tokens_per_s": LM_BATCH * T / (step_ms / 1e3),
          "data_wait_ms": wait_s / n_wait * 1e3,
          "data_wait_fraction": wait_s / wall_s,
          "computing_ms": comp_s / TRAIN_STEPS * 1e3,
          "max_memory_allocated": peak, "losses": losses,
          "flash_launches": fwd, "flash_route_launches": fwd_routes,
          "flash_bwd_launches": bwd, "flash_bwd_route_launches": bwd_routes,
          "flash_step_case": b6, **prof, **small})
    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention.cu",
         "replaces": "bigdl_tpu/ops/attention.py:59", "launches": fwd,
         "path": "train_lm", "max_abs_err": b6["max_abs_err"],
         "lse_max_abs_err": b6["lse_max_abs_err"],
         "ms": b6["ms"], "plain_ms": b6["plain_ms"],
         "bound_ms": b6["bound_ms"], "bound_by": b6["bound_by"],
         "library_ms": b6["library_ms"],
         "ms_over_library": b6["ms_over_library"],
         "kernel_route": b6["route"], "route_launches": fwd_routes},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "bigdl_torch/csrc/flash_attention_bwd.cu",
         "replaces": "bigdl_tpu/ops/attention.py:182", "launches": bwd,
         "path": "train_lm", "max_abs_err": rep["max_abs_err"],
         "ms": rep["ms"], "plain_ms": rep["plain_ms"],
         "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
         "library_ms": rep["library_ms"],
         "ms_over_library": rep["ms_over_library"],
         "kernel_route": rep["route"], "route_launches": bwd_routes}]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(sys.argv[2])
    phase_build()
    rep = phase_kernels()
    model, launches, routes = phase_serve()
    phase_generate(model)
    decode_row = phase_decode(model)
    del model
    torch.cuda.empty_cache()
    rows = [{
        "name": "flash_attention", "route": "cuda",
        "source": "bigdl_torch/csrc/flash_attention.cu",
        "replaces": "bigdl_tpu/ops/attention.py:59",
        "launches": launches, "path": "serve",
        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
        "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"], "library_ms": rep["library_ms"],
        "ms_over_library": rep["ms_over_library"],
        "kernel_route": rep["route"], "route_launches": routes}]
    train_rows, first_loss = phase_train()
    rows += train_rows
    rows += phase_dp_train(first_loss)
    phase_dp_two_process()
    rows += phase_train_lm()
    rows.append(decode_row)
    emit({"kernels": rows})
    print(gpu_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
